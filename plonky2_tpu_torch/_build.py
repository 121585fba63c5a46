"""Build and load the port's CUDA kernels at first use.

`nvcc` compiles every `csrc/*.cu` into an object file, one process per
source, all started together, then links them into one shared library with
a plain C interface (no PyTorch headers, so a build takes seconds), written
to `plonky2_tpu_torch/build/` under a name that carries a hash of the
sources; `ctypes` loads it.  ptxas's register and spill report of every
kernel goes to the library's `.log` beside it.  A failed build raises:
nothing falls back.

    python -m plonky2_tpu_torch._build     # build now, print the library path
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_lock = threading.Lock()
_lib = None

_vp = ctypes.c_void_p
_i64 = ctypes.c_int64
_int = ctypes.c_int
_SIGNATURES = {
    "p2t_poseidon_set_constants": [_vp, _vp, _vp],
    "p2t_poseidon_permute_cols": [_vp, _vp, _i64, _int, _vp],
    "p2t_gl_ops": [_vp, _vp, _vp, _vp, _i64, _vp],
    "p2t_lde_from_values": [_vp, _vp, _vp, _vp, _vp, _vp, _i64, _int, _int,
                            ctypes.c_uint64, _int, _vp],
    "p2t_lde_tiled_rev": [_vp] * 11 + [_i64, _int, _int, _int, _vp],
    "p2t_lde_tiled_geometry": [_int, _vp],
    "p2t_lde_geometry": [_int, _vp],
}


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")) +
                  glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME") and
                 os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH and "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def library_path() -> str:
    h = hashlib.sha256()
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libp2t_kernels-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels unless the library for these sources exists."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    objs, procs = [], []
    for src in (p for p in _sources() if p.endswith(".cu")):
        obj = f"{tmp}.{os.path.basename(src)}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
    log = _wait(procs)
    cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
    log += _wait([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True))])
    for obj in objs:
        os.remove(obj)
    with open(log_path(), "w") as f:
        f.write(log)
    os.replace(tmp, out)
    return out


def log_path() -> str:
    """nvcc's output for the library of these sources."""
    return library_path()[:-len(".so")] + ".log"


def _wait(procs: list) -> str:
    """Wait for every nvcc process; raise with the output of those that
    failed, else return all their output."""
    results = [(cmd, proc.communicate()[0], proc.returncode) for cmd, proc in procs]
    failed = [f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{output}"
              for cmd, output, rc in results if rc != 0]
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(output for _, output, _ in results)


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what} failed with CUDA error {err}")


if __name__ == "__main__":
    print(build())
