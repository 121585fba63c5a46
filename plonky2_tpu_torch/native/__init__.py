"""Native (C++) witness kernels, built with g++ at first use.

Counterpart of `plonky2_tpu/native/__init__.py`, with the port's build
rules: `witness_kernels.cpp` is compiled by `g++ -O3 -march=native -shared
-fPIC` into `plonky2_tpu_torch/build/` (git-ignored) under a name that
carries a hash of the source, the flags and the host's CPU (model name
and feature flags), so a build directory carried to another machine is
never loaded there; each process compiles into a file of its own and
renames it into place, so processes that build at the same moment do not
collide.  `ctypes` loads the library.  A failed build raises with g++'s
output: nothing falls back.

    python -m plonky2_tpu_torch.native     # build now, print the library path
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from .._build import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "witness_kernels.cpp")
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None

_u64p = ctypes.POINTER(ctypes.c_uint64)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_SIGNATURES = {
    "poseidon_rows": ([_u64p, _u64p, _u64p, ctypes.c_long, _u64p, _u64p,
                       ctypes.c_int, ctypes.c_int], None),
    "gl_mul_arr": ([_u64p, _u64p, _u64p, ctypes.c_long], None),
    "tape_run": ([_u64p, _u8p, _i32p, _i64p, _u64p, _i32p, _i32p, _i32p, _i32p,
                  ctypes.c_long, ctypes.c_long, _u64p, _u64p, ctypes.c_int,
                  ctypes.c_int, _i64p], ctypes.c_long),
}


def _cpu_model() -> bytes:
    """The first processor's model name and feature flags (what
    -march=native compiles for)."""
    with open("/proc/cpuinfo", "rb") as f:
        lines = f.read().split(b"\n\n")[0].splitlines()
    return b"\n".join(l for l in lines if l.startswith((b"model name", b"flags")))


def library_path() -> str:
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(GXX_FLAGS).encode())
    h.update(_cpu_model())
    return os.path.join(BUILD_DIR, f"libp2t_witness-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile witness_kernels.cpp unless the library for this source, these
    flags and this CPU exists."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", *GXX_FLAGS, "-o", tmp, _SRC]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded witness library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = handle
    return _lib


def ptr(a: np.ndarray, ctype):
    """A ctypes pointer to a contiguous numpy array's data."""
    if not a.flags.c_contiguous:
        raise ValueError("native kernels take C-contiguous arrays")
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def poseidon_rows(inputs, swaps, rc, mds, n_full_half: int, n_partial: int) -> np.ndarray:
    """inputs [R, 12] u64, swaps [R] u64 -> out [R, 4+36+n_partial+48+12]
    (PoseidonGate aux/output wire values in wire order)."""
    inputs = np.ascontiguousarray(inputs, dtype=np.uint64)
    swaps = np.ascontiguousarray(swaps, dtype=np.uint64)
    rc = np.ascontiguousarray(rc, dtype=np.uint64)
    mds = np.ascontiguousarray(mds, dtype=np.uint64)
    R = inputs.shape[0]
    if inputs.shape != (R, 12) or swaps.shape != (R,) or mds.shape != (12, 12) or \
            rc.shape != (2 * n_full_half + n_partial, 12):
        raise ValueError(f"poseidon_rows: shapes {inputs.shape}, {swaps.shape}, "
                         f"{rc.shape}, {mds.shape}")
    width = 4 + 3 * 12 + n_partial + 4 * 12 + 12
    out = np.empty((R, width), dtype=np.uint64)
    lib().poseidon_rows(ptr(inputs, ctypes.c_uint64), ptr(swaps, ctypes.c_uint64),
                        ptr(out, ctypes.c_uint64), R, ptr(rc, ctypes.c_uint64),
                        ptr(mds, ctypes.c_uint64), n_full_half, n_partial)
    return out


if __name__ == "__main__":
    print(build())
