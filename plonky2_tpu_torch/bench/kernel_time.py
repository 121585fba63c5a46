"""Time kernel K1, K2 or K3 of a checkout on the card, with chip_smoke.py's timer.

    python -m plonky2_tpu_torch.bench.kernel_time --kernel {K1,K2,K3} [--checkout DIR]

Imports `plonky2_tpu_torch` from DIR (default: this checkout) and times one
of its kernels, each result first held bit-equal to this checkout's plain
version:

- K1: `permute_cols_cuda` on both MDS layers at [12, 2^15], [12, 2^17] and
  [12, 2^20];
- K2: `lde_from_values_rev_cuda` (K2-rev) and `lde_from_values_cuda`
  (K2-nat) at [135, 2^12] and [135, 2^13], rate 3, against
  `ntt.lde_from_values_rev` and `ntt.lde_from_values`, and K2-rev at
  [132, 2^12]: one inverse block an SM of an H100, so that beside [135,
  2^12] it shows what the inverse launch's three extra blocks cost;
- K3: `lde_from_values_tiled_rev_cuda` at [135, 2^14], [135, 2^16] and
  [2, 2^20], rate 3, against `ntt.lde_from_values_rev`, and the MB of the
  twiddle tables the checkout keeps on the card for that (n, rate).

For K2 and K3 it also gives the device time of each `__global__` of one
call (K2's inverse and forward launches, K3's passes), from a
`torch.profiler` kernel table over 20 calls.

Run it once per checkout, in turns (parent, change, change, parent), to
compare two versions of a kernel on one card in one call.  Prints the
card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

K2_SHAPES = ((135, 1 << 12), (135, 1 << 13))
K3_SHAPES = ((135, 1 << 14), (135, 1 << 16), (2, 1 << 20))
LDE_RATE = 3
PROFILED_CALLS = 20


def _checkout_module(checkout: str, name: str):
    """Module `name` of the package in `checkout`, after dropping every
    `plonky2_tpu_torch` module imported so far (the plain versions keep
    their references)."""
    for mod in [m for m in sys.modules if m.startswith("plonky2_tpu_torch")]:
        del sys.modules[mod]
    sys.path.insert(0, os.path.abspath(checkout))
    return importlib.import_module(name)


def per_kernel_ms(fn, calls: int = PROFILED_CALLS) -> dict:
    """{kernel name: device ms per fn()} over `calls` calls under
    torch.profiler, for the device operations that are not PyTorch's own
    (`at::native`: the allocations' fills and copies)."""
    import torch
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total: dict = defaultdict(float)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and "at::native" not in e.name:
            name = e.name.replace("(anonymous namespace)::", "").split("(")[0]
            total[name] += (e.time_range.end - e.time_range.start) / 1e3
    return {name: t / calls for name, t in sorted(total.items())}


def time_k1(checkout, device, out):
    import numpy as np
    from chip_smoke import rand_field, require_equal, time_ms
    from plonky2_tpu_torch.field import gl
    from plonky2_tpu_torch.hashes import poseidon
    cuda_poseidon = _checkout_module(checkout, "plonky2_tpu_torch.hashes.cuda_poseidon")
    rng = np.random.RandomState(4)
    for b in (1 << 15, 1 << 17, 1 << 20):
        s = gl.to_tensor(rand_field(rng, (12, b)), device)
        want = poseidon.permute_cols_plain(s)
        for small in (True, False):
            require_equal(f"K1 [12, {b}] small_mds={small}",
                          cuda_poseidon.permute_cols_cuda(s, small_mds=small), want)
            out[f"{'small' if small else 'generic'} 2^{b.bit_length() - 1} ms"] = time_ms(
                lambda: cuda_poseidon.permute_cols_cuda(s, small_mds=small))


def _time_lde(tag, kernel, plain, shapes, device, out, rng):
    """Hold an LDE kernel bit-equal to its plain version at each [rows, n]
    (rate LDE_RATE), then time it and split one call by `__global__`."""
    import torch
    from chip_smoke import rand_field, require_equal, time_ms
    from plonky2_tpu_torch.field import gl
    for rows, n in shapes:
        v = gl.to_tensor(rand_field(rng, (rows, n)), device)
        cg, lg = kernel(v, LDE_RATE)
        cw, lw = plain(v, LDE_RATE)
        require_equal(f"{tag} coeffs [{rows}, {n}]", cg, cw)
        require_equal(f"{tag} LDE [{rows}, {n}]", lg, lw)
        del cg, lg, cw, lw
        key = f"{tag}[{rows}, 2^{n.bit_length() - 1}] r{LDE_RATE}"
        out[f"{key} ms"] = time_ms(lambda: kernel(v, LDE_RATE))
        out[f"{key} per kernel ms"] = per_kernel_ms(lambda: kernel(v, LDE_RATE))
        del v
        torch.cuda.empty_cache()


def time_k2(checkout, device, out):
    import numpy as np
    from plonky2_tpu_torch import ntt
    cuda_lde = _checkout_module(checkout, "plonky2_tpu_torch.ntt.cuda_lde")
    rng = np.random.RandomState(6)
    _time_lde("K2-rev ", cuda_lde.lde_from_values_rev_cuda, ntt.lde_from_values_rev,
              ((132, 1 << 12),) + K2_SHAPES, device, out, rng)
    _time_lde("K2-nat ", cuda_lde.lde_from_values_cuda, ntt.lde_from_values, K2_SHAPES,
              device, out, rng)


def time_k3(checkout, device, out):
    import numpy as np
    from plonky2_tpu_torch import ntt
    from plonky2_tpu_torch.field import gl
    cuda_lde_tiled = _checkout_module(checkout, "plonky2_tpu_torch.ntt.cuda_lde_tiled")
    _time_lde("", cuda_lde_tiled.lde_from_values_tiled_rev_cuda, ntt.lde_from_values_rev,
              K3_SHAPES, device, out, np.random.RandomState(5))
    for rows, n in K3_SHAPES:
        tables = cuda_lde_tiled._tables(n.bit_length() - 1, LDE_RATE, ntt.COSET_SHIFT % gl.P,
                                        device)
        out[f"[{rows}, 2^{n.bit_length() - 1}] r{LDE_RATE} tables MB"] = sum(
            t.numel() * t.element_size() for t in tables) / 1e6


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernel", choices=("K1", "K2", "K3"), required=True)
    parser.add_argument("--checkout", default=ROOT)
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke  # noqa: F401  (this checkout's timer and checks, whatever --checkout is)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit(f"CUDA is not available: {args.kernel} is timed on the card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    out = {"kernel": args.kernel, "checkout": os.path.abspath(args.checkout)}
    device = torch.device("cuda", 0)
    {"K1": time_k1, "K2": time_k2, "K3": time_k3}[args.kernel](args.checkout, device, out)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
