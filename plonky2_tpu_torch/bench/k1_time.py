"""Time kernel K1 of a checkout on the card, with chip_smoke.py's timer.

    python -m plonky2_tpu_torch.bench.k1_time [--checkout DIR]

Imports `plonky2_tpu_torch` from DIR (default: this checkout) and times its
`permute_cols_cuda` on both MDS layers at [12, 2^15], [12, 2^17] and
[12, 2^20], each result first held bit-equal to this checkout's plain
permutation.  Run it once per checkout, in turns (parent, change, change,
parent), to compare two versions of the kernel on one card in one call.
Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--checkout", default=ROOT)
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    from chip_smoke import rand_field, require_equal, time_ms
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: K1 is timed on the card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    # The checkout's kernels; this checkout's plain permutation and field.
    from plonky2_tpu_torch.field import gl
    from plonky2_tpu_torch.hashes import poseidon
    for name in [m for m in sys.modules if m.startswith("plonky2_tpu_torch")]:
        del sys.modules[name]
    sys.path.insert(0, os.path.abspath(args.checkout))
    cuda_poseidon = importlib.import_module("plonky2_tpu_torch.hashes.cuda_poseidon")
    device = torch.device("cuda", 0)
    rng = np.random.RandomState(4)
    out = {"checkout": os.path.abspath(args.checkout)}
    for b in (1 << 15, 1 << 17, 1 << 20):
        s = gl.to_tensor(rand_field(rng, (12, b)), device)
        want = poseidon.permute_cols_plain(s)
        for small in (True, False):
            require_equal(f"K1 [12, {b}] small_mds={small}",
                          cuda_poseidon.permute_cols_cuda(s, small_mds=small), want)
            out[f"{'small' if small else 'generic'} 2^{b.bit_length() - 1} ms"] = time_ms(
                lambda: cuda_poseidon.permute_cols_cuda(s, small_mds=small))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
