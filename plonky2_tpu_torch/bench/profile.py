"""Device profile of one warm prove on the card, with `torch.profiler`.

Builds config 1 (`build_poseidon_chain(12)`), config 2 (`build_u32_mix(13)`),
config 3 (`build_smt_process(14)`), config 4 (`build_ecdsa(1)`) or config 5
(`build_aggregation(4)`: the four inner proofs, then the outer circuit,
which is the one profiled) on the card, proves once to warm up, then profiles one more prove (CPU and CUDA
activities) and prints: the prove's wall time, the number of device
operations, the device's busy time (the union of the device operations'
intervals) and its share of the wall, the same share once the host witness
generation (timed alone after the profile) is taken out, the device time of
the largest kernels by name, and that of every hand-written kernel (csrc/:
the kernels in an anonymous namespace outside PyTorch's `at::native`).  The
card's name and power limit come first.

    python -m plonky2_tpu_torch.bench.profile --config 3
"""

from __future__ import annotations

import argparse
import subprocess
import time
from collections import defaultdict

import torch


def _busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals, in us."""
    busy, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(intervals):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy += cur_end - cur_start
    return busy


def main() -> int:
    from ..prove.prover import witness_matrix
    from . import (build_aggregation, build_ecdsa, build_poseidon_chain,
                   build_smt_process, build_u32_mix)
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", type=int, choices=(1, 2, 3, 4, 5), default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: the profile needs a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])

    build = {1: lambda: build_poseidon_chain(12), 2: lambda: build_u32_mix(13),
             3: lambda: build_smt_process(14), 4: lambda: build_ecdsa(1)}
    if args.config == 5:
        make, meta = build_aggregation(4)
        agg, proofs = make()
        data, inputs = agg.data, agg.witness(proofs)
    else:
        b, inputs, meta = build[args.config]()
        data = b.build(device="cuda")
    data.prove(inputs)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        data.prove(inputs)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0

    device_ops = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = _busy_us((e.time_range.start, e.time_range.end) for e in device_ops) / 1e6
    by_name: dict = defaultdict(lambda: [0.0, 0])
    for e in device_ops:
        rec = by_name[e.name]
        rec[0] += (e.time_range.end - e.time_range.start) / 1e6
        rec[1] += 1
    total_s = sum(t for t, _ in by_name.values())
    t0 = time.perf_counter()
    witness_matrix(data.prover, inputs)
    witness_s = time.perf_counter() - t0
    print(f"config {args.config} ({meta['name']}, 2^{data.common.degree_bits} rows): "
          f"warm prove {wall_s:.4f} s under the profiler; {len(device_ops)} device "
          f"operations; device busy {busy_s:.4f} s = {100 * busy_s / wall_s:.2f}% of "
          f"the wall (idle {100 - 100 * busy_s / wall_s:.2f}%); summed device time "
          f"{total_s:.4f} s")
    print(f"host witness alone {witness_s:.4f} s; device busy "
          f"{100 * busy_s / (wall_s - witness_s):.2f}% of the wall without it")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for title, rows in (("largest 12 kernels:", ranked[:12]),
                        ("hand-written kernels:",
                         [kv for kv in ranked if "(anonymous namespace)::" in kv[0]
                          and "at::native" not in kv[0]])):
        print(title)
        for name, (t, count) in rows:
            print(f"  {1e3 * t:10.3f} ms {100 * t / total_s:5.1f}% {count:7d}x  {name[:100]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
