"""What a traced run reads from the program: its spans and the profiler's
device operations.

Spans come from `plonky2_tpu_torch.utils.timing` (`profiling_enable`,
`last_tree`): each synchronises the card before it reads the clock, so a
span's wall holds the device work its phase issued.  They are turned into
plain dicts here, one tree a proof.  The device's busy time is the union
of the profiler's device intervals (`roofline.busy_us`), over a stretch in
which the spans are off, since their synchronisations add idle time of
their own.
"""

from __future__ import annotations

import logging
import time
from bisect import bisect_left
from collections import defaultdict

from .roofline import busy_us

TOP = 10
NAME = 160                    # characters of an operation's name kept


def span_dict(span) -> dict:
    return {"name": span.name, "s": span.elapsed,
            "children": [span_dict(c) for c in span.children]}


class Spans:
    """The program's phase spans, on for the life of the object."""

    def __init__(self):
        from plonky2_tpu_torch.utils import timing
        self.timing = timing
        timing.profiling_enable(logging.WARNING)    # record, print nothing

    def last(self) -> dict:
        return span_dict(self.timing.last_tree())

    def close(self):
        self.timing.profiling_disable()


class DeviceProfile:
    """`torch.profiler` over a stretch of proofs (CPU and CUDA activities);
    `result()` -> busy_s, window_s and the breakdown."""

    def __init__(self):
        import torch
        self.torch = torch
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)

    def __enter__(self):
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        return False

    def result(self) -> dict:
        """Read from the profiler's raw events (its per-event Python objects
        would take minutes to build for a stretch of proofs)."""
        kinds = self.torch.autograd.DeviceType
        dev, host = [], []
        for e in self.prof.profiler.kineto_results.events():
            kind = e.device_type()
            if kind == kinds.CUDA:
                dev.append((e.start_ns(), e.end_ns(), e.name()))
            elif kind == kinds.CPU:
                host.append((e.start_ns(), e.end_ns(), e.name()))
        dev.sort()
        by_name: dict = defaultdict(float)
        for s, e, name in dev:
            by_name[name[:NAME]] += (e - s) / 1e9
        return {"busy_s": busy_us((s, e) for s, e, _ in dev) / 1e9,
                "window_s": self.window_s,
                "device_ops": sorted(([n, t] for n, t in by_name.items()),
                                     key=lambda x: -x[1])[:TOP],
                "idle_gaps": idle_gaps(dev, host)}


def idle_gaps(dev: list, host: list) -> list:
    """The longest stretches with no device operation running (ns), each
    named by the top-level host operation that covers most of it, or,
    where none covers half (the host ran Python), by the last top-level
    host operation that starts in it; summed by that name -> [[name,
    seconds], ...]."""
    gaps, end = [], None
    for s, e, _ in dev:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    top = []                             # host operations not inside another
    for op in sorted(host):
        if not top or op[0] >= top[-1][1]:
            top.append(op)
    starts = [t[0] for t in top]
    by_name: dict = defaultdict(float)
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:1000]:
        j = bisect_left(starts, g1)
        best, cover, k = None, 0, j - 1
        while k >= 0 and top[k][1] > g0:
            c = min(top[k][1], g1) - max(top[k][0], g0)
            if c > cover:
                best, cover = top[k][2], c
            k -= 1
        if best is not None and cover * 2 >= g1 - g0:
            label = f"host in {best}"
        else:
            label = f"host Python, then {top[j - 1][2]}" if j and top[j - 1][0] > g0 \
                else "host Python"
        by_name[label[:NAME]] += (g1 - g0) / 1e9
    return sorted(([n, t] for n, t in by_name.items()), key=lambda x: -x[1])[:TOP]
