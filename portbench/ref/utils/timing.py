"""TimingTree-style phase spans.

Counterpart of `plonky2_tpu/utils/timing.py`.  A process-global stack of
nested spans; the prover opens one per phase.  torch launches CUDA work
asynchronously, so while profiling is on a span synchronizes every card
before it reads the clock and the device work a
phase issued lands in that phase.  With profiling off a span costs nothing
and forces no synchronisation.

Spans are recorded in `last_tree()` as well as logged, so a caller (the
chip smoke run) can print the per-phase split of the last prove.
`TimingTree` is the explicit-handle form: a root that the caller holds.
"""

from __future__ import annotations

import contextlib
import logging
import time

logger = logging.getLogger("plonky2_tpu_torch")

_ENABLED = False
_STACK: list["_Span"] = []
_LAST: list["_Span"] = []


def sync_cards():
    """Wait for every card: a mesh's shards may lie on several."""
    import torch
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


class _Span:
    __slots__ = ("name", "start", "elapsed", "children", "bytes")

    def __init__(self, name: str, nbytes: int | None = None):
        self.name = name
        self.start = time.perf_counter()
        self.elapsed = 0.0
        self.children: list[_Span] = []
        self.bytes = nbytes

    def _bw(self):
        if self.bytes and self.elapsed:
            return (f" [{self.bytes / 1e9:.2f} GB, "
                    f"{self.bytes / self.elapsed / 1e9:.0f} GB/s]")
        return ""

    def lines(self, depth=0, total=None):
        total = total if total is not None else self.elapsed
        pct = 100.0 * self.elapsed / total if total else 0.0
        out = [f"{'  ' * depth}{self.elapsed * 1e3:9.2f}ms {pct:5.1f}% "
               f"{self.name}{self._bw()}"]
        for c in self.children:
            out.extend(c.lines(depth + 1, total))
        return out


def profiling_enable(level=logging.DEBUG):
    """Turn on phase spans (and their synchronisation) and their log output."""
    global _ENABLED
    _ENABLED = True
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("[timing] %(message)s"))
        logger.addHandler(h)
        logger.propagate = False
    logger.setLevel(level)


def profiling_disable():
    global _ENABLED
    _ENABLED = False


def last_tree():
    """The most recent completed root span, or None."""
    return _LAST[-1] if _LAST else None


@contextlib.contextmanager
def timed_span(name: str, nbytes: int | None = None):
    """Nested phase span.  `nbytes`: estimated device bytes moved by the
    phase; the span prints the achieved GB/s next to its wall time."""
    if not _ENABLED:
        yield
        return
    sync_cards()
    span = _Span(name, nbytes)
    parent = _STACK[-1] if _STACK else None
    _STACK.append(span)
    try:
        yield
    finally:
        sync_cards()
        span.elapsed = time.perf_counter() - span.start
        _STACK.pop()
        if parent is not None:
            parent.children.append(span)
            logger.debug("%s.. %s: %.3fs%s", "  " * (len(_STACK) - 1),
                         span.name, span.elapsed, span._bw())
        else:
            _LAST[:] = [span]
            for line in span.lines():
                logger.debug(line)


class TimingTree:
    """Explicit-handle variant for callers that want the tree object
    (`with TimingTree("prove") as t: ... ; t.print()`): the spans opened
    inside the block, while profiling is on, become the root's children."""

    def __init__(self, name: str):
        self.root = _Span(name)

    def __enter__(self):
        _STACK.append(self.root)
        return self

    def __exit__(self, *exc):
        if _ENABLED:
            sync_cards()
        self.root.elapsed = time.perf_counter() - self.root.start
        _STACK.pop()
        return False

    @contextlib.contextmanager
    def span(self, name: str):
        with timed_span(name):
            yield

    def print(self, emit=print):
        for line in self.root.lines():
            emit(line)
