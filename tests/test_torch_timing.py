"""`plonky2_tpu_torch.utils.TimingTree` against the JAX package's
`plonky2_tpu.utils.timing.TimingTree`: the same spans, opened in the same
seeded order under each, give trees of the same names and nesting, and
print the same lines once their times are set equal."""

from __future__ import annotations

import random

import pytest

from plonky2_tpu.utils import timing as jtiming
from plonky2_tpu_torch import utils
from plonky2_tpu_torch.utils import timing


def _shape(span, depth=0):
    out = [(depth, span.name, span.bytes)]
    for c in span.children:
        out.extend(_shape(c, depth + 1))
    return out


def _spans(span):
    out = [span]
    for c in span.children:
        out.extend(_spans(c))
    return out


def _printed(tree, seed):
    """The tree's printed lines once every span's time is set from `seed`
    (so two trees of the same shape print the same times)."""
    rng = random.Random(seed)
    for i, span in enumerate(_spans(tree.root)):
        span.elapsed = rng.uniform(0.0, 2.0) / (i + 1)
    lines = []
    tree.print(lines.append)
    return lines


def _drive(module, spans, enabled: bool):
    """Open `spans` ([(depth, name)], depth 1 the root's children) inside a
    TimingTree of `module` and return the tree and its printed lines."""
    if enabled:
        module.profiling_enable()
    try:
        with module.TimingTree("prove") as tree:
            stack = []
            for depth, name in spans:
                while len(stack) >= depth:
                    stack.pop().__exit__(None, None, None)
                cm = tree.span(name) if depth == 1 else module.timed_span(name)
                cm.__enter__()
                stack.append(cm)
            while stack:
                stack.pop().__exit__(None, None, None)
    finally:
        module.profiling_disable()
    lines = []
    tree.print(lines.append)
    return tree, lines


def _random_spans(rng, n=12):
    spans, depth = [], 0
    for i in range(n):
        depth = rng.randint(1, min(depth + 1, 3))
        spans.append((depth, f"phase {i} at depth {depth}"))
    return spans


@pytest.mark.parametrize("seed", [0x71, 0x72, 0x73])
def test_timing_tree_equals_jax(seed):
    spans = _random_spans(random.Random(seed))
    tree, lines = _drive(timing, spans, enabled=True)
    jtree, jlines = _drive(jtiming, spans, enabled=True)
    assert _shape(tree.root) == _shape(jtree.root)
    assert [d for d, _, _ in _shape(tree.root)[1:]] == [d for d, _ in spans]
    assert len(lines) == len(jlines) == len(spans) + 1
    assert all(line.endswith(name) for line, (_, name) in zip(lines[1:], spans))
    assert tree.root.elapsed >= sum(c.elapsed for c in tree.root.children)
    assert _printed(tree, seed) == _printed(jtree, seed)
    # the global stack is left as it was found
    assert timing._STACK == [] and jtiming._STACK == []


def test_timing_tree_without_profiling_equals_jax():
    """With profiling off a span records nothing: the root alone."""
    spans = _random_spans(random.Random(0x74), 5)
    tree, lines = _drive(timing, spans, enabled=False)
    jtree, jlines = _drive(jtiming, spans, enabled=False)
    assert tree.root.children == [] and jtree.root.children == []
    assert len(lines) == len(jlines) == 1
    assert _printed(tree, 0x74) == _printed(jtree, 0x74)
    assert utils.TimingTree is timing.TimingTree
