"""Whether the window's proofs are right: the reference proves the same
inputs again and the bytes must be equal.

The reference is `portbench.ref`, the frozen plain copy of the prover, with
its own circuit, built by its own builder copy from the configuration
(`circuits.Side("reference")`) and its own constants/sigmas commit.  It
takes from the program only the proof bytes it judges.  A Plonky2 proof
here is deterministic, so equal bytes cover every layer a proof passes
through: the wire matrix (under the wires cap), the Z/partial-product and
quotient commitments, the constants/sigmas commitment (observed first by
the transcript, so every challenge follows from it), the openings at zeta
and FRI's commit-phase caps, final polynomial, proof-of-work witness and
query answers.  Where bytes differ, the parts that differ are named.
"""

from __future__ import annotations

import contextlib
import dataclasses
import random

from .circuits import Side

# Each number compared, with its limit: the most (max) or the least (min) it may read.
LIMITS = {"proofs_differing": ("max", 0), "proofs_checked": ("min", 1)}

PARTS = ("public_inputs", "wires_cap", "zs_pp_cap", "quotient_cap", "openings",
         "fri.commit_caps", "fri.final_poly", "fri.pow_witness", "fri.query_rounds")


def sample(seed: int, count: int, k: int) -> list[int]:
    """k of the window's `count` proofs, drawn from the seed."""
    return sorted(random.Random(f"check-{seed}").sample(range(count), min(k, count)))


def differing_parts(ref_side: Side, want: bytes, got: bytes) -> list[str]:
    de = ref_side.mod("serialization").deserialize_proof
    try:
        a, b = de(want), de(got)
    except (ValueError, EOFError, IndexError, KeyError) as e:
        return [f"unreadable proof ({type(e).__name__})"]
    out = []
    for part in PARTS:
        x, y = a, b
        for attr in part.split("."):
            x, y = getattr(x, attr), getattr(y, attr)
        if x != y:
            out.append(part)
    return out or ["bytes only"]


@contextlib.contextmanager
def fewer_queries(data):
    """The control's broken guarantee, while the block runs: one FRI query
    fewer than the configuration states (27 of 28), the step that would
    tempt a change that wants FRI cheaper."""
    common = data.prover.common
    cfg = common.config
    common.config = dataclasses.replace(
        cfg, fri=dataclasses.replace(cfg.fri, num_query_rounds=cfg.fri.num_query_rounds - 1))
    try:
        yield
    finally:
        common.config = cfg


def reference_circuit(config, circuit: dict, device: str):
    side = Side("reference")
    side.ensure_built(config, circuit, device)
    data, targets = side.load(config, circuit, device)
    return side, data, targets


def check(config, circuit: dict, samples: list, device: str) -> dict:
    """samples: [(input values, program proof bytes)] -> the numbers
    compared and, under `parts`, what differed."""
    side, data, targets = reference_circuit(config, circuit, device)
    differing, parts = 0, []
    for values, got in samples:
        want = side.serialize(data.prove(dict(zip(targets, values))))
        if want != got:
            differing += 1
            parts.append(differing_parts(side, want, got))
    return {"proofs_differing": differing, "proofs_checked": len(samples), "parts": parts}


def verdict(numbers: dict) -> bool:
    ok = True
    for name, (kind, limit) in LIMITS.items():
        v = numbers[name]
        ok &= v <= limit if kind == "max" else v >= limit
    return ok


def compared(numbers: dict) -> dict:
    return {name: {"value": numbers[name], "limit": limit, "kind": kind}
            for name, (kind, limit) in LIMITS.items()}
