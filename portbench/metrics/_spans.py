"""Shared by the span readers: the mean over a traced run's proofs of the
wall of the prove's top-level spans with the given names, in ms, or None
where no proof has such a span."""

# The prove's top-level phase spans (`plonky2_tpu_torch/prove/prover.py`).
WITNESS = ("witness generation", "witness scatter to wire matrix",
           "witness aux fill (batched)")
WIRE_COMMIT = "wire LDE + Merkle commit"
Z_COMMIT = "permutation Z polys + commit"
QUOTIENT = "quotient evaluation + commit"
OPENINGS = "openings at zeta"
FRI = "FRI (composite + commit phases + queries)"
NAMED = WITNESS + (WIRE_COMMIT, Z_COMMIT, QUOTIENT, OPENINGS, FRI)


def mean_ms(run, names) -> float | None:
    vals = []
    for root in run.spans:
        found = [c["s"] for c in root["children"] if c["name"] in names]
        if found:
            vals.append(sum(found))
    return 1e3 * sum(vals) / len(vals) if vals else None


def root_ms(run) -> list:
    return [1e3 * r["s"] for r in run.spans]
