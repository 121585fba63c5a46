"""unspanned_ms (ms): the prove's root span less the named phase spans
(the three witness spans, the wire commit, Z, quotient, openings and FRI),
a traced proof's mean: the domain tables and challenges in no span.  A span
added inside the root later leaves it unchanged."""
from portbench.metrics._spans import NAMED


def read(run):
    vals = [1e3 * (r["s"] - sum(c["s"] for c in r["children"] if c["name"] in NAMED))
            for r in run.spans]
    return sum(vals) / len(vals) if vals else None
