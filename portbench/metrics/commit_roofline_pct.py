"""commit_roofline_pct (%): the least time the chip could take for the wire
commit's work over wire_commit_ms.  The work is counted from the cell's
shapes (roofline.commit_bound_ms: the LDE of [wires, n] at the rate, then
Poseidon over the n * 2^rate leaves of `wires` elements and the tree's
internal nodes), against the card's peaks (peaks.json)."""
from portbench.metrics._spans import WIRE_COMMIT, mean_ms
from portbench.roofline import commit_bound_ms


def read(run):
    ms = mean_ms(run, (WIRE_COMMIT,))
    if not ms or run.peaks is None:
        return None
    s = run.shapes
    return 100.0 * commit_bound_ms(s["num_wires"], s["degree_bits"], s["rate_bits"],
                                   s["cap_height"], run.peaks) / ms
