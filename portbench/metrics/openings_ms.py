"""openings_ms (ms): the span "openings at zeta", a traced proof's mean."""
from portbench.metrics._spans import OPENINGS, mean_ms


def read(run):
    return mean_ms(run, (OPENINGS,))
