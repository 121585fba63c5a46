"""fri_ms (ms): the span "FRI (composite + commit phases + queries)", a
traced proof's mean."""
from portbench.metrics._spans import FRI, mean_ms


def read(run):
    return mean_ms(run, (FRI,))
