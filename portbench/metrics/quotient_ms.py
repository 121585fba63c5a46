"""quotient_ms (ms): the span "quotient evaluation + commit", a traced
proof's mean."""
from portbench.metrics._spans import QUOTIENT, mean_ms


def read(run):
    return mean_ms(run, (QUOTIENT,))
