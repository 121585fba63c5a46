"""witness_ms (ms): the spans "witness generation", "witness scatter to wire
matrix" and "witness aux fill (batched)", summed, a traced proof's mean."""
from portbench.metrics._spans import WITNESS, mean_ms


def read(run):
    return mean_ms(run, WITNESS)
