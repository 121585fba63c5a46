"""wire_commit_ms (ms): the span "wire LDE + Merkle commit" (the wire
matrix to the card, its LDE and its Merkle tree), a traced proof's mean."""
from portbench.metrics._spans import WIRE_COMMIT, mean_ms


def read(run):
    return mean_ms(run, (WIRE_COMMIT,))
