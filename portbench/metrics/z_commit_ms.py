"""z_commit_ms (ms): the span "permutation Z polys + commit", a traced
proof's mean."""
from portbench.metrics._spans import Z_COMMIT, mean_ms


def read(run):
    return mean_ms(run, (Z_COMMIT,))
