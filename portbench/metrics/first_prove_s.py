"""first_prove_s (s): the first prove after the load, which builds the
witness tape.  Host clock."""


def read(run):
    return run.first_prove_s
