"""setup_s (s): process start to the window's start, the input pool's
making left out: imports, the circuit's load from the checkout's cache
(built and saved first on the first run of a checkout), the first prove
(it builds the witness tape) and one warm prove.  Host clock."""


def read(run):
    return run.setup_s
