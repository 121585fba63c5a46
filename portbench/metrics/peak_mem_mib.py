"""peak_mem_mib (MiB): torch.cuda.max_memory_allocated() over the whole
process up to the window's close: what a card must hold to serve this
circuit.  Read before the reference runs."""


def read(run):
    return run.peak_bytes / 2**20 if run.peak_bytes else None
