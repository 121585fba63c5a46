"""prove_s (s): the time a proof: the window's wall, from its start to the
end of the last proof started in it, over the proofs completed.  A proof
ends with its serialize_proof bytes on the host.  Host clock, spans off."""


def read(run):
    return run.window_s / run.proofs if run.proofs and not run.trace else None
