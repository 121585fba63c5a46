"""load_s (s): deserialize_prover_data of the cached circuit onto the card,
with its constants/sigmas commit, in set-up.  Host clock."""


def read(run):
    return run.load_s
