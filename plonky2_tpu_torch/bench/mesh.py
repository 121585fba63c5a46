"""Prove a configuration on a mesh of every card, and on as many shards of
one card, against its unsharded proof.

Builds config 1 (`build_poseidon_chain(12)`), config 3
(`build_smt_process(14)`) or `mixed_small` on the first card, proves it
unsharded twice (the second warm), then twice on `make_prover_mesh()` (every
card of the machine: d cards) and twice on d shards of the first card.
Every proof must be the unsharded proof's bytes, and the port's verifier
must accept it.  Prints each card's name and power limit, each prove's
wall (host clock, the cards synchronized), the synchronized phase spans of
each warm prove, and the K1, K2 and K3 launches of each mesh prove.  With
one card both meshes have one shard.

    python -m plonky2_tpu_torch.bench.mesh --config 1 3
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch

FIRST_CARD = torch.device("cuda", 0)


def main() -> int:
    from .. import utils
    from ..parallel import Mesh, make_prover_mesh
    from ..serialization import serialize_proof
    from . import (build_mixed_small, build_poseidon_chain, build_smt_process,
                   kernel_launches)
    builds = {"1": lambda: build_poseidon_chain(12), "3": lambda: build_smt_process(14),
              "mixed_small": build_mixed_small}
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", nargs="+", choices=tuple(builds), default=["3"])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: the mesh run needs a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=index,name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    cards = smi.stdout.strip()
    print(cards)
    card = f"{torch.cuda.device_count()} x " + cards.splitlines()[0].split(", ", 1)[1]
    meshes = (("every card", make_prover_mesh()),)
    d = meshes[0][1].size
    meshes += ((f"{d} shards of {FIRST_CARD}", Mesh((FIRST_CARD,) * d)),)

    for config in args.config:
        b, inputs, meta = builds[config]()
        data = b.build(device=FIRST_CARD)
        raw = None
        for label, mesh in (("unsharded", None),) + meshes:
            for kind in ("first", "warm"):
                before = kernel_launches()
                utils.profiling_enable()
                t0 = time.perf_counter()
                proof = data.prove(inputs, mesh=mesh)
                utils.timing.sync_cards()
                wall = time.perf_counter() - t0
                utils.profiling_disable()
                got = serialize_proof(proof)
                if raw is None:
                    raw = got
                elif got != raw:
                    raise AssertionError(f"config {config}: the proof on {label} differs "
                                         f"from the unsharded proof")
                data.verify(proof)
                launches = {k: v - before[k] for k, v in kernel_launches().items()}
                print(f"config {config} ({meta['name']}, 2^{data.common.degree_bits} "
                      f"rows), {label}, {kind} prove: {wall:.3f} s; {len(raw)} bytes, "
                      f"the unsharded proof's, verified; launches "
                      + ", ".join(f"{k} {v}" for k, v in launches.items()) + f" ({card})")
                if kind == "warm":
                    for line in utils.last_tree().lines():
                        print("  " + line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
