"""Batch-ECDSA perf driver: the counterpart of the JAX package's
`scripts/perf.py`, itself the analog of the reference's perf binary
(`src/bin/perf.rs:7-9` -> `src/ecdsa/gadgets/ecdsa.rs:215-378`).

Builds a batch-N secp256k1 ECDSA-verify circuit (`build_ecdsa(batch)`,
standard_ecc_config) and prints its gate count, builds it, round-trips the
verifier key through bytes, proves cold and then warm with phase spans
(`utils.profiling_enable()`: each span synchronizes the card), round-trips
the proof through bytes and verifies it with the round-tripped key.  On
the card it also prints the card's name and power limit, the K1, K2 and K3
launches of the build and of each prove, and the peak device memory.

    python -m plonky2_tpu_torch.bench.perf [batch] [--cpu]

The batch defaults to 2 (2^17 rows); the reference's default is 20 (2^20
rows).  It runs on the card unless `--cpu` is given.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch

from . import kernel_launches
from .circuits import build_ecdsa

STEPS = ("build", "prove", "prove (warm)")


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(builder, inputs: dict, device, emit=print) -> dict:
    """The driver's steps on a traced circuit (`builder`, `inputs`): build
    on `device`, the verifier-key round trip, a cold and a warm prove, the
    proof round trip, and the verify with the round-tripped key and proof;
    each step's line goes to `emit`.  Raises if a round trip or the verify
    fails.  -> {"num_gates", "degree_bits", "build_s", "prove_s" [cold,
    warm], "verify_s", "vd_bytes", "proofs" [cold, warm bytes], "vd" and
    "proof" (the round-tripped key and proof), "trees" and
    "launches" ({step: kernel launches}, each step counted alone), and
    "peak_bytes" ({"build", "proves"}: `torch.cuda.max_memory_allocated()`,
    None off the card)}."""
    from .. import utils
    from ..prove.verifier import verify
    from ..serialization import (deserialize_proof, deserialize_verifier_data,
                                 serialize_proof, serialize_verifier_data)
    dev = utils.resolve_device(device)
    on_card = dev.type == "cuda"
    out = {"num_gates": builder.num_gates(), "prove_s": [], "proofs": [], "trees": {},
           "launches": {}, "peak_bytes": {}}
    utils.profiling_enable()
    try:
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        before = kernel_launches()
        t0 = time.perf_counter()
        data = builder.build(device=dev)
        _sync(dev)
        out["build_s"] = time.perf_counter() - t0
        out["launches"]["build"] = {k: v - before[k] for k, v in kernel_launches().items()}
        out["trees"]["build"] = utils.last_tree()
        out["peak_bytes"]["build"] = torch.cuda.max_memory_allocated(dev) if on_card else None
        out["degree_bits"] = data.common.degree_bits
        emit(f"built: degree 2^{data.common.degree_bits} ({out['build_s']:.3f}s)")

        # the verifier key through bytes (ecdsa.rs:298-316)
        vd_bytes = serialize_verifier_data(data.verifier)
        vd = deserialize_verifier_data(vd_bytes)
        if vd.cs_cap != data.verifier.cs_cap:
            raise AssertionError("the round-tripped verifier key has another cs_cap")
        out["vd_bytes"] = vd_bytes
        emit(f"verifier key roundtrip: {len(vd_bytes)} bytes OK")

        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        for step in STEPS[1:]:
            before = kernel_launches()
            t0 = time.perf_counter()
            proof = data.prove(inputs)
            _sync(dev)
            wall = time.perf_counter() - t0
            out["launches"][step] = {k: v - before[k] for k, v in kernel_launches().items()}
            out["trees"][step] = utils.last_tree()
            out["prove_s"].append(wall)
            out["proofs"].append(serialize_proof(proof))
            emit(f"{step}: {wall:.3f}s")
        out["peak_bytes"]["proves"] = torch.cuda.max_memory_allocated(dev) if on_card else None
        del data

        p_bytes = out["proofs"][-1]
        proof2 = deserialize_proof(p_bytes)
        if serialize_proof(proof2) != p_bytes:
            raise AssertionError("the proof does not round-trip through bytes")
        emit(f"proof roundtrip: {len(p_bytes)} bytes OK")

        t0 = time.perf_counter()
        verify(vd, proof2)
        out["verify_s"] = time.perf_counter() - t0
        out["vd"], out["proof"] = vd, proof2
        emit(f"verify (roundtripped key + proof): {out['verify_s']:.3f}s")
    finally:
        utils.profiling_disable()
    return out


def _card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("batch", type=int, nargs="?", default=2,
                        help="signatures a circuit (the reference's default is 20)")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    args = parser.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    card = None if args.cpu else _card()
    if card:
        print(card, flush=True)

    t0 = time.perf_counter()
    b, inputs, _meta = build_ecdsa(args.batch)
    print(f"batch={args.batch} num_gates={b.num_gates()} "
          f"(trace {time.perf_counter() - t0:.3f}s)", flush=True)
    res = run(b, inputs, device, emit=lambda line: print(line, flush=True))
    if res["proofs"][0] != res["proofs"][1]:
        raise AssertionError("the cold and the warm prove gave other bytes")
    if card:
        for step in STEPS:
            print(f"{step} launches: " + ", ".join(
                f"{k} {v}" for k, v in res["launches"][step].items()) + f" ({card})")
        print(f"peak device memory: build {res['peak_bytes']['build'] / 2**20:.1f} MiB, "
              f"proves {res['peak_bytes']['proves'] / 2**20:.1f} MiB ({card})", flush=True)
    print("PERF DRIVER OK", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
