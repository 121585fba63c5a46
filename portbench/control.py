"""The readings that `judge.LIMITS` were set from, on the card, in one
process (the benchmark's own runs do not run this).

    python3 portbench/control.py --workload <cell> --program-seeds <n ...> --control-seeds <n ...>

For each seed it draws the run's input pool and the statement the run's
check would draw, then prints one reading of `proofs_differing` a line:

* `program`: the program's proof of that statement against the
  reference's (a sound run: the lower reading);
* `control`: the reference put in the program's place with one of the
  configuration's guarantees broken (`judge.fewer_queries`: 27 FRI
  queries of 28), against the reference (the upper reading), with the
  parts of the proof that differ.

A last JSON line gathers the readings.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path[0] = str(Path(__file__).resolve().parent.parent)

from portbench import judge, spec as specs  # noqa: E402
from portbench.circuits import Side  # noqa: E402
from portbench.run import cache_env, log  # noqa: E402


def statement(config, sizes: dict, seed: int) -> list:
    """The inputs a run of `seed` draws, at the index its check draws."""
    rng = random.Random(seed)
    maker = config.module("inputs")
    pool = [maker.make(rng, sizes) for _ in range(config.data["input_pool"])]
    return pool[judge.sample(seed, len(pool), 1)[0]]


def readings(workload: str, program_seeds: list, control_seeds: list, device: str = "cuda",
             circuit: dict | None = None, sizes: dict | None = None) -> dict:
    _, config, _ = specs.cell(specs.load_spec(), workload)
    circuit = circuit or config.circuit
    sizes = sizes or config.sizes
    ref, ref_data, ref_targets = judge.reference_circuit(config, circuit, device)

    def reference(values):
        return ref.serialize(ref_data.prove(dict(zip(ref_targets, values))))

    out = {"program": [], "control": []}
    if program_seeds:
        program = Side("program")
        program.ensure_built(config, circuit, device)
        data, targets = program.load(config, circuit, device)
        for seed in program_seeds:
            values = statement(config, sizes, seed)
            t0 = time.perf_counter()
            got = program.serialize(data.prove(dict(zip(targets, values))))
            want = reference(values)
            reading = int(got != want)
            out["program"].append([seed, reading])
            log(f"program seed {seed}: proofs_differing {reading} "
                f"({time.perf_counter() - t0:.3f} s)")
    for seed in control_seeds:
        values = statement(config, sizes, seed)
        t0 = time.perf_counter()
        with judge.fewer_queries(ref_data):
            got = reference(values)
        want = reference(values)
        parts = judge.differing_parts(ref, want, got) if got != want else []
        out["control"].append([seed, int(got != want), parts])
        log(f"control seed {seed}: proofs_differing {int(got != want)} {parts} "
            f"({time.perf_counter() - t0:.3f} s)")
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--program-seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    a = p.parse_args()
    cache_env()
    import torch
    if not torch.cuda.is_available():
        log("the control runs on the card; torch sees no CUDA device")
        return 3
    out = readings(a.workload, a.program_seeds, a.control_seeds)
    print(json.dumps({"workload": a.workload, "device": torch.cuda.get_device_name(0), **out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
