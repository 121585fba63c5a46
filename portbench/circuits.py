"""A configuration's circuit on one side of the comparison, cached in the
checkout.

The program side is `plonky2_tpu_torch`, the reference side the frozen
plain copy `portbench.ref`; both have the same API (`serialization`,
`ir.builder.Wire`, `CircuitData.prove`).  A side's circuit is built once
per checkout, in a child process (`python3 -m portbench.circuits`), and
saved under `portbench/cache/`: its prover-data bytes and its input
targets in order.  The key is the configuration, its circuit parameters
and a hash of the side's source files, so an edit to either rebuilds.
Later runs load the bytes (`deserialize_prover_data`, which recomputes the
constants/sigmas commit on the device asked for).
"""

from __future__ import annotations

import argparse
import hashlib
import importlib
import json
import os
import subprocess
import sys
import time

from .spec import HERE, ROOT, Config, by_name, load_spec

CACHE = HERE / "cache"

SIDES = {
    "program": ("plonky2_tpu_torch", ROOT / "plonky2_tpu_torch"),
    "reference": ("portbench.ref", HERE / "ref"),
}


class Side:
    def __init__(self, side: str):
        self.side = side
        self.package, self.src = SIDES[side]

    def mod(self, name: str):
        return importlib.import_module(f"{self.package}.{name}")

    def source_hash(self, config: Config, circuit: dict) -> str:
        h = hashlib.sha256(json.dumps(circuit, sort_keys=True).encode())
        files = [p for p in sorted(self.src.rglob("*"))
                 if p.is_file() and p.suffix in (".py", ".cu", ".cuh", ".cpp")
                 and "build" not in p.relative_to(self.src).parts]
        for p in files + config.files():
            h.update(str(p.relative_to(ROOT)).encode())
            h.update(p.read_bytes())
        return h.hexdigest()[:16]

    def paths(self, config: Config, circuit: dict):
        stem = CACHE / f"{self.side}-{config.name}-{self.source_hash(config, circuit)}"
        return stem.with_suffix(".prover"), stem.with_suffix(".targets.json")

    def target_json(self, t):
        Wire = self.mod("ir.builder").Wire
        return [t.row, t.column] if isinstance(t, Wire) else int(t)

    def target_of(self, j):
        Wire = self.mod("ir.builder").Wire
        return Wire(j[0], j[1]) if isinstance(j, list) else j

    def build_and_save(self, config: Config, circuit: dict, device: str) -> None:
        builder, targets = config.module(self.side).build(circuit)
        data = builder.build(device=device)
        blob = self.mod("serialization").serialize_prover_data(data.prover)
        blob_path, targets_path = self.paths(config, circuit)
        CACHE.mkdir(parents=True, exist_ok=True)
        for path, payload in ((targets_path, json.dumps([self.target_json(t) for t in targets])
                               .encode()), (blob_path, blob)):
            tmp = path.with_name(path.name + ".partial")
            tmp.write_bytes(payload)
            os.replace(tmp, path)

    def ensure_built(self, config: Config, circuit: dict, device: str) -> float | None:
        """Build and save the circuit in a child process unless the cache
        has it -> the child's seconds, or None on a hit."""
        blob_path, targets_path = self.paths(config, circuit)
        if blob_path.exists() and targets_path.exists():
            return None
        t0 = time.perf_counter()
        cmd = [sys.executable, "-m", "portbench.circuits", "--side", self.side,
               "--config", config.name, "--device", device,
               "--circuit", json.dumps(circuit, sort_keys=True)]
        subprocess.run(cmd, cwd=ROOT, check=True)
        if not blob_path.exists():
            raise RuntimeError(f"{' '.join(cmd)} saved no circuit")
        return time.perf_counter() - t0

    def load(self, config: Config, circuit: dict, device: str):
        """-> (CircuitData on `device`, input targets in order)."""
        blob_path, targets_path = self.paths(config, circuit)
        data = self.mod("serialization").deserialize_prover_data(blob_path.read_bytes(), device)
        targets = [self.target_of(j) for j in json.loads(targets_path.read_text())]
        return data, targets

    def serialize(self, proof) -> bytes:
        return self.mod("serialization").serialize_proof(proof)


def main() -> int:
    p = argparse.ArgumentParser(description="Build a configuration's circuit on one "
                                "side and save it under portbench/cache/.")
    p.add_argument("--side", choices=sorted(SIDES), required=True)
    p.add_argument("--config", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--circuit", required=True, help="the circuit parameters, JSON")
    a = p.parse_args()
    config = Config(by_name(load_spec()["configs"], a.config, "configuration"))
    Side(a.side).build_and_save(config, json.loads(a.circuit), a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
