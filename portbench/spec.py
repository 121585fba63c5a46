"""`BENCHMARK.json` and the files it names, found by name.

A configuration is the directory of its `file` (`configs/<name>/`:
`config.json`, `program.py`, `reference.py`, `inputs.py`); a traffic mix is
`traffic/<name>.json`; a metric, end to end or per layer, is
`metrics/<name>.py` with a `read(run)` that returns its value or None.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def by_name(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


class Config:
    """One configuration's directory."""

    def __init__(self, entry: dict):
        self.name = entry["name"]
        self.dir = ROOT / Path(entry["file"]).parent
        self.data = json.loads((ROOT / entry["file"]).read_text())
        self.circuit = dict(self.data["circuit"])
        self.sizes = dict(self.data["sizes"])

    def module(self, role: str):
        """`program`, `reference` or `inputs` of this configuration."""
        return load_module(self.dir / f"{role}.py",
                           f"portbench_config_{self.name.replace('-', '_')}_{role}")

    def files(self) -> list[Path]:
        return sorted(p for p in self.dir.iterdir() if p.is_file())


def traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def reader(metric: str):
    return load_module(HERE / "metrics" / f"{metric}.py", f"portbench_metric_{metric}")


def cell(spec: dict, workload: str):
    """(workload entry, Config, traffic dict)."""
    w = by_name(spec["workloads"], workload, "workload")
    return w, Config(by_name(spec["configs"], w["config"], "configuration")), \
        traffic(w["traffic"])


def metrics_for(spec: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of `workload` reports: with trace off the end-to-end
    ones that apply to it, with trace on the per-layer ones that list it or,
    without a `workloads` key, whose `moves` metric it reports."""
    def applies(m):
        return workload in m.get("workloads", [workload])
    e2e = [m for m in spec["end_to_end"] if applies(m)]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in reported)]
