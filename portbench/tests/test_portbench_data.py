"""The harness is driven by data: a configuration, a traffic mix and a
metric are files found by the names in BENCHMARK.json.  A throwaway one of
each, added as new files and new entries to a copy of the benchmark, runs
without an edit to any file that is there."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

from portbench import spec

ROOT = Path(__file__).resolve().parents[2]


def test_files_are_found_by_name():
    s = spec.load_spec()
    for w in s["workloads"]:
        entry, config, mix = spec.cell(s, w["name"])
        assert config.dir.name == config.name == entry["config"]
        assert {p.name for p in config.files()} >= {"config.json", "program.py",
                                                    "reference.py", "inputs.py"}
        assert mix["loop"] == "closed"
        for m in spec.metrics_for(s, w["name"], False) + spec.metrics_for(s, w["name"], True):
            assert callable(spec.reader(m["name"]).read)
    names = [m["name"] for m in spec.metrics_for(s, "smt-x51.seq", True)]
    assert names[0] == "load_s" and "device_idle_pct" in names and "prove_s" not in names


def test_a_new_config_traffic_and_metric_need_only_new_files(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    (tmp_path / "plonky2_tpu_torch").symlink_to(ROOT / "plonky2_tpu_torch")
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*") if p.is_file()}

    pb = tmp_path / "portbench"
    shutil.copytree(pb / "configs" / "smt-process-d32-x51", pb / "configs" / "smt-tiny")
    cfg = json.loads((pb / "configs" / "smt-tiny" / "config.json").read_text())
    cfg.update(name="smt-tiny", input_pool=3,
               circuit={"builder": "smt_process", "degree_bits": 7, "n_levels": 4,
                        "circuit_config": "test_config"},
               sizes={"degree_bits": 7, "n_levels": 4, "input_values": 86})
    (pb / "configs" / "smt-tiny" / "config.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "seq-again.json").write_text(
        (pb / "traffic" / "seq.json").read_text())
    (pb / "metrics" / "proofs_done.py").write_text(
        "def read(run):\n    return run.proofs if not run.trace else None\n")

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "smt-tiny", "source": "a test", "reduced": [],
                             "file": "portbench/configs/smt-tiny/config.json", "why": "a test"})
    bench["workloads"].append({"name": "smt-tiny.again", "config": "smt-tiny",
                               "traffic": "seq-again", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "proofs_done", "unit": "proofs", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["smt-tiny.again"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    code = ("import json, torch\n"
            "torch.set_num_threads(2)\n"
            "from portbench import run\n"
            "r = run.run_cell('smt-tiny.again', 77, 0.05, False, device='cpu')\n"
            "print(json.dumps(r))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=600, check=True).stdout
    r = json.loads(out.strip().splitlines()[-1])
    assert r["correct"]
    assert set(r["metrics"]) == {"prove_s", "setup_s", "proofs_done"}
    assert r["metrics"]["proofs_done"] == {"value": 1, "unit": "proofs"}
    after = {p: p.read_bytes() for p in before}
    assert after == before                 # no file that was there changed
