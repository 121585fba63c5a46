"""One short run of each cell on the card, through the benchmark's
command; skips without a card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import spec

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in spec.load_spec()["workloads"]])
def test_a_short_run_is_correct(card, workload):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", workload,
                          "--seed", str(2**32 + 9), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=1200, check=True)
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["failed"] == 0
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    assert {"setup_s", "prove_s", "peak_mem_mib"} <= set(r["metrics"])
    assert list(r)[-1] == "compared"
