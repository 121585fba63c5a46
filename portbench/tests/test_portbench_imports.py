"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the port: module names are compared by their
top-level name, whole (`plonky2_tpu_torch` begins with `plonky2_tpu`)."""

import ast
import subprocess
import sys
from pathlib import Path

from portbench import run

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "plonky2_tpu_torch_x", sys)
    assert "plonky2_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "plonky2_tpu.field", sys)
    assert run.forbidden_modules() == ["plonky2_tpu"]


def test_no_source_under_portbench_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        bad = top_level_imports(path) & set(run.FORBIDDEN)
        assert not bad, f"{path} imports {bad}"


def test_reference_imports_nothing_of_the_port():
    for path in (HERE / "ref").rglob("*.py"):
        assert "plonky2_tpu_torch" not in top_level_imports(path), path


def test_a_reference_proof_loads_nothing_of_the_port_jax_or_the_jax_package():
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(2)\n"
        "from portbench.ref.circuits import build_smt_process\n"
        "from portbench.ref.ir import CircuitConfig\n"
        "from portbench.ref.serialization import serialize_proof\n"
        "b, inputs, _ = build_smt_process(7, 4, CircuitConfig.test_config())\n"
        "proof = b.build(device='cpu').prove(inputs)\n"
        "assert len(serialize_proof(proof)) > 0\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True).stdout
    loaded = set(eval(out.strip().splitlines()[-1]))
    assert not loaded & {"plonky2_tpu_torch", *run.FORBIDDEN}, loaded
