"""Tier-1's per-test time limit and `slow` set, from the repo root's `conftest.py`.

The time limit is checked in a child pytest: it loads the root conftest's
hooks with a 1 s limit and runs a generated test file on one xdist worker,
as tier-1 runs its tests.
"""
import ast
import importlib.util
import os
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT_CONFTEST = Path(__file__).resolve().parents[1] / "conftest.py"

CHILD_CONFTEST = """\
import importlib.util, pathlib
spec = importlib.util.spec_from_file_location("tier1_conftest", {path!r})
tier1 = importlib.util.module_from_spec(spec)
spec.loader.exec_module(tier1)
tier1.TEST_TIME_LIMIT_S = 1
tier1.TESTS_DIR = pathlib.Path(__file__).resolve().parent
globals().update((k, v) for k, v in vars(tier1).items() if k.startswith("pytest_"))


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: no time limit")
    tier1.pytest_configure(config)
"""


def _run_child(tmp_path, tests):
    (tmp_path / "conftest.py").write_text(CHILD_CONFTEST.format(path=str(ROOT_CONFTEST)))
    (tmp_path / "test_child.py").write_text(textwrap.dedent(tests))
    env = dict(os.environ, PYTEST_DISABLE_PLUGIN_AUTOLOAD="1")
    return subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "xdist", "-n", "1", "test_child.py"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=60)


def test_test_past_the_limit_fails(tmp_path):
    run = _run_child(tmp_path, """\
        import time
        import pytest

        def test_sleeps_past_the_limit():
            time.sleep(30)

        @pytest.mark.slow
        def test_slow_has_no_limit():
            time.sleep(1.5)
        """)
    assert run.returncode == 1, run.stdout + run.stderr
    assert "ran past the per-test time limit of 1 s" in run.stdout
    assert "1 failed, 1 passed" in run.stdout


def test_stuck_worker_ended_and_run_goes_on(tmp_path):
    run = _run_child(tmp_path, """\
        import os
        import signal

        def test_blocked_with_the_alarm_masked():
            signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGALRM})
            read_end, _ = os.pipe()
            os.read(read_end, 1)

        def test_after_the_stuck_one():
            pass
        """)
    assert run.returncode == 1, run.stdout + run.stderr
    # faulthandler's backstop at twice the limit wrote the stacks ...
    assert "Timeout (0:00:02)!" in run.stderr
    assert "in test_blocked_with_the_alarm_masked" in run.stderr
    # ... and ended the worker; xdist started another for the next test.
    assert ("crashed while running "
            "'test_child.py::test_blocked_with_the_alarm_masked'") in run.stdout
    assert "1 failed, 1 passed" in run.stdout


def test_slow_set_holds_only_jax_package_tests():
    spec = importlib.util.spec_from_file_location("tier1_conftest", ROOT_CONFTEST)
    tier1 = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tier1)
    assert len(tier1.SLOW) == 50
    for entry in tier1.SLOW:
        module, test = entry.split("::")
        source = (Path(__file__).resolve().parent / module).read_text()
        assert not module.startswith("test_torch_"), entry
        assert "plonky2_tpu_torch" not in source, entry
        assert test in {node.name for node in ast.parse(source).body
                        if isinstance(node, ast.FunctionDef)}, entry
