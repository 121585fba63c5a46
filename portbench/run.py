"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or `python3 -m portbench.run ...` from the checkout's root).  On one card
the run:

1. draws the configuration's pool of inputs from the seed (timed apart, on
   stderr; not set-up);
2. sets the program up: builds and saves the circuit on the first run of a
   checkout (a child process), loads it from `portbench/cache/`, proves
   once (the first prove builds the witness tape) and once more warm;
3. opens the window: the traffic mix's closed loop of `CircuitData.prove`
   and `serialize_proof` for `--seconds`.  With `--trace 1` the first half
   runs with the program's spans on and the second under `torch.profiler`;
4. reads the peak device memory, frees the program's state, and has the
   reference prove the proofs drawn from the seed again (`judge.py`);
5. prints the numbers compared beside their limits on stderr, then one
   JSON line on stdout: `correct`, `attempted`, `failed`, `metrics` (the
   end-to-end metrics, or with `--trace 1` the per-layer ones, each from
   `metrics/<name>.py`), `device`, with `--trace 1` `breakdown`, and last
   `compared`.

It exits non-zero, printing no result, without a card (or with fewer than
the cell asks for) and if `jax`, `jaxlib`, `flax` or `plonky2_tpu` is
loaded once the window has closed.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

if __package__ in (None, ""):
    # run as a script: import from the checkout's root, not from portbench/
    # (whose module names, such as trace, would shadow the standard library's)
    sys.path[0] = str(Path(__file__).resolve().parent.parent)

from portbench import judge, spec as specs, traffic  # noqa: E402
from portbench.circuits import CACHE, Side  # noqa: E402
from portbench.roofline import peaks  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "plonky2_tpu")


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (`plonky2_tpu_torch` is not `plonky2_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def cache_env() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["USE_FLAX"] = "0"


def host_cpu() -> list[int]:
    """The host's CPU times (/proc/stat: user, nice, system, idle, iowait,
    irq, softirq, steal), to log how busy the host was and how much time
    the hypervisor took from it over the window."""
    try:
        with open("/proc/stat") as f:
            return [int(x) for x in f.readline().split()[1:9]]
    except (OSError, ValueError):
        return []


def host_share(before: list, after: list) -> str:
    if not before or not after:
        return "host CPU not read"
    d = [b - a for a, b in zip(before, after)]
    total = sum(d) or 1
    return (f"host CPU busy {100 * (total - d[3] - d[4]) / total:.1f}%, "
            f"stolen {100 * d[7] / total:.1f}%")


def sync(device: str) -> None:
    if device == "cuda":
        import torch
        torch.cuda.synchronize()


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             circuit: dict | None = None, sizes: dict | None = None) -> dict:
    """One run of one cell -> its result (the JSON line's object).  Tests
    pass `device="cpu"` and a smaller `circuit` with its `sizes`."""
    import torch
    spec = specs.load_spec()
    cell, config, mix = specs.cell(spec, workload)
    traffic.check(mix)
    circuit = circuit or config.circuit
    sizes = sizes or config.sizes
    run = SimpleNamespace(trace=trace, spans=[], profile=None)

    # 1. the pool of inputs, drawn from the seed
    t0 = time.perf_counter()
    rng = random.Random(seed)
    maker = config.module("inputs")
    pool = traffic.Pool([maker.make(rng, sizes) for _ in range(config.data["input_pool"])])
    pool_s = time.perf_counter() - t0
    log(f"input pool: {len(pool.values)} statements of {len(pool.values[0])} values "
        f"in {pool_s:.3f} s (not set-up)")

    # 2. set-up
    program = Side("program")
    build_s = program.ensure_built(config, circuit, device)
    if build_s is not None:
        log(f"first run in this checkout: circuit built and saved in {build_s:.3f} s")
    t0 = time.perf_counter()
    data, targets = program.load(config, circuit, device)
    sync(device)
    run.load_s = time.perf_counter() - t0
    if len(targets) != sizes["input_values"]:
        raise ValueError(f"the circuit takes {len(targets)} input values, the "
                         f"configuration states {sizes['input_values']}")
    common = data.prover.common
    run.shapes = {"num_wires": common.config.num_wires, "degree_bits": common.degree_bits,
                  "rate_bits": common.config.fri.rate_bits,
                  "cap_height": common.config.fri.cap_height}
    if common.degree_bits != sizes["degree_bits"]:
        raise ValueError(f"the circuit has 2^{common.degree_bits} rows, the configuration "
                         f"states 2^{sizes['degree_bits']}")

    def prove(values):
        return program.serialize(data.prove(dict(zip(targets, values))))

    t0 = time.perf_counter()
    prove(pool.take()[1])
    run.first_prove_s = time.perf_counter() - t0
    prove(pool.take()[1])
    window_start = time.perf_counter()
    run.setup_s = window_start - PROCESS_START - pool_s
    log(f"set-up {run.setup_s:.3f} s: load {run.load_s:.3f} s, first prove "
        f"{run.first_prove_s:.3f} s, then one warm prove")

    # 3. the window
    cpu_before = host_cpu()
    if not trace:
        records, run.window_s = traffic.closed_loop(seconds, prove, pool)
    else:
        from portbench.trace import DeviceProfile, Spans
        spans = Spans()

        def prove_spanned(values):
            out = prove(values)
            run.spans.append(spans.last())
            return out
        records, _ = traffic.closed_loop(seconds / 2, prove_spanned, pool)
        spans.close()
        profile = DeviceProfile() if device == "cuda" else contextlib.nullcontext()
        with profile:
            more, _ = traffic.closed_loop(seconds / 2, prove, pool)
        records += more
        run.window_s = records[-1][2] - window_start
    run.proofs = sum(r[3] is not None for r in records)
    run.peak_bytes = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    log(f"window: {len(records)} proofs in {run.window_s:.3f} s; each "
        f"{' '.join(f'{r[2] - r[1]:.4f}' for r in records)} s, the process's CPU "
        f"{' '.join(f'{r[4]:.4f}' for r in records)} s; "
        f"{host_share(cpu_before, host_cpu())}")

    if trace and device == "cuda":
        run.profile = profile.result()
        del profile
    kind = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    run.peaks = peaks(kind) if device == "cuda" else None

    # 4. the program's state freed; the reference judges the sample
    del data, prove
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    done = [r for r in records if r[3] is not None]
    picks = judge.sample(seed, len(done), config.data["check_proofs"])
    samples = [(pool.values[done[i][0]], done[i][3]) for i in picks]
    t0 = time.perf_counter()
    numbers = judge.check(config, circuit, samples, device)
    log(f"reference: {len(samples)} proof(s) proved again in "
        f"{time.perf_counter() - t0:.3f} s; differing parts {numbers['parts']}")

    # 5. the result
    metrics = {}
    for m in specs.metrics_for(spec, workload, trace):
        value = specs.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device, "kind": kind,
           "count": cell["chips"], "memory_peak_bytes": run.peak_bytes}
    result = {"correct": len(done) == len(records) and judge.verdict(numbers),
              "attempted": len(records),
              "failed": len(records) - len(done), "metrics": metrics, "device": dev}
    if run.profile is not None:
        dev["busy_s"] = run.profile["busy_s"]
        dev["window_s"] = run.profile["window_s"]
        result["breakdown"] = {"device_ops": run.profile["device_ops"],
                               "idle_gaps": run.profile["idle_gaps"]}
    result["compared"] = judge.compared(numbers)
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    cache_env()
    import torch
    chips = specs.by_name(specs.load_spec()["workloads"], a.workload, "workload")["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"this cell needs {chips} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    result = run_cell(a.workload, a.seed, a.seconds, bool(a.trace))
    bad = forbidden_modules()
    if bad:
        log(f"loaded modules the benchmark may not load: {bad}")
        return 4
    for name, c in result["compared"].items():
        log(f"compared {name} {c['value']} limit {c['limit']} ({c['kind']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
