"""Smoke run of the PyTorch/CUDA port (`plonky2_tpu_torch`) on one GPU.

Drives the port's four main paths — build, witness, prove and serialize
the config-1 circuit (Poseidon chain, 2^12 rows), the config-2 circuit (u32
mul/add/xor/sub/compare, 2^13 rows) and the config-3 circuit (51 chained
depth-32 SMT process proofs, 2^14 rows), all under
standard_recursion_config, and the config-4 circuit (one secp256k1 ECDSA
verify, 55,421 gates, 2^16 rows, under standard_ecc_config: 136 wires) —
on the card, after checking each hand-written kernel against its plain
torch version there, and verifies every proof with the port's host
verifier:

  1. device      name, power limit, SM clock; fails without CUDA
  2. build       nvcc builds plonky2_tpu_torch/csrc/*.cu, one process per
                 source; ptxas's register and spill report, and each K2
                 kernel's registers and spills (none allowed); each
                 kernel's SASS instruction and multiply counts
                 (bench/sass.py), per butterfly for K2's and K3's
                 register-group kernels
  3. field       csrc/goldilocks.cuh against the plain field ops, K3's
                 lazy butterfly included
  4. K1          Poseidon kernel against the plain permutation, with both
                 MDS layers (small-entry split and generic mulmods), and
                 at ragged batch widths
  5. K2          LDE kernel, bit-reversed (K2-rev) and natural (K2-nat)
                 order, against the plain LDEs, at config 1's shape, config
                 2's (2^13), every size of its register-group kernels
                 (2^11..2^13), the first design's body (n = 4), and rates
                 0, 1, 3 and 6
  6. K3          tiled four-step LDE kernel against the plain LDE, at
                 config 3's wire and Z shapes, config 4's wire shape
                 [136, 2^16], 2^18 to 2^20 (three register groups), the
                 odd sizes 2^15 and 2^17 (n1 != n2), one polynomial, and
                 rates 0, 1 and 6
  7. tiny        the golden tiny circuit's proof sha256
  8. config 1    proof bytes equal the JAX package's (tests/torch_port_vectors.json)
  9. config 2    the same, proved twice
 10. config 3    the same, proved twice
 11. config 4    the same, proved twice; then K3 against the plain LDE at
                 its constants/sigmas and Z/partial-products commit shapes,
                 read from its built common data

Every proof phase (7-11) ends with a verify step: the port's verifier
accepts the card's proof and rejects it with one public input (the wires
cap where there is none) or one opening changed, and the verifier key's
bytes have the fixture's sha256 and read back to the same bytes.

All checks are exact: field arithmetic has no rounding, so every tolerance
is 0.  Kernel inputs cover all of [0, p), edge values included.  Kernel
launch counts are set to 0 just before each main path and read just after
it.  Each kernel's bound is the larger of its bytes (each input read once,
each output written once) over 3.35 TB/s and its 32-bit integer multiplies
over 64 per clock per SM x 132 SMs x the card's maximum SM clock.  Each
phase prints its lines and raises on failure.  The line before the last is
the kernels' JSON record; the last line is the device record.

    python3 chip_smoke.py
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# nvidia-smi's "name, power limit" of the card, set by phase_device and
# printed beside every wall, span and memory figure
CARD = ""


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, launches: int = 20, brackets: int = 5) -> float:
    """Device time of one fn() in ms: after a warm-up call and a
    synchronize, each of `brackets` pairs of CUDA events brackets
    `launches` back-to-back calls, so the host's launch time overlaps the
    device's work instead of adding to it; the median bracket over
    `launches`.  The plain versions, of hundreds of launches each, take
    launches=1."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(brackets):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


EDGES = [0, 1, 2**32 - 1, 2**32, 2**63 - 1, 2**63, (1 << 64) - (1 << 32) - 1,
         (1 << 64) - (1 << 32)]   # the last two are p - 2 and p - 1


def rand_field(rng, shape):
    """Canonical field elements over all of [0, p), as uint64, with EDGES
    in the first entries."""
    import numpy as np
    from plonky2_tpu_torch.field import gl
    hi = rng.randint(0, 2**32, size=shape, dtype=np.int64).astype(np.uint64)
    lo = rng.randint(0, 2**32, size=shape, dtype=np.int64).astype(np.uint64)
    x = ((hi << np.uint64(32)) | lo) % np.uint64(gl.P)
    flat = x.reshape(-1)
    k = min(len(EDGES), flat.size)
    flat[:k] = np.asarray(EDGES[:k], dtype=np.uint64)
    return x


def max_abs_err(got, want) -> float:
    """Largest |got - want| over u64 values (0 when bit-identical), taken
    over the first 10^5 positions that differ."""
    from plonky2_tpu_torch.field import gl
    idx = (got != want).reshape(-1).nonzero().reshape(-1)[:100_000]
    a = gl.from_tensor(got.reshape(-1)[idx]).astype(object)
    b = gl.from_tensor(want.reshape(-1)[idx]).astype(object)
    return float(max((abs(int(x) - int(y)) for x, y in zip(a, b)), default=0))


def require_equal(name: str, got, want) -> float:
    import torch
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.equal(got, want):
        n_diff = int((got != want).sum())
        raise AssertionError(f"{name}: kernel differs from plain at {n_diff} positions "
                             f"(max |diff| {max_abs_err(got, want)})")
    return 0.0


HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
IMAD_PER_CLOCK_PER_SM = 64       # 32-bit integer multiply(-add), compute capability 9.0
SMS = 132
MULMOD_IMADS = 4                 # a 64 x 64 -> 128-bit product: four 32 x 32 -> 64 products


def bound(nbytes: int, imads: int, sm_hz: float):
    """(bound_ms, bound_by): the larger of the memory time and the integer
    multiply time."""
    mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = imads / (IMAD_PER_CLOCK_PER_SM * SMS * sm_hz) * 1e3
    return (mem_ms, "bytes") if mem_ms >= ops_ms else (ops_ms, "operations")


def lde_work(b: int, n: int, rate_bits: int, table_words: int):
    """(bytes, 32-bit multiplies) of values [b, n] -> coeffs [b, n] + LDE
    [b, n * 2^rate]: radix-2 mulmods of one inverse NTT, the 1/n scale and,
    per coset, the coset scale and one forward NTT."""
    log_n = n.bit_length() - 1
    ntt_mulmods = (n // 2) * log_n
    mulmods = ntt_mulmods + n + (1 << rate_bits) * (n + ntt_mulmods)
    nbytes = 8 * (b * (2 * n + (n << rate_bits)) + table_words)
    return nbytes, b * mulmods * MULMOD_IMADS


def k2_table_words(log_n: int, rate_bits: int) -> int:
    """Words of the tables for K2's bound, as `pallas_lde._build` derives
    them: the roots of unity each way (n / 2 words each) and the [2^rate,
    n] coset scale table, whatever tables K2 itself reads."""
    n = 1 << log_n
    return n + (n << rate_bits)


def k3_table_words(log_n: int, rate_bits: int) -> int:
    """Words of the four-step identity's tables for K3's bound, as
    `pallas_lde_tiled._build_tiled` derives them: the column and row roots
    (n1 / 2 and n2 / 2 each way), the inverse and forward inter-pass
    twiddles [n1, n2], and the scale factors u [2^rate, n1], v [2^rate,
    n2].  (The JAX kernel multiplies u and v out into a [2^rate, n] scale
    before its passes; the identity needs only the factors.)"""
    n1, n2 = 1 << (log_n // 2), 1 << (log_n - log_n // 2)
    return n1 + n2 + 2 * n1 * n2 + ((n1 + n2) << rate_bits)


def poseidon_work(b: int):
    """(bytes, 32-bit multiplies) of b permutations, counted as the least
    work plonky2's fast partial rounds need: 118 S-boxes of 4 mulmods; the
    partial rounds' dense 11 x 11 initial layer (121 mulmods) and, in each
    of the 22 rounds, 22 mulmods and one small-entry product; 8 full
    small-entry MDS layers of 144 products.  A small-entry product is one
    32-bit multiply of each half of the element."""
    mulmods = 118 * 4 + 121 + 22 * 22
    small = 8 * 144 + 22
    return 8 * 12 * 2 * b, b * (mulmods * MULMOD_IMADS + small * 2)


def _smi(query: str) -> str:
    smi = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def phase_device():
    """-> (device name, maximum SM clock in Hz)."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: this smoke run needs a GPU")
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    sm_mhz = float(_smi("clocks.max.sm").split()[0])
    log(f"[device] maximum SM clock {sm_mhz:.0f} MHz")
    global CARD
    CARD = _smi("name,power.limit")
    log(CARD)
    return name, sm_mhz * 1e6


# K1's round loops in csrc/poseidon.cu, in address order: the 8 full rounds,
# and the 22 partial rounds run on one of their trips.
K1_LOOP_TRIPS = (8, 22)

# The rate at which K3's pass C (2^rate trips of its coset loop) is counted.
K3_SASS_RATE = 3


def k3_loop_trips(kernel: str, log_l: int):
    """(trip counts of the SASS loops of K3's kernel<log_l> in address
    order, butterflies one thread runs per block), from the built library's
    own geometry (`cuda_lde_tiled.geometry`): a register group of k stages
    runs 2^(log tile - k) / threads trips and is no loop at one trip; C's
    coset loop comes before its groups' loops."""
    from plonky2_tpu_torch.ntt.cuda_lde_tiled import geometry
    geo = geometry(log_l)
    log_t = geo["log_tile_c"] if kernel == "col_forward_kernel" else geo["log_tile"]
    reps = [(1 << (log_t - k)) // geo["threads"] for k in geo["groups"]]
    trips = [r for r in reps if r > 1]
    butterflies = (1 << (log_t - 1)) * log_l // geo["threads"]
    if kernel == "col_forward_kernel":
        trips = [1 << K3_SASS_RATE] + trips
        butterflies <<= K3_SASS_RATE
    return trips, butterflies


def k2_loop_trips(log_n: int):
    """(trip counts of the SASS loops of K2's register-group kernels for
    2^log_n in address order, butterflies one thread runs per block), from
    the built library's own geometry (`cuda_lde.geometry`): a register
    group of k stages runs 2^(log n - k) / threads trips and is no loop at
    one trip."""
    from plonky2_tpu_torch.ntt.cuda_lde import geometry
    geo = geometry(log_n)
    trips = [r for r in ((1 << (log_n - k)) // geo["threads"] for k in geo["groups"]) if r > 1]
    return trips, (1 << (log_n - 1)) * log_n // geo["threads"]


K2_KERNELS = re.compile(r"lde_kernel|k2_inverse_kernel|k2_forward_kernel")


def ptxas_resources(build_log: str) -> dict:
    """{mangled kernel name: {"registers", "stack", "spill_stores",
    "spill_loads"}} from ptxas's -v report in an nvcc build log."""
    out: dict = {}
    name = None
    for line in build_log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def phase_build():
    from plonky2_tpu_torch import _build
    t0 = time.perf_counter()
    path = _build.build()
    _build.lib()
    log(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)} -c, one process per csrc/*.cu, "
        f"linked into {os.path.relpath(path, ROOT)} in {time.perf_counter() - t0:.2f} s")
    with open(_build.log_path()) as f:
        build_log = f.read()
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("[build] " + line.strip())
    from plonky2_tpu_torch.bench import sass
    k2 = {name: r for name, r in ptxas_resources(build_log).items() if K2_KERNELS.search(name)}
    if not k2:
        raise AssertionError("no K2 kernel in ptxas's report")
    for mangled, name in zip(k2, sass._demangle(list(k2))):
        r = k2[mangled]
        short = name.replace("void ", "").replace("(anonymous namespace)::", "").split("(")[0]
        log(f"[build] K2 {short}: {r.get('registers')} registers, "
            f"{r.get('spill_stores')} bytes spill stores, {r.get('spill_loads')} bytes spill "
            f"loads, {r.get('stack')} bytes stack")
        if r.get("spill_stores") != 0 or r.get("spill_loads") != 0:
            raise AssertionError(f"K2 kernel {name} spills (or ptxas gave no spill line): {r}")
    try:
        counts, probes = sass.count(path), sass.probes()
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        log(f"[sass] not counted: {e}")
        return
    for name, c in sorted(counts.items()):
        loops = "".join(f"; a loop of {lp['instructions']} instructions "
                        f"({lp['multiplies']} multiplies)" for lp in c["loops"])
        log(f"[sass] {name}: {c['instructions']} instructions, {c['multiplies']} "
            f"integer multiplies, {c['imad_other']} IMAD moves/shifts/adds{loops}")
        k2 = re.search(r"k2_(inverse|forward)_kernel<(\d+)", name)
        if k2:
            trips, butterflies = k2_loop_trips(int(k2.group(2)))
            if len(c["loops"]) != len(trips):
                raise AssertionError(
                    f"{name}: {len(c['loops'])} SASS loops, but the library's register "
                    f"groups give {len(trips)} ({trips})")
            run = sass.per_thread(c, trips)
            log(f"[sass]   per block and thread (loops run {tuple(trips)} times): "
                f"{run['instructions']} instructions, {run['multiplies']} integer multiplies "
                f"for {butterflies} butterflies: {run['instructions'] / butterflies:.1f} "
                f"instructions and {run['multiplies'] / butterflies:.1f} multiplies a butterfly")
        k3 = re.search(r"(col_inverse_kernel|row_inverse_kernel|col_forward_kernel|"
                       r"row_forward_kernel)<(\d+)>", name)
        if k3:
            trips, butterflies = k3_loop_trips(k3.group(1), int(k3.group(2)))
            if len(c["loops"]) != len(trips):
                raise AssertionError(
                    f"{name}: {len(c['loops'])} SASS loops, but the library's register "
                    f"groups give {len(trips)} ({trips})")
            run = sass.per_thread(c, trips)
            log(f"[sass]   per block and thread (loops run {tuple(trips)} times"
                + (f", rate {K3_SASS_RATE}" if k3.group(1) == "col_forward_kernel" else "")
                + f"): {run['instructions']} instructions, {run['multiplies']} integer "
                f"multiplies for {butterflies} butterflies: "
                f"{run['instructions'] / butterflies:.1f} instructions and "
                f"{run['multiplies'] / butterflies:.1f} multiplies a butterfly")
        if "permute_cols_kernel" in name:
            try:
                run = sass.per_thread(c, K1_LOOP_TRIPS)
            except ValueError as e:
                log(f"[sass]   per permutation: not derived ({e})")
                continue
            log(f"[sass]   per permutation (round loops run {K1_LOOP_TRIPS} times): "
                f"{run['instructions']} instructions, {run['multiplies']} integer multiplies")
    for form, c in probes.items():
        log(f"[sass] probe {form}: {c['instructions']} instructions, "
            f"{c['multiplies']} integer multiplies")


def phase_field(device):
    import numpy as np
    import torch
    from plonky2_tpu_torch.field import gl
    from plonky2_tpu_torch.hashes.cuda_poseidon import gl_ops_cuda
    edge = np.asarray(EDGES, dtype=np.uint64)
    rand = rand_field(np.random.RandomState(7), 8192)
    a = np.concatenate([np.repeat(edge, len(edge)), rand])
    b = np.concatenate([np.tile(edge, len(edge)), rand[::-1]])
    ta, tb = gl.to_tensor(a, device), gl.to_tensor(b, device)
    got = gl_ops_cuda(ta, tb, tb)[:4]
    want = torch.stack([gl.add(ta, tb), gl.sub(ta, tb), gl.mul(ta, tb), gl.neg(ta)])
    torch.cuda.synchronize()
    require_equal("goldilocks.cuh", got, want)
    log(f"[field] goldilocks.cuh add/sub/mul/neg bit-equal to plain gl on "
        f"{len(a)} pairs (all pairs of 0, 1, 2^32-1, 2^32, 2^63-1, 2^63, "
        f"p-2, p-1, and random pairs over [0, p))")
    # K1's lazy forms take any u64: edges above p too, and random pairs over
    # [0, 2^64), against the plain ops on the inputs made canonical.
    edge = np.asarray(EDGES + [gl.P, gl.P + 1, 2**64 - 2**32 + 2**31, 2**64 - 2, 2**64 - 1],
                      dtype=np.uint64)
    rng = np.random.RandomState(8)
    rand = ((rng.randint(0, 2**32, 8192, dtype=np.int64).astype(np.uint64) << np.uint64(32))
            | rng.randint(0, 2**32, 8192, dtype=np.int64).astype(np.uint64))
    a = np.concatenate([np.repeat(edge, len(edge)), rand])
    b = np.concatenate([np.tile(edge, len(edge)), rand[::-1]])
    ta, tb = gl.to_tensor(a, device), gl.to_tensor(b, device)
    # K3's butterfly takes a twiddle too: random over [0, 2^64)
    tw = gl.to_tensor((rng.randint(0, 2**32, len(a), dtype=np.int64).astype(np.uint64)
                       << np.uint64(32)) | rng.randint(0, 2**32, len(a), dtype=np.int64)
                      .astype(np.uint64), device)
    out = gl_ops_cuda(ta, tb, tw)
    got = out[4:9]
    ca, cb = gl._canon(ta), gl._canon(tb)
    prod = gl.mul(ca, cb)
    want = torch.stack([prod, gl.add(gl.mul(ca, gl.full_like(ca, gl.EPSILON)), cb),
                        gl.add(ca, cb), gl.sub(ca, cb), gl.mul(prod, gl.full_like(ca, 12))])
    torch.cuda.synchronize()
    require_equal("goldilocks.cuh lazy forms", got, want)
    log(f"[field] lazy mul, reduce128, add, sub and a 12-product Acc bit-equal to plain gl "
        f"on {len(a)} pairs of any u64 (all pairs of the edges above and p, p+1, "
        f"2^64-2^31, 2^64-2, 2^64-1, and random pairs)")
    # K3's butterfly on the same pairs of any u64 and the random twiddles:
    # (e, o, w) -> (e + o, (e - o) * w), and with w = 1.
    got = out[9:]
    want = torch.stack([gl.add(ca, cb), gl.mul(gl.sub(ca, cb), gl._canon(tw)),
                        gl.add(ca, cb), gl.sub(ca, cb)])
    torch.cuda.synchronize()
    require_equal("goldilocks.cuh dif_lazy", got, want)
    log(f"[field] lazy DIF butterfly dif_lazy (with a twiddle and with w = 1) bit-equal to "
        f"plain gl on the same {len(a)} pairs of any u64, with random twiddles over [0, 2^64)")


def phase_k1(device):
    import numpy as np
    from plonky2_tpu_torch.field import gl
    from plonky2_tpu_torch.hashes import cuda_poseidon, poseidon
    rng = np.random.RandomState(1)
    out = {}
    for b in (1 << 15, 1 << 17, 1 << 20):
        s = gl.to_tensor(rand_field(rng, (12, b)), device)
        got = cuda_poseidon.permute_cols_cuda(s)
        want = poseidon.permute_cols_plain(s)
        err = require_equal(f"K1 [12, {b}]", got, want)
        ms = time_ms(lambda: cuda_poseidon.permute_cols_cuda(s))
        plain_ms = time_ms(lambda: poseidon.permute_cols_plain(s), launches=1)
        log(f"[K1] Poseidon [12, {b}]: bit-equal; kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms")
        out[b] = (err, ms, plain_ms)
        if b == 1 << 15:
            # The generic mulmod MDS layer (for a matrix with large entries)
            # on plonky2's matrix must give the same bits.
            got = cuda_poseidon.permute_cols_cuda(s, small_mds=False)
            require_equal(f"K1 generic MDS [12, {b}]", got, want)
            ms = time_ms(lambda: cuda_poseidon.permute_cols_cuda(s, small_mds=False))
            log(f"[K1] Poseidon [12, {b}], generic mulmod MDS layer: bit-equal; "
                f"kernel {ms:.4f} ms")
    # Ragged batches: a partial last block, and a batch of one state.
    for b in (1, 1000, (1 << 17) + 3):
        s = gl.to_tensor(rand_field(rng, (12, b)), device)
        want = poseidon.permute_cols_plain(s)
        for small in (True, False):
            require_equal(f"K1 [12, {b}] small_mds={small}",
                          cuda_poseidon.permute_cols_cuda(s, small_mds=small), want)
    log("[K1] ragged batches 1, 1000 and 2^17 + 3: bit-equal on both MDS layers")
    return out


def _lde_check(tag, device, rng, kernel, plain, shapes, rate_bits, plain_brackets=5):
    """Hold an LDE kernel against its plain version at each [rows, n]:
    -> {(rows, n, rate_bits): (max_abs_err, kernel ms, plain ms)}."""
    from plonky2_tpu_torch.field import gl
    out = {}
    for rows, n in shapes:
        v = gl.to_tensor(rand_field(rng, (rows, n)), device)
        cg, lg = kernel(v, rate_bits)
        cw, lw = plain(v, rate_bits)
        require_equal(f"{tag} coeffs [{rows}, {n}]", cg, cw)
        err = require_equal(f"{tag} LDE [{rows}, {n}]", lg, lw)
        del cg, lg, cw, lw
        ms = time_ms(lambda: kernel(v, rate_bits))
        plain_ms = time_ms(lambda: plain(v, rate_bits), launches=1, brackets=plain_brackets)
        log(f"[{tag}] LDE [{rows}, {n}] rate {rate_bits}: coeffs and LDE bit-equal; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        out[(rows, n, rate_bits)] = (err, ms, plain_ms)
    return out


# K2's shapes by rate: config 1's wires (2^12) and config 2's (2^13); every
# size of the register-group kernels (2^11..2^13) and the first design's
# body (n = 4); one polynomial; and the rates whose coset grid is 1, 2 or
# 64 blocks a polynomial.
K2_SHAPES = {3: ((135, 1 << 12), (20, 1 << 12), (3, 4), (135, 1 << 13), (1, 1 << 11)),
             6: ((2, 1 << 13),), 0: ((20, 1 << 12),), 1: ((20, 1 << 12),)}


def phase_k2(device):
    import numpy as np
    from plonky2_tpu_torch import ntt
    from plonky2_tpu_torch.ntt import cuda_lde
    rng = np.random.RandomState(2)
    rev, nat = {}, {}
    for rate_bits, shapes in K2_SHAPES.items():
        rev.update(_lde_check("K2-rev", device, rng, cuda_lde.lde_from_values_rev_cuda,
                              ntt.lde_from_values_rev, shapes, rate_bits))
        nat.update(_lde_check("K2-nat", device, rng, cuda_lde.lde_from_values_cuda,
                              ntt.lde_from_values, shapes, rate_bits))
    return rev, nat


def phase_k3(device):
    import numpy as np
    import torch
    from plonky2_tpu_torch import ntt
    from plonky2_tpu_torch.ntt import cuda_lde_tiled
    rng = np.random.RandomState(3)
    kernel, plain = cuda_lde_tiled.lde_from_values_tiled_rev_cuda, ntt.lde_from_values_rev
    out = _lde_check("K3", device, rng, kernel, plain, ((135, 1 << 14), (20, 1 << 14)), 3)
    # larger and odd log n (n1 = 2^(log n // 2) < n2 when log n is odd):
    # the tiles, row groups, register groups and tables take other shapes
    out.update(_lde_check("K3", device, rng, kernel, plain,
                          ((135, 1 << 15), (135, 1 << 16), (136, 1 << 16), (20, 1 << 17),
                           (2, 1 << 18), (2, 1 << 19), (2, 1 << 20)), 3, plain_brackets=2))
    out.update(_lde_check("K3", device, rng, kernel, plain, ((3, 1 << 14),), 6))
    # one polynomial, and the rates whose coset loop runs once or twice
    out.update(_lde_check("K3", device, rng, kernel, plain, ((1, 1 << 14),), 3))
    for rate_bits in (0, 1):
        out.update(_lde_check("K3", device, rng, kernel, plain, ((20, 1 << 14),), rate_bits))
    torch.cuda.empty_cache()
    return out


def phase_tiny(device):
    from plonky2_tpu_torch.ir import CircuitBuilder, CircuitConfig
    from plonky2_tpu_torch.serialization import serialize_proof
    with open(os.path.join(ROOT, "tests", "golden_vectors.json")) as f:
        golden = json.load(f)
    b = CircuitBuilder(CircuitConfig.test_config())
    x = b.add_virtual_target()
    y = b.add_virtual_target()
    z = b.mul_add(x, y, x)
    for t in b.two_to_one([x, y, z, x], [y, z, x, y]):
        b.register_public_input(t)
    data = b.build(device=device)
    proof = data.prove({x: 111, y: 222})
    raw = serialize_proof(proof)
    digest = hashlib.sha256(raw).hexdigest()
    if digest != golden["tiny_circuit_proof_sha256"]:
        raise AssertionError(f"tiny circuit proof sha256 {digest} != golden "
                             f"{golden['tiny_circuit_proof_sha256']}")
    log(f"[tiny] golden tiny circuit: {len(raw)} bytes, sha256 {digest} (golden)")
    verify_step("tiny", data, proof, fixture("tiny"))


def fixture(key: str) -> dict:
    with open(os.path.join(ROOT, "tests", "torch_port_vectors.json")) as f:
        return json.load(f)[key]


def verify_step(tag: str, data, proof, want: dict) -> None:
    """The port's verifier on the card's proof: it accepts it (the wall is
    printed) and rejects it with a public input (or, without one, the wires
    cap) or an opening changed; the verifier key has the fixture's sha256
    and round-trips."""
    import copy
    from plonky2_tpu_torch.field import gl
    from plonky2_tpu_torch.serialization import (deserialize_verifier_data,
                                                 serialize_verifier_data)
    t0 = time.perf_counter()
    data.verify(proof)
    verify_s = time.perf_counter() - t0

    def bump_public_input(p):
        p.public_inputs[0] = (p.public_inputs[0] + 1) % gl.P

    def bump_wires_cap(p):
        p.wires_cap[0][0] = (p.wires_cap[0][0] + 1) % gl.P

    def bump_opening(p):
        c0, c1 = p.openings.wires[0]
        p.openings.wires[0] = ((c0 + 1) % gl.P, c1)

    # config 4 has no public inputs: its first tamper is the wires cap
    first = (("a public input", bump_public_input) if proof.public_inputs
             else ("the wires cap", bump_wires_cap))
    for what, tamper in (first, ("an opening", bump_opening)):
        bad = copy.deepcopy(proof)
        tamper(bad)
        try:
            data.verify(bad)
        except ValueError as e:
            log(f"[{tag}] proof with {what} changed: rejected ({e})")
            continue
        raise AssertionError(f"{tag}: the verifier accepted a proof with {what} changed")
    vk = serialize_verifier_data(data.verifier)
    digest = hashlib.sha256(vk).hexdigest()
    if digest != want["verifier_data_sha256"]:
        raise AssertionError(f"{tag} verifier key sha256 {digest} != fixture "
                             f"{want['verifier_data_sha256']}")
    if serialize_verifier_data(deserialize_verifier_data(vk)) != vk:
        raise AssertionError(f"{tag} verifier key does not round-trip")
    log(f"[{tag}] verify {verify_s:.3f} s (host; {CARD}): accepted; verifier key "
        f"{len(vk)} bytes, sha256 {digest} equals the fixture and round-trips")


def phase_config(tag: str, device, build, fixture_key: str, proves: int = 2):
    """Build, witness and prove one configuration on the card; its proof
    bytes, cs_cap, public inputs and shape must equal the JAX fixture, and
    every prove must give the same bytes; then the verify step.  -> (kernel
    launches on the path (build + first prove), the circuit's common data)."""
    import torch
    from plonky2_tpu_torch import utils
    from plonky2_tpu_torch.hashes import cuda_poseidon
    from plonky2_tpu_torch.ntt import cuda_lde, cuda_lde_tiled
    from plonky2_tpu_torch.prove.prover import witness_matrix
    from plonky2_tpu_torch.serialization import serialize_proof
    want = fixture(fixture_key)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_poseidon.LAUNCHES = cuda_lde.LAUNCHES = cuda_lde.LAUNCHES_NAT = 0
    cuda_lde_tiled.LAUNCHES = 0
    t0 = time.perf_counter()
    b, inputs, meta = build()
    num_gates = b.num_gates()
    data = b.build(device=device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    utils.profiling_enable()
    t0 = time.perf_counter()
    proof = data.prove(inputs)
    raw = serialize_proof(proof)
    prove_s = [time.perf_counter() - t0]
    spans = [utils.last_tree().lines()]
    launches = {"K1": cuda_poseidon.LAUNCHES, "K2-rev": cuda_lde.LAUNCHES,
                "K2-nat": cuda_lde.LAUNCHES_NAT, "K3": cuda_lde_tiled.LAUNCHES}

    cs_cap = [[int(x) for x in d] for d in data.verifier.cs_cap]
    if num_gates != want["num_gates"] or data.common.degree_bits != want["degree_bits"]:
        raise AssertionError(f"{tag} shape: {num_gates} gates, 2^"
                             f"{data.common.degree_bits} rows != fixture")
    if cs_cap != want["cs_cap"]:
        raise AssertionError(f"{tag} constants/sigmas cap differs from the JAX fixture")
    digest = hashlib.sha256(raw).hexdigest()
    if len(raw) != want["proof_len"] or digest != want["proof_sha256"]:
        raise AssertionError(f"{tag} proof ({len(raw)} bytes, sha256 {digest}) "
                             f"differs from the JAX fixture ({want['proof_len']} "
                             f"bytes, {want['proof_sha256']})")
    if proof.public_inputs != want["public_inputs"]:
        raise AssertionError(f"{tag} public inputs differ from the JAX fixture")

    for _ in range(proves - 1):
        t0 = time.perf_counter()
        again = serialize_proof(data.prove(inputs))
        prove_s.append(time.perf_counter() - t0)
        spans.append(utils.last_tree().lines())
        if hashlib.sha256(again).hexdigest() != digest:
            raise AssertionError(f"{tag} prove {len(prove_s)} gave other bytes")
    utils.profiling_disable()
    peak = torch.cuda.max_memory_allocated()

    t0 = time.perf_counter()
    witness_matrix(data.prover, inputs)
    witness_s = time.perf_counter() - t0

    log(f"[{tag}] {meta['name']} 2^{data.common.degree_bits} ({num_gates} gates): "
        f"cs_cap, public inputs, {len(raw)} bytes and sha256 {digest} equal the JAX fixture")
    log(f"[{tag}] launches on the main path (build + first prove): "
        + ", ".join(f"{k} {v}" for k, v in launches.items()) + f" ({CARD})")
    log(f"[{tag}] build {build_s:.3f} s; witness {witness_s:.3f} s; prove "
        + ", ".join(f"{t:.3f} s" for t in prove_s)
        + f"; peak device memory {peak / 2**20:.1f} MiB ({CARD})")
    for i, lines in enumerate(spans):
        log(f"[{tag}] phase spans, prove {i + 1} (synchronized; {CARD}):")
        for line in lines:
            log("  " + line)
    verify_step(tag, data, proof, want)
    return launches, data.common


def phase_k3_commits(device, tag, common):
    """Hold K3 at the shapes of a circuit's other two commits, as its built
    common data gives them: [selectors | constants | sigmas] at build, and
    the Z polys with the partial products in each prove."""
    import numpy as np
    import torch
    from plonky2_tpu_torch import ntt
    from plonky2_tpu_torch.ntt import cuda_lde_tiled
    n = 1 << common.degree_bits
    cs_rows = (len(common.selector_info.groups) + common.num_constants_polys
               + common.config.num_routed_wires)
    zs_rows = common.config.num_challenges * (1 + common.num_partial_products)
    log(f"[K3] {tag}'s constants/sigmas commit [{cs_rows}, {n}] and Z/partial-products "
        f"commit [{zs_rows}, {n}], from its common data")
    out = _lde_check("K3", device, np.random.RandomState(4),
                     cuda_lde_tiled.lde_from_values_tiled_rev_cuda, ntt.lde_from_values_rev,
                     ((cs_rows, n), (zs_rows, n)), common.config.fri.rate_bits,
                     plain_brackets=2)
    torch.cuda.empty_cache()
    return out


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch
    name, sm_hz = phase_device()
    device = torch.device("cuda", 0)
    phase_build()
    phase_field(device)
    k1 = phase_k1(device)
    k2_rev, k2_nat = phase_k2(device)
    k3 = phase_k3(device)
    phase_tiny(device)

    from plonky2_tpu_torch.bench import (build_ecdsa, build_poseidon_chain,
                                         build_smt_process, build_u32_mix)
    paths, common = {}, {}
    for path, build in (("config1", lambda: build_poseidon_chain(12)),
                        ("config2", lambda: build_u32_mix(13)),
                        ("config3", lambda: build_smt_process(14)),
                        ("config4", lambda: build_ecdsa(1))):
        paths[path], common[path] = phase_config(path, device, build, path)
    k3.update(phase_k3_commits(device, "config4", common["config4"]))
    required = {"config1": ("K1", "K2-rev"), "config2": ("K1", "K2-rev"),
                "config3": ("K1", "K3"), "config4": ("K1", "K3")}
    for path, kernels in required.items():
        for k in kernels:
            if paths[path][k] <= 0:
                raise AssertionError(f"kernel {k} was not launched on the {path} path")

    # Each kernel at the shape its main path gives it; launches summed over
    # the paths named (all paths where None).  The LDE kernels' bytes
    # include the twiddle tables as the JAX kernels derive them
    # (k2_table_words, k3_table_words), whatever tables K2 and K3 read.
    rows = [
        ("K1", "poseidon permute_cols [12, 131072] (config 3 leaf hashing)",
         "plonky2_tpu_torch/csrc/poseidon.cu", "plonky2_tpu/hashes/pallas_poseidon.py:191",
         k1[1 << 17], poseidon_work(1 << 17), None),
        ("K2-rev", "lde_from_values_rev [135, 4096] rate 3 (config 1 wires)",
         "plonky2_tpu_torch/csrc/lde.cu", "plonky2_tpu/ntt/pallas_lde.py:316",
         k2_rev[(135, 4096, 3)], lde_work(135, 4096, 3, k2_table_words(12, 3)),
         ("config1",)),
        ("K2-rev", "lde_from_values_rev [135, 8192] rate 3 (config 2 wires)",
         "plonky2_tpu_torch/csrc/lde.cu", "plonky2_tpu/ntt/pallas_lde.py:316",
         k2_rev[(135, 1 << 13, 3)], lde_work(135, 1 << 13, 3, k2_table_words(13, 3)),
         ("config2",)),
        ("K2-nat", "lde_from_values [135, 4096] rate 3 (on no prove path)",
         "plonky2_tpu_torch/csrc/lde.cu", "plonky2_tpu/ntt/pallas_lde.py:303",
         k2_nat[(135, 4096, 3)], lde_work(135, 4096, 3, k2_table_words(12, 3)), None),
        ("K3", "lde_from_values_tiled_rev [135, 16384] rate 3 (config 3 wires)",
         "plonky2_tpu_torch/csrc/lde_tiled.cu", "plonky2_tpu/ntt/pallas_lde_tiled.py:338",
         k3[(135, 1 << 14, 3)], lde_work(135, 1 << 14, 3, k3_table_words(14, 3)),
         ("config3",)),
        ("K3", "lde_from_values_tiled_rev [136, 65536] rate 3 (config 4 wires)",
         "plonky2_tpu_torch/csrc/lde_tiled.cu", "plonky2_tpu/ntt/pallas_lde_tiled.py:338",
         k3[(136, 1 << 16, 3)], lde_work(136, 1 << 16, 3, k3_table_words(16, 3)),
         ("config4",)),
    ]
    def report(key, label, ms, nbytes, imads):
        bound_ms, bound_by = bound(nbytes, imads, sm_hz)
        log(f"[bound] {key} {label}: {nbytes / 1e6:.1f} MB, {imads / 1e6:.1f} M 32-bit "
            f"multiplies -> bound {bound_ms:.4f} ms ({bound_by}); kernel {ms:.4f} ms, "
            f"{100 * bound_ms / ms:.1f}% of the bound's speed")
        return bound_ms, bound_by

    records = []
    for key, label, source, replaces, (err, ms, plain_ms), (nbytes, imads), on in rows:
        bound_ms, bound_by = report(key, label, ms, nbytes, imads)
        launches = sum(p[key] for name, p in paths.items() if on is None or name in on)
        records.append({"name": f"{key} {label}", "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches, "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": None})
    # K2-nat at config 2's shape (on no prove path)
    report("K2-nat", "[135, 8192] rate 3 (config 2's shape)", k2_nat[(135, 1 << 13, 3)][1],
           *lde_work(135, 1 << 13, 3, k2_table_words(13, 3)))
    log("[library] none: no PyTorch call computes a Goldilocks NTT or a Poseidon "
        "permutation, so library_ms is null for every kernel")
    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
