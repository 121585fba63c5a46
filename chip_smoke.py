"""Smoke run of the PyTorch/CUDA port (`plonky2_tpu_torch`) on one GPU.

Drives the port's main paths — build, save and load, witness, prove and
serialize the config-1 circuit (Poseidon chain, 2^12 rows), the config-2
circuit (u32 mul/add/xor/sub/compare, 2^13 rows) and the config-3
circuit (51 chained depth-32 SMT process proofs, 2^14 rows), all under
standard_recursion_config, the config-4 circuit (one secp256k1 ECDSA
verify, 55,421 gates, 2^16 rows, under standard_ecc_config: 136 wires)
and its batch of 2 (config4-b2, 2^17 rows), config 5 (four zkDSA proofs of a 2^2-row circuit and the 2^13-row
circuit that verifies them in-circuit, both under test_config), config 1
under poseidon2_config (every two_to_one a Poseidon2Gate row), the
reference's 4-block Keccak-256 circuit (24,883 gates, 2^15 rows) under
keccak_config (Keccak Merkle trees, transcript and grind), and the two
lookup circuits: the JAX package's `mixed_small` (u32, xor, a lookup and
nonnative ops, 2^6 rows under test_config) and `lookup8` (47,616 lookups
into an 8-bit S-box, 2^13 rows under standard_recursion_config), and
the batch-ECDSA perf driver (`bench.perf.run`) at the reference perf
binary's default batch of 20 (2^20 rows) — on the card,
after checking each hand-written kernel against its plain torch version
there, and verifies every proof with the port's host verifier:

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
                 MDS layers (small-entry split and generic mulmods), at
                 2^15 to 2^23 states (2^23: perf-b20's wires tree), and
                 at ragged batch widths
  5. K2          LDE kernel, bit-reversed (K2-rev) and natural (K2-nat)
                 order, against the plain LDEs, at config 1's shape, config
                 2's (2^13), every size of its register-group kernels
                 (2^11..2^13), the first design's body (n = 4), and rates
                 0, 1, 3 and 6
  6. K3          tiled four-step LDE kernel against the plain LDE, at
                 config 3's wire and Z shapes, config 4's wire shape
                 [136, 2^16], perf-b20's [136, 2^20] (the plain version
                 on slices of 34 polys), 2^18 to 2^20 (three register
                 groups), the odd sizes 2^15 and 2^17 (n1 != n2), one
                 polynomial, and rates 0, 1 and 6
  7. tiny        the golden tiny circuit's proof sha256
  8. config 1    proof bytes equal the JAX package's (tests/torch_port_vectors.json);
                 the built circuit saved to bytes (serialize_prover_data:
                 the JAX fixture's sha256) and loaded on the card
                 (deserialize_prover_data: its commit launches K1 and K2-rev
                 or K3, its cs_cap is the fixture's), proved twice more from
                 the loaded circuit (the second time warm) to the same
                 bytes; the witness tape's wire matrix equals the dynamic
                 scheduler's and the fixture's sha256; the builder's graph
                 digest equals the fixture's where the fixture has one
  9. config 2    the same
 10. config 3    the same
 11. config 4    the same; then K3 against the plain LDE at its wires,
                 constants/sigmas and Z/partial-products commit shapes, read
                 from its built common data
     config4-b2  `build_ecdsa(2)` (2^17 rows): the same, against the
                 fixture's `config4_b2`
 12. config1-p2 config 1's chain under poseidon2_config: the steps of 8
 13. keccak4     `bench.build_keccak256(4)`: the builder's graph digest,
                 the build, the four Ethereum trie nodes of
                 ETH_LONG_VECTORS proved, each proof's public inputs (as
                 little-endian u32s) the node's Keccak-256 digest and its
                 bytes the fixture's, each verified (and rejected
                 tampered); the circuit saved, loaded on the card (its
                 cs_cap the fixture's, K3 launched) and the first node
                 proved from it; each node's wire matrix the fixture's; the
                 time each prove spends in Keccak Merkle trees and in the
                 grind, and one plain Keccak permutation over the wires
                 tree's 2^18 leaves
 14. mixed_small `bench.build_mixed_small()`: the steps of 8 (the graph
                 digest, the build, the proof bytes, save and load, the
                 loaded and warm proves, the wire matrix, the verify
                 step); then K2-rev against the plain LDE at its three
                 commit shapes (n = 64)
 15. mesh        the device mesh (`parallel`): `sharded_prove_step` on
                 the `mesh_step` fixture's wires [136, 2^12] (rate 3, cap
                 height 4) on `make_prover_mesh()` (d = 1 on one card)
                 and on four shards of the card, its cap and sample the
                 JAX function's on its 8-device mesh (K2-nat per poly
                 shard, K1 per row shard); config 1 (d = 1 and 4),
                 config 3 (d = 4) and mixed_small (d = 8) proved with
                 `mesh=` from the circuits their phases loaded, each to
                 the fixture's bytes, beside an unsharded warm prove
                 (walls and synchronized spans, information only: the
                 shards of one card run one after another), then the
                 verify step; then K2-nat, K2-rev and K3 against their
                 plain versions at the shard shapes ([136 / 34, 2^12],
                 [34, 2^12] and [17, 64], [34, 2^14])
 16. lookup8     `bench.build_lookup_bytes(13)`: the steps of 8, each
                 proof's public inputs S[x_i] for the first four inputs
                 (S and x_i computed on the host); then K2-rev against the
                 plain LDE at its three commit shapes (the Z/logUp commit
                 [34, 2^13]); the time of its Z span (with its logUp
                 sub-span) beside config 2's, which has the same n
 17. config 5    `bench.circuits.aggregation_steps`, the code of
                 `bench.build_aggregation(4)` up to the outer build: the
                 zkDSA circuit built, its four proofs (the JAX seed's keys
                 and messages) made and verified, each equal to the
                 fixture's bytes, and the outer circuit traced; K2-rev
                 against the plain LDE at the inner circuit's three commit
                 shapes (n = 4, read from its common data); then the steps
                 of 8 for the outer circuit of 2^13 rows
 18. perf-b20    `build_ecdsa(20)` (2^20 rows): its gate count and graph
                 digest against the fixture's `config4_b20` (traced by the
                 JAX package without a build; the digest taken in a
                 forked copy of the traced builder beside the build and
                 proves), then `bench.perf.run`: the
                 build, the verifier-key round trip, a cold and a warm
                 prove (the same bytes), the proof round trip and the
                 verify with the round-tripped key; its walls, phase spans
                 and peak device memory.  Its wall is nearly all
                 host Python, so it runs in a second process on the same
                 card (`chip_smoke.py --perf-b20-process`), started before
                 phase 2 and waited for after phase 17; its output is
                 printed then

Every proof phase (7-18) ends with a verify step: the port's verifier
accepts the card's proof and rejects it with one public input (the wires
cap where there is none) or one opening changed, and the verifier key's
bytes have the fixture's sha256 and read back to the same bytes.

All checks are exact: field arithmetic has no rounding, so every tolerance
is 0.  Kernel inputs cover all of [0, p), edge values included.  Kernel
launch counts are set to 0 just before each main path (a configuration's
build and first prove (keccak4: its four proves), its load from bytes, and
config 5's inner circuit, its four proofs and the outer trace; mixed_small
and lookup8 like configs 1-4; each sharded step and each prove with
`mesh=`; perf-b20's trace, build, two proves and verify) and read just
after it.
Each kernel's bound is the larger of its bytes (each input read once,
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
    import torch
    from plonky2_tpu_torch.field import gl
    from plonky2_tpu_torch.hashes import cuda_poseidon, poseidon
    rng = np.random.RandomState(1)
    out = {}
    # 2^23: the leaves of perf-b20's wires tree (2^20 rows, rate 3)
    for b in (1 << 15, 1 << 17, 1 << 20, 1 << 23):
        s = gl.to_tensor(rand_field(rng, (12, b)), device)
        got = cuda_poseidon.permute_cols_cuda(s)
        want = poseidon.permute_cols_plain(s)
        err = require_equal(f"K1 [12, {b}]", got, want)
        ms = time_ms(lambda: cuda_poseidon.permute_cols_cuda(s))
        plain_ms = time_ms(lambda: poseidon.permute_cols_plain(s), launches=1,
                           brackets=2 if b > 1 << 20 else 5)
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
    # the card is shared with the perf-b20 process: give back the cache
    torch.cuda.empty_cache()
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


# Polys a slice of the plain LDE at [136, 2^20] rate 3: ~2.3 GB of output
# and its temporaries a slice.
K3_PLAIN_ROWS = 34


def plain_by_slices(values, rate_bits):
    """The plain LDE (`ntt.lde_from_values_rev`) over slices of
    K3_PLAIN_ROWS polys, joined: the same (coeffs, LDE) as one call."""
    import torch
    from plonky2_tpu_torch import ntt
    outs = [ntt.lde_from_values_rev(values[i:i + K3_PLAIN_ROWS], rate_bits)
            for i in range(0, values.shape[0], K3_PLAIN_ROWS)]
    coeffs = torch.cat([c for c, _ in outs])
    lde = torch.cat([lde for _, lde in outs])
    return coeffs, lde


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
    # perf-b20's wires [136, 2^20] (1.14 G LDE elements): the plain version
    # runs on slices of K3_PLAIN_ROWS polys (each poly's transform is
    # independent of the others) so that its temporaries fit the card
    out.update(_lde_check("K3", device, rng, kernel, plain_by_slices, ((136, 1 << 20),), 3,
                          plain_brackets=1))
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
    # the fixture has no verifier key for a circuit it could not build
    if "verifier_data_sha256" in want and digest != want["verifier_data_sha256"]:
        raise AssertionError(f"{tag} verifier key sha256 {digest} != fixture "
                             f"{want['verifier_data_sha256']}")
    if serialize_verifier_data(deserialize_verifier_data(vk)) != vk:
        raise AssertionError(f"{tag} verifier key does not round-trip")
    equals = "equals the fixture" if "verifier_data_sha256" in want else "(no fixture)"
    log(f"[{tag}] verify {verify_s:.3f} s (host; {CARD}): accepted; verifier key "
        f"{len(vk)} bytes, sha256 {digest} {equals} and round-trips")


def reset_launches():
    import torch
    from plonky2_tpu_torch.hashes import cuda_poseidon
    from plonky2_tpu_torch.ntt import cuda_lde, cuda_lde_tiled
    torch.cuda.synchronize()
    cuda_poseidon.LAUNCHES = cuda_lde.LAUNCHES = cuda_lde.LAUNCHES_NAT = 0
    cuda_lde_tiled.LAUNCHES = 0


def read_launches():
    from plonky2_tpu_torch.bench import kernel_launches
    return kernel_launches()


def phase_config(tag: str, device, build, want: dict, check=None):
    """Build, witness and prove one configuration on the card; save the
    built circuit to bytes and load it back on the card (the circuit cache);
    prove once from the built circuit and twice from the loaded one (the
    second time warm: its tape built).  The prover data's bytes, the loaded
    circuit's cs_cap, every proof's bytes, the public inputs and the shape
    must equal the JAX fixture entry `want` (and the builder's graph
    digest, taken before the build, where `want` has one); the tape's wire
    matrix must equal the dynamic scheduler's and the fixture's digest;
    `check(proof, inputs)`, where given, holds each proof to what the
    circuit computes; then the verify step.  -> ({path: kernel launches}:
    the build and first prove, and the load, each counted from 0 just
    before it and read just after; the circuit's common data; the three
    proves' span trees; (the loaded circuit, its tape built, and the
    inputs), which the mesh phase proves again)."""
    import numpy as np
    import torch
    from plonky2_tpu_torch import utils
    from plonky2_tpu_torch.ir.digest import graph_digest
    from plonky2_tpu_torch.prove.prover import scheduler_witness_matrix, witness_matrix
    from plonky2_tpu_torch.serialization import (deserialize_prover_data, serialize_proof,
                                                 serialize_prover_data)

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    b, inputs, meta = build()
    trace_s = time.perf_counter() - t0
    num_gates = b.num_gates()
    if "graph_sha256" in want:
        # the digest's own time is left out of the build wall
        t1 = time.perf_counter()
        digest = graph_digest(b)
        t0 += time.perf_counter() - t1
        if digest != want["graph_sha256"]:
            raise AssertionError(f"{tag} graph sha256 {digest} != JAX fixture "
                                 f"{want['graph_sha256']}")
        log(f"[{tag}] builder graph ({num_gates} gates) sha256 {digest} equals the JAX "
            f"fixture")
    t1 = time.perf_counter()
    data = b.build(device=device)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t1
    build_s = time.perf_counter() - t0
    utils.profiling_enable()
    t0 = time.perf_counter()
    proof = data.prove(inputs)
    raw = serialize_proof(proof)
    prove_s = [time.perf_counter() - t0]
    trees = [utils.last_tree()]
    launches = {tag: read_launches()}
    if check is not None:
        check(proof, inputs)

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

    # the circuit cache: bytes of the JAX package's format, loaded on the card
    utils.profiling_disable()
    t0 = time.perf_counter()
    blob = serialize_prover_data(data.prover)
    save_s = time.perf_counter() - t0
    blob_digest = hashlib.sha256(blob).hexdigest()
    if blob_digest != want["prover_data_sha256"]:
        raise AssertionError(f"{tag} prover data sha256 {blob_digest} != JAX fixture "
                             f"{want['prover_data_sha256']}")
    reset_launches()
    t0 = time.perf_counter()
    loaded = deserialize_prover_data(blob, device)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    launches[f"{tag}-load"] = read_launches()
    if [[int(x) for x in d] for d in loaded.verifier.cs_cap] != want["cs_cap"]:
        raise AssertionError(f"{tag} loaded circuit's constants/sigmas cap differs from "
                             f"the JAX fixture")
    log(f"[{tag}] prover data {len(blob)} bytes, sha256 {blob_digest} equals the JAX "
        f"fixture; saved in {save_s:.3f} s, loaded on the card in {load_s:.3f} s with its "
        f"cs_cap equal to the fixture's ({CARD})")
    log(f"[{tag}] launches on the load path: "
        + ", ".join(f"{k} {v}" for k, v in launches[f"{tag}-load"].items()) + f" ({CARD})")

    utils.profiling_enable()
    for kind in ("loaded", "loaded, warm"):
        t0 = time.perf_counter()
        again_proof = loaded.prove(inputs)
        again = serialize_proof(again_proof)
        prove_s.append(time.perf_counter() - t0)
        trees.append(utils.last_tree())
        if check is not None:
            check(again_proof, inputs)
        if hashlib.sha256(again).hexdigest() != digest:
            raise AssertionError(f"{tag} prove from the {kind} circuit gave other bytes")
    utils.profiling_disable()
    peak = torch.cuda.max_memory_allocated()

    # the witness through the tape (as the prover runs it, the tape built)
    # and through the dynamic scheduler, its reference
    t0 = time.perf_counter()
    wires, _ = witness_matrix(data.prover, inputs)
    tape_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    wires_ref, _ = scheduler_witness_matrix(data.prover, inputs)
    scheduler_s = time.perf_counter() - t0
    if not np.array_equal(wires, wires_ref):
        raise AssertionError(f"{tag} tape wire matrix differs from the dynamic "
                             f"scheduler's at {int((wires != wires_ref).sum())} positions")
    wires_digest = hashlib.sha256(np.ascontiguousarray(wires, dtype="<u8").tobytes()).hexdigest()
    if wires_digest != want["wire_matrix_sha256"]:
        raise AssertionError(f"{tag} wire matrix sha256 {wires_digest} != JAX fixture "
                             f"{want['wire_matrix_sha256']}")

    log(f"[{tag}] {meta['name']} 2^{data.common.degree_bits} ({num_gates} gates): "
        f"cs_cap, public inputs, {len(raw)} bytes and sha256 {digest} equal the JAX "
        f"fixture, proved from the built and (twice) from the loaded circuit")
    log(f"[{tag}] wire matrix {wires.shape[0]} x {wires.shape[1]}: the tape's equals the "
        f"dynamic scheduler's, sha256 {wires_digest} equals the JAX fixture")
    log(f"[{tag}] launches on the main path (build + first prove): "
        + ", ".join(f"{k} {v}" for k, v in launches[tag].items()) + f" ({CARD})")
    kinds = ("built", "loaded", "loaded, warm")
    log(f"[{tag}] build {build_s:.3f} s ({trace_s:.3f} s before and {compile_s:.3f} s in "
        f"`build()`); load {load_s:.3f} s; witness through the tape "
        f"{tape_s:.3f} s, through the scheduler {scheduler_s:.3f} s; prove "
        f"({', '.join(kinds)}) " + ", ".join(f"{t:.3f} s" for t in prove_s)
        + f"; peak device memory {peak / 2**20:.1f} MiB ({CARD})")
    for i, tree in enumerate(trees):
        log(f"[{tag}] phase spans, prove {i + 1} ({kinds[i]} circuit; "
            f"synchronized; {CARD}):")
        for line in tree.lines():
            log("  " + line)
    verify_step(tag, data, proof, want)
    common = data.common
    del data, proof
    torch.cuda.empty_cache()
    return launches, common, trees, (loaded, inputs)


def phase_config5_inner(device):
    """Config 5's work before its outer build, by the entry point's own
    code (`bench.circuits.aggregation_steps`, which `build_aggregation(4)`'s
    make() runs): the zkDSA circuit built under test_config, its four
    proofs (keys and messages from the JAX package's seed and order) made
    and verified, and the outer circuit traced.  Each proof must equal the
    fixture's bytes; then the verify step on the first.  Its launches are
    their own path, `config5-inner`, counted from 0 just before it and read
    just after.  -> ({"config5-inner": launches}, the inner circuit's common
    data, the outer builder, its inputs with the four proofs bound)."""
    import random
    import torch
    from plonky2_tpu_torch import utils, zkaa
    from plonky2_tpu_torch.bench.circuits import AGGREGATION_SEED, aggregation_steps
    from plonky2_tpu_torch.serialization import serialize_proof
    want = fixture("config5")["inner"]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    utils.profiling_enable()
    inner, proofs, b, pts = aggregation_steps(random.Random(AGGREGATION_SEED), 4, device)
    utils.profiling_disable()
    launches = {"config5-inner": read_launches()}
    tree = utils.last_tree()
    peak = torch.cuda.max_memory_allocated()
    if inner.data.common.degree_bits != want["degree_bits"]:
        raise AssertionError(f"config5 inner circuit is 2^{inner.data.common.degree_bits} "
                             f"rows, the fixture's 2^{want['degree_bits']}")
    for i, proof in enumerate(proofs):
        raw = serialize_proof(proof)
        digest = hashlib.sha256(raw).hexdigest()
        if (len(raw), digest) != (want["proof_len"][i], want["proof_sha256"][i]):
            raise AssertionError(f"config5 inner proof {i} ({len(raw)} bytes, sha256 "
                                 f"{digest}) differs from the JAX fixture")
        if list(proof.public_inputs) != want["public_inputs"][i]:
            raise AssertionError(f"config5 inner proof {i}: public inputs differ from "
                                 f"the JAX fixture")
        log(f"[config5-inner] proof {i}: {len(raw)} bytes, sha256 {digest} equals the JAX "
            f"fixture; accepted by the verifier")
    log(f"[config5-inner] zkDSA circuit 2^{inner.data.common.degree_bits} "
        f"({inner.data.common.config.num_wires} wires), four proofs and the outer "
        f"circuit's trace ({b.num_gates()} gates): {tree.elapsed:.3f} s; peak device memory "
        f"{peak / 2**20:.1f} MiB ({CARD})")
    log(f"[config5-inner] launches on the path: "
        + ", ".join(f"{k} {v}" for k, v in launches["config5-inner"].items()) + f" ({CARD})")
    log(f"[config5-inner] steps (synchronized; {CARD}):")
    for step in tree.children:
        log(f"  {step.elapsed * 1e3:9.2f}ms {step.name}")
    verify_step("config5-inner", inner.data, proofs[0], want)
    return launches, inner.data.common, b, zkaa.aggregation_witness(pts, proofs)


def span_seconds(span, prefix: str) -> float:
    """Total seconds of the spans under `span` whose name starts with
    `prefix` (none of them nests in another)."""
    if span.name.startswith(prefix):
        return span.elapsed
    return sum(span_seconds(c, prefix) for c in span.children)


def phase_keccak4(device):
    """The reference's 4-block Keccak-256 circuit under keccak_config
    (`bench.build_keccak256(4)`): the builder's graph digest against the
    fixture's, the build, and the four Ethereum trie nodes proved on the
    card, each proof's public inputs spelling the node's digest and its
    bytes the fixture's, then the verify step on each; the circuit saved to
    bytes, loaded on the card (its cs_cap the JAX build's) and the first
    node proved from it; each node's wire matrix (through the tape) the
    fixture's, the first also the dynamic scheduler's; the time of one
    plain Keccak permutation over the wires tree's leaves.  -> ({path:
    launches}, the circuit's common data): `keccak4` (the build and the
    four proves) and `keccak4-load` (the load), each counted from 0 just
    before it and read just after."""
    import numpy as np
    import torch
    from plonky2_tpu_torch import utils
    from plonky2_tpu_torch.bench.circuits import build_keccak256
    from plonky2_tpu_torch.field import gl
    from plonky2_tpu_torch.hashes import keccak_hash
    from plonky2_tpu_torch.ir.digest import graph_digest
    from plonky2_tpu_torch.prove.prover import scheduler_witness_matrix, witness_matrix
    from plonky2_tpu_torch.serialization import (deserialize_prover_data, serialize_proof,
                                                 serialize_prover_data)
    tag, want = "keccak4", fixture("keccak4")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    b, witnesses, meta = build_keccak256(4)
    trace_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    digest = graph_digest(b)
    t0 += time.perf_counter() - t1           # the digest is left out of the wall
    num_gates = b.num_gates()
    if (num_gates, digest) != (want["num_gates"], want["graph_sha256"]):
        raise AssertionError(f"{tag} graph ({num_gates} gates, sha256 {digest}) differs "
                             f"from the JAX fixture")
    log(f"[{tag}] builder graph ({num_gates} gates) sha256 {digest} equals the JAX fixture")
    data = b.build(device=device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cs_cap = [[int(x) for x in d] for d in data.verifier.cs_cap]
    if data.common.degree_bits != want["degree_bits"] or cs_cap != want["cs_cap"]:
        raise AssertionError(f"{tag}: 2^{data.common.degree_bits} rows or the "
                             f"constants/sigmas cap differ from the JAX fixture")

    def prove_one(pd_data, i, kind):
        t0 = time.perf_counter()
        proof = pd_data.prove(witnesses[i])
        raw = serialize_proof(proof)
        wall = time.perf_counter() - t0
        tree = utils.last_tree()
        pi_hex = b"".join(int(v).to_bytes(4, "little") for v in proof.public_inputs).hex()
        sha = hashlib.sha256(raw).hexdigest()
        if pi_hex != meta["digests"][i] or proof.public_inputs != want["public_inputs"][i]:
            raise AssertionError(f"{tag} node {i}: public inputs {pi_hex} are not the "
                                 f"digest {meta['digests'][i]}")
        if (len(raw), sha) != (want["proof_len"][i], want["proof_sha256"][i]):
            raise AssertionError(f"{tag} node {i} proof ({len(raw)} bytes, sha256 {sha}) "
                                 f"differs from the JAX fixture")
        log(f"[{tag}] node {i} ({kind} circuit): public inputs spell its Keccak-256 "
            f"digest {pi_hex}; {len(raw)} bytes, sha256 {sha} equals the JAX fixture; "
            f"prove {wall:.3f} s")
        log(f"[{tag}] node {i} prove: Keccak Merkle trees "
            f"{span_seconds(tree, 'Merkle tree (keccak_hash'):.3f} s")
        log(f"[{tag}] node {i} prove: PoW grind {span_seconds(tree, 'FRI PoW grind'):.3f} s")
        log(f"[{tag}] phase spans, node {i} ({kind} circuit; synchronized; {CARD}):")
        for line in tree.lines():
            log("  " + line)
        return proof, wall

    utils.profiling_enable()
    proofs, walls = [], []
    for i in range(len(witnesses)):
        proof, wall = prove_one(data, i, "built")
        proofs.append(proof)
        walls.append(wall)
    utils.profiling_disable()
    launches = {tag: read_launches()}

    blob = serialize_prover_data(data.prover)
    blob_digest = hashlib.sha256(blob).hexdigest()
    if blob_digest != want["prover_data_sha256"]:
        raise AssertionError(f"{tag} prover data sha256 {blob_digest} != JAX fixture "
                             f"{want['prover_data_sha256']}")
    reset_launches()
    t0 = time.perf_counter()
    loaded = deserialize_prover_data(blob, device)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    launches[f"{tag}-load"] = read_launches()
    if [[int(x) for x in d] for d in loaded.verifier.cs_cap] != want["cs_cap"]:
        raise AssertionError(f"{tag} loaded circuit's constants/sigmas cap differs from "
                             f"the JAX build's")
    log(f"[{tag}] prover data {len(blob)} bytes, sha256 {blob_digest} equals the JAX "
        f"fixture; loaded on the card in {load_s:.3f} s with the JAX build's cs_cap ({CARD})")
    utils.profiling_enable()
    _, wall = prove_one(loaded, 0, "loaded")
    walls.append(wall)
    utils.profiling_disable()
    peak = torch.cuda.max_memory_allocated()

    for i, inputs in enumerate(witnesses):
        wires, _ = witness_matrix(data.prover, inputs)
        if i == 0 and not np.array_equal(wires, scheduler_witness_matrix(data.prover,
                                                                         inputs)[0]):
            raise AssertionError(f"{tag} tape wire matrix differs from the scheduler's")
        wd = hashlib.sha256(np.ascontiguousarray(wires, dtype="<u8").tobytes()).hexdigest()
        if wd != want["wire_matrix_sha256"][i]:
            raise AssertionError(f"{tag} node {i} wire matrix sha256 {wd} != JAX fixture")
    log(f"[{tag}] wire matrices of the four nodes equal the JAX fixture's (the first also "
        f"the dynamic scheduler's)")
    # one absorption of the wires tree's leaf hashing, plain torch
    n_leaves = 1 << (data.common.degree_bits + data.common.config.fri.rate_bits)
    state = gl.to_tensor(rand_field(np.random.RandomState(12), (12, n_leaves)), device)
    ms = time_ms(lambda: keccak_hash.permute_cols(state), launches=1, brackets=3)
    log(f"[{tag}] Keccak permute_cols [12, {n_leaves}] (plain torch): {ms:.4f} ms "
        f"({CARD})")
    del state
    for path, counts in launches.items():
        log(f"[{tag}] launches on the {path} path: "
            + ", ".join(f"{k} {v}" for k, v in counts.items()) + f" ({CARD})")
    log(f"[{tag}] build {build_s:.3f} s ({trace_s:.3f} s before `build()`); load "
        f"{load_s:.3f} s; proves (four built, one loaded) "
        + ", ".join(f"{t:.3f} s" for t in walls)
        + f"; peak device memory {peak / 2**20:.1f} MiB ({CARD})")
    for i, proof in enumerate(proofs):
        verify_step(f"{tag} node {i}", data, proof, want)
    return launches, data.common


def check_lookup8(proof, inputs) -> None:
    """lookup8's public inputs are S[x_i] for its first four inputs, with S
    drawn on the host from the circuit's seed."""
    from plonky2_tpu_torch.bench.circuits import lookup8_sbox
    sbox = lookup8_sbox()
    want = [sbox[v] for v in list(inputs.values())[:4]]
    if list(proof.public_inputs) != want:
        raise AssertionError(f"lookup8 public inputs {proof.public_inputs} are not the "
                             f"S-box outputs {want}")
    log(f"[lookup8] public inputs {want} are S[x_i] of the first four inputs")


def log_z_spans(trees) -> None:
    """lookup8's Z span (permutation Z polys + logUp helper polys + their
    commit) beside config 2's, which has the same n and no lookups."""
    for tag in ("config2", "lookup8"):
        z = [span_seconds(t, "permutation Z polys") for t in trees[tag]]
        lk = [span_seconds(t, "lookup helper polys") for t in trees[tag]]
        q = [span_seconds(t, "quotient evaluation") for t in trees[tag]]
        log(f"[{tag}] Z span (built, loaded, warm): "
            + ", ".join(f"{v * 1e3:.2f} ms" for v in z)
            + "; its logUp sub-span " + ", ".join(f"{v * 1e3:.2f} ms" for v in lk)
            + "; quotient span " + ", ".join(f"{v * 1e3:.2f} ms" for v in q)
            + f" ({CARD})")


def phase_commits(device, tag, common):
    """Hold the LDE kernel that the commit path's dispatcher
    (`ntt.lde_from_values_rev_auto`) picks for a circuit, K2-rev up to 2^13
    rows and K3 above, at the shapes of its three commits, as its built
    common data gives them: the wires and the Z polys with the partial
    products in each prove, and [selectors | constants | sigmas] at build.
    -> (the kernel's key, {(rows, n, rate): (max_abs_err, kernel ms, plain
    ms)})."""
    import numpy as np
    import torch
    from plonky2_tpu_torch import ntt
    from plonky2_tpu_torch.gates.lookup import lookup_info
    from plonky2_tpu_torch.ntt import cuda_lde, cuda_lde_tiled
    n = 1 << common.degree_bits
    rate_bits = common.config.fri.rate_bits
    if cuda_lde.supported(n, rate_bits):
        key, kernel = "K2-rev", cuda_lde.lde_from_values_rev_cuda
    else:
        key, kernel = "K3", cuda_lde_tiled.lde_from_values_tiled_rev_cuda
    wires_rows = common.config.num_wires
    cs_rows = (len(common.selector_info.groups) + common.num_constants_polys
               + common.config.num_routed_wires)
    # Z and the partial products, then a lookup circuit's logUp block of
    # k helper polys and S per challenge
    nc = common.config.num_challenges
    zs_rows = nc * (1 + common.num_partial_products)
    lki = lookup_info(common)
    if lki["has"]:
        zs_rows += nc * (lki["k"] + 1)
    log(f"[{key}] {tag}'s wires commit [{wires_rows}, {n}], constants/sigmas commit "
        f"[{cs_rows}, {n}] and Z/partial-products{' + logUp' if lki['has'] else ''} commit "
        f"[{zs_rows}, {n}], from its common data")
    out = _lde_check(key, device, np.random.RandomState(4), kernel, ntt.lde_from_values_rev,
                     ((wires_rows, n), (cs_rows, n), (zs_rows, n)), rate_bits,
                     plain_brackets=2)
    torch.cuda.empty_cache()
    return key, out


# The mesh_step fixture's wires: __graft_entry__.entry()'s draw, 136 rows
# so that every mesh size up to 8 divides them.
MESH_STEP_SHAPE = (136, 1 << 12)


def phase_mesh_step(device):
    """`parallel.sharded_prove_step` on the fixture's wires [136, 2^12], rate
    3, cap height 4, on `make_prover_mesh()` (every card: d = 1 on one) and
    on four shards of the card, `Mesh((device,) * 4)`: its cap and the
    sha256 of its sample must equal `mesh_step` (the JAX function on its
    8-device CPU mesh).  -> {path: launches}: `mesh-step-d1` and
    `mesh-step`, each counted from 0 just before it and read just after."""
    import numpy as np
    import torch
    from plonky2_tpu_torch.field import gl
    from plonky2_tpu_torch.parallel import Mesh, make_prover_mesh, sharded_prove_step
    want = fixture("mesh_step")
    if tuple(want["shape"]) != MESH_STEP_SHAPE:
        raise AssertionError(f"mesh_step fixture shape {want['shape']} != {MESH_STEP_SHAPE}")
    wires_host = np.random.RandomState(0).randint(0, 1 << 62, size=MESH_STEP_SHAPE) \
        .astype(np.uint64)
    wires = gl.to_tensor(wires_host, device)
    launches = {}
    for path, mesh in (("mesh-step-d1", make_prover_mesh()), ("mesh-step", Mesh((device,) * 4))):
        reset_launches()
        t0 = time.perf_counter()
        cap, sample = sharded_prove_step(mesh, wires, want["rate_bits"], want["cap_height"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[path] = read_launches()
        cap = [[int(x) for x in row] for row in gl.from_tensor(cap)]
        digest = hashlib.sha256(np.ascontiguousarray(gl.from_tensor(sample), dtype="<u8")
                                .tobytes()).hexdigest()
        if cap != want["cap"] or digest != want["sample_sha256"]:
            raise AssertionError(f"{path}: sharded_prove_step on {mesh.size} shards differs "
                                 f"from the JAX fixture (sample sha256 {digest})")
        log(f"[{path}] sharded_prove_step [136, 4096] rate 3 cap height 4 on {mesh.size} "
            f"shard(s) of {mesh.devices[0]}: cap and sample sha256 {digest} equal the JAX "
            f"fixture; {wall * 1e3:.2f} ms, first call (information only; {CARD})")
        log(f"[{path}] launches: " + ", ".join(f"{k} {v}" for k, v in launches[path].items())
            + f" ({CARD})")
    return launches


def phase_mesh(device, circuits):
    """Each circuit proved again with `mesh=` from the loaded circuit (its
    tape built) that its own phase left: config 1 on `make_prover_mesh()` (d
    = 1) and on four shards of the card, config 3 on four, mixed_small on
    eight (the d of tests/test_multichip.py).  Each proof's bytes must equal
    the fixture's, the unsharded prove's; then the verify step.  Beside
    each mesh prove, an unsharded warm prove of the same circuit; their
    walls and synchronized spans are information only (shards on one card
    run one after another).  circuits: {tag: (loaded circuit, inputs, the
    fixture's key)}.  -> {path: launches}, each mesh prove counted from 0
    just before it and read just after."""
    from plonky2_tpu_torch import utils
    from plonky2_tpu_torch.parallel import Mesh, make_prover_mesh
    from plonky2_tpu_torch.serialization import serialize_proof
    launches = {}
    for path, tag, mesh in (("mesh-config1-d1", "config1", make_prover_mesh()),
                            ("mesh-config1", "config1", Mesh((device,) * 4)),
                            ("mesh-config3", "config3", Mesh((device,) * 4)),
                            ("mesh-mixed_small", "mixed_small", Mesh((device,) * 8))):
        data, inputs, key = circuits[tag]
        want = fixture(key)
        utils.profiling_enable()
        walls, trees = [], []
        for m in (None, mesh):
            if m is not None:
                reset_launches()
            t0 = time.perf_counter()
            proof = data.prove(inputs, mesh=m)
            raw = serialize_proof(proof)
            walls.append(time.perf_counter() - t0)
            trees.append(utils.last_tree())
            if m is not None:
                launches[path] = read_launches()
            digest = hashlib.sha256(raw).hexdigest()
            if (len(raw), digest) != (want["proof_len"], want["proof_sha256"]):
                raise AssertionError(f"{path}: the proof on {m.size if m else 'no'} shards "
                                     f"({len(raw)} bytes, sha256 {digest}) differs from "
                                     f"the JAX fixture")
        utils.profiling_disable()
        log(f"[{path}] {tag} proved on {mesh.size} shard(s) of {mesh.devices[0]}: {len(raw)} "
            f"bytes, sha256 {digest} equals the JAX fixture and the unsharded proof")
        log(f"[{path}] launches: " + ", ".join(f"{k} {v}" for k, v in launches[path].items())
            + f" ({CARD})")
        log(f"[{path}] wall (information only): unsharded warm prove {walls[0]:.3f} s, "
            f"on {mesh.size} shard(s) {walls[1]:.3f} s ({CARD})")
        for label, tree in (("unsharded warm prove", trees[0]),
                            (f"prove on {mesh.size} shard(s)", trees[1])):
            log(f"[{path}] phase spans, {label} (synchronized; {CARD}):")
            for line in tree.lines():
                log("  " + line)
        verify_step(path, data, proof, want)
    return launches


def fork_digest(builder):
    """Start `graph_digest(builder)` in a forked copy of this process: the
    builder as it stands (before its build), hashed in pure Python (the
    copy makes no CUDA call) while this process goes on.  -> (pid, the
    read end of a pipe that gets {"digest", "seconds"} or {"error"})."""
    from plonky2_tpu_torch.ir.digest import graph_digest
    r, w = os.pipe()
    pid = os.fork()
    if pid == 0:
        os.close(r)
        code = 0
        try:
            t0 = time.perf_counter()
            msg = {"digest": graph_digest(builder), "seconds": time.perf_counter() - t0}
        except BaseException as e:       # report it to the parent, then exit
            msg, code = {"error": repr(e)}, 1
        os.write(w, json.dumps(msg).encode())
        os._exit(code)
    os.close(w)
    return pid, r


def join_digest(pid: int, r: int) -> dict:
    """The forked digest's message, once it has exited."""
    with os.fdopen(r) as f:
        raw = f.read()
    _, status = os.waitpid(pid, 0)
    return json.loads(raw) if raw else {"error": f"no output (wait status {status})"}


def phase_perf_b20(device):
    """The batch-ECDSA perf driver (`bench.perf.run`) at the reference perf
    binary's default batch of 20 (`build_ecdsa(20)`, 2^20 rows): the
    builder's gate count and graph digest against the fixture's
    `config4_b20` (the JAX package traced it without a build; the digest,
    minutes of Python, is taken in a forked copy of the traced builder
    while this process builds and proves), then the driver's steps (build,
    the verifier-key round trip, a cold and a warm prove, the proof round
    trip, the verify with the round-tripped key and proof); the two proofs
    must have the same bytes; then the verify step on the round-tripped
    key and proof.  Runs in a process of its own (`perf_b20_main`).  ->
    ({"perf-b20": launches}, counted from 0 just after the trace, which
    launches nothing, and read just after the verify; the driver's
    result)."""
    import signal
    import types
    from plonky2_tpu_torch.bench import build_ecdsa, perf
    from plonky2_tpu_torch.prove.verifier import verify
    tag, want = "perf-b20", fixture("config4_b20")
    t0 = time.perf_counter()
    b, inputs, _meta = build_ecdsa(want["batch"])
    trace_s = time.perf_counter() - t0
    num_gates = b.num_gates()
    if num_gates != want["num_gates"]:
        raise AssertionError(f"{tag}: {num_gates} gates, the JAX fixture {want['num_gates']}")
    log(f"[{tag}] batch={want['batch']} num_gates={num_gates} (trace {trace_s:.3f}s; {CARD})")
    # before the first CUDA call of this process: the fork copies no context
    digest_pid, digest_pipe = fork_digest(b)
    try:
        reset_launches()
        res = perf.run(b, inputs, device, emit=lambda line: log(f"[{tag}] {line}"))
        del b, inputs
        launches = {tag: read_launches()}
        msg = join_digest(digest_pid, digest_pipe)
        digest_pid = None
    finally:
        if digest_pid is not None:
            os.kill(digest_pid, signal.SIGKILL)
            join_digest(digest_pid, digest_pipe)
    if msg.get("digest") != want["graph_sha256"]:
        raise AssertionError(f"{tag} graph digest {msg} differs from the JAX fixture's "
                             f"{want['graph_sha256']}")
    log(f"[{tag}] builder graph ({num_gates} gates) sha256 {msg['digest']} equals the JAX "
        f"fixture (taken of the traced builder in a forked copy, {msg['seconds']:.3f} s; "
        f"{CARD})")
    cold, warm = res["proofs"]
    if cold != warm:
        raise AssertionError(f"{tag}: the cold and the warm prove gave other bytes")
    log(f"[{tag}] cold and warm proofs: {len(cold)} bytes each, the same bytes, sha256 "
        f"{hashlib.sha256(cold).hexdigest()}")
    log(f"[{tag}] walls: trace {trace_s:.3f} s, build {res['build_s']:.3f} s, prove "
        f"(cold, warm) {res['prove_s'][0]:.3f} s, {res['prove_s'][1]:.3f} s, verify "
        f"{res['verify_s']:.3f} s; peak device memory: build "
        f"{res['peak_bytes']['build'] / 2**20:.1f} MiB, proves "
        f"{res['peak_bytes']['proves'] / 2**20:.1f} MiB ({CARD})")
    for step in perf.STEPS:
        log(f"[{tag}] launches, {step}: "
            + ", ".join(f"{k} {v}" for k, v in res["launches"][step].items()) + f" ({CARD})")
    log(f"[{tag}] launches on the path: "
        + ", ".join(f"{k} {v}" for k, v in launches[tag].items()) + f" ({CARD})")
    for step in perf.STEPS:
        log(f"[{tag}] phase spans, {step} (synchronized; {CARD}):")
        for line in res["trees"][step].lines():
            log("  " + line)
    vd = res["vd"]
    checked = types.SimpleNamespace(verifier=vd, verify=lambda proof: verify(vd, proof))
    verify_step(tag, checked, res["proof"], want)
    return launches, res


# The longest the perf-b20 process may run, from its start just before
# the kernels' build (the whole run must end within 1200 s).
PERF_B20_TIMEOUT_S = 1080

# chip_smoke.py's argument that runs the perf-b20 path alone: the process
# that `start_perf_b20` starts beside the other paths.
PERF_B20_FLAG = "--perf-b20-process"


def start_perf_b20():
    """Start the perf-b20 path (`phase_perf_b20`) in a second process on
    the same card, beside the other paths: most of its wall (the trace,
    the build's copy classes and generator schedule, the first prove's
    tape) is host Python, which runs on one core at 2^20 rows.  Its
    kernel counts are its own (0 when it starts, reset just before its
    trace); its output goes to a temporary file.  -> (process, file)."""
    import tempfile
    out = tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), PERF_B20_FLAG],
                            stdout=out, stderr=subprocess.STDOUT, cwd=ROOT)
    return proc, out


def finish_perf_b20(proc, out, deadline: float) -> dict:
    """Wait for the perf-b20 process (killed at `deadline`, a
    `time.perf_counter()` value), print its output, and fail if it failed.
    -> {"perf-b20": launches}, the JSON of its last line."""
    try:
        rc = proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = None
    out.seek(0)
    lines = out.read().splitlines()
    out.close()
    for line in lines:
        log(line)
    if rc != 0:
        raise AssertionError(f"the perf-b20 process {'timed out' if rc is None else 'failed'}"
                             f" (exit {rc})")
    return json.loads(lines[-1])


def perf_b20_main() -> int:
    """The perf-b20 process: `phase_perf_b20` on the first card; its last
    line is {"perf-b20": launches}."""
    sys.path.insert(0, ROOT)
    import torch
    global CARD
    CARD = _smi("name,power.limit")
    launches, _ = phase_perf_b20(torch.device("cuda", 0))
    log(json.dumps(launches))
    return 0


def phase_mesh_kernels(device):
    """The LDE kernels at the mesh paths' shard shapes, rate 3: K2-nat at
    mesh-step's [136, 2^12] (one shard) and [34, 2^12] (four); K2-rev at
    mesh-config1's wires shard [34, 2^12] and mesh-mixed_small's [17, 64];
    K3 at mesh-config3's wires shard [34, 2^14].  -> (K2-nat, K2-rev, K3)
    as `_lde_check` gives them."""
    import numpy as np
    import torch
    from plonky2_tpu_torch import ntt
    from plonky2_tpu_torch.ntt import cuda_lde, cuda_lde_tiled
    rng = np.random.RandomState(14)
    nat = _lde_check("K2-nat", device, rng, cuda_lde.lde_from_values_cuda,
                     ntt.lde_from_values, ((136, 1 << 12), (34, 1 << 12)), 3)
    rev = _lde_check("K2-rev", device, rng, cuda_lde.lde_from_values_rev_cuda,
                     ntt.lde_from_values_rev, ((34, 1 << 12), (17, 64)), 3)
    k3 = _lde_check("K3", device, rng, cuda_lde_tiled.lde_from_values_tiled_rev_cuda,
                    ntt.lde_from_values_rev, ((34, 1 << 14),), 3, plain_brackets=2)
    torch.cuda.empty_cache()
    return nat, rev, k3


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch
    name, sm_hz = phase_device()
    device = torch.device("cuda", 0)
    # the reference perf binary's batch of 20 through the port's perf
    # driver, in a second process from here to the end (its first kernel
    # launch comes minutes after the kernels' build below)
    deadline = time.perf_counter() + PERF_B20_TIMEOUT_S
    perf_proc, perf_out = start_perf_b20()
    try:
        phase_build()
        return run_paths(device, name, sm_hz, perf_proc, perf_out, deadline)
    finally:
        if perf_proc.poll() is None:
            perf_proc.kill()
            perf_proc.wait()


def run_paths(device, name: str, sm_hz: float, perf_proc, perf_out, deadline: float) -> int:
    """Every phase after the kernels' build, the perf-b20 process running
    beside them; its result is read at the end (`finish_perf_b20`)."""
    import torch
    t_start = time.perf_counter()
    phase_field(device)
    k1 = phase_k1(device)
    k2_rev, k2_nat = phase_k2(device)
    k3 = phase_k3(device)
    phase_tiny(device)

    from plonky2_tpu_torch.bench import (build_ecdsa, build_lookup_bytes,
                                         build_mixed_small, build_poseidon_chain,
                                         build_smt_process, build_u32_mix)
    paths, common, trees, circuits = {}, {}, {}, {}
    for path, key, build in (("config1", "config1", lambda: build_poseidon_chain(12)),
                             ("config2", "config2", lambda: build_u32_mix(13)),
                             ("config3", "config3", lambda: build_smt_process(14)),
                             ("config4", "config4", lambda: build_ecdsa(1)),
                             ("config4-b2", "config4_b2", lambda: build_ecdsa(2))):
        launches, common[path], trees[path], loaded = phase_config(path, device, build,
                                                                   fixture(key))
        paths.update(launches)
        if path in ("config1", "config3"):
            circuits[path] = (*loaded, path)
    from plonky2_tpu_torch.ir import CircuitConfig
    launches, common["config1-p2"], _, _ = phase_config(
        "config1-p2", device,
        lambda: build_poseidon_chain(12, CircuitConfig.poseidon2_config()),
        fixture("config1_p2"))
    paths.update(launches)
    launches, common["keccak4"] = phase_keccak4(device)
    paths.update(launches)
    launches, common["mixed_small"], _, loaded = phase_config(
        "mixed_small", device, build_mixed_small, fixture("mixed_small"))
    paths.update(launches)
    circuits["mixed_small"] = (*loaded, "mixed_small")
    # the mesh: the sharded step, then configs 1 and 3 and mixed_small
    # proved again on shards of the card
    paths.update(phase_mesh_step(device))
    paths.update(phase_mesh(device, circuits))
    del circuits
    for held_out, mesh_out in zip((k2_nat, k2_rev, k3), phase_mesh_kernels(device)):
        held_out.update(mesh_out)
    launches, common["lookup8"], trees["lookup8"], _ = phase_config(
        "lookup8", device, build_lookup_bytes, fixture("lookup8"),
        check=check_lookup8)
    paths.update(launches)
    log_z_spans(trees)
    held = {"K2-rev": k2_rev, "K3": k3}
    for path in ("keccak4", "config4", "config4-b2", "mixed_small", "lookup8"):
        key, out = phase_commits(device, path, common[path])
        held[key].update(out)
    # config 5: the inner circuit, its proofs and the outer trace are one
    # path; the outer build and first prove, and its load, are the others
    launches, common["config5-inner"], b5, inputs5 = phase_config5_inner(device)
    paths.update(launches)
    key, out = phase_commits(device, "config5-inner", common["config5-inner"])
    held[key].update(out)
    launches, common["config5"], _, _ = phase_config(
        "config5", device, lambda: (b5, inputs5, {"name": "aggregation_4"}),
        fixture("config5")["outer"])
    paths.update(launches)
    log(f"[perf-b20] the other paths took {time.perf_counter() - t_start:.1f} s; waiting "
        f"for the perf-b20 process")
    paths.update(finish_perf_b20(perf_proc, perf_out, deadline))
    required = {"config1": ("K1", "K2-rev"), "config2": ("K1", "K2-rev"),
                "config3": ("K1", "K3"), "config4": ("K1", "K3"),
                "config4-b2": ("K1", "K3"),
                "config5": ("K1", "K2-rev"), "config1-p2": ("K1", "K2-rev"),
                "keccak4": ("K3",), "mixed_small": ("K1", "K2-rev"),
                "lookup8": ("K1", "K2-rev")}
    required.update({f"{path}-load": kernels for path, kernels in list(required.items())})
    required["config5-inner"] = ("K1", "K2-rev")
    required.update({"mesh-step-d1": ("K1", "K2-nat"), "mesh-step": ("K1", "K2-nat"),
                     "mesh-config1-d1": ("K1", "K2-rev"), "mesh-config1": ("K1", "K2-rev"),
                     "mesh-config3": ("K1", "K3"), "mesh-mixed_small": ("K1", "K2-rev"),
                     "perf-b20": ("K1", "K3")})
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
        ("K1", "poseidon permute_cols [12, 8388608] (perf-b20 leaf hashing)",
         "plonky2_tpu_torch/csrc/poseidon.cu", "plonky2_tpu/hashes/pallas_poseidon.py:191",
         k1[1 << 23], poseidon_work(1 << 23), ("perf-b20",)),
        ("K2-rev", "lde_from_values_rev [135, 4096] rate 3 (config 1 wires)",
         "plonky2_tpu_torch/csrc/lde.cu", "plonky2_tpu/ntt/pallas_lde.py:316",
         k2_rev[(135, 4096, 3)], lde_work(135, 4096, 3, k2_table_words(12, 3)),
         ("config1", "config1-load", "config1-p2", "config1-p2-load", "mesh-config1-d1")),
        ("K2-rev", "lde_from_values_rev [34, 4096] rate 3 (config 1 wires, a shard of 4)",
         "plonky2_tpu_torch/csrc/lde.cu", "plonky2_tpu/ntt/pallas_lde.py:316",
         k2_rev[(34, 4096, 3)], lde_work(34, 4096, 3, k2_table_words(12, 3)),
         ("mesh-config1",)),
        ("K2-rev", "lde_from_values_rev [135, 8192] rate 3 (config 2 and 5 wires)",
         "plonky2_tpu_torch/csrc/lde.cu", "plonky2_tpu/ntt/pallas_lde.py:316",
         k2_rev[(135, 1 << 13, 3)], lde_work(135, 1 << 13, 3, k2_table_words(13, 3)),
         ("config2", "config2-load", "config5", "config5-load")),
        ("K2-rev", "lde_from_values_rev [135, 4] rate 3 (config 5 inner wires)",
         "plonky2_tpu_torch/csrc/lde.cu", "plonky2_tpu/ntt/pallas_lde.py:316",
         k2_rev[(135, 4, 3)], lde_work(135, 4, 3, k2_table_words(2, 3)),
         ("config5-inner",)),
        ("K2-rev", "lde_from_values_rev [135, 64] rate 3 (mixed_small wires)",
         "plonky2_tpu_torch/csrc/lde.cu", "plonky2_tpu/ntt/pallas_lde.py:316",
         k2_rev[(135, 64, 3)], lde_work(135, 64, 3, k2_table_words(6, 3)),
         ("mixed_small", "mixed_small-load")),
        ("K2-rev", "lde_from_values_rev [17, 64] rate 3 (mixed_small wires, a shard of 8)",
         "plonky2_tpu_torch/csrc/lde.cu", "plonky2_tpu/ntt/pallas_lde.py:316",
         k2_rev[(17, 64, 3)], lde_work(17, 64, 3, k2_table_words(6, 3)),
         ("mesh-mixed_small",)),
        ("K2-rev", "lde_from_values_rev [34, 8192] rate 3 (lookup8 Z + logUp)",
         "plonky2_tpu_torch/csrc/lde.cu", "plonky2_tpu/ntt/pallas_lde.py:316",
         k2_rev[(34, 1 << 13, 3)], lde_work(34, 1 << 13, 3, k2_table_words(13, 3)),
         ("lookup8", "lookup8-load")),
        ("K2-nat", "lde_from_values [136, 4096] rate 3 (mesh-step, one shard)",
         "plonky2_tpu_torch/csrc/lde.cu", "plonky2_tpu/ntt/pallas_lde.py:303",
         k2_nat[(136, 4096, 3)], lde_work(136, 4096, 3, k2_table_words(12, 3)),
         ("mesh-step-d1",)),
        ("K2-nat", "lde_from_values [34, 4096] rate 3 (mesh-step, a shard of 4)",
         "plonky2_tpu_torch/csrc/lde.cu", "plonky2_tpu/ntt/pallas_lde.py:303",
         k2_nat[(34, 4096, 3)], lde_work(34, 4096, 3, k2_table_words(12, 3)),
         ("mesh-step",)),
        ("K3", "lde_from_values_tiled_rev [135, 16384] rate 3 (config 3 wires)",
         "plonky2_tpu_torch/csrc/lde_tiled.cu", "plonky2_tpu/ntt/pallas_lde_tiled.py:338",
         k3[(135, 1 << 14, 3)], lde_work(135, 1 << 14, 3, k3_table_words(14, 3)),
         ("config3", "config3-load")),
        ("K3", "lde_from_values_tiled_rev [34, 16384] rate 3 (config 3 wires, a shard of 4)",
         "plonky2_tpu_torch/csrc/lde_tiled.cu", "plonky2_tpu/ntt/pallas_lde_tiled.py:338",
         k3[(34, 1 << 14, 3)], lde_work(34, 1 << 14, 3, k3_table_words(14, 3)),
         ("mesh-config3",)),
        ("K3", "lde_from_values_tiled_rev [135, 32768] rate 3 (keccak4 wires)",
         "plonky2_tpu_torch/csrc/lde_tiled.cu", "plonky2_tpu/ntt/pallas_lde_tiled.py:338",
         k3[(135, 1 << 15, 3)], lde_work(135, 1 << 15, 3, k3_table_words(15, 3)),
         ("keccak4", "keccak4-load")),
        ("K3", "lde_from_values_tiled_rev [136, 65536] rate 3 (config 4 wires)",
         "plonky2_tpu_torch/csrc/lde_tiled.cu", "plonky2_tpu/ntt/pallas_lde_tiled.py:338",
         k3[(136, 1 << 16, 3)], lde_work(136, 1 << 16, 3, k3_table_words(16, 3)),
         ("config4", "config4-load")),
        ("K3", "lde_from_values_tiled_rev [136, 131072] rate 3 (config4-b2 wires)",
         "plonky2_tpu_torch/csrc/lde_tiled.cu", "plonky2_tpu/ntt/pallas_lde_tiled.py:338",
         k3[(136, 1 << 17, 3)], lde_work(136, 1 << 17, 3, k3_table_words(17, 3)),
         ("config4-b2", "config4-b2-load")),
        ("K3", "lde_from_values_tiled_rev [136, 1048576] rate 3 (perf-b20 wires)",
         "plonky2_tpu_torch/csrc/lde_tiled.cu", "plonky2_tpu/ntt/pallas_lde_tiled.py:338",
         k3[(136, 1 << 20, 3)], lde_work(136, 1 << 20, 3, k3_table_words(20, 3)),
         ("perf-b20",)),
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
    # K2-nat at config 2's shape (held, on no path)
    report("K2-nat", "[135, 8192] rate 3 (config 2's shape)", k2_nat[(135, 1 << 13, 3)][1],
           *lde_work(135, 1 << 13, 3, k2_table_words(13, 3)))
    log("[library] none: no PyTorch call computes a Goldilocks NTT or a Poseidon "
        "permutation, so library_ms is null for every kernel")
    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(perf_b20_main() if PERF_B20_FLAG in sys.argv[1:] else main())
