"""The yardstick's arithmetic: the least time the chip could take for a
commit's work, and the device's busy time from a profiler trace.

`bound`, `lde_work`, `k2_table_words`, `k3_table_words` and
`poseidon_work` are copies of the functions of the same names in the
repository's `chip_smoke.py`, with the chip's peaks taken from
`peaks.json` instead of module constants; `busy_us` is a copy of
`plonky2_tpu_torch/bench/profile.py`'s `_busy_us`.  The work is counted
from shapes alone, so it reads the same whatever implements it.
"""

from __future__ import annotations

import json
from pathlib import Path

MULMOD_IMADS = 4                 # a 64 x 64 -> 128-bit product: four 32 x 32 -> 64 products
DIGEST = 4                       # elements of a Poseidon digest
RATE = 8                         # elements a Poseidon sponge absorbs a permutation


def peaks(kind: str) -> dict:
    """The peaks of the card whose `torch.cuda.get_device_name()` is `kind`
    (`peaks.json`, matched by its longest entry that `kind` starts with)."""
    table = json.loads((Path(__file__).parent / "peaks.json").read_text())
    names = [k for k in table if kind.startswith(k)]
    if not names:
        raise KeyError(f"no peaks for {kind!r} in peaks.json")
    return table[max(names, key=len)]


def bound(nbytes: int, imads: int, pk: dict):
    """(bound_ms, bound_by): the larger of the memory time and the integer
    multiply time."""
    mem_ms = nbytes / pk["hbm_bytes_per_s"] * 1e3
    ops_ms = imads / (pk["imad_per_clock_per_sm"] * pk["sms"] * pk["sm_hz"]) * 1e3
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
    """Words of the tables of the fused LDE (n <= 2^13): the roots of unity
    each way (n / 2 words each) and the [2^rate, n] coset scale table."""
    n = 1 << log_n
    return n + (n << rate_bits)


def k3_table_words(log_n: int, rate_bits: int) -> int:
    """Words of the four-step identity's tables (n >= 2^14): the column and
    row roots (n1 / 2 and n2 / 2 each way), the inverse and forward
    inter-pass twiddles [n1, n2], and the scale factors u [2^rate, n1], v
    [2^rate, n2]."""
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


def tree_permutations(leaves: int, leaf_len: int, cap_height: int) -> int:
    """Poseidon permutations of a cap-rooted Merkle tree: each leaf longer
    than a digest is absorbed RATE elements a permutation, and each
    internal node below the cap is one two-to-one hash."""
    per_leaf = -(-leaf_len // RATE) if leaf_len > DIGEST else 0
    return leaves * per_leaf + max(leaves - (1 << cap_height), 0)


def commit_bound_ms(num_polys: int, log_n: int, rate_bits: int, cap_height: int,
                    pk: dict) -> float:
    """The least time of one commit: the LDE of values [num_polys, 2^log_n]
    at `rate_bits`, then the Merkle tree over its 2^(log_n + rate_bits)
    rows of num_polys elements; each bounded on its own, the two summed."""
    n = 1 << log_n
    tables = k2_table_words(log_n, rate_bits) if log_n <= 13 else \
        k3_table_words(log_n, rate_bits)
    lde_ms, _ = bound(*lde_work(num_polys, n, rate_bits, tables), pk)
    perms = tree_permutations(n << rate_bits, num_polys, cap_height)
    tree_ms, _ = bound(*poseidon_work(perms), pk)
    return lde_ms + tree_ms


def busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals, in us."""
    busy, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(intervals):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy += cur_end - cur_start
    return busy
