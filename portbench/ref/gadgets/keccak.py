"""Keccak-256 in-circuit (rate 1088 / capacity 512) and its hash targets.

Host copy of `plonky2_tpu/gadgets/keccak.py` (the reference's
src/hash/types.rs Hash256Target / HashInputTarget with their witness
setters, and src/hash/keccak256.rs: the witness-side pad10*1, the 24-round
keccak-f[1600] on 25 lanes of [U32Target; 2] -- theta by
unsafe_xor_many_u64, rho and pi by lrot_u64, chi by not/and/xor, iota with
the round constants -- and the multi-block sponge with a conditional_u64
select per block).  Every builder call is made in the JAX module's order:
row order decides the graph and the proof bytes.

The round constants and rotation offsets are generated from the Keccak
spec.  The host functions `keccak256_host` and `keccak_f1600_host` are the
witness and test oracle, and `hashes/keccak_hash.py` hashes with the
permutation.  The functions taking `self` are attached to
`CircuitBuilder` as methods at import.
"""

from __future__ import annotations

from dataclasses import dataclass

from . import attach
from .biguint import BigUintTarget

RATE_BITS = 1088
STATE_BITS = 1600
LANES = 25                     # 5x5 lanes of 64 bits
RATE_LANES = RATE_BITS // 64   # 17
M64 = (1 << 64) - 1


def _gen_round_constants() -> list[int]:
    """The Keccak round constants, from the spec's LFSR."""
    rcs = []
    r = 1
    for _ in range(24):
        rc = 0
        for j in range(7):
            r = ((r << 1) ^ ((r >> 7) * 0x71)) & 0xFF
            if r & 2:
                rc ^= 1 << ((1 << j) - 1)
        rcs.append(rc)
    return rcs


def _gen_rotc_piln():
    """The rotation offsets and the pi lane order, from the spec's walk."""
    rotc, piln = [], []
    x, y = 1, 0
    for t in range(24):
        x, y = y, (2 * x + 3 * y) % 5
        rotc.append(((t + 1) * (t + 2) // 2) % 64)
        piln.append(x + 5 * y)
    return rotc, piln


RNDC = _gen_round_constants()
ROTC, PILN = _gen_rotc_piln()


# ------------------------------------------------------------------
# host oracle
# ------------------------------------------------------------------

def keccak_f1600_host(lanes: list[int]) -> list[int]:
    """keccak-f[1600] on 25 u64 lanes (Python ints)."""
    s = list(lanes)
    for rnd in range(24):
        bc = [s[i] ^ s[i + 5] ^ s[i + 10] ^ s[i + 15] ^ s[i + 20]
              for i in range(5)]
        for i in range(5):
            t = bc[(i + 4) % 5] ^ (((bc[(i + 1) % 5] << 1)
                                    | (bc[(i + 1) % 5] >> 63)) & M64)
            for j in range(0, 25, 5):
                s[j + i] ^= t
        t = s[1]
        for i in range(24):
            j = PILN[i]
            s[j], t = ((t << ROTC[i]) | (t >> (64 - ROTC[i]))) & M64, s[j]
        for j in range(0, 25, 5):
            row = s[j:j + 5]
            for i in range(5):
                s[j + i] = row[i] ^ (~row[(i + 1) % 5] & row[(i + 2) % 5] & M64)
        s[0] ^= RNDC[rnd]
    return s


def keccak256_host(data: bytes) -> bytes:
    """Ethereum Keccak-256 (padding 0x01 ... 0x80)."""
    rate_bytes = RATE_BITS // 8
    padded = bytearray(data)
    pad_len = rate_bytes - (len(data) % rate_bytes)
    padded += b"\x00" * pad_len
    padded[len(data)] ^= 0x01
    padded[-1] ^= 0x80
    lanes = [0] * LANES
    for off in range(0, len(padded), rate_bytes):
        block = padded[off:off + rate_bytes]
        for i in range(RATE_LANES):
            lanes[i] ^= int.from_bytes(block[8 * i:8 * i + 8], "little")
        lanes = keccak_f1600_host(lanes)
    return b"".join(lane.to_bytes(8, "little") for lane in lanes[:4])


# ------------------------------------------------------------------
# targets and witness setters
# ------------------------------------------------------------------

@dataclass
class HashInputTarget:
    input: BigUintTarget          # blocks_num * 34 u32 limbs, little-endian
    input_bits: int
    blocks: list                  # BoolTargets: absorb block k + 1?


# A Hash256Target is a list of 8 U32Targets (the big-endian u32 convention
# of the reference's set_hash256_target).

def add_virtual_hash_input_target(self, blocks_num: int,
                                  block_bits: int = RATE_BITS) -> HashInputTarget:
    if block_bits % 32:
        raise ValueError(f"block_bits {block_bits} is not a multiple of 32")
    total_limbs = blocks_num * block_bits // 32
    inp = self.add_virtual_biguint_target(total_limbs)
    blocks = []
    for _ in range(blocks_num - 1):
        t = self.add_virtual_target()
        self.assert_bool(t)
        blocks.append(t)
    return HashInputTarget(inp, blocks_num * block_bits, blocks)


def add_virtual_hash256_target(self) -> list:
    return [self.add_virtual_u32_target() for _ in range(8)]


def connect_hash256(self, a: list, b: list) -> None:
    for x, y in zip(a, b):
        self.connect_u32(x, y)


def set_keccak256_input_target(inputs: dict, target: HashInputTarget,
                               value: bytes) -> None:
    """The witness-side pad10*1 (keccak256.rs:22-36)."""
    v = int.from_bytes(value, "little") if value else 0
    input_len_bits = len(value) * 8
    num_actual_blocks = 1 + input_len_bits // RATE_BITS
    padded_len_bits = num_actual_blocks * RATE_BITS
    v |= 1 << input_len_bits
    v |= 1 << (padded_len_bits - 1)
    for i, t in enumerate(target.input.limbs):
        inputs[t.target] = (v >> (32 * i)) & 0xFFFFFFFF
    for i, t in enumerate(target.blocks):
        inputs[t] = 1 if i < num_actual_blocks - 1 else 0


def set_hash256_target(inputs: dict, target: list, value: bytes) -> None:
    if len(value) != 32:
        raise ValueError(f"a Keccak-256 digest has 32 bytes, got {len(value)}")
    for i in range(8):
        inputs[target[i].target] = int.from_bytes(value[4 * i:4 * i + 4], "big")


# ------------------------------------------------------------------
# circuit
# ------------------------------------------------------------------

def _keccak_f1600(self, s: list) -> list:
    """24 rounds on 25 [U32Target; 2] lanes (keccak256.rs:79-128)."""
    rndc = [[self.constant_u32(rc & 0xFFFFFFFF), self.constant_u32(rc >> 32)]
            for rc in RNDC]
    s = [list(lane) for lane in s]
    for rnd in range(24):
        bc = [self.unsafe_xor_many_u64(
            [s[i], s[i + 5], s[i + 10], s[i + 15], s[i + 20]])
            for i in range(5)]
        for i in range(5):
            t1 = self.lrot_u64(bc[(i + 1) % 5], 1)
            t2 = self.xor_u64(bc[(i + 4) % 5], t1)
            for j in range(0, 25, 5):
                s[j + i] = self.xor_u64(s[j + i], t2)
        t = s[1]
        for i in range(24):
            j = PILN[i]
            s[j], t = self.lrot_u64(t, ROTC[i]), s[j]
        for j in range(0, 25, 5):
            row = [s[j + i] for i in range(5)]
            for i in range(5):
                t1 = self.not_u64(row[(i + 1) % 5])
                t2 = self.and_u64(row[(i + 2) % 5], t1)
                s[j + i] = self.xor_u64(s[j + i], t2)
        s[0] = self.xor_u64(s[0], rndc[rnd])
    return s


def hash_keccak256(self, hash_input: HashInputTarget) -> BigUintTarget:
    """The multi-block sponge (keccak256.rs:130-177); returns the 8-limb
    output."""
    zero = self.zero_u32()
    state = [[zero, zero] for _ in range(LANES)]
    # first block: absorbed by assignment
    for i in range(RATE_LANES):
        state[i] = [hash_input.input.limbs[2 * i],
                    hash_input.input.limbs[2 * i + 1]]
    state = self._keccak_f1600(state)

    for k, blk in enumerate(hash_input.blocks):
        start = (k + 1) * RATE_LANES * 2
        nxt = []
        for i in range(LANES):
            if i < RATE_LANES:
                nxt.append([
                    self.xor_u32(state[i][0], hash_input.input.limbs[start + 2 * i]),
                    self.xor_u32(state[i][1], hash_input.input.limbs[start + 2 * i + 1]),
                ])
            else:
                nxt.append(list(state[i]))
        nxt = self._keccak_f1600(nxt)
        state = [self.conditional_u64(nxt[i], state[i], blk)
                 for i in range(LANES)]

    output = self.add_virtual_biguint_target(8)
    for i in range(4):
        self.connect_u32(state[i][0], output.limbs[2 * i])
        self.connect_u32(state[i][1], output.limbs[2 * i + 1])
    return output


# attach to CircuitBuilder
attach(globals())
