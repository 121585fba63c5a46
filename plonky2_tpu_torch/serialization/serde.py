"""Proof and verifier-key (de)serialization.

Host copy of `plonky2_tpu/serialization/serde.py`: the byte formats of the
JAX package, so a proof or a verifier key written by either package reads
in the other.  Every gate serializes as its `key()` string and is rebuilt
through `gate_from_key`, whose registry holds exactly the ported gates; a
gate that the JAX package registers but the port does not carry yet raises
NotImplementedError naming it.  The transcript and in-circuit hashers are
Poseidon, written as the name "poseidon" twice.
"""

from __future__ import annotations

import re

from ..field import gl
from ..fri.fri import (FriConfig, FriInitialOpening, FriProof, FriQueryRound,
                       FriQueryStep)
from ..ir.config import HASHER, CircuitConfig
from ..prove.compile import CommonData, SelectorInfo, VerifierData
from ..prove.proof import OpeningSet, Proof
from .buffer import Buffer

# ------------------------------------------------------------------
# gate registry
# ------------------------------------------------------------------

# Gates of the JAX registry that the port does not carry yet.
NOT_PORTED = ("Lookup", "LookupTable", "Poseidon2", "Exponentiation",
              "ArithmeticExtension", "MulExtension", "Reducing",
              "ReducingExtension", "CosetInterpolation")


def _registry():
    from ..gates import (ArithmeticGate, BaseSumGate, ConstantGate, NoopGate,
                         PoseidonGate, PublicInputGate)
    from ..gates.comparison import ComparisonGate, U32SubtractionGate
    from ..gates.random_access import RandomAccessGate
    from ..gates.u32_arithmetic import (U32AddManyGate, U32ArithmeticGate,
                                        U32RangeCheckGate)
    from ..gates.u32_interleave import (U32InterleaveGate,
                                        UninterleaveToB32Gate,
                                        UninterleaveToU32Gate)
    return {
        "Arithmetic": lambda a: ArithmeticGate(num_ops=a["num_ops"]),
        "BaseSum": lambda a: BaseSumGate(a["base"], a["limbs"]),
        "Constant": lambda a: ConstantGate(num_consts=a["num_consts"]),
        "PublicInput": lambda a: PublicInputGate(),
        "Noop": lambda a: NoopGate(),
        "Poseidon": lambda a: PoseidonGate(),
        "U32Arithmetic": lambda a: U32ArithmeticGate(num_ops=a["num_ops"]),
        "U32AddMany": lambda a: U32AddManyGate(a["num_addends"], a["num_ops"]),
        "U32RangeCheck": lambda a: U32RangeCheckGate(num_ops=a["num_ops"]),
        "U32Interleave": lambda a: U32InterleaveGate(num_ops=a["num_ops"]),
        "UninterleaveToU32":
            lambda a: UninterleaveToU32Gate(num_ops=a["num_ops"]),
        "UninterleaveToB32":
            lambda a: UninterleaveToB32Gate(num_ops=a["num_ops"]),
        "U32Subtraction": lambda a: U32SubtractionGate(num_ops=a["num_ops"]),
        "Comparison": lambda a: ComparisonGate(num_bits=a["num_bits"]),
        "RandomAccess":
            lambda a: RandomAccessGate(a["bits"], a["num_copies"]),
    }


_KEY_RE = re.compile(r"^(\w+)(?:\((.*)\))?$")


def gate_from_key(key: str):
    """Rebuild a gate object from its `key()` string."""
    m = _KEY_RE.match(key)
    if not m:
        raise ValueError(f"unparsable gate key: {key}")
    name, argstr = m.group(1), m.group(2)
    args = {}
    if argstr:
        for part in argstr.split(","):
            k, v = part.split("=")
            args[k.strip()] = int(v)
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"{name} gate is not ported to plonky2_tpu_torch yet")
    reg = _registry()
    if name not in reg:
        raise ValueError(f"unknown gate: {name}")
    gate = reg[name](args)
    if gate.key() != key:
        raise ValueError(f"registry mismatch: {gate.key()} != {key}")
    return gate


# ------------------------------------------------------------------
# proof
# ------------------------------------------------------------------

def _write_cap(buf: Buffer, cap) -> None:
    buf.write_list(cap, buf.write_digest)


def _read_cap(buf: Buffer):
    return buf.read_list(buf.read_digest)


def serialize_proof(proof) -> bytes:
    buf = Buffer()
    _write_cap(buf, proof.wires_cap)
    _write_cap(buf, proof.zs_pp_cap)
    _write_cap(buf, proof.quotient_cap)

    o = proof.openings
    for group in (o.constants_sigmas, o.wires, o.zs_partial_products,
                  o.zs_next, o.quotient):
        buf.write_list(group, buf.write_ext)

    f = proof.fri
    buf.write_list(f.commit_caps, lambda cap: _write_cap(buf, cap))

    def write_round(qr):
        def write_initial(init):
            buf.write_list(init.leaf_values, lambda v: buf.write_field(int(v)))
            buf.write_list(init.siblings, buf.write_digest)
        buf.write_list(qr.initial, write_initial)

        def write_step(st):
            buf.write_list(st.evals, buf.write_ext)
            buf.write_list(st.siblings, buf.write_digest)
        buf.write_list(qr.steps, write_step)

    buf.write_list(f.query_rounds, write_round)
    buf.write_list(f.final_poly, buf.write_ext)
    buf.write_u64(int(f.pow_witness))

    buf.write_list(proof.public_inputs, lambda v: buf.write_field(int(v)))
    return buf.bytes()


def deserialize_proof(data: bytes) -> Proof:
    buf = Buffer(data)
    wires_cap = _read_cap(buf)
    zs_pp_cap = _read_cap(buf)
    quotient_cap = _read_cap(buf)

    groups = [buf.read_list(buf.read_ext) for _ in range(5)]
    openings = OpeningSet(*groups)

    commit_caps = buf.read_list(lambda: _read_cap(buf))

    def read_round():
        def read_initial():
            leaf_values = buf.read_list(buf.read_field)
            siblings = buf.read_list(buf.read_digest)
            return FriInitialOpening(leaf_values, siblings)
        initial = buf.read_list(read_initial)

        def read_step():
            evals = buf.read_list(buf.read_ext)
            siblings = buf.read_list(buf.read_digest)
            return FriQueryStep(evals, siblings)
        steps = buf.read_list(read_step)
        return FriQueryRound(initial, steps)

    query_rounds = buf.read_list(read_round)
    final_poly = buf.read_list(buf.read_ext)
    pow_witness = buf.read_u64()
    public_inputs = buf.read_list(buf.read_field)

    fri = FriProof(commit_caps=commit_caps, query_rounds=query_rounds,
                   final_poly=final_poly, pow_witness=pow_witness)
    if buf.remaining():
        raise ValueError(f"{buf.remaining()} trailing bytes")
    return Proof(wires_cap=wires_cap, zs_pp_cap=zs_pp_cap,
                 quotient_cap=quotient_cap, openings=openings, fri=fri,
                 public_inputs=public_inputs)


# ------------------------------------------------------------------
# verifier key
# ------------------------------------------------------------------

def _write_config(buf: Buffer, cfg: CircuitConfig) -> None:
    for v in (cfg.num_wires, cfg.num_routed_wires, cfg.num_constants,
              cfg.num_challenges, cfg.security_bits,
              cfg.max_quotient_degree_factor):
        buf.write_u32(v)
    f = cfg.fri
    for v in (f.rate_bits, f.cap_height, f.proof_of_work_bits,
              f.num_query_rounds, f.arity_bits, f.final_poly_bits):
        buf.write_u32(v)
    buf.write_str(HASHER)          # in-circuit hasher
    buf.write_str(HASHER)          # transcript / Merkle hasher


def _read_config(buf: Buffer) -> CircuitConfig:
    vals = [buf.read_u32() for _ in range(6)]
    fvals = [buf.read_u32() for _ in range(6)]
    for role in ("in-circuit", "transcript"):
        name = buf.read_str()
        if name != HASHER:
            raise NotImplementedError(
                f"{role} hasher {name!r} is not ported to plonky2_tpu_torch "
                f"yet (only {HASHER!r})")
    return CircuitConfig(num_wires=vals[0], num_routed_wires=vals[1],
                         num_constants=vals[2], num_challenges=vals[3],
                         security_bits=vals[4],
                         max_quotient_degree_factor=vals[5],
                         fri=FriConfig(*fvals))


def serialize_verifier_data(vd: VerifierData) -> bytes:
    c = vd.common
    buf = Buffer()
    _write_config(buf, c.config)
    buf.write_u32(c.degree_bits)
    buf.write_list([g.key() for g in c.gates], buf.write_str)
    buf.write_list(c.selector_info.groups,
                   lambda grp: buf.write_list(grp, buf.write_u32))
    buf.write_u32(c.num_constants_polys)
    buf.write_u32(c.num_public_inputs)
    _write_cap(buf, vd.cs_cap)
    return buf.bytes()


def deserialize_verifier_data(data: bytes) -> VerifierData:
    buf = Buffer(data)
    config = _read_config(buf)
    degree_bits = buf.read_u32()
    gates = [gate_from_key(k) for k in buf.read_list(buf.read_str)]
    groups = buf.read_list(lambda: buf.read_list(buf.read_u32))
    num_constants_polys = buf.read_u32()
    num_public_inputs = buf.read_u32()
    cs_cap = _read_cap(buf)
    if buf.remaining():
        raise ValueError(f"{buf.remaining()} trailing bytes")

    gate_group = {gi: g for g, grp in enumerate(groups) for gi in grp}
    sel = SelectorInfo(groups=groups, unused=len(gates), gate_group=gate_group)
    nr = config.num_routed_wires
    common = CommonData(
        config=config,
        degree_bits=degree_bits,
        gates=gates,
        selector_info=sel,
        num_constants_polys=num_constants_polys,
        k_is=[pow(gl.GENERATOR, i, gl.P) for i in range(nr)],
        num_public_inputs=num_public_inputs,
        num_partial_products=(nr + config.max_quotient_degree_factor - 1)
        // config.max_quotient_degree_factor - 1,
        chunk_size=config.max_quotient_degree_factor,
    )
    return VerifierData(common=common, cs_cap=cs_cap)
