"""Prover-side CircuitData serialization: build once, prove later — in a
different process, without re-tracing the circuit.

Host copy of `plonky2_tpu/serialization/prover_serde.py`, in the same
byte format: the same circuit gives the same bytes in both packages.  The
portable prover state is:

* the compiled arrays (selector / constant / sigma polynomials),
* the gate instance list (gate registry keys + per-row constants) — gate
  witness generators, with their tape op specs, rebuild from it,
* the copy-constraint classes (target -> representative mapping),
* every gadget hint as a `NamedGenerator` (witness/hints.py) — name +
  JSON params + dep/out targets.

The constants/sigmas LDE + Merkle tree are *recomputed* on load on the
device asked for (`compile.commit_constants_sigmas`: kernel K2 or K3, then
K1, on the card) rather than shipped: at rate 8 they are 8x the payload
and derive deterministically from the committed polynomials.
"""

from __future__ import annotations

import json
import struct

import numpy as np

from ..field import gl
from ..ir.builder import Wire
from ..prove.compile import (CircuitData, ProverData, SelectorInfo, circuit_data,
                             common_data)
from ..utils.device import DEFAULT_DEVICE, resolve_device
from ..witness import NamedGenerator
from .buffer import Buffer
from .serde import _read_config, _write_config, gate_from_key


# A target is 9 bytes: a tag, then (row, column) as two u32s for a wire
# (tag 1) or the index as a u64 for a virtual target (tag 0).
_WIRE_T = struct.Struct("<BII")
_VIRTUAL_T = struct.Struct("<BQ")


def _target_bytes(t) -> bytes:
    if isinstance(t, Wire):
        return _WIRE_T.pack(1, t.row, t.column)
    return _VIRTUAL_T.pack(0, int(t))


def _write_targets(buf: Buffer, ts) -> None:
    buf.write_u32(len(ts))
    buf._data += b"".join(map(_target_bytes, ts))


def _read_targets(buf: Buffer, n: int) -> list:
    """The next n targets (a virtual target's u64 read as its two u32 halves)."""
    end = buf._pos + _WIRE_T.size * n
    if end > len(buf._data):
        raise EOFError("buffer exhausted")
    out = [Wire(a, b) if tag else a | b << 32
           for tag, a, b in _WIRE_T.iter_unpack(memoryview(buf._data)[buf._pos:end])]
    buf._pos = end
    return out


def _write_arr(buf: Buffer, t) -> None:
    a = gl.from_tensor(t)
    buf.write_u32(a.shape[0])
    buf.write_u32(a.shape[1])
    buf._data.extend(a.astype("<u8").tobytes())


def _read_arr(buf: Buffer) -> np.ndarray:
    r = buf.read_u32()
    c = buf.read_u32()
    raw = buf._take(r * c * 8)
    a = np.frombuffer(raw, dtype="<u8").astype(np.uint64).reshape(r, c)
    if (a >= np.uint64(gl.P)).any():
        raise ValueError("non-canonical field element in a polynomial array")
    return a


def _tkey(t):
    """Canonical order of targets (sets and dicts iterate arbitrarily)."""
    return (1, t.row, t.column) if isinstance(t, Wire) else (0, int(t), 0)


def serialize_prover_data(pd: ProverData) -> bytes:
    """Raises TypeError if a gadget hint is not a NamedGenerator."""
    bad = [g for g in pd.custom_generators if not isinstance(g, NamedGenerator)]
    if bad:
        raise TypeError("non-serializable hint generators present; register them in "
                        f"witness/hints.py: {bad[:3]}")
    common = pd.common
    buf = Buffer()
    _write_config(buf, common.config)
    buf.write_u32(common.degree_bits)
    buf.write_list([g.key() for g in common.gates], buf.write_str)
    buf.write_list(common.selector_info.groups,
                   lambda grp: buf.write_list(grp, buf.write_u32))
    buf.write_u32(common.num_constants_polys)
    buf.write_u32(common.num_public_inputs)
    buf.write_u32(pd.pi_gate_row)
    _write_targets(buf, pd.pi_targets)
    buf.write_list(pd.row_gate, buf.write_u32)
    # per-row gate constants (sparse: most rows have none)
    buf.write_list(pd.instance_list,
                   lambda inst: buf.write_list([int(c) for c in inst[1]], buf.write_u64))
    _write_arr(buf, pd.selector_polys)
    _write_arr(buf, pd.constant_polys)
    _write_arr(buf, pd.sigma_polys)
    items = sorted(pd.classes.items(), key=lambda kv: _tkey(kv[0]))
    buf.write_u32(len(items))
    for rep, members in items:
        buf._data += _target_bytes(rep)
        _write_targets(buf, sorted(members, key=_tkey))
    # gadget hints; gate generators and the public-input hash generator
    # rebuild on load from the instance list
    # (hints often share one params dict, e.g. every use of a lookup
    # table: each dict is dumped once)
    dumped: dict = {}
    buf.write_u32(len(pd.custom_generators))
    for g in pd.custom_generators:
        buf.write_str(g.name)
        raw = dumped.get(id(g.params))
        if raw is None:
            raw = dumped[id(g.params)] = json.dumps(g.params)
        buf.write_str(raw)
        _write_targets(buf, g.deps)
        _write_targets(buf, g.outs)
    return buf.bytes()


def deserialize_prover_data(data: bytes, device=DEFAULT_DEVICE) -> CircuitData:
    """The circuit of `serialize_prover_data`'s bytes, its tensors on
    `device` (the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    buf = Buffer(data)
    config = _read_config(buf)
    degree_bits = buf.read_u32()
    gates = [gate_from_key(k) for k in buf.read_list(buf.read_str)]
    groups = buf.read_list(lambda: buf.read_list(buf.read_u32))
    gate_group = {gi: g for g, grp in enumerate(groups) for gi in grp}
    sel = SelectorInfo(groups=groups, unused=len(gates), gate_group=gate_group)
    num_constants_polys = buf.read_u32()
    num_public_inputs = buf.read_u32()
    pi_gate_row = buf.read_u32()
    pi_targets = _read_targets(buf, buf.read_u32())
    row_gate = buf.read_list(buf.read_u32)
    consts_per_row = buf.read_list(lambda: buf.read_list(buf.read_u64))
    sel_vals = _read_arr(buf)
    const_vals = _read_arr(buf)
    sigma_vals = _read_arr(buf)
    classes: dict = {}
    rep_map: dict = {}
    for _ in range(buf.read_u32()):
        rep = _read_targets(buf, 1)[0]
        members = _read_targets(buf, buf.read_u32())
        rep_map.update(dict.fromkeys(members, rep))
        classes[rep] = set(members)
    # equal params strings load as one shared dict, as the builder made
    # them (a lookup table's 256 pairs are written once for each use)
    custom, parsed = [], {}
    for _ in range(buf.read_u32()):
        name = buf.read_str()
        raw = buf.read_str()
        params = parsed.get(raw)
        if params is None:
            params = parsed[raw] = json.loads(raw)
        deps = _read_targets(buf, buf.read_u32())
        outs = _read_targets(buf, buf.read_u32())
        custom.append(NamedGenerator(name, params, deps, outs))
    if buf.remaining():
        raise ValueError(f"{buf.remaining()} trailing bytes")

    common = common_data(config, degree_bits, gates, sel, num_constants_polys,
                         num_public_inputs)
    instances = [(gates[gi], tuple(consts))
                 for gi, consts in zip(row_gate, consts_per_row)]
    return circuit_data(common, gl.to_tensor(sel_vals, dev), gl.to_tensor(const_vals, dev),
                        gl.to_tensor(sigma_vals, dev), instances, row_gate, pi_targets,
                        pi_gate_row, classes, rep_map, custom)
