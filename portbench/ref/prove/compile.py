"""Circuit compilation: builder graph -> tensor-form proving/verifying keys.

Counterpart of `plonky2_tpu/prove/compile.py`: place the public-input gate,
pad to a power of two with noops, group gates into selector polynomials,
pack per-gate constants into constant polynomials, resolve the
copy-constraint union-find into sigma polynomials (one `index_select` of
the label table), LDE + Merkle-commit the constants/sigmas oracle through
`lde_from_values_rev_auto` (kernel K2 or K3 on the card) and the config's
transcript hasher, and freeze the witness-generator schedule.  Every tensor
of `ProverData` lives on the device given to `compile_circuit`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..field import gl
from ..gates import NoopGate, PublicInputGate
from ..merkle import MerkleTree
from ..ntt import host_powers, lde_from_values_rev_auto
from ..utils.device import DEFAULT_DEVICE, resolve_device
from ..witness import LambdaGenerator


@dataclass
class SelectorInfo:
    groups: list          # list[list[int]] — gate indices per selector poly
    unused: int           # selector value on foreign rows
    gate_group: dict      # gate index -> group index


@dataclass
class CommonData:
    config: object
    degree_bits: int
    gates: list           # unique gate objects, index = selector value
    selector_info: SelectorInfo
    num_constants_polys: int
    k_is: list            # coset shifts per routed wire (host ints)
    num_public_inputs: int
    num_partial_products: int   # per challenge
    chunk_size: int


@dataclass
class ProverData:
    common: CommonData
    # tensors on the prover's device
    selector_polys: torch.Tensor     # [num_groups, n]
    constant_polys: torch.Tensor     # [num_constants_polys, n]
    sigma_polys: torch.Tensor        # [num_routed, n]
    cs_coeffs: torch.Tensor          # constants_sigmas coefficients
    cs_lde: torch.Tensor             # [C, 8n], bit-reversed
    cs_tree: MerkleTree
    # host structures
    rep_of: object                   # target -> canonical representative
    generators: list
    gate_rows: dict                  # gate index -> list of row numbers
    row_gate: list                   # row -> gate index
    instance_list: list              # [(gate, constants)] padded
    pi_targets: list                 # registered public-input targets
    class_wires: dict = None         # rep -> list[Wire] (copy classes)
    classes: dict = None             # rep -> set of all members (serde)
    pi_gate_row: int = -1            # row of the PublicInputGate
    custom_generators: list = None   # gadget hints only (serde)

    @property
    def device(self) -> torch.device:
        return self.cs_lde.device


@dataclass
class VerifierData:
    common: CommonData
    cs_cap: list                     # host cap


@dataclass
class CircuitData:
    prover: ProverData
    verifier: VerifierData

    @property
    def common(self):
        return self.prover.common

    def prove(self, inputs: dict, mesh=None):
        """A proof for `inputs`; with `mesh` (`parallel.make_prover_mesh`
        or a `parallel.Mesh`), its device phases sharded over the mesh."""
        from .prover import prove
        return prove(self.prover, inputs, mesh)


def _selector_groups(gates, max_degree_factor: int) -> SelectorInfo:
    """Greedy grouping: filtered degree = gate_deg + group_size (+1 for the
    unused factor) must stay <= max_degree_factor + 1."""
    order = sorted(range(len(gates)), key=lambda i: -gates[i].degree)
    groups: list[list[int]] = []
    for gi in order:
        placed = False
        for grp in groups:
            max_deg = max(gates[i].degree for i in grp + [gi])
            if max_deg + len(grp) + 1 <= max_degree_factor + 1:
                grp.append(gi)
                placed = True
                break
        if not placed:
            if gates[gi].degree + 1 > max_degree_factor + 1:
                raise ValueError(
                    f"gate {gates[gi].key()} has degree {gates[gi].degree} > "
                    f"max_quotient_degree_factor {max_degree_factor}")
            groups.append([gi])
    gate_group = {gi: g for g, grp in enumerate(groups) for gi in grp}
    return SelectorInfo(groups=groups, unused=len(gates), gate_group=gate_group)


def compile_circuit(builder, device=DEFAULT_DEVICE) -> CircuitData:
    """Compile `builder`'s circuit; its tensors live on `device` (the card
    unless the caller asks for the CPU)."""
    from ..utils import timed_span
    dev = resolve_device(device)
    with timed_span(f"build ({len(builder.gate_instances)} gate rows)"):
        return _compile_impl(builder, dev)


def _sigma_polys(perm: np.ndarray, k_is: list, degree_bits: int, device):
    """sigma[c, r] = label of the copy-successor of wire (r, c), where the
    label of (r, c) is k_c * g^r: one gather of the [nr, n] label table."""
    n = 1 << degree_bits
    g_pows = gl.to_tensor(host_powers(gl.primitive_root_of_unity(degree_bits), n),
                          device)
    labels = gl.mul(gl.to_tensor(k_is, device)[:, None], g_pows[None, :])
    idx = torch.from_numpy(perm.reshape(-1)).to(device)
    return labels.reshape(-1).index_select(0, idx).reshape(perm.shape)


def commit_constants_sigmas(sel_vals, const_vals, sigma_vals, config):
    """[selectors | constants | sigmas] -> (coeffs, LDE, Merkle tree under
    the config's transcript hasher).  The build and the load both commit
    here (the JAX package's load commits with Poseidon whatever the config,
    `plonky2_tpu/serialization/prover_serde.py:182`; the port does not copy
    that)."""
    from ..utils import timed_span
    cs_vals = torch.cat([sel_vals, const_vals, sigma_vals], dim=0)
    with timed_span("constants/sigmas LDE + Merkle commit"):
        cs_coeffs, cs_lde = lde_from_values_rev_auto(cs_vals, config.fri.rate_bits)
        cs_tree = MerkleTree.build_cols(cs_lde, config.fri.cap_height,
                                        config.transcript_module())
        cs_tree.cap_host()
    return cs_coeffs, cs_lde, cs_tree


def _compile_impl(builder, device) -> CircuitData:
    from ..ir.builder import Wire
    from ..utils import timed_span
    config = builder.config

    # ---- public-input gate + padding ----
    pi_gate_row = builder.add_gate(PublicInputGate(), [])
    n_rows = len(builder.gate_instances)
    degree_bits = max(2, (n_rows - 1).bit_length())
    n = 1 << degree_bits
    while len(builder.gate_instances) < n:
        builder.add_gate(NoopGate(), [])
    instances = builder.gate_instances

    # ---- unique gates + selectors ----
    key_to_idx: dict = {}
    gates: list = []
    row_gate = []
    for g, _ in instances:
        k = g.key()
        if k not in key_to_idx:
            key_to_idx[k] = len(gates)
            gates.append(g)
        row_gate.append(key_to_idx[k])
    sel = _selector_groups(gates, config.max_quotient_degree_factor)

    sel_vals = np.full((len(sel.groups), n), sel.unused, dtype=np.uint64)
    for r, gi in enumerate(row_gate):
        sel_vals[sel.gate_group[gi], r] = gi

    # ---- constant polynomials ----
    num_const_polys = max([config.num_constants] +
                          [g.num_constants for g in gates])
    const_vals = np.zeros((num_const_polys, n), dtype=np.uint64)
    for r, (g, consts) in enumerate(instances):
        for i, c in enumerate(consts):
            const_vals[i, r] = c
    common = common_data(config, degree_bits, gates, sel, num_const_polys,
                         len(builder.public_inputs))

    # ---- sigma polynomials from the copy-constraint forest ----
    with timed_span("sigma construction (copy classes)"):
        nr = config.num_routed_wires
        universe = set(builder._parent.keys()) | set(builder._parent.values())
        classes: dict = {}
        rep_map: dict = {}        # frozen union-find: item -> canonical rep
        for item in universe:
            rep = builder._find(item)
            classes.setdefault(rep, set()).update((item, rep))
            rep_map[item] = rep

        # successor permutation as flat indices into the label table [nr, n]
        perm = np.arange(nr * n, dtype=np.int64).reshape(nr, n)
        for members in classes.values():
            ms = sorted(m for m in members if isinstance(m, Wire))
            if len(ms) < 2:
                continue
            for i, m in enumerate(ms):
                nxt = ms[(i + 1) % len(ms)]
                perm[m.column, m.row] = nxt.column * n + nxt.row
        sigma_vals = _sigma_polys(perm, common.k_is, degree_bits, device)

    return circuit_data(common, gl.to_tensor(sel_vals, device),
                        gl.to_tensor(const_vals, device), sigma_vals, instances,
                        row_gate, list(builder.public_inputs), pi_gate_row, classes,
                        rep_map, list(builder.custom_generators))


def common_data(config, degree_bits: int, gates: list, sel: SelectorInfo,
                num_constants_polys: int, num_public_inputs: int) -> CommonData:
    """The circuit's common data; the coset shifts and partial-product
    counts follow from the config."""
    nr = config.num_routed_wires
    qf = config.max_quotient_degree_factor
    return CommonData(
        config=config,
        degree_bits=degree_bits,
        gates=gates,
        selector_info=sel,
        num_constants_polys=num_constants_polys,
        k_is=[pow(gl.GENERATOR, i, gl.P) for i in range(nr)],
        num_public_inputs=num_public_inputs,
        num_partial_products=(nr + qf - 1) // qf - 1,
        chunk_size=qf,
    )


def circuit_data(common, selector_polys, constant_polys, sigma_polys, instances,
                 row_gate, pi_targets, pi_gate_row, classes, rep_map,
                 custom_generators) -> CircuitData:
    """Commit [selectors | constants | sigmas] on their device and freeze
    the witness-generator schedule: the gadget hints, every row's gate
    generators, then the public-input hash generator.  `compile_circuit`
    and `deserialize_prover_data` both end here."""
    from ..ir.builder import Wire
    from ..utils import timed_span
    cs_coeffs, cs_lde, cs_tree = commit_constants_sigmas(
        selector_polys, constant_polys, sigma_polys, common.config)

    with timed_span("generator schedule"):
        generators = list(custom_generators)
        for r, (g, consts) in enumerate(instances):
            generators.extend(g.generators(r, consts))

    def _pi_fn(vals, row=pi_gate_row, hasher=common.config.hasher_module()):
        h = hasher.hash_no_pad_s([v % gl.P for v in vals])
        return [(Wire(row, i), h[i]) for i in range(4)]

    generators.append(LambdaGenerator(
        pi_targets, _pi_fn, outs=[Wire(pi_gate_row, i) for i in range(4)]))

    gate_rows: dict = {}
    for r, gi in enumerate(row_gate):
        gate_rows.setdefault(gi, []).append(r)

    prover = ProverData(
        common=common,
        selector_polys=selector_polys,
        constant_polys=constant_polys,
        sigma_polys=sigma_polys,
        cs_coeffs=cs_coeffs,
        cs_lde=cs_lde,
        cs_tree=cs_tree,
        # frozen flat map: one dict.get per lookup in the witness schedule
        rep_of=lambda t, _m=rep_map: _m.get(t, t),
        generators=generators,
        gate_rows=gate_rows,
        row_gate=row_gate,
        instance_list=instances,
        pi_targets=pi_targets,
        class_wires={rep: [m for m in members if isinstance(m, Wire)]
                     for rep, members in classes.items()},
        classes=classes,
        pi_gate_row=pi_gate_row,
        custom_generators=custom_generators,
    )
    verifier = VerifierData(common=common, cs_cap=cs_tree.cap_host())
    return CircuitData(prover=prover, verifier=verifier)
