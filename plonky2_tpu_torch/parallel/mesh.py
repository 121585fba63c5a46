"""A single-controller device mesh and the mesh-sharded commit step.

Counterpart of `plonky2_tpu/parallel/mesh.py` and of the JAX prover's
`_MeshPlacer`.  As in JAX, one process holds every device of a 1-D mesh
(axis "d") and runs the host phases (witness, transcript, grind result,
proof assembly) once; the device phases use two layouts:

* **poly-sharded**: [P, n] split along the polynomials into d shards of
  ceil(P/d) rows, zero-padded; the iNTT and LDE are along the last axis, so
  each shard's transform is local;
* **row-sharded**: [..., N] split along the last axis (domain points, leaf
  columns) into d contiguous shards; leaf hashing, the Z and quotient
  evaluations and the FRI composite are elementwise across points.

A sharded value is a list of d tensors, shard i on `devices[i]`.  The move
between the layouts (the all-to-all that XLA inserts in JAX) is explicit
`.to(device)` copies of slices.  A device may repeat in a mesh: d shards of
one card run one after another on it, which is how a one-card machine (or
the CPU) proves on more than one shard.  All the math is exact, so a proof
is the same bytes at any d.

`sharded_prove_step` is the JAX package's "training step" of this mesh: one
sharded commit (natural-order iNTT and coset LDE per poly shard, kernel
K2-nat on the card; the all-to-all; leaf hashing and tree levels per row
shard, kernel K1) and a degree-7 constraint-style sample over the LDE.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..field import gl
from ..hashes import poseidon
from ..merkle.merkle import sharded_levels
from ..ntt import lde_from_values_auto
from ..utils.device import DEFAULT_DEVICE, resolve_device


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh (axis "d") of `devices`, all of one type, in order;
    `devices[0]` runs the unsharded steps.  A device may repeat.  The size
    is a power of two, since the row shards split N = n * 2^rate."""

    devices: tuple

    def __post_init__(self):
        devices = tuple(torch.device(dev) for dev in self.devices)
        object.__setattr__(self, "devices", devices)
        d = len(devices)
        if d == 0 or d & (d - 1):
            raise ValueError(f"a mesh's size must be a power of two, got {d}")
        types = {dev.type for dev in devices}
        if len(types) != 1:
            raise ValueError(f"a mesh holds devices of one type, got {sorted(types)}")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device_type(self) -> str:
        return self.devices[0].type

    def polys(self, arr: torch.Tensor) -> list:
        """Split dim 0 (polynomials) into d shards of ceil(P/d) rows, the
        last ones zero-padded; shard i on devices[i].  `unpad` cuts the pad
        off after the transform."""
        ps = -(-arr.shape[0] // self.size)
        return [_pad_rows(arr[i * ps:(i + 1) * ps].to(dev), ps)
                for i, dev in enumerate(self.devices)]

    def unpad(self, shards: list, p: int) -> list:
        """Poly shards of a padded [d * ps, ...] array -> the shards of its
        first p rows (the last shards lose their pad rows)."""
        ps = shards[0].shape[0]
        return [s[:max(0, min(ps, p - i * ps))] for i, s in enumerate(shards)]

    def rows(self, arr: torch.Tensor) -> list:
        """Split the last dim into d contiguous shards, shard i on
        devices[i]."""
        w = self._shard_width(arr.shape[-1])
        return [arr[..., i * w:(i + 1) * w].to(dev) for i, dev in enumerate(self.devices)]

    def replicate(self, arr: torch.Tensor) -> list:
        return [arr.to(dev) for dev in self.devices]

    def gather(self, shards: list, dim: int = -1) -> torch.Tensor:
        """Concatenate shards along `dim` onto devices[0]."""
        return torch.cat([s.to(self.devices[0]) for s in shards], dim=dim)

    def polys_to_rows(self, shards: list) -> list:
        """The all-to-all: poly shards [p_i, N] (unpadded) -> row shards
        [sum p_i, N/d], row shard j on devices[j]."""
        w = self._shard_width(shards[0].shape[-1])
        return [torch.cat([s[..., j * w:(j + 1) * w].to(dev) for s in shards], dim=0)
                for j, dev in enumerate(self.devices)]

    def rows_to_polys(self, shards: list) -> list:
        """The all-to-all back: row shards [P, w] -> poly shards of ceil(P/d)
        rows over all d * w points, zero-padded as `polys` pads."""
        ps = -(-shards[0].shape[0] // self.size)
        return [_pad_rows(torch.cat([s[i * ps:(i + 1) * ps].to(dev) for s in shards],
                                    dim=-1), ps)
                for i, dev in enumerate(self.devices)]

    def _shard_width(self, length: int) -> int:
        if length % self.size:
            raise ValueError(f"a mesh of {self.size} shards does not divide a length "
                             f"of {length}")
        return length // self.size


def _pad_rows(part: torch.Tensor, rows: int) -> torch.Tensor:
    """`part` with zero rows appended up to `rows`."""
    if part.shape[0] == rows:
        return part
    pad = torch.zeros((rows - part.shape[0],) + tuple(part.shape[1:]), dtype=part.dtype,
                      device=part.device)
    return torch.cat([part, pad], dim=0)


def make_prover_mesh(n_devices: int | None = None, device=DEFAULT_DEVICE) -> Mesh:
    """The first `n_devices` devices of `device`'s type (all of them where
    None).  On the CPU: n_devices shards of the CPU device (1 where None).
    Raises where fewer devices exist (the JAX function silently returns a
    smaller mesh)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return Mesh((dev,) * (1 if n_devices is None else n_devices))
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        if n > count:
            raise ValueError(f"asked for a mesh of {n} CUDA devices, {count} present")
        return Mesh(tuple(torch.device("cuda", i) for i in range(n)))
    raise ValueError(f"no mesh for device type {dev.type}")


def _sample(lde_rows: torch.Tensor) -> torch.Tensor:
    """w0^7 - w_last over the points of one row shard [P, w]: the Poseidon
    gate's degree-7 S-box of the first wire against the last."""
    w0 = lde_rows[0]
    x3 = gl.mul(gl.mul(w0, w0), w0)
    return gl.sub(gl.mul(gl.mul(x3, x3), w0), lde_rows[-1])


def sharded_prove_step(mesh: Mesh, wires: torch.Tensor, rate_bits: int, cap_height: int):
    """One sharded commit and constraint pass, as the JAX function computes
    it.  wires [P, n] int64, with d dividing P and N = n * 2^rate_bits.
    Per poly shard the natural-order iNTT and coset LDE
    (`lde_from_values_auto`: K2-nat on the card); the all-to-all to row
    shards; per row shard the Poseidon leaf hashes of its LDE rows (no
    padding: JAX's `hash_or_noop` takes the rows as they are) and its tree
    levels, then the top levels on devices[0] down to 2^cap_height.
    -> (cap [2^cap_height, 4], sample [N]), both on devices[0]."""
    P, n = wires.shape
    N = n << rate_bits
    if P % mesh.size or N % mesh.size:
        raise ValueError(f"a mesh of {mesh.size} shards must divide the {P} polynomials "
                         f"and the {N} points")
    if (1 << cap_height) > N:
        raise ValueError(f"cap height {cap_height} is above the {N} leaves")
    ldes = [lde_from_values_auto(s, rate_bits)[1] for s in mesh.polys(wires)]
    rows = mesh.polys_to_rows(ldes)
    hashes = [poseidon.hash_or_noop_cols(r) for r in rows]
    _, top = sharded_levels(mesh.devices[0], hashes, cap_height, poseidon)
    return top[-1].T, mesh.gather([_sample(r) for r in rows])
