"""Kernel K1: the Poseidon permutation on the card (`csrc/poseidon.cu`).

Replaces `plonky2_tpu/hashes/pallas_poseidon.py` `permute_cols_pallas`.
`poseidon.permute_cols` sends a CUDA tensor here and runs the plain torch
version (`poseidon.permute_cols_plain`) for a CPU tensor.  There is no
probe and no fallback: a build or launch failure raises.  The result is
bit-identical to the plain version at every batch width, so there is no
width threshold either.
"""

from __future__ import annotations

import torch

from .. import _build
from ..field import gl
from . import poseidon

LAUNCHES = 0                 # kernel launches made by `permute_cols_cuda`
_constants_on: set = set()   # device indices holding the constant tables


def _fast_tables():
    """The fast partial rounds' tables as one u64 array in the kernel's
    order: first [12], initial [11 * 11], post [22], m00 [22], v [22 * 11],
    w [22 * 11]."""
    t = poseidon.fast_partial_tables(poseidon.ROUND_CONSTANTS, poseidon.MDS)
    words = (t["first"] + sum(t["initial"], []) + t["post"] + t["m00"]
             + sum(t["v"], []) + sum(t["w"], []))
    return gl.to_u64(words)


def _upload_constants(device: torch.device) -> None:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx in _constants_on:
        return
    rc = gl.to_u64(poseidon.ROUND_CONSTANTS).reshape(-1)
    mds = gl.to_u64(poseidon.MDS).reshape(-1)
    fast = _fast_tables()
    with torch.cuda.device(idx):
        _build.check(_build.lib().p2t_poseidon_set_constants(
            rc.ctypes.data, mds.ctypes.data, fast.ctypes.data), "poseidon constant upload")
    _constants_on.add(idx)


def permute_cols_cuda(s: torch.Tensor,
                      small_mds: bool = poseidon.MDS_SMALL) -> torch.Tensor:
    """Launch K1 on s [12, B] int64 (contiguous, on a CUDA device).

    `small_mds` picks the MDS layer: the split into 32-bit halves, right
    only when every entry is < 2^20 (plonky2's matrix), or full mulmods,
    right for any matrix.  Both give the same bits on plonky2's matrix."""
    global LAUNCHES
    if s.dtype != gl.DTYPE or s.dim() != 2 or s.shape[0] != poseidon.WIDTH:
        raise ValueError(f"K1 takes an int64 [12, B] tensor, got "
                         f"{s.dtype} {tuple(s.shape)}")
    if not s.is_contiguous():
        raise ValueError("K1 takes a contiguous [12, B] tensor")
    if small_mds and not poseidon.MDS_SMALL:
        raise ValueError("the small-entry MDS layer needs every MDS entry < 2^20")
    _upload_constants(s.device)
    out = torch.empty_like(s)
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream(s.device).cuda_stream
        _build.check(_build.lib().p2t_poseidon_permute_cols(
            s.data_ptr(), out.data_ptr(), s.shape[1], int(small_mds), stream),
            "K1 launch")
    LAUNCHES += 1
    return out


def gl_ops_cuda(a: torch.Tensor, b: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Field-layer check of csrc/goldilocks.cuh, computed on the card: [13,
    n] rows add(a, b), sub(a, b), mul(a, b), neg(a) for canonical a, b;
    then, for any u64 a, b, w, canonical: mul_lazy(a, b), reduce128_lazy(hi
    = a, lo = b), add_lazy(a, canon(b)), sub_lazy(a, canon(b)), an Acc of
    twelve products a * b, and the (e, o) of K3's butterfly dif_lazy(a, b,
    w) and of dif_lazy(a, b) (w = 1)."""
    if not (a.shape == b.shape == w.shape and a.dim() == 1 and a.device.type == "cuda"):
        raise ValueError("gl_ops_cuda takes three equal 1-D CUDA tensors")
    a, b, w = a.contiguous(), b.contiguous(), w.contiguous()
    out = torch.empty((13, a.shape[0]), dtype=gl.DTYPE, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        _build.check(_build.lib().p2t_gl_ops(
            a.data_ptr(), b.data_ptr(), w.data_ptr(), out.data_ptr(), a.shape[0], stream),
            "goldilocks check launch")
    return out
