"""Other layouts of the fused attention kernels, forward and backward.

Counterpart of ``spatial_clip_tpu/ops/attention_variants.py`` and of the
interleaved branch of ``spatial_clip_tpu/ops/fused_attention.py``. The math
is the standard kernels' (``fused_attention`` and
``fused_attention_bwd_recompute``); only where q, k and v live differs:

- interleaved (``attn_impl='pallas_inter'``): qkv's columns in
  :func:`interleave_perm` order. :func:`fused_attention_inter` replaces
  ``_attn_fwd_impl`` -> ``_fwd_kernel`` with the interleaved BlockSpecs and
  :func:`fused_attention_inter_bwd` ``_bwd_pallas`` -> ``_bwd_kernel_inter``;
  ``fused_attention.fused_attention(..., interleaved=True)`` and
  ``FusedAttention`` reach them. :func:`permute_rows` permutes the port's
  (3D, Din) qkv weight and its bias into that order, with a gather as its
  backward (JAX's ``permute_columns``);
- seq-major with a bias (``attn_impl='pallas_t'``): :func:`fused_attention_t`
  / :class:`FusedAttentionT` over the no-bias qkv GEMM output, the bias
  added inside the kernels (``_fwd_pallas_t`` -> ``_fwd_kernel_t``,
  ``_bwd_pallas_t`` -> ``_bwd_kernel_t``), db from the backward kernel, and
  dq, dk, dv written as the column blocks of one dqkv;
- split (``attn_impl='pallas_split'``): :func:`fused_attention_split` /
  :class:`FusedAttentionSplit` over three (B, L, D) arrays
  (``_split_fwd_impl`` / ``_split_bwd_impl``);
- slab: :func:`fused_attention_slab` and :func:`fused_attention_slab_bwd`,
  the standard layout with one block per sequence (``_fwd_pallas_slab`` /
  ``_bwd_pallas_slab``). JAX selects it with the module global
  ``KERNEL_VARIANT``, which the port does not carry, so no model path
  reaches these two;
- dx in the kernel (``BWD_FUSE='dxdb'``): :func:`fused_attention_bwd_dx`,
  the recompute backward with db that also forms the qkv projection's input
  gradient dx = dqkv W (``_bwd_pallas3_dx`` -> ``_bwd_kernel3_dx``);
  ``fused_attention.QKVAttention`` reaches it.

On a CUDA tensor each wrapper launches its kernel in
``csrc/attention_layouts.cu`` (the dx wrapper: ``csrc/attention_dx.cu``),
which runs the standard kernels' bodies; on a CPU tensor it runs its plain
PyTorch version, the standard plain version (``reference_attention``,
``reference_attention_bwd``) on the operand put back in the standard layout.
A CUDA tensor either goes through the kernel or raises. Each wrapper counts
its launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from spatial_clip_tpu_torch.ops import cuda_build
from spatial_clip_tpu_torch.ops.fused_attention import (
    _check,
    _check_bwd,
    _check_geometry,
    _check_kernel_device,
    _check_mask,
    VARIANT_MAX_SEQ,
    bwd_smem_bytes,
    bwd_supported,
    check_resident,
    check_resident_qkv,
    reference_attention,
    reference_attention_bwd,
)

LANES = 128  # the TPU's lane width, which the interleaved order is cut by


def heads_per_block(heads: int, head_dim: int, lanes: Optional[int] = None) -> Optional[int]:
    """Heads per lane group, as JAX's ``heads_per_block`` picks them: the
    largest count that divides ``heads`` and fills a multiple of 128 lanes
    within ``lanes`` (128 when None); None where no count does (JAX then
    falls back to its einsum attention, and so do the port's towers:
    :func:`attention_supported`)."""
    lanes = lanes or LANES
    if head_dim >= 128:
        return 1 if head_dim % 128 == 0 else None
    if 128 % head_dim != 0:
        return None
    hpb = min(lanes // head_dim, heads)
    while hpb > 1 and (heads % hpb != 0 or (hpb * head_dim) % 128 != 0):
        hpb -= 1
    if heads % hpb != 0 or (hpb * head_dim) % 128 != 0:
        return None
    return hpb


def attention_supported(heads: int, width: int) -> bool:
    """JAX's ``fused_attention.supported``: whether its attention kernels
    take ``heads`` heads over ``width`` channels. Where this fails, JAX's
    towers run the einsum attention, and so do the port's."""
    head_dim = width // heads
    return heads * head_dim == width and heads_per_block(heads, head_dim) is not None


def interleave_perm(heads: int, head_dim: int) -> list:
    """The order that turns standard [q|k|v] rows (of the port's (3D, Din)
    weight, or columns of qkv) into [q_g0|k_g0|v_g0|q_g1|...], with head
    groups of :func:`heads_per_block` heads at 128 lanes."""
    hpb = heads_per_block(heads, head_dim)
    if hpb is None:
        raise NotImplementedError(
            f"heads={heads} head_dim={head_dim}: no interleaved layout (JAX's heads_per_block "
            "is None there, and the towers run the einsum attention instead)")
    lanes = hpb * head_dim
    D = heads * head_dim
    perm = []
    for j in range(D // lanes):
        for part in range(3):
            base = part * D + j * lanes
            perm.extend(range(base, base + lanes))
    return perm


def inverse_perm(perm) -> tuple:
    inv = [0] * len(perm)
    for i, p in enumerate(perm):
        inv[p] = i
    return tuple(inv)


@functools.lru_cache(maxsize=None)
def _perm_tensors(heads: int, head_dim: int, device: torch.device):
    perm = interleave_perm(heads, head_dim)
    return (torch.tensor(perm, dtype=torch.long, device=device),
            torch.tensor(inverse_perm(perm), dtype=torch.long, device=device))


class _PermuteRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, perm, inv):
        ctx.save_for_backward(inv)
        return w.index_select(0, perm)

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        return g.index_select(0, inv), None, None


def permute_rows(w: torch.Tensor, heads: int, head_dim: int) -> torch.Tensor:
    """``w`` (3D, ...) with its rows in :func:`interleave_perm` order; the
    gradient is gathered back with the inverse order (JAX's
    ``permute_columns``, on the port's (out, in) weight layout)."""
    perm, inv = _perm_tensors(heads, head_dim, w.device)
    return _PermuteRows.apply(w, perm, inv)


def _launch(entry: str, device: torch.device, *args) -> None:
    lib = cuda_build.library()
    with torch.cuda.device(device):
        err = getattr(lib, f"sc_attention_{entry}")(
            *args, torch.cuda.current_stream(device).cuda_stream)
    cuda_build.check(lib, err, f"attention {entry} launch")


def _dims(B, L, D, heads, dtype):
    hd = D // heads
    return B, L, heads, hd, cuda_build.DTYPE_CODES[dtype], hd ** -0.5


def _ptr(mask):
    return None if mask is None else mask.data_ptr()


# ---------------------------------------------------------------- interleaved

def _check_inter(qkv, heads) -> int:
    D = qkv.shape[-1] // 3
    hpb = heads_per_block(heads, D // heads)
    if hpb is None:
        raise ValueError(f"head geometry heads={heads} width={D} has no interleaved layout")
    return hpb


def reference_attention_inter(qkv: torch.Tensor, mask: Optional[torch.Tensor],
                              heads: int) -> torch.Tensor:
    """Plain version: :func:`reference_attention` on qkv put back in the
    standard column order."""
    _, inv = _perm_tensors(heads, qkv.shape[-1] // 3 // heads, qkv.device)
    return reference_attention(qkv.index_select(-1, inv), mask, heads)


def reference_attention_inter_bwd(qkv, mask, g, heads: int) -> torch.Tensor:
    """Plain version: the recompute backward (:func:`reference_attention_bwd`
    with ``lse=None``) in the standard order, dqkv put in the interleaved one."""
    perm, inv = _perm_tensors(heads, qkv.shape[-1] // 3 // heads, qkv.device)
    dqkv = reference_attention_bwd(qkv.index_select(-1, inv), mask, None, g, heads)[0]
    return dqkv.index_select(-1, perm)


def fused_attention_inter(qkv: torch.Tensor, mask: Optional[torch.Tensor],
                          heads: int) -> torch.Tensor:
    """The inference forward over an interleaved qkv (B, L, 3D), contiguous,
    float32 or bfloat16. Returns the context (B, L, D), standard order."""
    _check(qkv, mask, heads)
    hpb = _check_inter(qkv, heads)
    check_resident_qkv(qkv, heads, False, "fused_attention_inter")
    if cuda_build.plain_device(qkv):
        return reference_attention_inter(qkv, mask, heads)
    _check_kernel_device(qkv)
    B, L, three_d = qkv.shape
    out = qkv.new_empty((B, L, three_d // 3))
    B, L, H, hd, code, scale = _dims(B, L, three_d // 3, heads, qkv.dtype)
    _launch("inter_fwd", qkv.device, qkv.data_ptr(), _ptr(mask), out.data_ptr(), B, L, H, hd,
            hpb, code, scale)
    fused_attention_inter.launches += 1
    return out


def fused_attention_inter_bwd(qkv: torch.Tensor, mask: Optional[torch.Tensor], g: torch.Tensor,
                              heads: int) -> torch.Tensor:
    """Backward of :func:`fused_attention_inter` that recomputes the softmax
    statistics: dqkv in qkv's (interleaved) order, no bias gradient."""
    g = _check_bwd(qkv, mask, g, heads)
    hpb = _check_inter(qkv, heads)
    check_resident_qkv(qkv, heads, True, "fused_attention_inter_bwd")
    if cuda_build.plain_device(qkv):
        return reference_attention_inter_bwd(qkv, mask, g, heads)
    _check_kernel_device(qkv, g)
    dqkv = torch.empty_like(qkv)
    B, L, H, hd, code, scale = _dims(*qkv.shape[:2], qkv.shape[2] // 3, heads, qkv.dtype)
    _launch("inter_bwd", qkv.device, qkv.data_ptr(), _ptr(mask), g.data_ptr(), dqkv.data_ptr(),
            B, L, H, hd, hpb, code, scale)
    fused_attention_inter_bwd.launches += 1
    return dqkv


# ----------------------------------------------------------------------- slab

def fused_attention_slab(qkv: torch.Tensor, mask: Optional[torch.Tensor],
                         heads: int) -> torch.Tensor:
    """:func:`fused_attention` over one block per sequence (JAX's
    ``_fwd_pallas_slab``); its bits on the card, its plain version here."""
    _check(qkv, mask, heads)
    check_resident_qkv(qkv, heads, False, "fused_attention_slab")
    if cuda_build.plain_device(qkv):
        return reference_attention(qkv, mask, heads)
    _check_kernel_device(qkv)
    B, L, three_d = qkv.shape
    out = qkv.new_empty((B, L, three_d // 3))
    _launch("slab_fwd", qkv.device, qkv.data_ptr(), _ptr(mask), out.data_ptr(),
            *_dims(B, L, three_d // 3, heads, qkv.dtype))
    fused_attention_slab.launches += 1
    return out


def fused_attention_slab_bwd(qkv: torch.Tensor, mask: Optional[torch.Tensor], g: torch.Tensor,
                             heads: int) -> torch.Tensor:
    """The recompute backward over one block per sequence (JAX's
    ``_bwd_pallas_slab``): dqkv in qkv's layout, no bias gradient."""
    g = _check_bwd(qkv, mask, g, heads)
    check_resident_qkv(qkv, heads, True, "fused_attention_slab_bwd")
    if cuda_build.plain_device(qkv):
        return reference_attention_bwd(qkv, mask, None, g, heads)[0]
    _check_kernel_device(qkv, g)
    dqkv = torch.empty_like(qkv)
    _launch("slab_bwd", qkv.device, qkv.data_ptr(), _ptr(mask), g.data_ptr(), dqkv.data_ptr(),
            *_dims(*qkv.shape[:2], qkv.shape[2] // 3, heads, qkv.dtype))
    fused_attention_slab_bwd.launches += 1
    return dqkv


# ------------------------------------------------------------------ seq-major

def _check_t(qkv_t: torch.Tensor, bias: torch.Tensor, mask, heads: int) -> torch.Tensor:
    """The seq-major wrappers' checks; returns the bias as a contiguous (3D,)
    vector in qkv_t's dtype."""
    if qkv_t.dim() != 3 or qkv_t.shape[-1] % 3:
        raise ValueError(f"qkv_t must be (L, B, 3*D); got {tuple(qkv_t.shape)}")
    L, B, three_d = qkv_t.shape
    # the kernel's strides are these two layouts': seq-major contiguous, or
    # the transposed view of a contiguous (B, L, 3D) tensor
    if qkv_t.stride() not in ((B * three_d, three_d, 1), (three_d, L * three_d, 1)):
        raise ValueError(f"qkv_t strides {qkv_t.stride()}: want a contiguous (L, B, 3D) tensor "
                         "or the transpose(0, 1) view of a contiguous (B, L, 3D) one")
    _check_geometry(B, L, three_d // 3, heads, qkv_t.dtype)
    _check_mask(mask, L, qkv_t.device)
    if bias.numel() != three_d or bias.device != qkv_t.device:
        raise ValueError(f"bias must hold {three_d} values on qkv_t's device; got "
                         f"{tuple(bias.shape)}")
    return bias.reshape(three_d).to(qkv_t.dtype).contiguous()


def _with_bias(qkv_t, bias):
    """(B, L, 3D): the no-bias qkv plus the bias, each sum rounded to the
    input dtype as the kernel rounds it."""
    return (qkv_t.transpose(0, 1) + bias).contiguous()


def reference_attention_t(qkv_t, bias, mask, heads: int) -> torch.Tensor:
    """Plain version: :func:`reference_attention` on ``qkv_t + bias`` (in
    the input dtype), put back in (B, L, 3D) order."""
    return reference_attention(_with_bias(qkv_t, bias), mask, heads)


def reference_attention_t_bwd(qkv_t, bias, mask, g, heads: int):
    """Plain version: the recompute backward with db on ``qkv_t + bias``;
    returns dqkv = [dq|dk|dv] (B, L, 3D) and db (3D,) f32, the sum of the
    rounded dq, dk and dv over (B, L)."""
    return reference_attention_bwd(_with_bias(qkv_t, bias), mask, None, g, heads)


def fused_attention_t_fwd(qkv_t: torch.Tensor, bias: torch.Tensor,
                          mask: Optional[torch.Tensor], heads: int) -> torch.Tensor:
    """The inference forward over the seq-major no-bias qkv: qkv_t (L, B,
    3D), contiguous or the ``transpose(0, 1)`` view of a contiguous (B, L,
    3D) tensor; bias (3D) or (1, 3D), cast to qkv_t's dtype and added to q,
    k and v in that dtype. Returns the context (B, L, D)."""
    bias = _check_t(qkv_t, bias, mask, heads)
    L, _, three_d = qkv_t.shape
    check_resident(L, three_d // 3 // heads, qkv_t.dtype, False, "fused_attention_t_fwd")
    if cuda_build.plain_device(qkv_t):
        return reference_attention_t(qkv_t, bias, mask, heads)
    _check_kernel_device(qkv_t, bias)
    L, B, three_d = qkv_t.shape
    out = qkv_t.new_empty((B, L, three_d // 3))
    _launch("t_fwd", qkv_t.device, qkv_t.data_ptr(), qkv_t.stride(0), qkv_t.stride(1),
            bias.data_ptr(), _ptr(mask), out.data_ptr(),
            *_dims(B, L, three_d // 3, heads, qkv_t.dtype))
    fused_attention_t_fwd.launches += 1
    return out


def fused_attention_t_bwd(qkv_t: torch.Tensor, bias: torch.Tensor, mask: Optional[torch.Tensor],
                          g: torch.Tensor, heads: int):
    """Backward of :func:`fused_attention_t_fwd` that recomputes the softmax
    statistics from ``qkv_t + bias``: returns dqkv (B, L, 3D) in qkv_t's
    dtype, whose column blocks are the TPU kernel's three standard (B, L, D)
    outputs dq, dk, dv (the kernel writes them there, so no concatenation is
    made), and db (3D,) f32, summed in a fixed order."""
    bias = _check_t(qkv_t, bias, mask, heads)
    L, B, three_d = qkv_t.shape
    D = three_d // 3
    check_resident(L, D // heads, qkv_t.dtype, True, "fused_attention_t_bwd")
    if g.shape != (B, L, D) or g.device != qkv_t.device:
        raise ValueError(f"g must be {(B, L, D)} on qkv_t's device; got {tuple(g.shape)}")
    g = g.to(qkv_t.dtype).contiguous()
    if cuda_build.plain_device(qkv_t):
        return reference_attention_t_bwd(qkv_t, bias, mask, g, heads)
    _check_kernel_device(qkv_t, bias, g)
    dqkv = qkv_t.new_empty((B, L, three_d))
    db_part = torch.empty((B, three_d), dtype=torch.float32, device=qkv_t.device)
    db = torch.empty((three_d,), dtype=torch.float32, device=qkv_t.device)
    _launch("t_bwd", qkv_t.device, qkv_t.data_ptr(), qkv_t.stride(0), qkv_t.stride(1),
            bias.data_ptr(), _ptr(mask), g.data_ptr(), dqkv.data_ptr(), db_part.data_ptr(),
            db.data_ptr(), *_dims(B, L, D, heads, qkv_t.dtype))
    fused_attention_t_bwd.launches += 1
    return dqkv, db


class FusedAttentionT(torch.autograd.Function):
    """Attention over the no-bias qkv GEMM output (B, L, 3D) with the bias
    (1, 3D) added in the kernels (JAX's ``fused_attention_t`` and its custom
    VJP): the kernels take its ``transpose(0, 1)`` view, so nothing is
    copied. The backward returns dqkv = [dq|dk|dv] and db in the bias's shape
    and dtype, as ``_attn_t_bwd`` does (the kernel writes dq, dk and dv in
    place in dqkv); the mask gets no gradient."""

    @staticmethod
    def forward(ctx, qkv_nb, bias, mask, heads: int):
        ctx.save_for_backward(qkv_nb, bias, mask)
        ctx.heads = heads
        return fused_attention_t_fwd(qkv_nb.transpose(0, 1), bias, mask, heads)

    @staticmethod
    def backward(ctx, g):
        qkv_nb, bias, mask = ctx.saved_tensors
        dqkv, db = fused_attention_t_bwd(qkv_nb.transpose(0, 1), bias, mask, g, ctx.heads)
        return dqkv, db.to(bias.dtype).view(bias.shape), None, None


def fused_attention_t(qkv_nb: torch.Tensor, bias: torch.Tensor, mask: Optional[torch.Tensor],
                      heads: int) -> torch.Tensor:
    """:class:`FusedAttentionT` on a contiguous (B, L, 3D) no-bias qkv."""
    return FusedAttentionT.apply(qkv_nb.contiguous(), bias, mask, heads)


# ---------------------------------------------------------------------- split

def _check_split(q, k, v, mask, heads) -> None:
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must be (B, L, D) of one shape; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if len({t.dtype for t in (q, k, v)}) != 1 or len({t.device for t in (q, k, v)}) != 1:
        raise ValueError("q, k, v must share one dtype and device")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("q, k, v must be contiguous")
    B, L, D = q.shape
    _check_geometry(B, L, D, heads, q.dtype)
    _check_mask(mask, L, q.device)


def reference_attention_split(q, k, v, mask, heads: int) -> torch.Tensor:
    """Plain version: :func:`reference_attention` on [q|k|v]."""
    return reference_attention(torch.cat([q, k, v], dim=-1), mask, heads)


def reference_attention_split_bwd(q, k, v, mask, g, heads: int):
    """Plain version: the recompute backward on [q|k|v]; dq, dk, dv apart."""
    dqkv = reference_attention_bwd(torch.cat([q, k, v], dim=-1), mask, None, g, heads)[0]
    return tuple(t.contiguous() for t in dqkv.chunk(3, dim=-1))


def fused_attention_split_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              mask: Optional[torch.Tensor], heads: int) -> torch.Tensor:
    """The inference forward over separate q, k, v, each (B, L, D),
    contiguous. Returns the context (B, L, D)."""
    _check_split(q, k, v, mask, heads)
    check_resident(q.shape[1], q.shape[2] // heads, q.dtype, False, "fused_attention_split_fwd")
    if cuda_build.plain_device(q):
        return reference_attention_split(q, k, v, mask, heads)
    _check_kernel_device(q, k, v)
    out = torch.empty_like(q)
    _launch("split_fwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask),
            out.data_ptr(), *_dims(*q.shape, heads, q.dtype))
    fused_attention_split_fwd.launches += 1
    return out


def fused_attention_split_bwd(q, k, v, mask: Optional[torch.Tensor], g: torch.Tensor,
                              heads: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of :func:`fused_attention_split_fwd` that recomputes the
    softmax statistics: dq, dk, dv apart, in q's dtype, no bias gradient."""
    _check_split(q, k, v, mask, heads)
    B, L, D = q.shape
    check_resident(L, D // heads, q.dtype, True, "fused_attention_split_bwd")
    if g.shape != (B, L, D) or g.device != q.device:
        raise ValueError(f"g must be {(B, L, D)} on q's device; got {tuple(g.shape)}")
    g = g.to(q.dtype).contiguous()
    if cuda_build.plain_device(q):
        return reference_attention_split_bwd(q, k, v, mask, g, heads)
    _check_kernel_device(q, k, v, g)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    _launch("split_bwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask),
            g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *_dims(B, L, D, heads, q.dtype))
    fused_attention_split_bwd.launches += 1
    return dq, dk, dv


class FusedAttentionSplit(torch.autograd.Function):
    """Attention over separate q, k, v (JAX's ``fused_attention_split`` and
    its custom VJP): the backward returns dq, dk and dv apart, so no dqkv is
    assembled; the mask gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, mask, heads: int):
        ctx.save_for_backward(q, k, v, mask)
        ctx.heads = heads
        return fused_attention_split_fwd(q, k, v, mask, heads)

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask = ctx.saved_tensors
        return (*fused_attention_split_bwd(q, k, v, mask, g, ctx.heads), None, None)


def fused_attention_split(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor], heads: int) -> torch.Tensor:
    """:class:`FusedAttentionSplit` on contiguous q, k, v."""
    return FusedAttentionSplit.apply(q.contiguous(), k.contiguous(), v.contiguous(), mask, heads)


# ------------------------------------------------------- dx inside the kernel

def dx_supported(heads: int, width: int, seq: int, din: int, dtype: torch.dtype) -> bool:
    """Whether :func:`fused_attention_bwd_dx`'s kernel takes this geometry:
    the resident backward's (:func:`bwd_supported`) up to L =
    VARIANT_MAX_SEQ, and an input width ``din`` that is a positive multiple
    of 16, the tensor-core tiles' width."""
    return (bwd_supported(heads, width, seq, dtype) and seq <= VARIANT_MAX_SEQ and din >= 16
            and din % 16 == 0)


# The bf16 dx product's design constants (csrc/attention_dx.cu's SC_DX_CLUSTER
# and SC_DX_MAX_STAGES), its stage depth (kDepth), the shared memory a CTA may
# take with a second on an SM (228 KB less 1 KB reserved for each), and the
# names of its plan's fields.
DX_CLUSTER, DX_MAX_STAGES, DX_DEPTH = 2, 4, 64
DX_TWO_PER_SM = (233472 - 2 * 1024) // 2
DX_PLAN_KEYS = ("mt", "groups", "nc", "passes", "n_k", "box_rows", "stages", "cluster", "smem")


def dx_plan(seq: int, heads: int, head_dim: int, din: int, cluster: int = DX_CLUSTER,
            max_stages: int = DX_MAX_STAGES) -> dict:
    """The bf16 dx product's plan at these shapes (mirrors
    ``dxtc::Plan``): row groups of up to 128 rows, ``mt`` m64 tiles each (1
    at L <= 64, else 2), each in ``passes`` of ``nc = 256 / mt`` dx columns
    over ``n_k`` 64-deep stages of K = 3 heads head_dim; W landed in boxes of
    ``box_rows`` rows, every ``cluster``-th by each CTA of a cluster; as many
    ring stages (2 to ``max_stages``) as fit beside the body's two blocks an
    SM or in its own shared memory; ``smem`` the launch's dynamic bytes."""
    k = 3 * heads * head_dim
    mt = 1 if seq <= 64 else 2
    nc = 256 // mt
    blocks = nc // 64
    stage = (mt + blocks) * 64 * DX_DEPTH * 2
    body = bwd_smem_bytes(seq, head_dim, torch.bfloat16)
    room, fixed = max(body, DX_TWO_PER_SM), 1024 + 16 * max_stages
    fit = (room - fixed) // stage if room > fixed else 0
    stages = 2 if fit < 2 else min(fit, max_stages)
    return dict(mt=mt, groups=-(-seq // 128), nc=nc, passes=-(-din // nc), n_k=-(-k // DX_DEPTH),
                box_rows=DX_DEPTH * blocks // max(blocks, cluster), stages=stages, cluster=cluster,
                smem=max(body, 1024 + stages * (stage + 16)))


def dx_kernel_plan(seq: int, heads: int, head_dim: int, din: int) -> dict:
    """:func:`dx_plan` as the kernel library computes it (needs the card's
    build): the plan the bf16 launch runs."""
    lib = cuda_build.library()
    plan = (ctypes.c_int * len(DX_PLAN_KEYS))()
    cuda_build.check(lib, lib.sc_attention_bwd_dx_plan(seq, heads, head_dim, din, plan),
                     "sc_attention_bwd_dx_plan")
    return dict(zip(DX_PLAN_KEYS, plan))


def reference_attention_bwd_dx(qkv: torch.Tensor, mask: Optional[torch.Tensor],
                               g: torch.Tensor, w: torch.Tensor, heads: int):
    """Plain version with the TPU kernel's rounding points: dqkv and db of
    the recompute backward (:func:`reference_attention_bwd` with
    ``lse=None``), and dx = dqkv W with dq, dk, dv rounded to the input
    dtype before the product, summed in f32 and rounded to the input dtype
    once. w is the port's (3D, Din) qkv weight in qkv's dtype. Returns
    (dqkv (B, L, 3D), dx (B, L, Din), db (3D,) f32)."""
    dqkv, db = reference_attention_bwd(qkv, mask, None, g, heads)
    return dqkv, torch.matmul(dqkv.float(), w.float()).to(qkv.dtype), db


def fused_attention_bwd_dx(qkv: torch.Tensor, mask: Optional[torch.Tensor], g: torch.Tensor,
                           w: torch.Tensor, heads: int):
    """The recompute backward with the bias gradient and the qkv
    projection's input gradient in one launch: given the context's
    cotangent g (B, L, D) and the projection's weight w (3D, Din) in qkv's
    dtype, returns dqkv (qkv's shape and dtype), dx = dqkv W (B, L, Din) in
    qkv's dtype, and db (3D,) f32. dqkv and db are
    :func:`fused_attention_bwd_recompute_db`'s. On the card Din must be a
    positive multiple of 16 (:func:`dx_supported`)."""
    g = _check_bwd(qkv, mask, g, heads)
    check_resident_qkv(qkv, heads, True, "fused_attention_bwd_dx")
    B, L, three_d = qkv.shape
    if w.dim() != 2 or w.shape[0] != three_d:
        raise ValueError(f"w must be (3D, Din) = ({three_d}, Din); got {tuple(w.shape)}")
    if w.dtype != qkv.dtype or w.device != qkv.device or not w.is_contiguous():
        raise ValueError(f"w must be contiguous, in qkv's dtype {qkv.dtype} and on its device; "
                         f"got {w.dtype} on {w.device}")
    if cuda_build.plain_device(qkv):
        return reference_attention_bwd_dx(qkv, mask, g, w, heads)
    din = w.shape[1]
    if not dx_supported(heads, three_d // 3, L, din, qkv.dtype):
        raise ValueError(f"input width Din={din} not taken: the dx kernel's tensor-core tiles "
                         "need a positive multiple of 16")
    _check_kernel_device(qkv, g, w)
    dqkv = torch.empty_like(qkv)
    dx = qkv.new_empty((B, L, din))
    db_part = torch.empty((B, three_d), dtype=torch.float32, device=qkv.device)
    db = torch.empty((three_d,), dtype=torch.float32, device=qkv.device)
    B, L, H, hd, code, scale = _dims(B, L, three_d // 3, heads, qkv.dtype)
    _launch("bwd_dx", qkv.device, qkv.data_ptr(), _ptr(mask), g.data_ptr(), w.data_ptr(),
            dqkv.data_ptr(), dx.data_ptr(), db_part.data_ptr(), db.data_ptr(), B, L, H, hd, din,
            code, scale)
    fused_attention_bwd_dx.launches += 1
    return dqkv, dx, db


fused_attention_inter.launches = 0
fused_attention_inter_bwd.launches = 0
fused_attention_slab.launches = 0
fused_attention_slab_bwd.launches = 0
fused_attention_t_fwd.launches = 0
fused_attention_t_bwd.launches = 0
fused_attention_split_fwd.launches = 0
fused_attention_split_bwd.launches = 0
fused_attention_bwd_dx.launches = 0
