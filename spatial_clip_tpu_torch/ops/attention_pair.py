"""Zipped dual-tower attention: the image tower's and the text tower's
layer-i attention in one kernel launch, forward and backward.

Counterpart of ``spatial_clip_tpu/ops/attention_pair.py``, which
``CLIP.encode_pair`` reaches under ``zip_towers='on'``:

- :func:`fused_attention_pair`: both towers' inference forward
  (``_pair_fwd_impl`` -> ``_pair_fwd_duo_kernel``);
- :func:`fused_attention_pair_bwd`: both towers' backward that recomputes the
  softmax statistics, without the bias gradient (``_pair_bwd_impl`` ->
  ``_pair_bwd_duo_kernel``, ``_bwd_kernel`` in each half);
- :class:`PairAttention`: the two as one autograd function (the custom VJP
  of ``fused_attention_pair``); without grad it is the forward alone.

On a CUDA tensor each wrapper launches ``csrc/attention_pair.cu``, one grid
whose blocks run tower a's (batch, head) pairs and then tower b's through the
single-tower kernels' own bodies, so each tower's result is bit for bit what
``fused_attention`` and ``fused_attention_bwd_recompute`` give. On a CPU
tensor it runs the plain version, those two functions' plain versions once
per tower. A CUDA tensor either goes through the pair kernel or raises; it
never falls back to two single-tower launches.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from spatial_clip_tpu_torch.ops import cuda_build
from spatial_clip_tpu_torch.ops.fused_attention import (
    _check,
    _check_bwd,
    _check_kernel_device,
    check_resident_qkv,
    reference_attention,
    reference_attention_bwd,
    supported,
)


def pair_supported(heads_a: int, dim_a: int, heads_b: int, dim_b: int) -> bool:
    """Whether both towers' head geometries are taken (JAX's
    ``pair_supported``: JAX's gate, ``attention_supported``, on each tower)
    by the pair kernel's head dims."""
    from spatial_clip_tpu_torch.ops.attention_variants import attention_supported

    return all(attention_supported(h, d) and supported(h, d)
               for h, d in ((heads_a, dim_a), (heads_b, dim_b)))


def _check_pair(qkv_a, qkv_b) -> None:
    if qkv_a.shape[0] != qkv_b.shape[0]:
        raise ValueError(f"paired towers need equal batch, got {qkv_a.shape[0]} vs "
                         f"{qkv_b.shape[0]}")
    if qkv_a.dtype != qkv_b.dtype or qkv_a.device != qkv_b.device:
        raise ValueError(f"paired towers need one dtype and device, got {qkv_a.dtype} "
                         f"{qkv_a.device} vs {qkv_b.dtype} {qkv_b.device}")


def reference_attention_pair(qkv_a, mask_a, qkv_b, mask_b, heads_a: int,
                             heads_b: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: :func:`reference_attention` on each tower."""
    return reference_attention(qkv_a, mask_a, heads_a), reference_attention(qkv_b, mask_b, heads_b)


def reference_attention_pair_bwd(qkv_a, mask_a, g_a, qkv_b, mask_b, g_b, heads_a: int,
                                 heads_b: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the recompute backward without db
    (:func:`reference_attention_bwd` with ``lse=None``) on each tower."""
    return (reference_attention_bwd(qkv_a, mask_a, None, g_a, heads_a)[0],
            reference_attention_bwd(qkv_b, mask_b, None, g_b, heads_b)[0])


def _tower(qkv, mask, heads):
    """(qkv, mask, L, heads, hd) as the C entry points take one tower."""
    B, L, three_d = qkv.shape
    return (qkv.data_ptr(), None if mask is None else mask.data_ptr(), L, heads,
            three_d // 3 // heads)


def fused_attention_pair(qkv_a: torch.Tensor, mask_a: Optional[torch.Tensor],
                         qkv_b: torch.Tensor, mask_b: Optional[torch.Tensor],
                         heads_a: int, heads_b: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both towers' inference attention in one launch.

    qkv_a (B, La, 3 Da), qkv_b (B, Lb, 3 Db): one batch, one dtype (float32
    or bfloat16), contiguous; masks (L, L) additive float32 or None. Returns
    the contexts (ctx_a (B, La, Da), ctx_b (B, Lb, Db)). Counts each kernel
    launch in ``fused_attention_pair.launches``.
    """
    _check(qkv_a, mask_a, heads_a)
    _check(qkv_b, mask_b, heads_b)
    _check_pair(qkv_a, qkv_b)
    for qkv, heads in ((qkv_a, heads_a), (qkv_b, heads_b)):
        check_resident_qkv(qkv, heads, False, "fused_attention_pair")
    if cuda_build.plain_device(qkv_a):
        return reference_attention_pair(qkv_a, mask_a, qkv_b, mask_b, heads_a, heads_b)
    _check_kernel_device(qkv_a, qkv_b)
    out_a = qkv_a.new_empty((*qkv_a.shape[:2], qkv_a.shape[2] // 3))
    out_b = qkv_b.new_empty((*qkv_b.shape[:2], qkv_b.shape[2] // 3))
    qa, ma, La, Ha, hda = _tower(qkv_a, mask_a, heads_a)
    qb, mb, Lb, Hb, hdb = _tower(qkv_b, mask_b, heads_b)
    lib = cuda_build.library()
    with torch.cuda.device(qkv_a.device):
        err = lib.sc_attention_pair_fwd(
            qa, ma, out_a.data_ptr(), La, Ha, hda, qb, mb, out_b.data_ptr(), Lb, Hb, hdb,
            qkv_a.shape[0], cuda_build.DTYPE_CODES[qkv_a.dtype], hda ** -0.5, hdb ** -0.5,
            torch.cuda.current_stream(qkv_a.device).cuda_stream)
    cuda_build.check(lib, err, "fused_attention_pair launch")
    fused_attention_pair.launches += 1
    return out_a, out_b


def fused_attention_pair_bwd(qkv_a: torch.Tensor, mask_a: Optional[torch.Tensor],
                             g_a: torch.Tensor, qkv_b: torch.Tensor,
                             mask_b: Optional[torch.Tensor], g_b: torch.Tensor,
                             heads_a: int, heads_b: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward of :func:`fused_attention_pair` in one launch: given each
    context's cotangent (cast to qkv's dtype, as ``_pair_bwd_impl`` casts
    it), returns (dqkv_a, dqkv_b), each in its qkv's shape and dtype, with
    the softmax statistics recomputed and no bias gradient. Each tower must
    fit the resident backward body (``fused_attention.check_resident``;
    longer is ROADMAP Queue 2 A1). Counts each
    kernel launch in ``fused_attention_pair_bwd.launches``."""
    g_a = _check_bwd(qkv_a, mask_a, g_a, heads_a)
    g_b = _check_bwd(qkv_b, mask_b, g_b, heads_b)
    _check_pair(qkv_a, qkv_b)
    for qkv, heads in ((qkv_a, heads_a), (qkv_b, heads_b)):
        check_resident_qkv(qkv, heads, True, "fused_attention_pair_bwd")
    if cuda_build.plain_device(qkv_a):
        return reference_attention_pair_bwd(qkv_a, mask_a, g_a, qkv_b, mask_b, g_b, heads_a,
                                            heads_b)
    _check_kernel_device(qkv_a, g_a, qkv_b, g_b)
    dqkv_a, dqkv_b = torch.empty_like(qkv_a), torch.empty_like(qkv_b)
    qa, ma, La, Ha, hda = _tower(qkv_a, mask_a, heads_a)
    qb, mb, Lb, Hb, hdb = _tower(qkv_b, mask_b, heads_b)
    lib = cuda_build.library()
    with torch.cuda.device(qkv_a.device):
        err = lib.sc_attention_pair_bwd(
            qa, ma, g_a.data_ptr(), dqkv_a.data_ptr(), La, Ha, hda,
            qb, mb, g_b.data_ptr(), dqkv_b.data_ptr(), Lb, Hb, hdb,
            qkv_a.shape[0], cuda_build.DTYPE_CODES[qkv_a.dtype], hda ** -0.5, hdb ** -0.5,
            torch.cuda.current_stream(qkv_a.device).cuda_stream)
    cuda_build.check(lib, err, "fused_attention_pair_bwd launch")
    fused_attention_pair_bwd.launches += 1
    return dqkv_a, dqkv_b


fused_attention_pair.launches = 0
fused_attention_pair_bwd.launches = 0


class PairAttention(torch.autograd.Function):
    """:func:`fused_attention_pair` with :func:`fused_attention_pair_bwd` as
    its backward (the custom VJP of JAX's ``fused_attention_pair``): dqkv of
    each tower flows back to what made its qkv; the masks get no gradient."""

    @staticmethod
    def forward(ctx, qkv_a, mask_a, qkv_b, mask_b, heads_a: int, heads_b: int):
        ctx.save_for_backward(qkv_a, mask_a, qkv_b, mask_b)
        ctx.heads = (heads_a, heads_b)
        return fused_attention_pair(qkv_a, mask_a, qkv_b, mask_b, heads_a, heads_b)

    @staticmethod
    def backward(ctx, g_a, g_b):
        qkv_a, mask_a, qkv_b, mask_b = ctx.saved_tensors
        dqkv_a, dqkv_b = fused_attention_pair_bwd(qkv_a, mask_a, g_a, qkv_b, mask_b, g_b,
                                                  *ctx.heads)
        return dqkv_a, None, dqkv_b, None, None, None
