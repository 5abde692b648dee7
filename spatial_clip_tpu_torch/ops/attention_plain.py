"""The plain attention routes, JAX's ``einsum``, ``einsum_bf16``, ``xla``,
``fold`` and ``fold_bf16`` (``spatial_clip_tpu/models/transformer.py``
``Attention.__call__`` and ``_fold_attention``, :578-655), in plain PyTorch.

JAX takes them where ``attn_impl`` names them, and takes ``einsum``
wherever a kernel setting's gate fails: a head geometry that
``heads_per_block`` groups no heads of (``attention_variants.
attention_supported``), or a mask with a batch dimension. The towers route
the same way (``models.transformer.MultiHeadAttention``). JAX computes these
with XLA's ops, outside any Pallas kernel, so they have no kernel here
either: PyTorch's ops run them on the card and on the CPU alike. ``xla`` is
``jax.nn.dot_product_attention``, whose counterpart is
``F.scaled_dot_product_attention``. :func:`head_attention` is the einsum
attention the timm towers write inline (unequal query and key lengths, a
bias); :func:`encoder_attention` the Hugging Face encoders' (flax's
softmax in the compute dtype); :func:`dot_product_attention` the XLA core
of ``jax.nn.dot_product_attention``, CoCa's cross-attention. Each function
counts its calls in
``<function>.launches``, as the kernel wrappers count theirs, so that a run
shows which attention went where.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

PLAIN_IMPLS = ("xla", "einsum", "einsum_bf16", "fold", "fold_bf16")


def _softmax_attend(q, k, v, mask, scale: float, acc_dtype, scores: str, context: str):
    """JAX's einsum attention: scores ``einsum(q * scale, k)`` in the compute
    dtype, cast to ``acc_dtype`` (f32 for 'einsum', the compute dtype for
    'einsum_bf16'), the mask added and the softmax taken there, p cast to the
    compute dtype, then ``einsum(p, v)``."""
    attn = torch.einsum(scores, q * scale, k).to(acc_dtype)
    if mask is not None:
        attn = attn + mask.to(acc_dtype)
    return torch.einsum(context, torch.softmax(attn, dim=-1).to(q.dtype), v)


def plain_attention(qkv: torch.Tensor, mask: Optional[torch.Tensor], heads: int,
                    impl: str = "einsum") -> torch.Tensor:
    """Attention over a (B, L, 3D) qkv in the compute dtype, JAX's
    ``impl`` route: 'einsum' (f32 scores and softmax, p cast to the compute
    dtype; :607-617), 'einsum_bf16' (all in the compute dtype) or 'xla'
    (SDPA, the mask cast to the compute dtype). mask: additive, (L, L) or
    broadcastable to (B, heads, L, L), or None. Returns the context (B, L,
    D)."""
    B, L, three_d = qkv.shape
    D = three_d // 3
    q, k, v = (t.reshape(B, L, heads, D // heads) for t in qkv.split(D, dim=-1))
    plain_attention.launches += 1
    if impl == "xla":
        bias = None if mask is None else mask.to(qkv.dtype)
        out = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                             v.transpose(1, 2), attn_mask=bias)
        return out.transpose(1, 2).reshape(B, L, D)
    acc = qkv.dtype if impl == "einsum_bf16" else torch.float32
    out = _softmax_attend(q, k, v, mask, (D // heads) ** -0.5, acc, "bqhd,bkhd->bhqk",
                          "bhqk,bkhd->bqhd")
    return out.reshape(B, L, D)


def head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """JAX's einsum attention as the timm towers write it inline
    (``spatial_clip_tpu/models/timm_model.py``: the MAP and attention-pool
    heads, EVA's and Swin's blocks): q (B, Lq, D), k and v (B, Lk, D) in the
    compute dtype, scores ``einsum(q * hd^-1/2, k)`` cast to f32, ``bias``
    (an additive f32 (heads, Lq, Lk), Swin's relative positions) added, the
    softmax in f32, p cast to the compute dtype, ``einsum(p, v)``. Returns
    (B, Lq, D)."""
    B, Lq, D = q.shape
    hd = D // heads
    q, k, v = (t.reshape(t.shape[0], t.shape[1], heads, hd) for t in (q, k, v))
    head_attention.launches += 1
    out = _softmax_attend(q, k, v, bias, hd ** -0.5, torch.float32, "bqhd,bkhd->bhqk",
                          "bhqk,bkhd->bqhd")
    return out.reshape(B, Lq, D)


def encoder_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                      bias: Optional[torch.Tensor] = None, scale: Optional[str] = "div",
                      acc_dtype=None, drop=None) -> torch.Tensor:
    """The Hugging Face encoders' attention (``spatial_clip_tpu/models/
    hf_model.py``: transformers' Flax BERT and T5 through flax's
    ``dot_product_attention_weights``, and ``m2m_encoder.py``'s einsums): q,
    k, v (B, L, heads x hd) in the compute dtype; q divided by ``sqrt(hd)``
    in the compute dtype (``scale='div'``, flax's), multiplied by
    ``hd^-1/2`` (``'mul'``, the M2M encoder's) or left as it is (None, T5);
    the scores in ``acc_dtype`` (default: the compute dtype, flax's), the
    additive ``bias`` (the padding mask, T5's relative positions) and the
    softmax there, p cast to the compute dtype and passed through ``drop``
    (dropout, in a training step), then ``einsum(p, v)``. Returns (B, L, heads
    x hd)."""
    B, L, D = q.shape
    hd = D // heads
    q, k, v = (t.reshape(t.shape[0], t.shape[1], heads, hd) for t in (q, k, v))
    if scale == "div":
        q = q / torch.tensor(hd ** 0.5, dtype=q.dtype, device=q.device)
    elif scale == "mul":
        q = q * hd ** -0.5
    encoder_attention.launches += 1
    attn = torch.einsum("bqhd,bkhd->bhqk", q, k).to(acc_dtype or q.dtype)
    if bias is not None:
        attn = attn + bias
    p = torch.softmax(attn, dim=-1).to(q.dtype)
    if drop is not None:
        p = drop(p)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, L, D)


def fold_attention(x: torch.Tensor, w_qkv: torch.Tensor, b_qkv: torch.Tensor,
                   w_out: torch.Tensor, b_out: torch.Tensor, mask: Optional[torch.Tensor],
                   heads: int, impl: str = "fold") -> torch.Tensor:
    """JAX's ``_fold_attention``: q, k and v projected straight into the
    head-split (3, B, H, L, hd) form by one einsum with the (3D, Din) weight
    viewed as (3, H, hd, Din), the einsum attention (scores in f32 under
    'fold', in the compute dtype under 'fold_bf16'), and the output
    projection contracting (h, d) in one einsum with the (W, D) weight
    viewed as (W, H, hd). x and every weight in the compute dtype. Returns
    (B, L, W)."""
    D, din = w_qkv.shape[0] // 3, w_qkv.shape[1]
    hd = D // heads
    qkv = (torch.einsum("bld,thkd->tbhlk", x, w_qkv.view(3, heads, hd, din))
           + b_qkv.view(3, 1, heads, 1, hd))
    q, k, v = qkv.unbind(0)
    fold_attention.launches += 1
    acc = x.dtype if impl == "fold_bf16" else torch.float32
    out = _softmax_attend(q, k, v, mask, hd ** -0.5, acc, "bhqd,bhkd->bhqk", "bhqk,bhkd->bhqd")
    return torch.einsum("bhqd,whd->bqw", out, w_out.view(w_out.shape[0], heads, hd)) + b_out


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``jax.nn.dot_product_attention(q, k, v)`` with no bias or mask, as
    its XLA core computes it (``jax/_src/nn/functions.py``,
    ``_dot_product_attention_core``): q (B, T, N, H), k and v (B, S, N, H)
    in the compute dtype; the logits q.k as exact products summed in f32
    (XLA's BF16_BF16_F32 preset: the compute-dtype inputs widened to f32,
    whose products they represent exactly), scaled by H^-1/2 in f32
    afterwards, the softmax in f32, the probabilities rounded to the
    compute dtype, then P.V in the compute dtype. Returns (B, T, N, H)."""
    dot_product_attention.launches += 1
    logits = torch.einsum("btnh,bsnh->bnts", q.float(), k.float())
    logits = logits * torch.tensor(1.0 / math.sqrt(q.shape[-1]), dtype=torch.float32,
                                   device=q.device)
    probs = torch.softmax(logits, dim=-1).to(k.dtype)
    return torch.einsum("bnts,bsnh->btnh", probs, v)


plain_attention.launches = 0
head_attention.launches = 0
dot_product_attention.launches = 0
encoder_attention.launches = 0
fold_attention.launches = 0
