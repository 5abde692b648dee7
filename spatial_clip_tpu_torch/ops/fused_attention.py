"""Fused multi-head attention forward over a raw fused-qkv tensor.

Counterpart of ``spatial_clip_tpu/ops/fused_attention.py``: the forward of
``fused_attention`` (its ``_attn_fwd_impl`` -> ``_fwd_kernel``). On a CUDA
tensor :func:`fused_attention` launches the hand-written kernel in
``csrc/fused_attention_fwd.cu``; on a CPU tensor it runs
:func:`reference_attention`, the plain PyTorch version of the same math.
It never falls back from one to the other: a CUDA tensor either goes
through the kernel or raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from spatial_clip_tpu_torch.ops import cuda_build

HEAD_DIMS = (32, 64, 128)
MAX_SEQ = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def supported(heads: int, width: int) -> bool:
    """Whether the kernel takes ``heads`` heads over ``width`` channels."""
    return width % heads == 0 and width // heads in HEAD_DIMS


def _check(qkv: torch.Tensor, mask: Optional[torch.Tensor], heads: int) -> None:
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be (B, L, 3*D); got {tuple(qkv.shape)}")
    B, L, three_d = qkv.shape
    D = three_d // 3
    if heads < 1 or D % heads or D // heads not in HEAD_DIMS:
        raise ValueError(
            f"head geometry heads={heads} width={D} is not taken: head_dim "
            f"must be one of {HEAD_DIMS}")
    if not 1 <= L <= MAX_SEQ or B < 1:
        raise ValueError(f"sequence length {L} (batch {B}) outside 1..{MAX_SEQ}")
    if qkv.dtype not in _DTYPE_CODES:
        raise ValueError(f"qkv dtype {qkv.dtype} not taken (float32 or bfloat16)")
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    if mask is not None:
        if mask.shape != (L, L) or mask.dtype != torch.float32:
            raise ValueError(
                f"mask must be a float32 ({L}, {L}) additive mask; got "
                f"{mask.dtype} {tuple(mask.shape)}")
        if mask.device != qkv.device or not mask.is_contiguous():
            raise ValueError("mask must be contiguous and on qkv's device")


def reference_attention(qkv: torch.Tensor, mask: Optional[torch.Tensor],
                        heads: int) -> torch.Tensor:
    """Plain PyTorch version with the TPU kernel's math (``_one_head_fwd``):
    f32 scores ``q k^T * hd^-1/2 + mask``, row max subtracted,
    ``e = exp(s - max)``, ``o = (e in v's dtype) v`` in f32, then
    ``o * 1/max(sum e, 1e-30)`` cast to the input dtype. Returns (B, L, D)."""
    B, L, three_d = qkv.shape
    D = three_d // 3
    hd = D // heads
    q, k, v = qkv.float().view(B, L, 3, heads, hd).permute(2, 0, 3, 1, 4)
    s = torch.matmul(q, k.transpose(-1, -2)) * hd ** -0.5
    if mask is not None:
        s = s + mask
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    sigma = e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(e.to(qkv.dtype).float(), v) * (1.0 / sigma)
    return o.to(qkv.dtype).transpose(1, 2).reshape(B, L, D)


def fused_attention(qkv: torch.Tensor, mask: Optional[torch.Tensor],
                    heads: int) -> torch.Tensor:
    """Multi-head self-attention over a fused qkv tensor.

    qkv: (B, L, 3*D) contiguous, float32 or bfloat16; head h of q, k and v
    sits at columns ``h*hd:(h+1)*hd`` of the three D-wide blocks.
    mask: (L, L) additive float32 mask, or None. Returns the context
    (B, L, D) in qkv's dtype. Counts each kernel launch in
    ``fused_attention.launches``.
    """
    _check(qkv, mask, heads)
    if qkv.device.type == "cpu":
        return reference_attention(qkv, mask, heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"no kernel for device {qkv.device}")
    if qkv.data_ptr() % 16:
        raise ValueError("qkv must be 16-byte aligned (the kernel reads 16-byte vectors)")
    B, L, three_d = qkv.shape
    D = three_d // 3
    hd = D // heads
    lib = cuda_build.library()
    out = torch.empty((B, L, D), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        err = lib.sc_attention_fwd(
            qkv.data_ptr(), None if mask is None else mask.data_ptr(),
            out.data_ptr(), B, L, heads, hd, _DTYPE_CODES[qkv.dtype],
            hd ** -0.5, torch.cuda.current_stream(qkv.device).cuda_stream)
    cuda_build.check(lib, err, "fused_attention_fwd launch")
    fused_attention.launches += 1
    return out


fused_attention.launches = 0
