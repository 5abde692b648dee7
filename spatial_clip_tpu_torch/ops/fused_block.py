"""The attention half of a pre-LN transformer block in one kernel, forward
only: ``x + out_proj(attention(qkv_proj(LN(x))))``.

Counterpart of ``spatial_clip_tpu/ops/fused_block.py`` (``fused_block_attn``
-> ``_block_kernel``), which the JAX package measures against the unfused
block (``scripts/bench_block_kernel.py``; the port's is
``spatial_clip_tpu_torch.bench_block``); no model path calls it. Forward only,
as in JAX.

On a CUDA tensor :func:`fused_block_attn` launches ``csrc/fused_block.cu``;
on a CPU tensor it runs :func:`reference_block_attn`, the plain version with
the TPU kernel's math and rounding points. It never falls back from one to
the other, and it raises on a CUDA input that requires grad.
"""
from __future__ import annotations

from typing import Optional

import torch

from spatial_clip_tpu_torch.ops import cuda_build
from spatial_clip_tpu_torch.ops.fused_attention import MAX_SMEM_BYTES, _mm_f32, reference_attention

HEAD_DIMS = (32, 64, 128)
MAX_SEQ = 128  # rows of a sequence, rounded up to 16
MAX_WIDTH = 1024
_CHUNK = 64  # csrc/fused_block.cu: columns of a product pass and of a weight chunk
_ATTN_WARPS, _ATTN_ROWS = 8, 2  # the attention body's block (csrc/attention_fwd.cuh)


def _round_up(n: int, to: int = 128) -> int:
    return (n + to - 1) // to * to


def smem_bytes(seq: int, width: int, heads: int, dtype: torch.dtype) -> int:
    """Shared memory one block of the kernel needs: the normalized rows (L
    rounded up to 16, 16-byte padded), two weight chunks (64 x 64), the f32
    product tile (64 columns), the head's q|k|v tile, and the attention
    body's K tile and per-warp rows. Mirrors ``sc_block_attn_smem_bytes``."""
    item = torch.empty((), dtype=dtype).element_size()
    pad, hd = 16 // item, width // heads
    lp = (seq + 15) // 16 * 16
    total = (_round_up(lp * (width + pad) * item) + 2 * _round_up(_CHUNK * (_CHUNK + pad) * item)
             + _round_up(lp * (_CHUNK + 4) * 4) + _round_up(seq * 3 * hd * item))
    seq4 = (seq + 3) // 4 * 4
    return total + seq * (hd + pad) * item + _ATTN_WARPS * _ATTN_ROWS * (hd + seq4) * 4


def supported(seq: int, width: int, heads: int, dtype: torch.dtype) -> bool:
    """Whether the kernel takes this geometry: a width that is a multiple of
    64 up to 1024, a head dim of 32, 64 or 128, L up to 128 (rounded up to
    16) and one sequence's working set within a block's shared memory."""
    return (heads >= 1 and width % heads == 0 and width // heads in HEAD_DIMS
            and width % _CHUNK == 0 and width <= MAX_WIDTH and 1 <= seq
            and (seq + 15) // 16 * 16 <= MAX_SEQ and dtype in cuda_build.DTYPE_CODES
            and smem_bytes(seq, width, heads, dtype) <= MAX_SMEM_BYTES)


def reference_block_attn(x: torch.Tensor, ln_weight: torch.Tensor, ln_bias: torch.Tensor,
                         w_qkv: torch.Tensor, b_qkv: torch.Tensor, w_out: torch.Tensor,
                         b_out: torch.Tensor, mask: Optional[torch.Tensor], heads: int,
                         eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version with ``_block_kernel``'s math and rounding
    points: one-pass f32 LayerNorm statistics (var = max(E[x^2] - mean^2,
    0)), h in x's dtype; qkv = h W_qkv^T summed in f32 plus the f32 bias,
    in x's dtype; per head the inference attention of
    :func:`reference_attention` (context in x's dtype); o = ctx W_out^T
    summed in f32 plus the f32 bias; out = (x in f32 + o) in x's dtype.
    Weights are cast to x's dtype at use, biases and LayerNorm parameters to
    f32."""
    B, L, D = x.shape
    dtype = x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    h = (xf - mean) * torch.rsqrt(var + eps)
    h = (h * ln_weight.float() + ln_bias.float()).to(dtype)
    qkv = (_mm_f32(h.view(B * L, D), w_qkv.to(dtype).t()) + b_qkv.float()).to(dtype)
    ctx = reference_attention(qkv.view(B, L, 3 * D), mask, heads)
    o = _mm_f32(ctx.view(B * L, D), w_out.to(dtype).t()) + b_out.float()
    return (xf + o.view(B, L, D)).to(dtype)


def _check(x, ln_weight, ln_bias, w_qkv, b_qkv, w_out, b_out, mask, heads) -> None:
    if x.dim() != 3:
        raise ValueError(f"x must be (B, L, D); got {tuple(x.shape)}")
    B, L, D = x.shape
    if heads < 1 or D % heads:
        raise ValueError(f"width {D} is not a multiple of heads={heads}")
    want = {"ln_weight": (D,), "ln_bias": (D,), "w_qkv": (3 * D, D), "b_qkv": (3 * D,),
            "w_out": (D, D), "b_out": (D,)}
    got = dict(ln_weight=ln_weight, ln_bias=ln_bias, w_qkv=w_qkv, b_qkv=b_qkv, w_out=w_out,
               b_out=b_out)
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"{name} must be {shape}; got {tuple(got[name].shape)}")
        if got[name].device != x.device:
            raise ValueError(f"{name} must be on x's device")
    if x.dtype not in cuda_build.DTYPE_CODES:
        raise ValueError(f"x dtype {x.dtype} not taken (float32 or bfloat16)")
    if mask is not None and (mask.shape != (L, L) or mask.dtype != torch.float32
                             or mask.device != x.device):
        raise ValueError(f"mask must be a float32 ({L}, {L}) additive mask on x's device; got "
                         f"{mask.dtype} {tuple(mask.shape)}")


def fused_block_attn(x: torch.Tensor, ln_weight: torch.Tensor, ln_bias: torch.Tensor,
                     w_qkv: torch.Tensor, b_qkv: torch.Tensor, w_out: torch.Tensor,
                     b_out: torch.Tensor, mask: Optional[torch.Tensor], heads: int,
                     eps: float = 1e-5) -> torch.Tensor:
    """``x + (attention(LN(x) W_qkv^T + b_qkv) W_out^T + b_out)`` in one
    kernel launch, forward only.

    x (B, L, D) float32 or bfloat16; ln_weight, ln_bias (D,); w_qkv (3D, D)
    and w_out (D, D) in the port's (out, in) layouts (``attn.in_proj_weight``,
    ``out_proj.weight``), cast to x's dtype; b_qkv (3D,), b_out (D,), used in
    f32; mask (L, L) additive float32 or None. Returns (B, L, D) in x's
    dtype. On the card it takes the geometries :func:`supported` names and
    raises ValueError on any other, and on inputs that require grad. Counts
    each kernel launch in ``fused_block_attn.launches``.
    """
    _check(x, ln_weight, ln_bias, w_qkv, b_qkv, w_out, b_out, mask, heads)
    if x.device.type == "cpu":
        return reference_block_attn(x, ln_weight, ln_bias, w_qkv, b_qkv, w_out, b_out, mask,
                                    heads, eps)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (
            x, ln_weight, ln_bias, w_qkv, b_qkv, w_out, b_out)):
        raise NotImplementedError("fused_block_attn is forward only, as in the JAX package: "
                                  "call it under torch.no_grad()")
    B, L, D = x.shape
    if not supported(L, D, heads, x.dtype):
        raise ValueError(f"block geometry L={L} D={D} heads={heads} {x.dtype} is not taken "
                         f"(needs {smem_bytes(L, D, heads, x.dtype)} B of shared memory)")
    dtype = x.dtype
    x = x.contiguous()
    args = [x, ln_weight.float(), ln_bias.float(), w_qkv.to(dtype), b_qkv.float(),
            w_out.to(dtype), b_out.float()]
    args = [t.contiguous() for t in args]
    if mask is not None:
        mask = mask.contiguous()
    if any(t.data_ptr() % 16 for t in args):
        raise ValueError("fused_block_attn's tensors must be 16-byte aligned")
    out = torch.empty_like(x)
    lib = cuda_build.library()
    with torch.cuda.device(x.device):
        err = lib.sc_block_attn_fwd(
            *(t.data_ptr() for t in args), None if mask is None else mask.data_ptr(),
            out.data_ptr(), B, L, D, heads, cuda_build.DTYPE_CODES[dtype], eps,
            (D // heads) ** -0.5, torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(lib, err, "fused_block_attn launch")
    fused_block_attn.launches += 1
    return out


fused_block_attn.launches = 0
