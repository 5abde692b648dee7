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
the other, and it raises on a CUDA input that requires grad. The bf16 kernel
runs the products on wgmma fed by TMA, with the weight stages shared across
a cluster of CTAs, and the attention on the tensor-core body; :func:`plan`
mirrors how it cuts its work and its shared memory.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from spatial_clip_tpu_torch.ops import cuda_build
from spatial_clip_tpu_torch.ops.fused_attention import (
    MAX_SMEM_BYTES,
    _mm_f32,
    fwd_smem_bytes,
    reference_attention,
)

HEAD_DIMS = (32, 64, 128)
MAX_SEQ = 128  # rows of a sequence, rounded up to 16
MAX_WIDTH = 1024
_CHUNK = 64  # csrc/fused_block.cu: the f32 kernel's product columns and weight chunk
_ATTN_WARPS, _ATTN_ROWS = 8, 2  # the f32 attention body's block (csrc/attention_fwd.cuh)
# csrc/fused_block.cu's design constants of the bf16 kernel (SC_BLOCK_CLUSTER,
# SC_BLOCK_MAX_STAGES), its stage depth and short row boxes
CLUSTER, MAX_STAGES = 2, 4
DEPTH, BOX_ROWS, WARPS = 64, 16, 12  # 64-deep stages, 16-row boxes, 12 warps a CTA
PLAN_KEYS = ("rp", "mt", "nc", "n_k", "qkv_passes", "out_passes", "box_rows", "head_groups",
             "st_tiles", "stages", "cluster", "slab", "a_region", "stage_bytes", "smem")


def _round_up(n: int, to: int = 128) -> int:
    return (n + to - 1) // to * to


def plan(seq: int, width: int, heads: int, cluster: int = CLUSTER,
         max_stages: int = MAX_STAGES) -> dict:
    """The bf16 kernel's plan at these shapes (mirrors ``blk::Plan``): a CTA
    owns one sequence of ``rp`` rows (L rounded up to 16) as ``mt`` m64
    tiles, each stored (and its residual landed) in one 64-row box;
    products in passes of ``nc`` output columns over ``n_k`` 64-deep
    stages of W (``nc`` rows, landed in boxes of ``box_rows`` rows split
    across the cluster); shared memory from a
    1024-byte aligned base: the A slabs (``rp`` x 64 a K-tile, the pad
    the last m64 tile reads past them, or the attention body's space if
    larger: ``a_region``, where ``head_groups`` heads run at once, each on
    12 / head_groups warps that hold one m-tile each: three at L <= 64,
    two at L <= 96, where their bodies fit), ``st_tiles`` 64 x 64 staging tiles for each
    consumer warpgroup's epilogue (two where they leave room for two ring
    stages), ``stages`` ring stages of ``stage_bytes``, the barriers."""
    rp = (seq + 15) // 16 * 16
    mt = 1 if rp <= 64 else 2
    nc = 256 // mt
    n_k = width // DEPTH
    blocks = nc // 64
    slab = rp * 128
    body = fwd_smem_bytes(seq, width // heads, torch.bfloat16)
    a_region = _round_up(max(n_k * slab + mt * 8192 - slab, body), 1024)
    head_groups = next((g for g in (3, 2) if -(-seq // 16) <= WARPS // g and g * body <= a_region),
                       1)
    for st_tiles in (2, 1):
        fixed = 1024 + a_region + 2 * st_tiles * 8192 + 8 * (2 * max_stages + 3)
        room = (MAX_SMEM_BYTES - fixed) // (nc * 128) if MAX_SMEM_BYTES > fixed else 0
        if room >= 2:
            break
    stages = min(max(room, 2), max_stages)
    return dict(rp=rp, mt=mt, nc=nc, n_k=n_k,
                qkv_passes=-(-3 * width // nc), out_passes=-(-width // nc),
                box_rows=64 * blocks // max(blocks, cluster), head_groups=head_groups,
                st_tiles=st_tiles, stages=stages,
                cluster=cluster, slab=slab, a_region=a_region, stage_bytes=nc * 128,
                smem=(1024 + a_region + 2 * st_tiles * 8192 + stages * nc * 128
                      + 8 * (2 * stages + 3)))


def kernel_plan(seq: int, width: int, heads: int) -> dict:
    """:func:`plan` as the kernel library computes it (needs the card's
    build): the plan the bf16 launch runs."""
    lib = cuda_build.library()
    values = (ctypes.c_int * len(PLAN_KEYS))()
    cuda_build.check(lib, lib.sc_block_attn_plan(seq, width, heads, values), "sc_block_attn_plan")
    return dict(zip(PLAN_KEYS, values))


def weight_bytes(p: dict) -> Tuple[int, int]:
    """Bytes of W_qkv and W_out that one CTA of the bf16 kernel lands into
    its shared memory under plan ``p`` (:func:`plan` or :func:`kernel_plan`),
    and that it reads from L2 (its share of the cluster's multicasts): every
    pass's stages, columns past the weight zero-filled. Derived from the
    plan, not measured."""
    landed = (p["qkv_passes"] + p["out_passes"]) * p["n_k"] * p["stage_bytes"]
    return landed, landed // p["cluster"]


def smem_bytes(seq: int, width: int, heads: int, dtype: torch.dtype) -> int:
    """Shared memory one block of the kernel needs; mirrors
    ``sc_block_attn_smem_bytes``. bf16: :func:`plan`'s. f32: the normalized
    rows (L rounded up to 16, 16-byte padded), two weight chunks (64 x 64),
    the f32 product tile (64 columns), the head's q|k|v tile, and the
    attention body's K tile and per-warp rows."""
    if dtype == torch.bfloat16:
        return plan(seq, width, heads)["smem"]
    item = 4
    pad, hd = 16 // item, width // heads
    lp = (seq + 15) // 16 * 16
    total = (_round_up(lp * (width + pad) * item) + 2 * _round_up(_CHUNK * (_CHUNK + pad) * item)
             + _round_up(lp * (_CHUNK + 4) * 4) + _round_up(seq * 3 * hd * item))
    seq4 = (seq + 3) // 4 * 4
    return total + seq * (hd + pad) * item + _ATTN_WARPS * _ATTN_ROWS * (hd + seq4) * 4


def supported(seq: int, width: int, heads: int, dtype: torch.dtype) -> bool:
    """Whether the kernel takes this geometry: a width that is a multiple of
    64 up to 1024, a head dim of 32, 64 or 128, L up to 128 (rounded up to
    16) and one CTA's working set within its shared memory."""
    return (heads >= 1 and width % heads == 0 and width // heads in HEAD_DIMS
            and width % _CHUNK == 0 and width <= MAX_WIDTH and 1 <= seq
            and (seq + 15) // 16 * 16 <= MAX_SEQ and dtype in cuda_build.DTYPE_CODES
            and smem_bytes(seq, width, heads, dtype) <= MAX_SMEM_BYTES)


def workspace_numel(batch: int, seq: int, width: int) -> int:
    """Elements of the bf16 kernel's workspace: q|k|v (B, L, 3D), then the
    context (B, L, D)."""
    return batch * seq * 4 * width


def split_workspace(workspace: torch.Tensor, batch: int, seq: int,
                    width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The q|k|v (B, L, 3D) and context (B, L, D) views of a workspace of
    :func:`workspace_numel` elements."""
    n = batch * seq * 3 * width
    flat = workspace.view(-1)
    return flat[:n].view(batch, seq, 3 * width), flat[n:].view(batch, seq, width)


def reference_block_qkv(x: torch.Tensor, ln_weight: torch.Tensor, ln_bias: torch.Tensor,
                        w_qkv: torch.Tensor, b_qkv: torch.Tensor,
                        eps: float = 1e-5) -> torch.Tensor:
    """The plain version's q|k|v (B, L, 3D) in x's dtype: one-pass f32
    LayerNorm statistics (var = max(E[x^2] - mean^2, 0)), h in x's dtype,
    h W_qkv^T summed in f32 plus the f32 bias, rounded once."""
    B, L, D = x.shape
    dtype = x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    h = (xf - mean) * torch.rsqrt(var + eps)
    h = (h * ln_weight.float() + ln_bias.float()).to(dtype)
    return (_mm_f32(h.view(B * L, D), w_qkv.to(dtype).t()) + b_qkv.float()).to(dtype).view(
        B, L, 3 * D)


def reference_block_attn(x: torch.Tensor, ln_weight: torch.Tensor, ln_bias: torch.Tensor,
                         w_qkv: torch.Tensor, b_qkv: torch.Tensor, w_out: torch.Tensor,
                         b_out: torch.Tensor, mask: Optional[torch.Tensor], heads: int,
                         eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version with ``_block_kernel``'s math and rounding
    points: q|k|v of :func:`reference_block_qkv`; per head the inference
    attention of :func:`reference_attention` (context in x's dtype); o =
    ctx W_out^T summed in f32 plus the f32 bias; out = (x in f32 + o) in x's
    dtype. Weights are cast to x's dtype at use, biases and LayerNorm
    parameters to f32."""
    B, L, D = x.shape
    qkv = reference_block_qkv(x, ln_weight, ln_bias, w_qkv, b_qkv, eps)
    ctx = reference_attention(qkv, mask, heads)
    o = _mm_f32(ctx.view(B * L, D), w_out.to(x.dtype).t()) + b_out.float()
    return (x.float() + o.view(B, L, D)).to(x.dtype)


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
                     eps: float = 1e-5, workspace: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x + (attention(LN(x) W_qkv^T + b_qkv) W_out^T + b_out)`` in one
    kernel launch, forward only.

    x (B, L, D) float32 or bfloat16; ln_weight, ln_bias (D,); w_qkv (3D, D)
    and w_out (D, D) in the port's (out, in) layouts (``attn.in_proj_weight``,
    ``out_proj.weight``), cast to x's dtype; b_qkv (3D,), b_out (D,), used in
    f32; mask (L, L) additive float32 or None. Returns (B, L, D) in x's
    dtype. On the card it takes the geometries :func:`supported` names and
    raises ValueError on any other, and on inputs that require grad. Counts
    each kernel launch in ``fused_block_attn.launches``.

    ``workspace``: the bf16 kernel's scratch, :func:`workspace_numel`
    elements in x's dtype on x's device, where it leaves q|k|v and each
    head's context (:func:`split_workspace`); allocated per call when None.
    The plain version and the f32 kernel do not use it.
    """
    _check(x, ln_weight, ln_bias, w_qkv, b_qkv, w_out, b_out, mask, heads)
    if cuda_build.plain_device(x):
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
    qkv = ctx = None
    if dtype == torch.bfloat16:
        if workspace is None:
            workspace = torch.empty((workspace_numel(B, L, D),), dtype=dtype, device=x.device)
        if (workspace.dtype != dtype or workspace.device != x.device
                or workspace.numel() != workspace_numel(B, L, D) or not workspace.is_contiguous()):
            raise ValueError(f"workspace must be {workspace_numel(B, L, D)} contiguous {dtype} "
                             f"elements on {x.device}")
        qkv, ctx = (t.data_ptr() for t in split_workspace(workspace, B, L, D))
        if qkv % 16 or ctx % 16:
            raise ValueError("fused_block_attn's workspace must be 16-byte aligned")
    lib = cuda_build.library()
    with torch.cuda.device(x.device):
        err = lib.sc_block_attn_fwd(
            *(t.data_ptr() for t in args), None if mask is None else mask.data_ptr(), qkv, ctx,
            out.data_ptr(), B, L, D, heads, cuda_build.DTYPE_CODES[dtype], eps,
            (D // heads) ** -0.5, torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(lib, err, "fused_block_attn launch")
    fused_block_attn.launches += 1
    return out


fused_block_attn.launches = 0
