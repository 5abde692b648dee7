"""Fused multi-head attention over a raw fused-qkv tensor, forward and backward.

Counterpart of ``spatial_clip_tpu/ops/fused_attention.py``:

- :func:`fused_attention`: the inference forward (``_attn_fwd_impl`` ->
  ``_fwd_kernel``);
- :func:`fused_attention_lse`: the training forward that also returns each
  row's logsumexp (``_fwd_pallas_lse`` -> ``_fwd_kernel_lse``);
- :func:`fused_attention_bwd`: the backward from that logsumexp, with the
  qkv-bias gradient (``_bwd_pallas3_db_lse`` -> ``_bwd_kernel3_db_lse``);
- :func:`fused_attention_bwd_recompute`: the backward that recomputes the
  softmax statistics from the scores, without the bias gradient
  (``_bwd_pallas`` -> ``_bwd_kernel``, and ``_bwd_pallas3`` ->
  ``_bwd_kernel3``, which computes the same in another layout);
- :func:`fused_attention_bwd_recompute_db`: the recompute backward with the
  bias gradient (``_bwd_pallas3_db`` -> ``_bwd_kernel3_db``);
- :class:`QKVAttention`: the qkv projection and attention as one autograd
  function (``qkv_attention`` and its custom VJP), routed as JAX routes it:
  the forward saves the logsumexp where :func:`lse_ok` holds, and the
  backward is picked by :data:`BWD_FUSE` and whether an lse was saved, plus
  the dW GEMM and, outside ``'dxdb'`` (whose kernel,
  ``attention_variants.fused_attention_bwd_dx``, forms dx itself), the dx
  GEMM;
- :class:`FusedAttention`: attention over a given qkv as one autograd
  function (``fused_attention`` and its custom VJP): the inference forward,
  and the recompute backward. The towers reach it where the fused LayerNorm
  -> qkv projection makes qkv, and under ``attn_impl='pallas_inter'``.

``interleaved=True`` (JAX's ``fused_attention(..., interleaved)``) takes qkv
with its columns in ``attention_variants.interleave_perm`` order and routes
to that module's interleaved kernels, which count their own launches.

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/fused_attention_fwd.cu``, ``csrc/fused_attention_bwd.cu``) where the
resident bodies take the length (:func:`fwd_max_seq`, :func:`bwd_max_seq`:
one (batch, head) in a block's shared memory), and past it the key-tiled
kernels of ``csrc/attention_long.cu`` through ``ops.attention_long``, which
count their own launches; on a CPU tensor it runs its plain PyTorch version
(``reference_attention``, ``reference_attention_lse``,
``reference_attention_bwd``), which has the TPU kernel's math at any length.
It never falls back from one to the other: a CUDA tensor either goes through
a kernel or raises.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from spatial_clip_tpu_torch.ops import cuda_build

HEAD_DIMS = (32, 64, 128)
# The resident bodies' lengths (their ``takes`` in csrc/attention_fwd.cuh and
# csrc/attention_bwd.cuh): the f32 bodies keep a row's scores in registers,
# 256 keys; shared memory bounds the rest (:func:`fwd_max_seq`,
# :func:`bwd_max_seq`). The pair, layout and dx kernels, built on the same
# bodies, are held to VARIANT_MAX_SEQ (their ``kMaxSeq``).
SIMT_MAX_SEQ = 256
VARIANT_MAX_SEQ = 256
# the bodies' block geometry (csrc/attention_fwd.cuh, csrc/attention_bwd.cuh):
# bf16 on the tensor cores in tiles of 16 query rows and 16 keys; f32 on the
# CUDA cores, 8 warps of 2 query rows a pass (the backward's phase 1)
_TILE = 16
_SIMT_WARPS, _SIMT_ROWS = 8, 2
MAX_SMEM_BYTES = 232448  # 227 KB: the most shared memory a block may use on sm_90

# QKVAttention's backward, read at backward time as JAX reads its
# ``BWD_FUSE``: 'db' (the default) computes the qkv-bias gradient in the
# kernel; 'none' takes the no-db kernel and sums dqkv in f32 outside it;
# 'dxdb' takes the recompute kernel that forms db and the projection's input
# gradient dx too (``attention_variants.fused_attention_bwd_dx``), whatever
# the forward saved.
BWD_FUSE = "db"

# JAX's batch-block caps (``FWD_BLOCK_CAP``, ``_bwd_cap``); lse_ok only
_FWD_BLOCK_CAP = 32
_SHORT_SEQ = 128


def _pick_block_b(B: int, cap: int) -> int:
    for bb in (64, 32, 16, 8, 4, 2, 1):
        if bb <= cap and B % bb == 0:
            return bb
    return 1


def lse_ok(B: int, L: int) -> bool:
    """Whether JAX's ``qkv_attention`` saves the logsumexp for a batch of B
    sequences of length L (``_lse_ok``, with ``_pick_block_b`` and
    ``_bwd_cap`` at their defaults): the TPU kernels' lse block needs a
    batch block that is a multiple of 8 or the whole batch, in the forward's
    grid and the backward's. It reproduces JAX's routing and means nothing
    for the card: a batch that is not a multiple of 8 and is larger than 4
    (3, 6, 12, 100, ...) fails it, and JAX then trains it through the
    recompute backward with db."""
    for cap in (_FWD_BLOCK_CAP, 64 if L <= _SHORT_SEQ else 32):
        bb = _pick_block_b(B, cap)
        if bb % 8 != 0 and bb != B:
            return False
    return True


def supported(heads: int, width: int) -> bool:
    """Whether the forward kernels take ``heads`` heads over ``width`` channels."""
    return width % heads == 0 and width // heads in HEAD_DIMS


def bwd_smem_bytes(seq: int, head_dim: int, dtype: torch.dtype) -> int:
    """Shared memory one block of the backward kernel needs, in every
    option. bf16: q, k, v and do of one (batch, head) as four tiles of
    :func:`fwd_rows` rows of head_dim elements plus 16 bytes of pad, three
    f32 values a row (the softmax statistics and the row term r), and the
    f32 column sums of each 16-row tile's dq, dk and dv (db). f32: Q, K, V
    and do in 16-byte padded rows, the p and ds tiles (seq x seq rounded up
    to 8), and f32 per-warp rows and db partials. Mirrors
    ``sc_attention_bwd_smem_bytes``."""
    if dtype == torch.bfloat16:
        rows = fwd_rows(seq, dtype)
        return 4 * rows * (head_dim + 8) * 2 + 3 * rows * 4 + rows // _TILE * 3 * head_dim * 4
    item = torch.empty((), dtype=dtype).element_size()
    stride = head_dim + 16 // item
    seq_pad = (seq + 7) // 8 * 8
    warp_floats = _SIMT_ROWS * (2 * head_dim + seq_pad)
    return ((4 * seq * stride + 2 * seq * seq_pad) * item
            + (_SIMT_WARPS * warp_floats + _SIMT_WARPS * 3 * head_dim) * 4)


def fwd_rows(seq: int, dtype: torch.dtype) -> int:
    """Rows of each operand the bf16 bodies (forward and backward) stage for
    a sequence of ``seq``: ``seq`` rounded up to a 16-row tile, the rows past
    it zero (the padded keys as many). The f32 bodies pad none."""
    if dtype == torch.bfloat16:
        return (seq + _TILE - 1) // _TILE * _TILE
    return seq


def fwd_smem_bytes(seq: int, head_dim: int, dtype: torch.dtype) -> int:
    """Shared memory one block of the forward kernel needs. bf16: the q, k
    and v tiles of one (batch, head), :func:`fwd_rows` rows of head_dim
    elements plus 16 bytes of pad, and an f32 row max per row. f32: K in
    16-byte padded rows, and per warp f32 query rows and a score row padded
    to 4. Mirrors ``sc_attention_fwd_smem_bytes``."""
    if dtype == torch.bfloat16:
        rows = fwd_rows(seq, dtype)
        return 3 * rows * (head_dim + 8) * 2 + rows * 4
    seq_pad = (seq + 3) // 4 * 4
    warp_floats = _SIMT_ROWS * (head_dim + seq_pad)
    return seq * (head_dim + 4) * 4 + _SIMT_WARPS * warp_floats * 4


def fwd_takes(seq: int, head_dim: int, dtype: torch.dtype) -> bool:
    """Whether the resident forward body takes a sequence of ``seq``: one
    (batch, head) within a block's shared memory and (f32) at most
    SIMT_MAX_SEQ keys. Mirrors ``sc::fwd::takes``."""
    return (seq >= 1 and fwd_smem_bytes(seq, head_dim, dtype) <= MAX_SMEM_BYTES
            and (dtype == torch.bfloat16 or seq <= SIMT_MAX_SEQ))


def bwd_takes(seq: int, head_dim: int, dtype: torch.dtype) -> bool:
    """Whether the resident backward body takes a sequence of ``seq``.
    Mirrors ``sc::bwd::takes``."""
    return (seq >= 1 and bwd_smem_bytes(seq, head_dim, dtype) <= MAX_SMEM_BYTES
            and (dtype == torch.bfloat16 or seq <= SIMT_MAX_SEQ))


@functools.lru_cache(maxsize=None)
def fwd_max_seq(head_dim: int, dtype: torch.dtype) -> int:
    """The longest sequence the resident forward takes (head_dim 32 / 64 /
    128: bf16 944 / 528 / 272, f32 256); longer ones take the key-tiled
    kernels (``ops.attention_long``). Mirrors ``sc_attention_fwd_max_seq``."""
    seq = 0
    while fwd_takes(seq + 1, head_dim, dtype):
        seq += 1
    return seq


@functools.lru_cache(maxsize=None)
def bwd_max_seq(head_dim: int, dtype: torch.dtype) -> int:
    """The longest sequence the resident backward takes (head_dim 32 / 64 /
    128: bf16 640 / 352 / 192, f32 130 / 106 / 72); longer ones take the
    key-tiled kernels. Mirrors ``sc_attention_bwd_max_seq``."""
    seq = 0
    while bwd_takes(seq + 1, head_dim, dtype):
        seq += 1
    return seq


def bwd_supported(heads: int, width: int, seq: int, dtype: torch.dtype) -> bool:
    """Whether the resident backward kernel takes this geometry: a forward
    head_dim, a kernel dtype and 1 <= seq <= :func:`bwd_max_seq`."""
    return (supported(heads, width) and dtype in cuda_build.DTYPE_CODES
            and bwd_takes(seq, width // heads, dtype))


class ResidentLengthError(NotImplementedError, ValueError):
    """A kernel that keeps the whole sequence in one block (the pair,
    layout and dx kernels) refused its length: ROADMAP Queue 2 A1."""


def check_resident(L: int, head_dim: int, dtype: torch.dtype, backward: bool,
                   what: str) -> None:
    """Raise :class:`ResidentLengthError` where ``what`` (a pair, layout or
    dx kernel) does not take L: past VARIANT_MAX_SEQ, or past its body's
    shared memory (:func:`fwd_max_seq` / :func:`bwd_max_seq`)."""
    limit = min(VARIANT_MAX_SEQ, (bwd_max_seq if backward else fwd_max_seq)(head_dim, dtype))
    if L > limit:
        raise ResidentLengthError(
            f"{what} at sequence length {L}, head_dim={head_dim}, {dtype}: the kernel keeps "
            f"one (batch, head) in a block's shared memory and takes L <= {limit}; longer "
            "sequences through it are ROADMAP Queue 2 A1")


def check_resident_qkv(qkv: torch.Tensor, heads: int, backward: bool, what: str) -> None:
    """:func:`check_resident` at a (B, L, 3D) qkv's geometry."""
    check_resident(qkv.shape[1], qkv.shape[2] // 3 // heads, qkv.dtype, backward, what)


def _check_geometry(B: int, L: int, D: int, heads: int, dtype: torch.dtype) -> None:
    """The head geometry, sequence length and dtype the kernels take."""
    if heads < 1 or D % heads or D // heads not in HEAD_DIMS:
        raise ValueError(
            f"head geometry heads={heads} width={D} is not taken: head_dim "
            f"must be one of {HEAD_DIMS}")
    if L < 1 or B < 1:
        raise ValueError(f"sequence length {L} (batch {B}) must be at least 1")
    if dtype not in cuda_build.DTYPE_CODES:
        raise ValueError(f"qkv dtype {dtype} not taken (float32 or bfloat16)")


def _check_mask(mask: Optional[torch.Tensor], L: int, device: torch.device) -> None:
    if mask is not None:
        if mask.shape != (L, L) or mask.dtype != torch.float32:
            raise ValueError(
                f"mask must be a float32 ({L}, {L}) additive mask; got "
                f"{mask.dtype} {tuple(mask.shape)}")
        if mask.device != device or not mask.is_contiguous():
            raise ValueError("mask must be contiguous and on qkv's device")


def _check(qkv: torch.Tensor, mask: Optional[torch.Tensor], heads: int) -> None:
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be (B, L, 3*D); got {tuple(qkv.shape)}")
    B, L, three_d = qkv.shape
    _check_geometry(B, L, three_d // 3, heads, qkv.dtype)
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    _check_mask(mask, L, qkv.device)


def _check_kernel_device(*tensors: torch.Tensor) -> None:
    """The kernels' own requirements, on a tensor that is not on the CPU."""
    if tensors[0].device.type != "cuda":
        raise ValueError(f"no kernel for device {tensors[0].device}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("qkv must be 16-byte aligned (the kernel reads 16-byte vectors)")


def _split_heads(qkv: torch.Tensor, heads: int):
    """(B, L, 3D) -> q, k, v as f32 (B, H, L, hd)."""
    B, L, three_d = qkv.shape
    hd = three_d // 3 // heads
    return qkv.float().view(B, L, 3, heads, hd).permute(2, 0, 3, 1, 4)


def _scores(q, k, mask, hd):
    s = torch.matmul(q, k.transpose(-1, -2)) * hd ** -0.5
    return s if mask is None else s + mask


def _softmax_pv(qkv, mask, heads):
    """The forward's f32 math per head: (o, sigma, row max), o already
    scaled by 1/sigma, (B, H, L, .)."""
    q, k, v = _split_heads(qkv, heads)
    s = _scores(q, k, mask, q.shape[-1])
    row_max = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - row_max)
    sigma = e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.matmul(e.to(qkv.dtype).float(), v) * (1.0 / sigma), sigma, row_max


def _merge_heads(o: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    B, H, L, hd = o.shape
    return o.to(dtype).transpose(1, 2).reshape(B, L, H * hd)


def reference_attention(qkv: torch.Tensor, mask: Optional[torch.Tensor],
                        heads: int) -> torch.Tensor:
    """Plain PyTorch version with the TPU kernel's math (``_one_head_fwd``):
    f32 scores ``q k^T * hd^-1/2 + mask``, row max subtracted,
    ``e = exp(s - max)``, ``o = (e in v's dtype) v`` in f32, then
    ``o * 1/max(sum e, 1e-30)`` cast to the input dtype. Returns (B, L, D)."""
    return _merge_heads(_softmax_pv(qkv, mask, heads)[0], qkv.dtype)


def reference_attention_lse(qkv: torch.Tensor, mask: Optional[torch.Tensor],
                            heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`reference_attention` and each row's logsumexp, as
    ``_one_head_fwd(want_lse=True)`` computes it:
    ``lse = log(max(sum e, 1e-30)) + max``. Returns the context (B, L, D)
    and lse (H, B, L) f32."""
    o, sigma, row_max = _softmax_pv(qkv, mask, heads)
    lse = (torch.log(sigma) + row_max)[..., 0].transpose(0, 1).contiguous()
    return _merge_heads(o, qkv.dtype), lse


def reference_attention_bwd(qkv: torch.Tensor, mask: Optional[torch.Tensor],
                            lse: Optional[torch.Tensor], g: torch.Tensor,
                            heads: int, lsum: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version with the TPU kernels' math (``_bwd_compute``):
    ``p = exp(s - lse)`` from the saved lse (``exp(s - lse - lsum)`` given
    ``lsum``: lse then holds each row's max and lsum the log of its sum,
    kept apart), or with ``lse=None`` recomputed
    as ``_p_from_scores`` does, ``e / max(sum e, 1e-30)`` with
    ``e = exp(s - max s)``; then ``dv = (p in the input dtype)^T do``,
    ``dp = do v^T``, ``ds = p (dp - sum_j dp p) hd^-1/2`` in the input
    dtype, ``dq = ds k``, ``dk = ds^T q``, all dots in f32 and dq/dk/dv cast
    to the input dtype. Returns dqkv in qkv's (B, L, 3D) layout and db (3D,)
    f32, the sum over (B, L) of the cast dqkv."""
    B, L, three_d = qkv.shape
    hd = three_d // 3 // heads
    dtype = qkv.dtype
    q, k, v = _split_heads(qkv, heads)
    do = g.to(dtype).float().view(B, L, heads, hd).transpose(1, 2)
    s = _scores(q, k, mask, hd)
    if lse is None:
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = e / e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    elif lsum is None:
        p = torch.exp(s - lse.transpose(0, 1).unsqueeze(-1))
    else:
        p = torch.exp(s - lse.transpose(0, 1).unsqueeze(-1) - lsum.transpose(0, 1).unsqueeze(-1))
    dv = torch.matmul(p.to(dtype).float().transpose(-1, -2), do)
    dp = torch.matmul(do, v.transpose(-1, -2))
    ds = (p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * hd ** -0.5).to(dtype).float()
    dq = torch.matmul(ds, k)
    dk = torch.matmul(ds.transpose(-1, -2), q)
    dqkv = torch.stack([dq, dk, dv]).to(dtype)  # (3, B, H, L, hd)
    dqkv = dqkv.permute(1, 3, 0, 2, 4).reshape(B, L, three_d)
    return dqkv, dqkv.float().sum(dim=(0, 1))


def kernel_route(seq: int, head_dim: int, dtype: torch.dtype, backward: bool = False) -> str:
    """Which kernels the wrappers launch on a CUDA tensor: 'resident' (one
    (batch, head) a block, csrc/fused_attention_*.cu) up to
    :func:`fwd_max_seq` / :func:`bwd_max_seq`, 'long' (the key-tiled
    kernels, csrc/attention_long.cu) past it."""
    takes = bwd_takes if backward else fwd_takes
    return "resident" if takes(seq, head_dim, dtype) else "long"


def _resident(qkv: torch.Tensor, heads: int, backward: bool) -> bool:
    return kernel_route(qkv.shape[1], qkv.shape[2] // 3 // heads, qkv.dtype,
                        backward) == "resident"


def _fwd(qkv, mask, heads, lse: Optional[torch.Tensor]) -> torch.Tensor:
    """Launch the forward kernel (writes ``lse`` unless it is None)."""
    B, L, three_d = qkv.shape
    D = three_d // 3
    hd = D // heads
    lib = cuda_build.library()
    out = torch.empty((B, L, D), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        err = lib.sc_attention_fwd(
            qkv.data_ptr(), None if mask is None else mask.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), B, L, heads, hd,
            cuda_build.DTYPE_CODES[qkv.dtype], hd ** -0.5,
            torch.cuda.current_stream(qkv.device).cuda_stream)
    cuda_build.check(lib, err, "fused_attention_fwd launch")
    return out


def fused_attention(qkv: torch.Tensor, mask: Optional[torch.Tensor],
                    heads: int, interleaved: bool = False) -> torch.Tensor:
    """Multi-head self-attention over a fused qkv tensor.

    qkv: (B, L, 3*D) contiguous, float32 or bfloat16; head h of q, k and v
    sits at columns ``h*hd:(h+1)*hd`` of the three D-wide blocks.
    mask: (L, L) additive float32 mask, or None. Returns the context
    (B, L, D) in qkv's dtype. Counts each kernel launch in
    ``fused_attention.launches``. ``interleaved``: qkv's columns are in
    ``interleave_perm`` order (``attention_variants.fused_attention_inter``).
    """
    if interleaved:
        from spatial_clip_tpu_torch.ops import attention_variants

        return attention_variants.fused_attention_inter(qkv, mask, heads)
    _check(qkv, mask, heads)
    if cuda_build.plain_device(qkv):
        return reference_attention(qkv, mask, heads)
    _check_kernel_device(qkv)
    if not _resident(qkv, heads, False):
        from spatial_clip_tpu_torch.ops import attention_long

        return attention_long.fused_attention_long(qkv, mask, heads)
    out = _fwd(qkv, mask, heads, None)
    fused_attention.launches += 1
    return out


def fused_attention_lse(qkv: torch.Tensor, mask: Optional[torch.Tensor],
                        heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`fused_attention` that also returns each row's logsumexp of the
    scaled, masked scores: lse (heads, B, L) f32, the residual
    :func:`fused_attention_bwd` rebuilds the probabilities from. Counts each
    kernel launch in ``fused_attention_lse.launches``."""
    _check(qkv, mask, heads)
    if cuda_build.plain_device(qkv):
        return reference_attention_lse(qkv, mask, heads)
    _check_kernel_device(qkv)
    if not _resident(qkv, heads, False):
        from spatial_clip_tpu_torch.ops import attention_long

        return attention_long.fused_attention_long_lse(qkv, mask, heads)
    B, L, three_d = qkv.shape
    lse = torch.empty((heads, B, L), dtype=torch.float32, device=qkv.device)
    out = _fwd(qkv, mask, heads, lse)
    fused_attention_lse.launches += 1
    return out, lse


def _check_bwd(qkv, mask, g, heads) -> torch.Tensor:
    """The backward kernels' checks; returns g in qkv's dtype, contiguous."""
    _check(qkv, mask, heads)
    B, L, three_d = qkv.shape
    D = three_d // 3
    if g.shape != (B, L, D):
        raise ValueError(f"g must be {(B, L, D)}; got {tuple(g.shape)}")
    if g.device != qkv.device:
        raise ValueError("g must be on qkv's device")
    return g.to(qkv.dtype).contiguous()


def _check_lse(lse: torch.Tensor, qkv: torch.Tensor, heads: int, name: str = "lse") -> None:
    """A (heads, B, L) f32 row statistic (the lse, or the key-tiled dQ
    kernel's r) on qkv's device, contiguous."""
    B, L, _ = qkv.shape
    if (lse.shape != (heads, B, L) or lse.dtype != torch.float32 or not lse.is_contiguous()
            or lse.device != qkv.device):
        raise ValueError(f"{name} must be contiguous float32 {(heads, B, L)} on qkv's device; "
                         f"got {lse.dtype} {tuple(lse.shape)} on {lse.device}")


def fused_attention_bwd(qkv: torch.Tensor, mask: Optional[torch.Tensor],
                        lse: torch.Tensor, g: torch.Tensor,
                        heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward of :func:`fused_attention_lse`: given the cotangent ``g`` of
    the context (B, L, D), returns dqkv (qkv's shape and dtype) and db (3D,)
    f32, the gradient of a bias added to qkv. Counts each launch of the
    resident kernel in ``fused_attention_bwd.launches``; past
    :func:`bwd_max_seq` the key-tiled kernels run and count their own."""
    g = _check_bwd(qkv, mask, g, heads)
    _check_lse(lse, qkv, heads)
    B, L, three_d = qkv.shape
    D = three_d // 3
    if cuda_build.plain_device(qkv):
        return reference_attention_bwd(qkv, mask, lse, g, heads)
    _check_kernel_device(qkv, g)
    if not _resident(qkv, heads, True):
        from spatial_clip_tpu_torch.ops import attention_long

        return attention_long.fused_attention_long_bwd(qkv, mask, lse, g, heads)
    hd = D // heads
    dqkv = torch.empty_like(qkv)
    db_part = torch.empty((B, three_d), dtype=torch.float32, device=qkv.device)
    db = torch.empty((three_d,), dtype=torch.float32, device=qkv.device)
    lib = cuda_build.library()
    with torch.cuda.device(qkv.device):
        err = lib.sc_attention_bwd(
            qkv.data_ptr(), None if mask is None else mask.data_ptr(), lse.data_ptr(),
            g.data_ptr(), dqkv.data_ptr(), db_part.data_ptr(), db.data_ptr(),
            B, L, heads, hd, cuda_build.DTYPE_CODES[qkv.dtype], hd ** -0.5,
            torch.cuda.current_stream(qkv.device).cuda_stream)
    cuda_build.check(lib, err, "fused_attention_bwd launch")
    fused_attention_bwd.launches += 1
    return dqkv, db


def fused_attention_bwd_recompute(qkv: torch.Tensor, mask: Optional[torch.Tensor],
                                  g: torch.Tensor, heads: int,
                                  interleaved: bool = False) -> torch.Tensor:
    """Backward of :func:`fused_attention` that recomputes the softmax
    statistics from the scores (no saved logsumexp): given the cotangent
    ``g`` of the context (B, L, D), returns dqkv (qkv's shape and dtype).
    Counts each launch of the resident kernel in
    ``fused_attention_bwd_recompute.launches``; past :func:`bwd_max_seq` the
    key-tiled kernels run (the forward for the lse, then the backward) and
    count their own. ``interleaved``: qkv and
    dqkv in ``interleave_perm`` order
    (``attention_variants.fused_attention_inter_bwd``)."""
    if interleaved:
        from spatial_clip_tpu_torch.ops import attention_variants

        return attention_variants.fused_attention_inter_bwd(qkv, mask, g, heads)
    g = _check_bwd(qkv, mask, g, heads)
    if cuda_build.plain_device(qkv):
        return reference_attention_bwd(qkv, mask, None, g, heads)[0]
    _check_kernel_device(qkv, g)
    if not _resident(qkv, heads, True):
        from spatial_clip_tpu_torch.ops import attention_long

        return attention_long.fused_attention_long_bwd_recompute(qkv, mask, g, heads, db=False)[0]
    B, L, three_d = qkv.shape
    hd = three_d // 3 // heads
    dqkv = torch.empty_like(qkv)
    lib = cuda_build.library()
    with torch.cuda.device(qkv.device):
        err = lib.sc_attention_bwd_recompute(
            qkv.data_ptr(), None if mask is None else mask.data_ptr(), g.data_ptr(),
            dqkv.data_ptr(), B, L, heads, hd, cuda_build.DTYPE_CODES[qkv.dtype], hd ** -0.5,
            torch.cuda.current_stream(qkv.device).cuda_stream)
    cuda_build.check(lib, err, "fused_attention_bwd_recompute launch")
    fused_attention_bwd_recompute.launches += 1
    return dqkv


def fused_attention_bwd_recompute_db(qkv: torch.Tensor, mask: Optional[torch.Tensor],
                                     g: torch.Tensor,
                                     heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`fused_attention_bwd_recompute` that also returns db (3D,) f32,
    the gradient of a bias added to qkv, summed in the kernel over the cast
    dqkv in a fixed order as :func:`fused_attention_bwd` sums it. Counts
    each kernel launch in ``fused_attention_bwd_recompute_db.launches``."""
    g = _check_bwd(qkv, mask, g, heads)
    if cuda_build.plain_device(qkv):
        return reference_attention_bwd(qkv, mask, None, g, heads)
    _check_kernel_device(qkv, g)
    if not _resident(qkv, heads, True):
        from spatial_clip_tpu_torch.ops import attention_long

        return attention_long.fused_attention_long_bwd_recompute(qkv, mask, g, heads, db=True)
    B, L, three_d = qkv.shape
    hd = three_d // 3 // heads
    dqkv = torch.empty_like(qkv)
    db_part = torch.empty((B, three_d), dtype=torch.float32, device=qkv.device)
    db = torch.empty((three_d,), dtype=torch.float32, device=qkv.device)
    lib = cuda_build.library()
    with torch.cuda.device(qkv.device):
        err = lib.sc_attention_bwd_recompute_db(
            qkv.data_ptr(), None if mask is None else mask.data_ptr(), g.data_ptr(),
            dqkv.data_ptr(), db_part.data_ptr(), db.data_ptr(), B, L, heads, hd,
            cuda_build.DTYPE_CODES[qkv.dtype], hd ** -0.5,
            torch.cuda.current_stream(qkv.device).cuda_stream)
    cuda_build.check(lib, err, "fused_attention_bwd_recompute_db launch")
    fused_attention_bwd_recompute_db.launches += 1
    return dqkv, db


fused_attention.launches = 0
fused_attention_lse.launches = 0
fused_attention_bwd.launches = 0
fused_attention_bwd_recompute.launches = 0
fused_attention_bwd_recompute_db.launches = 0


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b summed in f32 and returned in f32 (JAX's dot_general with
    ``preferred_element_type=float32``)."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class QKVAttention(torch.autograd.Function):
    """``qkv = x W^T + b`` in x's dtype, then attention; the counterpart of
    ``qkv_attention`` and its custom VJP, with JAX's routing.

    Forward (``_qkv_attn_fwd``): where :func:`lse_ok` holds,
    :func:`fused_attention_lse`, saving the lse; otherwise the inference
    :func:`fused_attention`, saving none. Backward (``_qkv_attn_bwd``), by
    :data:`BWD_FUSE` at backward time: 'dxdb', whatever was saved,
    ``attention_variants.fused_attention_bwd_dx``, one launch that returns
    dqkv, ``dx = dqkv W`` (in qkv's dtype, cast to x's) and db; 'db' with a
    saved lse, :func:`fused_attention_bwd`; 'db' without,
    :func:`fused_attention_bwd_recompute_db`; otherwise (JAX's 'none')
    :func:`fused_attention_bwd_recompute` and db the f32 sum of dqkv over
    (B, L). ``dW = dqkv^T x`` (summed in f32, returned in W's dtype) is a
    GEMM under every option, and so is ``dx = dqkv W`` (in x's dtype)
    outside 'dxdb', as the JAX package leaves them to XLA. The mask gets no
    gradient.
    """

    @staticmethod
    def forward(ctx, x, weight, bias, mask, heads: int):
        w = weight.to(x.dtype)
        qkv = F.linear(x, w, bias.to(x.dtype))
        if lse_ok(qkv.shape[0], qkv.shape[1]):
            out, lse = fused_attention_lse(qkv, mask, heads)
        else:
            out, lse = fused_attention(qkv, mask, heads), None
        ctx.save_for_backward(x, w, qkv, mask, lse)
        ctx.heads = heads
        ctx.param_dtypes = (weight.dtype, bias.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, qkv, mask, lse = ctx.saved_tensors
        fuse, dx, dw = BWD_FUSE, None, None
        if fuse == "dxdb":
            from spatial_clip_tpu_torch.ops import attention_variants

            dqkv, dx, db = attention_variants.fused_attention_bwd_dx(qkv, mask, g, w, ctx.heads)
            dx = dx.to(x.dtype) if ctx.needs_input_grad[0] else None
        elif fuse == "db" and lse is not None:
            dqkv, db = fused_attention_bwd(qkv, mask, lse, g, ctx.heads)
        elif fuse == "db":
            dqkv, db = fused_attention_bwd_recompute_db(qkv, mask, g, ctx.heads)
        else:
            dqkv = fused_attention_bwd_recompute(qkv, mask, g, ctx.heads)
            db = dqkv.float().sum(dim=(0, 1))
        flat = dqkv.view(-1, dqkv.shape[-1])
        if ctx.needs_input_grad[0] and fuse != "dxdb":
            dx = torch.matmul(dqkv, w)
        if ctx.needs_input_grad[1]:
            dw = _mm_f32(flat.t(), x.reshape(flat.shape[0], -1)).to(ctx.param_dtypes[0])
        return dx, dw, db.to(ctx.param_dtypes[1]), None, None


class FusedAttention(torch.autograd.Function):
    """:func:`fused_attention` over a qkv made elsewhere (the fused LayerNorm
    -> qkv projection, or the interleaved projection), with
    :func:`fused_attention_bwd_recompute` as its backward; dqkv flows back to
    what made qkv, in qkv's column order. The counterpart of
    ``fused_attention``'s custom VJP (``_attn_fwd`` -> ``_fwd_kernel``,
    ``_attn_bwd`` -> ``_bwd_kernel``, or ``_bwd_kernel_inter`` when
    ``interleaved``). The mask gets no gradient."""

    @staticmethod
    def forward(ctx, qkv, mask, heads: int, interleaved: bool = False):
        ctx.save_for_backward(qkv, mask)
        ctx.heads, ctx.interleaved = heads, interleaved
        return fused_attention(qkv, mask, heads, interleaved)

    @staticmethod
    def backward(ctx, g):
        qkv, mask = ctx.saved_tensors
        dqkv = fused_attention_bwd_recompute(qkv, mask, g, ctx.heads, ctx.interleaved)
        return dqkv, None, None, None


def qkv_attention(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  mask: Optional[torch.Tensor], heads: int) -> torch.Tensor:
    """Fused qkv projection + multi-head attention with the hand-written
    backward. x: (B, L, Din) in the compute dtype; weight (3D, Din) and bias
    (3D,) in any dtype (cast to x's at use). Returns the context (B, L, D)."""
    return QKVAttention.apply(x.contiguous(), weight, bias, mask, heads)
