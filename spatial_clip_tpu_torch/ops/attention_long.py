"""Attention past the resident kernels' lengths, forward and backward.

The kernels of ``csrc/attention_long.cu`` keep a tile of 64 of a block's own
rows and stream the other side's rows through shared memory in tiles of 64,
so they take any length. ``ops.fused_attention``'s wrappers route here on a
CUDA tensor whose length the resident bodies do not take
(``fused_attention.fwd_max_seq`` / ``bwd_max_seq``); the counterparts of
``spatial_clip_tpu/ops/fused_attention.py``'s kernels at those lengths:

- :func:`fused_attention_long` / :func:`fused_attention_long_lse`: the
  inference forward and the forward with the logsumexp (``_fwd_kernel``,
  ``_fwd_kernel_lse``), one kernel (``sc_attention_long_fwd``);
- :func:`fused_attention_long_bwd`: the backward from the saved lse, with db
  (``_bwd_kernel3_db_lse``): :func:`long_bwd_dq` (dq and each row's r),
  :func:`long_bwd_dkdv` (dk and dv), :func:`long_db` (db, a fixed-order
  column sum of the finished dqkv);
- :func:`fused_attention_long_bwd_recompute`: the recompute options
  (``_bwd_kernel``, ``_bwd_kernel3``, ``_bwd_kernel3_db``): the forward with
  lse for the statistics, then the same kernels.

Each wrapper counts its launches in ``<wrapper>.launches``, apart from the
resident kernels' counters. On a CPU tensor each runs its plain PyTorch
version, ``fused_attention``'s ``reference_attention*`` math, which takes any
length; on a CUDA tensor it launches its kernel or raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from spatial_clip_tpu_torch.ops import cuda_build
from spatial_clip_tpu_torch.ops.fused_attention import (
    _check,
    _check_bwd,
    _check_kernel_device,
    _check_lse,
    _scores,
    _split_heads,
    reference_attention,
    reference_attention_bwd,
    reference_attention_lse,
)

# the launch geometry of csrc/attention_long.cu (sc_attention_long_plan)
BLOCK = 64  # rows a block owns, and rows of every streamed tile
TC_THREADS = 128  # bf16: 4 warps, a warp per 16 of the block's rows
SIMT_THREADS = 256  # f32: 16 x 16 threads, each 4 x 4 of a 64 x 64 score tile
DB_ROWS = 256  # rows of dqkv one db partial sums
KINDS = ("fwd", "dq", "dkdv")  # sc_attention_long_smem_bytes's kind 0 / 1 / 2


def tiles(seq: int) -> int:
    return -(-seq // BLOCK)


def blocks(batch: int, seq: int, heads: int) -> int:
    """Blocks of each kernel's grid: one per (batch, head, 64 rows)."""
    return batch * heads * tiles(seq)


def threads(dtype: torch.dtype) -> int:
    return TC_THREADS if dtype == torch.bfloat16 else SIMT_THREADS


def smem_bytes(kind: str, head_dim: int, dtype: torch.dtype) -> int:
    """Shared memory of one block of a kernel: its own tiles (forward q; dQ
    q and do; dK/dV k and v), two stages of the streamed tiles (k and v, or
    q and do), each BLOCK rows of head_dim elements and 16 bytes of pad, the
    dK/dV stages' f32 lse and r, and in f32 one 64 x 65 f32 score tile.
    Mirrors ``sc_attention_long_smem_bytes``."""
    item = torch.empty((), dtype=dtype).element_size()
    tile = BLOCK * (head_dim + 16 // item) * item
    score = BLOCK * (BLOCK + 1) * 4 if dtype == torch.float32 else 0
    own = {"fwd": 1, "dq": 2, "dkdv": 2}[kind]
    stats = 4 * BLOCK * 4 if kind == "dkdv" else 0
    return (own + 4) * tile + stats + score


def db_chunks(rows: int) -> int:
    """Partial rows of :func:`long_db`'s first pass."""
    return -(-rows // DB_ROWS)


def _launch(entry: str, qkv: torch.Tensor, *args) -> None:
    lib = cuda_build.library()
    with torch.cuda.device(qkv.device):
        err = getattr(lib, f"sc_attention_long_{entry}")(
            *args, torch.cuda.current_stream(qkv.device).cuda_stream)
    cuda_build.check(lib, err, f"attention long {entry} launch")


def _dims(qkv: torch.Tensor, heads: int):
    B, L, three_d = qkv.shape
    hd = three_d // 3 // heads
    return B, L, heads, hd, cuda_build.DTYPE_CODES[qkv.dtype], hd ** -0.5


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _fwd(qkv, mask, heads, lse: Optional[torch.Tensor]) -> torch.Tensor:
    B, L, three_d = qkv.shape
    out = qkv.new_empty((B, L, three_d // 3))
    _launch("fwd", qkv, qkv.data_ptr(), _ptr(mask), out.data_ptr(), _ptr(lse), *_dims(qkv, heads))
    return out


def fused_attention_long(qkv: torch.Tensor, mask: Optional[torch.Tensor],
                         heads: int) -> torch.Tensor:
    """``fused_attention.fused_attention`` at any length: the context (B, L,
    D) in qkv's dtype. Counts each launch in ``fused_attention_long.launches``."""
    _check(qkv, mask, heads)
    if qkv.device.type == "cpu":
        return reference_attention(qkv, mask, heads)
    _check_kernel_device(qkv)
    out = _fwd(qkv, mask, heads, None)
    fused_attention_long.launches += 1
    return out


def fused_attention_long_lse(qkv: torch.Tensor, mask: Optional[torch.Tensor],
                             heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`fused_attention_long` and each row's logsumexp, (heads, B, L)
    f32 as ``fused_attention_lse`` lays it out. Counts each launch in
    ``fused_attention_long_lse.launches``."""
    _check(qkv, mask, heads)
    if qkv.device.type == "cpu":
        return reference_attention_lse(qkv, mask, heads)
    _check_kernel_device(qkv)
    B, L, _ = qkv.shape
    lse = torch.empty((heads, B, L), dtype=torch.float32, device=qkv.device)
    out = _fwd(qkv, mask, heads, lse)
    fused_attention_long_lse.launches += 1
    return out, lse


def _check_dqkv(dqkv: torch.Tensor, qkv: torch.Tensor) -> None:
    if (dqkv.shape != qkv.shape or dqkv.dtype != qkv.dtype or not dqkv.is_contiguous()
            or dqkv.device != qkv.device):
        raise ValueError(f"dqkv must be a contiguous {qkv.dtype} {tuple(qkv.shape)} on qkv's "
                         f"device; got {dqkv.dtype} {tuple(dqkv.shape)} on {dqkv.device}")


def reference_long_r(qkv, mask, lse, g, heads) -> torch.Tensor:
    """The plain version of the dQ kernel's r: ``r_i = sum_j dp_ij p_ij``
    with ``p = exp(s - lse)`` and ``dp = do v^T`` in f32 (the term
    ``reference_attention_bwd`` subtracts), (heads, B, L) f32."""
    B, L, three_d = qkv.shape
    hd = three_d // 3 // heads
    q, k, v = _split_heads(qkv, heads)
    do = g.to(qkv.dtype).float().view(B, L, heads, hd).transpose(1, 2)
    p = torch.exp(_scores(q, k, mask, hd) - lse.transpose(0, 1).unsqueeze(-1))
    dp = torch.matmul(do, v.transpose(-1, -2))
    return (dp * p).sum(dim=-1).transpose(0, 1).contiguous()


def long_bwd_dq(qkv: torch.Tensor, mask: Optional[torch.Tensor], lse: torch.Tensor,
                g: torch.Tensor, heads: int, dqkv: torch.Tensor) -> torch.Tensor:
    """The dQ kernel: writes dq into the q columns of ``dqkv`` (qkv's shape
    and dtype) and returns each row's r (heads, B, L) f32, which
    :func:`long_bwd_dkdv` takes. Counts each launch in
    ``long_bwd_dq.launches``."""
    g = _check_bwd(qkv, mask, g, heads)
    _check_lse(lse, qkv, heads)
    _check_dqkv(dqkv, qkv)
    D = qkv.shape[-1] // 3
    if qkv.device.type == "cpu":
        dqkv[..., :D] = reference_attention_bwd(qkv, mask, lse, g, heads)[0][..., :D]
        return reference_long_r(qkv, mask, lse, g, heads)
    _check_kernel_device(qkv, g, dqkv)
    r = torch.empty_like(lse)
    _launch("bwd_dq", qkv, qkv.data_ptr(), _ptr(mask), lse.data_ptr(), g.data_ptr(),
            dqkv.data_ptr(), r.data_ptr(), *_dims(qkv, heads))
    long_bwd_dq.launches += 1
    return r


def long_bwd_dkdv(qkv: torch.Tensor, mask: Optional[torch.Tensor], lse: torch.Tensor,
                  r: torch.Tensor, g: torch.Tensor, heads: int, dqkv: torch.Tensor) -> None:
    """The dK/dV kernel: writes dk and dv into the k and v columns of
    ``dqkv`` from the lse and :func:`long_bwd_dq`'s r. Counts each launch in
    ``long_bwd_dkdv.launches``."""
    g = _check_bwd(qkv, mask, g, heads)
    _check_lse(lse, qkv, heads)
    _check_lse(r, qkv, heads, "r")
    _check_dqkv(dqkv, qkv)
    D = qkv.shape[-1] // 3
    if qkv.device.type == "cpu":
        dqkv[..., D:] = reference_attention_bwd(qkv, mask, lse, g, heads)[0][..., D:]
        return
    _check_kernel_device(qkv, g, dqkv)
    _launch("bwd_dkdv", qkv, qkv.data_ptr(), _ptr(mask), lse.data_ptr(), r.data_ptr(),
            g.data_ptr(), dqkv.data_ptr(), *_dims(qkv, heads))
    long_bwd_dkdv.launches += 1


def long_db(dqkv: torch.Tensor) -> torch.Tensor:
    """db (3D,) f32: the sum over (B, L) of dqkv's values as f32, in a fixed
    order (256-row partials, then ``attention_db.cuh``'s reduce), so the
    same bits on every run. Counts each launch in ``long_db.launches``."""
    if dqkv.device.type == "cpu":
        return dqkv.float().sum(dim=(0, 1))
    _check_kernel_device(dqkv)
    n = dqkv.shape[-1]
    rows = dqkv.numel() // n
    part = torch.empty((db_chunks(rows), n), dtype=torch.float32, device=dqkv.device)
    db = torch.empty((n,), dtype=torch.float32, device=dqkv.device)
    _launch("db", dqkv, dqkv.data_ptr(), part.data_ptr(), db.data_ptr(), rows, n,
            cuda_build.DTYPE_CODES[dqkv.dtype])
    long_db.launches += 1
    return db


def fused_attention_long_bwd(qkv: torch.Tensor, mask: Optional[torch.Tensor],
                             lse: torch.Tensor, g: torch.Tensor, heads: int,
                             db: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``fused_attention.fused_attention_bwd`` at any length: dqkv (qkv's
    shape and dtype) and, with ``db``, db (3D,) f32; db is None otherwise.
    Runs :func:`long_bwd_dq`, :func:`long_bwd_dkdv` and :func:`long_db`."""
    g = _check_bwd(qkv, mask, g, heads)
    _check_lse(lse, qkv, heads)
    if qkv.device.type == "cpu":
        dqkv, db_ref = reference_attention_bwd(qkv, mask, lse, g, heads)
        return dqkv, db_ref if db else None
    dqkv = torch.empty_like(qkv)
    r = long_bwd_dq(qkv, mask, lse, g, heads, dqkv)
    long_bwd_dkdv(qkv, mask, lse, r, g, heads, dqkv)
    return dqkv, long_db(dqkv) if db else None


def fused_attention_long_bwd_recompute(qkv: torch.Tensor, mask: Optional[torch.Tensor],
                                       g: torch.Tensor, heads: int, db: bool
                                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The recompute backward at any length (``fused_attention_bwd_recompute``
    and ``_recompute_db``): the lse from :func:`fused_attention_long_lse`,
    then :func:`fused_attention_long_bwd`. On the CPU, the plain version that
    recomputes p from the scores' max and sum."""
    g = _check_bwd(qkv, mask, g, heads)
    if qkv.device.type == "cpu":
        dqkv, db_ref = reference_attention_bwd(qkv, mask, None, g, heads)
        return dqkv, db_ref if db else None
    lse = fused_attention_long_lse(qkv, mask, heads)[1]
    return fused_attention_long_bwd(qkv, mask, lse, g, heads, db)


fused_attention_long.launches = 0
fused_attention_long_lse.launches = 0
long_bwd_dq.launches = 0
long_bwd_dkdv.launches = 0
long_db.launches = 0
