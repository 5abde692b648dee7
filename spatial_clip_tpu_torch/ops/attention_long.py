"""Attention past the resident kernels' lengths, forward and backward.

The kernels of ``csrc/attention_long.cu`` keep a tile of a block's own rows
and stream the other side's rows through shared memory, so they take any
length: bf16 on wgmma fed by TMA (128 own rows a block, streamed tiles of
128 keys in the forward and dQ below hd 128, 64 rows otherwise), f32 on the CUDA cores
(64 and 64). ``ops.fused_attention``'s wrappers route here on a CUDA tensor
whose length the resident bodies do not take
(``fused_attention.fwd_max_seq`` / ``bwd_max_seq``); the counterparts of
``spatial_clip_tpu/ops/fused_attention.py``'s kernels at those lengths:

- :func:`fused_attention_long` / :func:`fused_attention_long_lse`: the
  inference forward and the forward with the logsumexp (``_fwd_kernel``,
  ``_fwd_kernel_lse``), one kernel (``sc_attention_long_fwd``);
- :func:`fused_attention_long_bwd`: the backward from the saved lse, with db
  (``_bwd_kernel3_db_lse``): :func:`long_bwd_dq` (dq and each row's r, a
  :class:`RowStats`), :func:`long_bwd_dkdv` (dk and dv), :func:`long_db` (db: in bf16 the
  fixed-order sum of the partial rows the two kernels write, one a block, in
  f32 a fixed-order column sum of the finished dqkv);
- :func:`fused_attention_long_bwd_recompute`: the recompute options
  (``_bwd_kernel``, ``_bwd_kernel3``, ``_bwd_kernel3_db``): the forward for
  each row's max and log sum, kept apart (``parts``), then the same kernels
  given both (``lsum``). JAX's recompute kernels form p from the max and the
  sum; their logsumexp would round to the max in a row that a finfo(f32).min
  mask masks in full, and p would be 1 where theirs is 1 / L.

Each wrapper counts its launches in ``<wrapper>.launches``, apart from the
resident kernels' counters. On a CPU tensor each runs its plain PyTorch
version, ``fused_attention``'s ``reference_attention*`` math, which takes any
length; on a CUDA tensor it launches its kernel or raises.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from spatial_clip_tpu_torch.ops import cuda_build
from spatial_clip_tpu_torch.ops.fused_attention import (
    _check,
    _check_bwd,
    _check_kernel_device,
    _check_lse,
    _merge_heads,
    _scores,
    _softmax_pv,
    _split_heads,
    reference_attention,
    reference_attention_bwd,
    reference_attention_lse,
)

# the launch geometry of csrc/attention_long.cu (sc_attention_long_plan)
ROWS = 128  # bf16: own rows of a block, two consumer warpgroups of 64
TC_THREADS = 384  # bf16: producer warpgroup 0, consumer warpgroups 1 and 2
FWD_KEYS = 128  # bf16: keys of a forward stage
BWD_TILE = 64  # bf16: rows of a dK/dV stage (query rows) and of a stats row
MAX_STAGES = 4  # bf16: most stages of a ring
BLOCK = 64  # f32: own rows of a block, and rows of every streamed tile
SIMT_THREADS = 256  # f32: 16 x 16 threads, each 4 x 4 of a 64 x 64 score tile
DB_ROWS = 256  # rows of dqkv one long_db_kernel partial sums (f32)
KINDS = ("fwd", "dq", "dkdv")  # sc_attention_long_smem_bytes's kind 0 / 1 / 2
MAX_SMEM = 232448  # 227 KB, the most a block may use on sm_90


def dq_keys(head_dim: int) -> int:
    """Keys of a bf16 dQ stage: 128 below hd 128, 64 at hd 128."""
    return BWD_TILE if head_dim == 128 else 2 * BWD_TILE


def rows(dtype: torch.dtype) -> int:
    """Own rows of a block of each kernel."""
    return ROWS if dtype == torch.bfloat16 else BLOCK


def tiles(seq: int, dtype: torch.dtype = torch.bfloat16) -> int:
    return -(-seq // rows(dtype))


def blocks(batch: int, seq: int, heads: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Blocks of each kernel's grid: one per (batch, head, own rows)."""
    return batch * heads * tiles(seq, dtype)


def threads(dtype: torch.dtype) -> int:
    return TC_THREADS if dtype == torch.bfloat16 else SIMT_THREADS


def tc_layout(kind: str, head_dim: int) -> dict:
    """A bf16 kernel's shared memory (``make_layout`` in the source): two
    buffers of an item's own 128-row tiles (forward q; dQ q and do; dK/dV k
    and v; ``own`` is one buffer), each
    streamed tile (128 keys in the forward and, below hd 128, in dQ; else 64
    rows), a
    stage (two tiles, and in dK/dV 1024 bytes of lse and r), the db staging
    (8 warps' f32 column sums of dq, or of dk and dv), as many stages as fit
    up to MAX_STAGES, the mbarriers (two for each own buffer, three a
    stage); ``total`` is the launch's dynamic
    shared memory, the base's 1024-byte alignment included, rounded up to
    128. An operand row is 128 bytes a 64-column block (hd 32 lands one
    64-column box)."""
    k = KINDS.index(kind)
    row = 128 * (2 if head_dim == 128 else 1)
    own = (1 if k == 0 else 2) * ROWS * row
    operand = (FWD_KEYS if k == 0 else dq_keys(head_dim) if k == 1 else BWD_TILE) * row
    stage = 2 * operand + (1024 if k == 2 else 0)
    db = 0 if k == 0 else (2 if k == 2 else 1) * 8 * head_dim * 4
    fixed = 1024 + 2 * own + db + 8 * (4 + 3 * MAX_STAGES)
    stages = min(MAX_STAGES, (MAX_SMEM - fixed) // stage)
    total = 1024 + 2 * own + stages * stage + db + 8 * (4 + 3 * stages)
    return dict(own=own, operand=operand, stage=stage, db=db, stages=stages,
                total=-(-total // 128) * 128)


def smem_bytes(kind: str, head_dim: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block of a kernel. bf16:
    :func:`tc_layout`'s total. f32: its own tiles (forward q; dQ q and do;
    dK/dV k and v), two stages of the streamed tiles (k and v, or q and do),
    each BLOCK rows of head_dim elements and 16 bytes of pad, the dK/dV
    stages' f32 lse and r, one 64 x 65 f32 score tile. Mirrors
    ``sc_attention_long_smem_bytes``."""
    if dtype == torch.bfloat16:
        return tc_layout(kind, head_dim)["total"]
    tile = BLOCK * (head_dim + 4) * 4
    own = {"fwd": 1, "dq": 2, "dkdv": 2}[kind]
    stats = 4 * BLOCK * 4 if kind == "dkdv" else 0
    return (own + 4) * tile + stats + BLOCK * (BLOCK + 1) * 4


def db_chunks(rows: int) -> int:
    """Partial rows of :func:`long_db`'s first pass over dqkv (no partials
    given)."""
    return -(-rows // DB_ROWS)


def stat_row(split: bool = False) -> int:
    """f32 values of a stats row: BWD_TILE lse and BWD_TILE r; split (the
    rows' max in place of lse, for the recompute options), BWD_TILE log
    sums as well (``stat_row`` in the source)."""
    return (3 if split else 2) * BWD_TILE


def stats_rows(batch: int, seq: int, heads: int) -> int:
    """Rows of the bf16 backward's stats: one per (batch, head, BWD_TILE
    query rows), each BWD_TILE lse values then BWD_TILE r values."""
    return batch * heads * -(-seq // BWD_TILE)


def pack_stats(lse: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """The plain version of the stats rows (:func:`stats_rows`, 2 BWD_TILE
    f32 each) of lse and r (heads, B, L): the layout the bf16 dQ kernel
    writes and the dK/dV kernel lands with one bulk copy a query tile; 0
    past L."""
    heads, B, L = lse.shape
    tiles_ = -(-L // BWD_TILE)
    pad = tiles_ * BWD_TILE - L
    both = torch.stack([lse, r]).float()  # (2, heads, B, L)
    both = torch.nn.functional.pad(both, (0, pad)).view(2, heads, B, tiles_, BWD_TILE)
    return both.permute(2, 1, 3, 0, 4).reshape(B * heads * tiles_, 2 * BWD_TILE).contiguous()


def unpack_stats(rows: torch.Tensor, heads: int, batch: int,
                 seq: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """lse and r (heads, B, L) f32 from stats rows: :func:`pack_stats`
    undone (rows of the split statistics hold the rows' log sums third)."""
    tiles_, segs = -(-seq // BWD_TILE), rows.shape[1] // BWD_TILE
    both = rows.view(batch, heads, tiles_, segs, BWD_TILE).permute(3, 1, 0, 2, 4)
    both = both.reshape(segs, heads, batch, tiles_ * BWD_TILE)[..., :seq]
    return both[0].contiguous(), both[1].contiguous()


class RowStats(NamedTuple):
    """What :func:`long_bwd_dq` hands :func:`long_bwd_dkdv`: the lse it
    was given (with ``lsum``, each row's max and the log of its sum) and
    each row's r = sum_j dp p. The f32 kernel and the plain
    version give r as (heads, B, L) f32; the bf16 kernel gives ``rows``
    instead (r None), one stats row a (batch, head, BWD_TILE query rows),
    which the dK/dV kernel lands with one bulk copy (:func:`pack_stats`;
    with ``lsum`` the row also holds the log sums, :func:`stat_row`)."""

    lse: torch.Tensor
    r: Optional[torch.Tensor] = None
    rows: Optional[torch.Tensor] = None
    lsum: Optional[torch.Tensor] = None

    def unpacked(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """lse and r (heads, B, L) f32; from the bf16 kernel, as read back
        from its stats rows."""
        if self.rows is None:
            return self.lse, self.r
        return unpack_stats(self.rows, *self.lse.shape)


def db_parts(batch: int, seq: int) -> int:
    """Partial rows of db the bf16 backward kernels write: one per
    (sequence, block of ROWS own rows), row ``b * tiles(seq) + t``."""
    return batch * tiles(seq)


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


def _fwd(qkv, mask, heads, lse: Optional[torch.Tensor],
         lsum: Optional[torch.Tensor] = None) -> torch.Tensor:
    B, L, three_d = qkv.shape
    out = qkv.new_empty((B, L, three_d // 3))
    _launch("fwd_split", qkv, qkv.data_ptr(), _ptr(mask), out.data_ptr(), _ptr(lse), _ptr(lsum),
            *_dims(qkv, heads))
    return out


def reference_attention_parts(qkv: torch.Tensor, mask: Optional[torch.Tensor],
                              heads: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the forward with ``parts``: the context, each
    row's max and the log of its sum ``log(max(sum e, 1e-30))``, kept apart,
    (heads, B, L) f32 each."""
    o, sigma, row_max = _softmax_pv(qkv, mask, heads)
    stat = lambda t: t[..., 0].transpose(0, 1).contiguous()  # noqa: E731
    return _merge_heads(o, qkv.dtype), stat(row_max), stat(torch.log(sigma))


def fused_attention_long(qkv: torch.Tensor, mask: Optional[torch.Tensor],
                         heads: int) -> torch.Tensor:
    """``fused_attention.fused_attention`` at any length: the context (B, L,
    D) in qkv's dtype. Counts each launch in ``fused_attention_long.launches``."""
    _check(qkv, mask, heads)
    if cuda_build.plain_device(qkv):
        return reference_attention(qkv, mask, heads)
    _check_kernel_device(qkv)
    out = _fwd(qkv, mask, heads, None)
    fused_attention_long.launches += 1
    return out


def fused_attention_long_lse(qkv: torch.Tensor, mask: Optional[torch.Tensor],
                             heads: int, parts: bool = False):
    """:func:`fused_attention_long` and each row's logsumexp, (heads, B, L)
    f32 as ``fused_attention_lse`` lays it out; with ``parts``, the row max
    and the log of the row sum instead, kept apart: (out, max, lsum), which
    the backward takes as ``lse`` and ``lsum``. Counts each launch in
    ``fused_attention_long_lse.launches``."""
    _check(qkv, mask, heads)
    if cuda_build.plain_device(qkv):
        if parts:
            return reference_attention_parts(qkv, mask, heads)
        return reference_attention_lse(qkv, mask, heads)
    _check_kernel_device(qkv)
    B, L, _ = qkv.shape
    lse = torch.empty((heads, B, L), dtype=torch.float32, device=qkv.device)
    lsum = torch.empty_like(lse) if parts else None
    out = _fwd(qkv, mask, heads, lse, lsum)
    fused_attention_long_lse.launches += 1
    return (out, lse, lsum) if parts else (out, lse)


def _check_dqkv(dqkv: torch.Tensor, qkv: torch.Tensor) -> None:
    if (dqkv.shape != qkv.shape or dqkv.dtype != qkv.dtype or not dqkv.is_contiguous()
            or dqkv.device != qkv.device):
        raise ValueError(f"dqkv must be a contiguous {qkv.dtype} {tuple(qkv.shape)} on qkv's "
                         f"device; got {dqkv.dtype} {tuple(dqkv.shape)} on {dqkv.device}")


def _check_part(part: Optional[torch.Tensor], qkv: torch.Tensor) -> None:
    """db's partial rows: (db_parts(B, L), 3D) f32 beside a bf16 qkv (the f32
    kernels write none)."""
    if part is None:
        return
    B, L, three_d = qkv.shape
    want = (db_parts(B, L), three_d)
    if qkv.dtype != torch.bfloat16:
        raise ValueError(f"db partial rows are the bf16 kernels' only; qkv is {qkv.dtype}")
    if (tuple(part.shape) != want or part.dtype != torch.float32 or not part.is_contiguous()
            or part.device != qkv.device):
        raise ValueError(f"part must be a contiguous float32 {want} on qkv's device; got "
                         f"{part.dtype} {tuple(part.shape)} on {part.device}")


def reference_db_parts(dqkv: torch.Tensor, cols: slice) -> torch.Tensor:
    """The plain version of the partial rows' ``cols``: per (sequence, block
    of ROWS rows), the f32 column sums of dqkv's values (rounded to its
    dtype), (db_parts(B, L), len(cols)) f32."""
    B, L, _ = dqkv.shape
    d = dqkv[..., cols].float()
    pad = tiles(L) * ROWS - L
    d = torch.nn.functional.pad(d, (0, 0, 0, pad))
    return d.view(B, tiles(L), ROWS, -1).sum(dim=2).reshape(B * tiles(L), -1)


def reference_long_r(qkv, mask, lse, g, heads, lsum=None) -> torch.Tensor:
    """The plain version of the dQ kernel's r: ``r_i = sum_j dp_ij p_ij``
    with ``p = exp(s - lse)`` (``exp(s - lse - lsum)`` given lsum) and
    ``dp = do v^T`` in f32 (the term ``reference_attention_bwd`` subtracts),
    (heads, B, L) f32."""
    B, L, three_d = qkv.shape
    hd = three_d // 3 // heads
    q, k, v = _split_heads(qkv, heads)
    do = g.to(qkv.dtype).float().view(B, L, heads, hd).transpose(1, 2)
    p = _scores(q, k, mask, hd) - lse.transpose(0, 1).unsqueeze(-1)
    if lsum is not None:
        p = p - lsum.transpose(0, 1).unsqueeze(-1)
    p = torch.exp(p)
    dp = torch.matmul(do, v.transpose(-1, -2))
    return (dp * p).sum(dim=-1).transpose(0, 1).contiguous()


def _check_row_stats(stats: RowStats, qkv: torch.Tensor, heads: int) -> None:
    """The dQ kernel's hand-over beside qkv: on the card in bf16 its stats
    rows; else lse and r (heads, B, L) f32."""
    if stats.lsum is not None:
        _check_lse(stats.lsum, qkv, heads, "lsum")
    if cuda_build.plain_device(qkv) or qkv.dtype != torch.bfloat16:
        _check_lse(stats.lse, qkv, heads)
        if stats.r is None:
            raise ValueError("the f32 kernels and the plain versions take r (heads, B, L) f32")
        _check_lse(stats.r, qkv, heads, "r")
        return
    B, L, _ = qkv.shape
    want, rows = (stats_rows(B, L, heads), stat_row(stats.lsum is not None)), stats.rows
    if (rows is None or tuple(rows.shape) != want or rows.dtype != torch.float32
            or not rows.is_contiguous() or rows.device != qkv.device):
        got = None if rows is None else f"{rows.dtype} {tuple(rows.shape)} on {rows.device}"
        raise ValueError(f"the bf16 kernels hand lse and r over as contiguous float32 stats "
                         f"rows {want} on qkv's device; got {got}")


def long_bwd_dq(qkv: torch.Tensor, mask: Optional[torch.Tensor], lse: torch.Tensor,
                g: torch.Tensor, heads: int, dqkv: torch.Tensor,
                part: Optional[torch.Tensor] = None,
                lsum: Optional[torch.Tensor] = None) -> RowStats:
    """The dQ kernel: writes dq into the q columns of ``dqkv`` (qkv's shape
    and dtype) and, given ``part`` (bf16 only, see :func:`db_parts`), each
    block's column sums of its rounded dq rows into part's q columns;
    returns the lse and each row's r as the :class:`RowStats`
    :func:`long_bwd_dkdv` takes (the bf16 kernel's as stats rows). Given
    ``lsum``, ``lse`` is each row's max and lsum the log of its sum
    (``fused_attention_long_lse(parts=True)``): p = exp(s - lse - lsum).
    Counts each launch in ``long_bwd_dq.launches``."""
    g = _check_bwd(qkv, mask, g, heads)
    _check_lse(lse, qkv, heads)
    if lsum is not None:
        _check_lse(lsum, qkv, heads, "lsum")
    _check_dqkv(dqkv, qkv)
    _check_part(part, qkv)
    D = qkv.shape[-1] // 3
    if cuda_build.plain_device(qkv):
        dqkv[..., :D] = reference_attention_bwd(qkv, mask, lse, g, heads, lsum)[0][..., :D]
        if part is not None:
            part[:, :D] = reference_db_parts(dqkv, slice(0, D))
        return RowStats(lse, reference_long_r(qkv, mask, lse, g, heads, lsum), lsum=lsum)
    _check_kernel_device(qkv, g, dqkv)
    B, L, _ = qkv.shape
    if qkv.dtype == torch.bfloat16:
        stats = RowStats(lse, rows=torch.empty((stats_rows(B, L, heads), stat_row(lsum is not None)),
                                               dtype=torch.float32, device=qkv.device), lsum=lsum)
    else:
        stats = RowStats(lse, r=torch.empty_like(lse), lsum=lsum)
    _launch("bwd_dq_split", qkv, qkv.data_ptr(), _ptr(mask), lse.data_ptr(), _ptr(lsum),
            g.data_ptr(), dqkv.data_ptr(), _ptr(stats.r), _ptr(part), _ptr(stats.rows),
            *_dims(qkv, heads))
    long_bwd_dq.launches += 1
    return stats


def long_bwd_dkdv(qkv: torch.Tensor, mask: Optional[torch.Tensor], stats: RowStats,
                  g: torch.Tensor, heads: int, dqkv: torch.Tensor,
                  part: Optional[torch.Tensor] = None) -> None:
    """The dK/dV kernel: writes dk and dv into the k and v columns of
    ``dqkv`` from :func:`long_bwd_dq`'s :class:`RowStats` (the bf16 kernel
    reads its stats rows alone), and given ``part`` (bf16 only) each
    block's column sums of its rounded dk and dv rows into part's k and v
    columns; with the stats' ``lsum``, p = exp(s - lse - lsum). Counts each
    launch in ``long_bwd_dkdv.launches``."""
    g = _check_bwd(qkv, mask, g, heads)
    _check_row_stats(stats, qkv, heads)
    _check_dqkv(dqkv, qkv)
    _check_part(part, qkv)
    D = qkv.shape[-1] // 3
    if cuda_build.plain_device(qkv):
        dqkv[..., D:] = reference_attention_bwd(qkv, mask, stats.lse, g, heads,
                                                stats.lsum)[0][..., D:]
        if part is not None:
            part[:, D:] = reference_db_parts(dqkv, slice(D, 3 * D))
        return
    _check_kernel_device(qkv, g, dqkv)
    lse, r = (None, None) if stats.rows is not None else (stats.lse, stats.r)
    _launch("bwd_dkdv_split", qkv, qkv.data_ptr(), _ptr(mask), _ptr(lse), _ptr(stats.lsum),
            _ptr(r), g.data_ptr(), dqkv.data_ptr(), _ptr(part), _ptr(stats.rows),
            *_dims(qkv, heads))
    long_bwd_dkdv.launches += 1


def long_db(dqkv: torch.Tensor, part: Optional[torch.Tensor] = None) -> torch.Tensor:
    """db (3D,) f32 in a fixed order, so the same bits on every run: given
    ``part``, the bf16 kernels' partial rows, their sum
    (``attention_db.cuh``'s reduce); else the sum over (B, L) of dqkv's
    values as f32 (256-row partials, then the same reduce). Counts each
    launch in ``long_db.launches``."""
    n = dqkv.shape[-1]
    if part is not None and (part.dim() != 2 or part.shape[1] != n or part.dtype != torch.float32
                             or not part.is_contiguous() or part.device != dqkv.device):
        raise ValueError(f"part must be a contiguous float32 (parts, {n}) on dqkv's device; got "
                         f"{part.dtype} {tuple(part.shape)} on {part.device}")
    if cuda_build.plain_device(dqkv):
        return dqkv.float().sum(dim=(0, 1)) if part is None else part.sum(dim=0)
    _check_kernel_device(dqkv)
    db = torch.empty((n,), dtype=torch.float32, device=dqkv.device)
    if part is None:
        rows = dqkv.numel() // n
        chunks = torch.empty((db_chunks(rows), n), dtype=torch.float32, device=dqkv.device)
        _launch("db", dqkv, dqkv.data_ptr(), chunks.data_ptr(), db.data_ptr(), rows, n,
                cuda_build.DTYPE_CODES[dqkv.dtype])
    else:
        _launch("db_partials", dqkv, part.data_ptr(), db.data_ptr(), part.shape[0], n)
    long_db.launches += 1
    return db


def fused_attention_long_bwd(qkv: torch.Tensor, mask: Optional[torch.Tensor],
                             lse: torch.Tensor, g: torch.Tensor, heads: int,
                             db: bool = True, lsum: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``fused_attention.fused_attention_bwd`` at any length: dqkv (qkv's
    shape and dtype) and, with ``db``, db (3D,) f32; db is None otherwise.
    Runs :func:`long_bwd_dq`, :func:`long_bwd_dkdv` and :func:`long_db`: in
    bf16 the two kernels write db's partial rows and long_db sums them; in
    f32 long_db sums dqkv. ``lsum``: as :func:`long_bwd_dq` takes it."""
    g = _check_bwd(qkv, mask, g, heads)
    _check_lse(lse, qkv, heads)
    if cuda_build.plain_device(qkv):
        dqkv, db_ref = reference_attention_bwd(qkv, mask, lse, g, heads, lsum)
        return dqkv, db_ref if db else None
    dqkv = torch.empty_like(qkv)
    B, L, three_d = qkv.shape
    part = (torch.empty((db_parts(B, L), three_d), dtype=torch.float32, device=qkv.device)
            if db and qkv.dtype == torch.bfloat16 else None)
    stats = long_bwd_dq(qkv, mask, lse, g, heads, dqkv, part, lsum)
    long_bwd_dkdv(qkv, mask, stats, g, heads, dqkv, part)
    return dqkv, long_db(dqkv, part) if db else None


def fused_attention_long_bwd_recompute(qkv: torch.Tensor, mask: Optional[torch.Tensor],
                                       g: torch.Tensor, heads: int, db: bool
                                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The recompute backward at any length (``fused_attention_bwd_recompute``
    and ``_recompute_db``): each row's max and log sum, kept apart, from
    :func:`fused_attention_long_lse` (``parts``), then
    :func:`fused_attention_long_bwd` given both, so that p is exp(s - max)
    / sum as JAX's recompute kernels form it, also in a row whose logsumexp
    would round to its max. On the CPU, the plain version that recomputes p
    from the scores' max and sum."""
    g = _check_bwd(qkv, mask, g, heads)
    if cuda_build.plain_device(qkv):
        dqkv, db_ref = reference_attention_bwd(qkv, mask, None, g, heads)
        return dqkv, db_ref if db else None
    _, row_max, lsum = fused_attention_long_lse(qkv, mask, heads, parts=True)
    return fused_attention_long_bwd(qkv, mask, row_max, g, heads, db, lsum)


fused_attention_long.launches = 0
fused_attention_long_lse.launches = 0
long_bwd_dq.launches = 0
long_bwd_dkdv.launches = 0
long_db.launches = 0
