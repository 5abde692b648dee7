"""Fused spatial multi-positive cross-entropy, forward and backward.

Counterpart of ``spatial_clip_tpu/ops/fused_contrastive.py``:

- :func:`fused_spatial_ce`: the per-row loss (B,) as an autograd function
  (``fused_spatial_ce`` and its custom VJP);
- :func:`spatial_ce_fwd`: loss, lse and mass (``_fwd_impl`` -> ``_fwd_kernel``);
- :func:`spatial_ce_dq`: dq and dscale (``_fused_bwd`` -> ``_dq_kernel``);
- :func:`spatial_ce_dk`: dK (``_fused_bwd`` -> ``_dk_kernel``).

The three take the kernels' inputs: q (B, D) and K (N, D) f32, the column
tile ids (N,), each row's own tile id ``gt_ids`` (B,), the neighbor ids
(B, k) int32 and their weights (B, k) f32 clamped at 0, and the scale, a
0-dim f32 tensor that the kernels read on the device (no host sync). On a
CUDA tensor each launches its hand-written kernel
(``csrc/fused_spatial_ce.cu``); on a CPU tensor it runs its plain PyTorch
version (``reference_spatial_ce_fwd``, ``_dq``, ``_dk``: dense f32 math).
It never falls back from one to the other.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from spatial_clip_tpu_torch.ops import cuda_build

MAX_DIM = 1536  # the widest feature dim the kernels take: a cluster of three 512-column slices
MAX_NEIGHBORS = 16
FWD, DQ, DK = 0, 1, 2  # the kinds of csrc/fused_spatial_ce.cu's sc_spatial_ce_scratch


def _check(q, kmat, col_ids, gt_ids, nbr, alphas, scale) -> None:
    """The kernels' input contract, checked before any launch."""
    if q.dim() != 2 or kmat.dim() != 2 or q.shape[1] != kmat.shape[1]:
        raise ValueError(f"q (B, D) and kmat (N, D) must share D; got {tuple(q.shape)} "
                         f"and {tuple(kmat.shape)}")
    (B, D), N = q.shape, kmat.shape[0]
    if B < 1 or N < 1 or not 1 <= D <= MAX_DIM:
        raise ValueError(f"B={B}, N={N}, D={D}: need B, N >= 1 and 1 <= D <= {MAX_DIM}")
    if col_ids.shape != (N,) or gt_ids.shape != (B,):
        raise ValueError(f"col_ids must be ({N},) and gt_ids ({B},); got "
                         f"{tuple(col_ids.shape)} and {tuple(gt_ids.shape)}")
    if nbr.dim() != 2 or nbr.shape[0] != B or alphas.shape != nbr.shape:
        raise ValueError(f"nbr and alphas must be ({B}, k); got {tuple(nbr.shape)} "
                         f"and {tuple(alphas.shape)}")
    if nbr.shape[1] > MAX_NEIGHBORS:
        raise ValueError(f"{nbr.shape[1]} neighbors per row; the kernels take {MAX_NEIGHBORS}")
    if scale.dim() != 0:
        raise ValueError(f"scale must be a 0-dim tensor; got {tuple(scale.shape)}")
    want = {"q": (q, torch.float32), "kmat": (kmat, torch.float32),
            "col_ids": (col_ids, torch.int32), "gt_ids": (gt_ids, torch.int32),
            "nbr": (nbr, torch.int32), "alphas": (alphas, torch.float32),
            "scale": (scale, torch.float32)}
    for name, (t, dtype) in want.items():
        if t.dtype != dtype or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name} must be contiguous {dtype} on {q.device}; got "
                             f"{t.dtype} on {t.device}")


def _check_bwd(q, lse, mass, g) -> None:
    for name, t in (("lse", lse), ("mass", mass), ("g", g)):
        if (t.shape != (q.shape[0],) or t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != q.device):
            raise ValueError(f"{name} must be contiguous float32 ({q.shape[0]},) on "
                             f"{q.device}; got {t.dtype} {tuple(t.shape)} on {t.device}")


def _check_kernel_device(q: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")


# ------------------------------------------------------------ plain versions

def _labels(col_ids, gt_ids, nbr, alphas) -> torch.Tensor:
    """Unnormalized labels (B, N) from tile ids, in the TPU kernel's order:
    the diagonal match, then each neighbor's weight where its id matches."""
    labels = (col_ids[None, :] == gt_ids[:, None]).float()
    for j in range(nbr.shape[1]):
        labels = labels + (col_ids[None, :] == nbr[:, j:j + 1]).float() * alphas[:, j:j + 1]
    return labels


def reference_spatial_ce_fwd(q, kmat, col_ids, gt_ids, nbr, alphas, scale):
    """Plain version of the forward kernel (``_fwd_kernel``): z = s q K^T in
    f32, lse = m + log(max(sum exp(z - m), 1e-30)) with m the row max,
    mass = max(sum l, 1e-12), loss = lse - (sum l z) / mass. Returns
    (loss, lse, mass), each (B,) f32."""
    z = (q @ kmat.T) * scale
    labels = _labels(col_ids, gt_ids, nbr, alphas)
    m = z.amax(dim=1)
    lse = m + torch.log(torch.exp(z - m[:, None]).sum(dim=1).clamp_min(1e-30))
    mass = labels.sum(dim=1).clamp_min(1e-12)
    return lse - (labels * z).sum(dim=1) / mass, lse, mass


def _dz(q, kmat, col_ids, gt_ids, nbr, alphas, scale, lse, mass, g):
    """dz = (exp(z - lse) - l / mass) g, and the unscaled products q K^T."""
    zraw = q @ kmat.T
    p = torch.exp(zraw * scale - lse[:, None])
    labels = _labels(col_ids, gt_ids, nbr, alphas)
    return (p - labels / mass[:, None]) * g[:, None], zraw


def reference_spatial_ce_dq(q, kmat, col_ids, gt_ids, nbr, alphas, scale, lse, mass, g):
    """Plain version of the dq kernel (``_dq_kernel``): dq = s dz K (B, D)
    and dscale = sum(dz * q K^T), a 0-dim f32."""
    dz, zraw = _dz(q, kmat, col_ids, gt_ids, nbr, alphas, scale, lse, mass, g)
    return scale * (dz @ kmat), (dz * zraw).sum()


def reference_spatial_ce_dk(q, kmat, col_ids, gt_ids, nbr, alphas, scale, lse, mass, g):
    """Plain version of the dK kernel (``_dk_kernel``): dK = s dz^T q (N, D)."""
    dz, _ = _dz(q, kmat, col_ids, gt_ids, nbr, alphas, scale, lse, mass, g)
    return scale * (dz.T @ q)


def reference_spatial_ce(q, kmat, col_ids, gt, nbr, alphas, scale) -> torch.Tensor:
    """The JAX package's ``reference_spatial_ce``: dense soft cross-entropy
    against the L1-normalized labels; ``gt`` holds column indices."""
    z = (q.float() @ kmat.float().T) * scale
    labels = _labels(col_ids, col_ids[gt.long()], nbr, alphas.float().clamp_min(0.0))
    labels = labels / labels.sum(dim=1, keepdim=True).clamp_min(1e-12)
    return -(F.log_softmax(z, dim=-1) * labels).sum(dim=1)


# ----------------------------------------------------------------- wrappers

# The kernels' tiles (csrc/fused_spatial_ce.cu, one walk for all three
# entries): the rows a CTA owns, its columns of D, the rows of a tile, the
# bytes of its shared memory before the cluster's partial z
# (sizeof(walk::Smem)) and of one slice's partial z; the names of a plan's
# fields.
OWN, COLS, TILE = 32, 512, 32
SMEM, Z_SLICE_BYTES = 212416, OWN * TILE * 4
MAX_SMEM = 232448  # 227 KB, the most a block may use on sm_90
PLAN_KEYS = ("own", "tile", "blocks", "slices", "splits", "per", "smem", "resident")


def plan(kind: int, B: int, N: int, D: int, resident: int) -> dict:
    """How entry ``kind`` cuts its work (mirrors ``make_plan``): ``blocks``
    row blocks of ``own`` owned rows (q rows for the forward and dq, K rows
    for dK), each ``slices`` CTAs of 512 columns of D (a cluster, which
    exchanges partial z), and the other side's tiles of ``tile`` rows cut
    into ``splits`` ranges of ``per`` tiles, as many as fill one wave of the
    ``resident`` CTAs the card holds; ``smem`` a CTA's dynamic shared
    memory."""
    n_own, n_other = (N, B) if kind == DK else (B, N)
    slices = -(-D // COLS)
    blocks, tiles = -(-n_own // OWN), -(-n_other // TILE)
    want = min(tiles, max(1, resident // (blocks * slices)))
    per = -(-tiles // want)
    return dict(own=OWN, tile=TILE, blocks=blocks, slices=slices, splits=-(-tiles // per),
                per=per, smem=SMEM + (slices * Z_SLICE_BYTES if slices > 1 else 0),
                resident=resident)


def kernel_plan(kind: int, B: int, N: int, D: int) -> dict:
    """:func:`plan` as the kernel library computes it on the current card
    (needs the card's build), with the resident CTAs it read."""
    lib = cuda_build.library()
    out = (ctypes.c_int * len(PLAN_KEYS))()
    cuda_build.check(lib, lib.sc_spatial_ce_plan(kind, B, N, D, out), "sc_spatial_ce_plan")
    return dict(zip(PLAN_KEYS, out))


def _scratch(kind: int, q: torch.Tensor, kmat: torch.Tensor) -> torch.Tensor:
    """The f32 scratch that entry ``kind`` takes at these shapes on q's card.
    The kernels' source sizes it (their split of the work) and checks it."""
    lib = cuda_build.library()
    n = ctypes.c_size_t()
    with torch.cuda.device(q.device):
        err = lib.sc_spatial_ce_scratch(kind, q.shape[0], kmat.shape[0], q.shape[1],
                                        ctypes.byref(n))
    cuda_build.check(lib, err, "fused_spatial_ce scratch size")
    return torch.empty((n.value,), dtype=torch.float32, device=q.device)


def _launch(fn: str, what: str, kind: int, inputs, before, after) -> None:
    """Call entry ``fn`` with the inputs, the tensors ``before`` the scratch,
    the scratch and its length, the tensors ``after`` it, then B, N, D, k
    and PyTorch's current stream."""
    q, kmat, nbr = inputs[0], inputs[1], inputs[4]
    scratch = _scratch(kind, q, kmat)
    lib = cuda_build.library()
    with torch.cuda.device(q.device):
        err = getattr(lib, fn)(
            *(t.data_ptr() for t in (*inputs, *before)), scratch.data_ptr(), scratch.numel(),
            *(t.data_ptr() for t in after), q.shape[0], kmat.shape[0], q.shape[1],
            nbr.shape[1], torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(lib, err, what)


def spatial_ce_fwd(q, kmat, col_ids, gt_ids, nbr, alphas, scale):
    """(loss, lse, mass), each (B,) f32. Counts each kernel launch in
    ``spatial_ce_fwd.launches``."""
    inputs = (q, kmat, col_ids, gt_ids, nbr, alphas, scale)
    _check(*inputs)
    if cuda_build.plain_device(q):
        return reference_spatial_ce_fwd(*inputs)
    _check_kernel_device(q)
    loss, lse, mass = torch.empty((3, q.shape[0]), dtype=torch.float32, device=q.device)
    _launch("sc_spatial_ce_fwd", "fused_spatial_ce forward launch", FWD, inputs, (),
            (loss, lse, mass))
    spatial_ce_fwd.launches += 1
    return loss, lse, mass


def spatial_ce_dq(q, kmat, col_ids, gt_ids, nbr, alphas, scale, lse, mass, g):
    """(dq (B, D), dscale ()) f32 from the forward's lse and mass and the
    loss cotangent g (B,). Counts each kernel launch in
    ``spatial_ce_dq.launches``."""
    inputs = (q, kmat, col_ids, gt_ids, nbr, alphas, scale)
    _check(*inputs)
    _check_bwd(q, lse, mass, g)
    if cuda_build.plain_device(q):
        return reference_spatial_ce_dq(*inputs, lse, mass, g)
    _check_kernel_device(q)
    dq = torch.empty_like(q)
    dscale = torch.empty((), dtype=torch.float32, device=q.device)
    _launch("sc_spatial_ce_dq", "fused_spatial_ce dq launch", DQ, inputs, (lse, mass, g),
            (dq, dscale))
    spatial_ce_dq.launches += 1
    return dq, dscale


def spatial_ce_dk(q, kmat, col_ids, gt_ids, nbr, alphas, scale, lse, mass, g):
    """dK (N, D) f32, as :func:`spatial_ce_dq`. Counts each kernel launch in
    ``spatial_ce_dk.launches``."""
    inputs = (q, kmat, col_ids, gt_ids, nbr, alphas, scale)
    _check(*inputs)
    _check_bwd(q, lse, mass, g)
    if cuda_build.plain_device(q):
        return reference_spatial_ce_dk(*inputs, lse, mass, g)
    _check_kernel_device(q)
    dk = torch.empty_like(kmat)
    _launch("sc_spatial_ce_dk", "fused_spatial_ce dK launch", DK, inputs, (lse, mass, g),
            (dk,))
    spatial_ce_dk.launches += 1
    return dk


spatial_ce_fwd.launches = 0
spatial_ce_dq.launches = 0
spatial_ce_dk.launches = 0


def prepare_inputs(q, kmat, col_ids, gt, nbr, alphas, scale):
    """What ``_fwd_impl`` does outside its kernel: q and K to f32, the
    ground truth as the tile id of its column (``col_ids[gt]``, so the
    diagonal matches by id), the ids to int32, the alphas clamped at 0."""
    cid = col_ids.to(torch.int32).contiguous()
    return (q.float().contiguous(), kmat.float().contiguous(), cid,
            cid[gt.long()].contiguous(), nbr.to(torch.int32).contiguous(),
            alphas.float().clamp_min(0.0).contiguous(), scale.float().reshape(()).contiguous())


class FusedSpatialCE(torch.autograd.Function):
    """Per-row losses with the kernels' backward. The forward saves lse and
    mass (B,); the backward returns dq and dK in the inputs' dtypes and
    dscale in the scale's, and nothing for the ids and alphas (data, as in
    the JAX package)."""

    @staticmethod
    def forward(ctx, q, kmat, col_ids, gt, nbr, alphas, scale):
        inputs = prepare_inputs(q, kmat, col_ids, gt, nbr, alphas, scale)
        loss, lse, mass = spatial_ce_fwd(*inputs)
        ctx.save_for_backward(*inputs, lse, mass)
        ctx.dtypes = (q.dtype, kmat.dtype, scale.dtype)
        return loss

    @staticmethod
    def backward(ctx, g):
        *inputs, lse, mass = ctx.saved_tensors
        g = g.float().contiguous()
        dq = dk = dscale = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[6]:
            dq, dscale = spatial_ce_dq(*inputs, lse, mass, g)
            dq, dscale = dq.to(ctx.dtypes[0]), dscale.to(ctx.dtypes[2])
        if ctx.needs_input_grad[1]:
            dk = spatial_ce_dk(*inputs, lse, mass, g).to(ctx.dtypes[1])
        return dq, dk, None, None, None, None, dscale


def fused_spatial_ce(q: torch.Tensor, kmat: torch.Tensor, col_ids: torch.Tensor,
                     gt: torch.Tensor, nbr: torch.Tensor, alphas: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """Per-row soft cross-entropy (B,) of the spatial multi-positive loss.

    q: (B, D) features; kmat: (N, D) the other tower's features; col_ids:
    (N,) their tile ids; gt: (B,) each row's ground-truth column index;
    nbr / alphas: (B, k) neighbor tile ids (ids < 0 match no column) and
    weights; scale: the 0-dim effective logit scale.
    """
    return FusedSpatialCE.apply(q, kmat, col_ids, gt, nbr, alphas, scale)
