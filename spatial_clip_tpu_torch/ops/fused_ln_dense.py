"""Fused LayerNorm -> Dense (a pre-LN projection), forward and data gradient.

Counterpart of ``spatial_clip_tpu/ops/fused_ln_dense.py``:

- :func:`ln_dense_fwd`: ``y = xhat W'^T + b'`` and xhat
  (``_fwd_pallas`` -> ``_fwd_kernel``);
- :func:`ln_dense_bwd_dx`: dx through W' and the normalization
  (``_bwd_dx_pallas`` -> ``_bwd_dx_kernel``);
- :class:`FusedLNDense` / :func:`fused_ln_dense`: ``LN(x) W^T + b`` as one
  autograd function (``fused_ln_dense`` and its custom VJP).

The LayerNorm's affine is folded into the projection (:func:`_fold`):
``LN(x) W^T + b = xhat (W gamma)^T + (W beta + b)``. Statistics are
two-pass f32. Weights use the port's (out, in) layout: W (N, K), so W'
is (N, K) too. On a CUDA tensor each wrapper launches its hand-written
kernel (``csrc/fused_ln_dense.cu``), whose products run inside the kernel;
on a CPU tensor it runs its plain PyTorch version (``reference_ln_dense_fwd``,
``reference_ln_dense_bwd_dx``). It never falls back from one to the other.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from spatial_clip_tpu_torch.ops import cuda_build
from spatial_clip_tpu_torch.ops.fused_attention import _mm_f32
from spatial_clip_tpu_torch.ops.fused_ln import check_kernel_width


# The bf16 dx kernel's tiling (csrc/fused_ln_dense.cu, namespace dxtc): a
# K-group of CTAs owns DX_ROW_TILE rows, each CTA up to 3 units of 128 of
# the K columns.
DX_ROW_TILE = 128


def dx_k_parts(k: int) -> int:
    """The CTAs of the bf16 dx kernel's K-group at width k (``Split``)."""
    units = k // 128
    return 1 if units <= 3 else 2 if units <= 6 else 4


def supported(k: int, n: int) -> bool:
    """The JAX package's gate (``_fused_ln_ok``): 128-aligned dims and a
    weight of at most 7 MiB in bf16."""
    return k % 128 == 0 and n % 128 == 0 and k * n * 2 <= 7 * 2 ** 20


def _fold(gamma: torch.Tensor, beta: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
          dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """W' = W gamma (columns scaled) in ``dtype`` and b' = W beta + b in f32,
    for W (N, K)."""
    w = weight.float()
    return (w * gamma).to(dtype), w @ beta.float() + bias.float()


def _two_pass_xhat(x: torch.Tensor, eps: float):
    xa = x.float()
    xc = xa - xa.mean(dim=1, keepdim=True)
    r = torch.rsqrt((xc * xc).mean(dim=1, keepdim=True) + eps)
    return xc * r, r


def reference_ln_dense_fwd(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                           eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version with the TPU kernel's math: two-pass f32
    statistics, xhat rounded to x's dtype, ``xhat W'^T`` summed in f32 plus
    b', cast to x's dtype. Returns y (R, N) and xhat (R, K)."""
    xhat = _two_pass_xhat(x, eps)[0].to(x.dtype)
    y = (_mm_f32(xhat, w1.t()) + b1).to(x.dtype)
    return y, xhat


def reference_ln_dense_bwd_dx(x: torch.Tensor, g: torch.Tensor, w1: torch.Tensor,
                              eps: float) -> torch.Tensor:
    """Plain PyTorch version of the dx kernel: statistics recomputed from x,
    ``u = g W'`` summed in f32, ``dx = r (u - mean(u) - xhat mean(u xhat))``
    with xhat in f32, cast to x's dtype."""
    xhat, r = _two_pass_xhat(x, eps)
    u = _mm_f32(g, w1)
    dx = r * (u - u.mean(dim=1, keepdim=True) - xhat * (u * xhat).mean(dim=1, keepdim=True))
    return dx.to(x.dtype)


def reference_ln_dense(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                       weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5):
    """Plain LayerNorm (f32 two-pass statistics, output in x's dtype) then
    the projection in x's dtype: the JAX package's ``reference_ln_dense``."""
    xhat = _two_pass_xhat(x, eps)[0]
    y = (xhat * gamma + beta).to(x.dtype)
    return y @ weight.to(x.dtype).t() + bias.to(x.dtype)


def _check(x: torch.Tensor, other: torch.Tensor, w1: torch.Tensor) -> None:
    """x (R, K) and w1 (N, K) in one dtype; ``other`` (R, N) or (N,)."""
    if x.dim() != 2 or x.shape[0] < 1 or w1.dim() != 2 or w1.shape[1] != x.shape[1]:
        raise ValueError(f"x must be (R, K) with R >= 1 and w1 (N, K); got "
                         f"{tuple(x.shape)} and {tuple(w1.shape)}")
    if x.dtype not in cuda_build.DTYPE_CODES or w1.dtype != x.dtype:
        raise ValueError(f"x and w1 must share a dtype, float32 or bfloat16; got "
                         f"{x.dtype} and {w1.dtype}")
    for t in (x, other, w1):
        if not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"inputs must be contiguous and on {x.device}")


def _check_kernel_device(*tensors: torch.Tensor):
    """The kernels' own requirements, on a tensor that is not on the CPU.
    Returns the kernel library."""
    x, w1 = tensors[0], tensors[1]
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    lib = cuda_build.library()
    (N, K) = w1.shape
    check_kernel_width(lib, K, f"K={K}, N={N}: K")
    if N % 128:
        raise ValueError(f"K={K}, N={N}: the kernels take N a multiple of 128")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the kernels read 16-byte vectors: tensors must be 16-byte aligned")
    return lib


def ln_dense_fwd(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                 eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (R, K) and the folded W' (N, K) in one dtype, b' (N,) float32.
    Returns y (R, N) and xhat (R, K) in x's dtype. Counts each kernel
    launch in ``ln_dense_fwd.launches`` and in ``ln_dense_fwd.routes`` by
    its body: ``tc`` (bf16, wgmma) or ``f32`` (CUDA cores)."""
    _check(x, b1, w1)
    if b1.shape != (w1.shape[0],) or b1.dtype != torch.float32:
        raise ValueError(f"b1 must be float32 ({w1.shape[0]},); got {b1.dtype} "
                         f"{tuple(b1.shape)}")
    if cuda_build.plain_device(x):
        return reference_ln_dense_fwd(x, w1, b1, eps)
    (R, K), N = x.shape, w1.shape[0]
    y = torch.empty((R, N), dtype=x.dtype, device=x.device)
    xhat = torch.empty_like(x)
    lib = _check_kernel_device(x, w1, b1, y, xhat)
    with torch.cuda.device(x.device):
        err = lib.sc_ln_dense_fwd(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), y.data_ptr(), xhat.data_ptr(), R, K, N,
            cuda_build.DTYPE_CODES[x.dtype], eps, torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(lib, err, "ln_dense_fwd launch")
    ln_dense_fwd.launches += 1
    ln_dense_fwd.routes["tc" if x.dtype == torch.bfloat16 else "f32"] += 1
    return y, xhat


def ln_dense_fwd_plan(R: int, K: int, N: int) -> dict:
    """The bf16 forward kernel's launch plan at this shape, from the kernel
    library (needs the card's build): its units (row pairs x 256-column
    tiles), the clusters of its persistent grid, the stages of each
    consumer's ring, cluster size and CTAs."""
    lib = cuda_build.library()
    plan = (ctypes.c_int * 5)()
    cuda_build.check(lib, lib.sc_ln_dense_fwd_plan(R, K, N, plan), "sc_ln_dense_fwd_plan")
    return dict(zip(("units", "clusters", "stages", "cluster", "ctas"), plan))


def ln_dense_bwd_dx(x: torch.Tensor, g: torch.Tensor, w1: torch.Tensor,
                    eps: float) -> torch.Tensor:
    """dx (R, K) in x's dtype for ``y = normalize(x) W'^T + const`` given
    g (R, N), all three in one dtype. Counts each kernel launch in
    ``ln_dense_bwd_dx.launches`` and in ``ln_dense_bwd_dx.routes`` by its
    body: ``tc`` (bf16, wgmma) or ``f32`` (CUDA cores)."""
    _check(x, g, w1)
    if g.shape != (x.shape[0], w1.shape[0]) or g.dtype != x.dtype:
        raise ValueError(f"g must be {x.dtype} {(x.shape[0], w1.shape[0])}; got {g.dtype} "
                         f"{tuple(g.shape)}")
    if cuda_build.plain_device(x):
        return reference_ln_dense_bwd_dx(x, g, w1, eps)
    (R, K), N = x.shape, w1.shape[0]
    dx = torch.empty_like(x)
    lib = _check_kernel_device(x, w1, g, dx)
    with torch.cuda.device(x.device):
        err = lib.sc_ln_dense_bwd_dx(
            x.data_ptr(), g.data_ptr(), w1.data_ptr(), dx.data_ptr(), R, K, N,
            cuda_build.DTYPE_CODES[x.dtype], eps, torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(lib, err, "ln_dense_bwd_dx launch")
    ln_dense_bwd_dx.launches += 1
    ln_dense_bwd_dx.routes["tc" if x.dtype == torch.bfloat16 else "f32"] += 1
    return dx


def ln_dense_bwd_dx_plan(R: int, K: int, N: int) -> dict:
    """The bf16 dx kernel's launch plan at this shape, from the kernel
    library (needs the card's build): its 128-row tiles, clusters, the
    stages of its W' ring, cluster size, CTAs, the CTAs that split each
    tile's K columns (``k_parts``) and the 128-column units a CTA holds."""
    lib = cuda_build.library()
    plan = (ctypes.c_int * 7)()
    cuda_build.check(lib, lib.sc_ln_dense_bwd_dx_plan(R, K, N, plan), "sc_ln_dense_bwd_dx_plan")
    return dict(zip(("row_tiles", "clusters", "stages", "cluster", "ctas", "k_parts", "units"),
                    plan))


ln_dense_fwd.launches = 0
ln_dense_fwd.routes = {"tc": 0, "f32": 0}
ln_dense_bwd_dx.launches = 0
ln_dense_bwd_dx.routes = {"tc": 0, "f32": 0}


class FusedLNDense(torch.autograd.Function):
    """``LN(x; gamma, beta) W^T + b`` through :func:`ln_dense_fwd`, with the
    backward of ``_vjp_bwd``: in W's (N, K) layout, ``dW' = g^T xhat``
    (bf16 operands summed in f32, a GEMM outside the kernel as in JAX),
    ``db = sum g``, ``dW = dW' gamma + db beta^T``, ``dgamma = sum_n dW' W``,
    ``dbeta = W^T db``, and dx from :func:`ln_dense_bwd_dx`."""

    @staticmethod
    def forward(ctx, x, gamma, beta, weight, bias, eps: float):
        w1, b1 = _fold(gamma, beta, weight, bias, x.dtype)
        y, xhat = ln_dense_fwd(x, w1, b1, eps)
        ctx.save_for_backward(x, xhat, gamma, beta, weight, w1)
        ctx.eps = eps
        ctx.dtypes = (gamma.dtype, beta.dtype, weight.dtype, bias.dtype)
        return y

    @staticmethod
    def backward(ctx, g):
        x, xhat, gamma, beta, weight, w1 = ctx.saved_tensors
        gf = g.to(x.dtype).contiguous()
        dw1 = _mm_f32(gf.t(), xhat)  # (N, K) f32
        db = g.float().sum(dim=0)
        w = weight.float()
        dweight = dw1 * gamma + db[:, None] * beta
        dgamma = (dw1 * w).sum(dim=0)
        dbeta = w.t() @ db
        dx = ln_dense_bwd_dx(x, gf, w1, ctx.eps)
        return (dx, *(t.to(d) for t, d in zip((dgamma, dbeta, dweight, db), ctx.dtypes)), None)


def fused_ln_dense(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``LN(x; gamma, beta) W^T + b`` for x (R, K) in the compute dtype,
    gamma/beta (K,) f32 and W (N, K), b (N,) in any float dtype. Returns
    (R, N) in x's dtype; one read of x per direction through the kernels."""
    return FusedLNDense.apply(x.contiguous(), gamma, beta, weight, bias, eps)
