"""Fused LayerNorm over the rows of a 2-D tensor, forward and backward.

Counterpart of ``spatial_clip_tpu/ops/fused_ln.py``:

- :func:`fused_ln_fwd`: y (``_fwd_impl`` -> ``_fwd_kernel``);
- :func:`fused_ln_bwd`: dx, dgamma, dbeta (``_bwd_impl`` -> ``_bwd_kernel``);
- :class:`FusedLayerNorm` / :func:`fused_layer_norm`: the two as one
  autograd function (``fused_layer_norm`` and its custom VJP).

Statistics are one-pass f32 (mean and E[x^2], ``var = max(E[x^2] - mean^2,
0)``), the model's ``ln_impl='onepass'`` math; the backward recomputes them
from x. On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/fused_ln.cu``); on a CPU tensor it runs its plain PyTorch version
(``reference_ln_fwd``, ``reference_ln_bwd``). It never falls back from one to
the other: a CUDA tensor either goes through the kernel or raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from spatial_clip_tpu_torch.ops import cuda_build


# csrc/fused_ln.cu: warps of a backward block, and SC_LN_BWD_BLOCKS, the most
# resident blocks an SM of its one-wave grid
BWD_WARPS, BWD_BLOCKS = 8, 1


def supported(width: int) -> bool:
    """The JAX package's gate for routing a LayerNorm to the kernel."""
    return width % 128 == 0


def bwd_blocks(rows: int, sms: int, per_sm: int) -> int:
    """Blocks of the backward's grid (``sc_layer_norm_bwd_blocks``): one
    full wave of at most ``BWD_BLOCKS`` blocks on each of ``sms`` SMs (fewer
    where the occupancy API gives ``per_sm`` fewer), or one for each
    ``BWD_WARPS`` rows when there are fewer; block b of nb owns rows [b R /
    nb, (b + 1) R / nb). Its dgamma / dbeta partials are (blocks, 2 D)
    f32."""
    return min(sms * min(per_sm, BWD_BLOCKS), -(-rows // BWD_WARPS))


def _one_pass_stats(x: torch.Tensor, eps: float):
    xa = x.float()
    mean = xa.mean(dim=-1, keepdim=True)
    var = ((xa * xa).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    return xa, mean, torch.rsqrt(var + eps)


def reference_ln_fwd(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     eps: float) -> torch.Tensor:
    """Plain PyTorch version with the TPU kernel's math: one-pass f32
    statistics, ``(x - mean) rstd gamma + beta`` in f32, cast to x's dtype."""
    xa, mean, rstd = _one_pass_stats(x, eps)
    return ((xa - mean) * rstd * gamma + beta).to(x.dtype)


def reference_ln_bwd(x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor,
                     eps: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernel: statistics recomputed
    from x, ``w = dy gamma``, ``dx = (w - mean(w) - xhat mean(w xhat)) rstd``
    in x's dtype; dgamma = sum of ``dy xhat`` and dbeta = sum of dy over the
    rows, (D,) f32."""
    xa, mean, rstd = _one_pass_stats(x, eps)
    xhat = (xa - mean) * rstd
    dya = dy.float()
    w = dya * gamma
    c1 = w.mean(dim=-1, keepdim=True)
    c2 = (w * xhat).mean(dim=-1, keepdim=True)
    dx = ((w - c1 - xhat * c2) * rstd).to(x.dtype)
    return dx, (dya * xhat).sum(dim=0), dya.sum(dim=0)


def _check(x: torch.Tensor, *params: torch.Tensor) -> None:
    if x.dim() != 2 or x.shape[0] < 1:
        raise ValueError(f"x must be (R, D) with R >= 1; got {tuple(x.shape)}")
    D = x.shape[1]
    if x.dtype not in cuda_build.DTYPE_CODES:
        raise ValueError(f"x dtype {x.dtype} not taken (float32 or bfloat16)")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    for p in params:
        if p.shape != (D,) or p.dtype != torch.float32 or p.device != x.device:
            raise ValueError(f"gamma / beta must be float32 ({D},) on {x.device}; got "
                             f"{p.dtype} {tuple(p.shape)} on {p.device}")


def check_kernel_width(lib, width: int, what: str) -> None:
    """Raise unless the LayerNorm kernels take rows of ``width``: a multiple
    of 128 up to the library's ``sc_layer_norm_max_width()``."""
    most = lib.sc_layer_norm_max_width()
    if not (supported(width) and width <= most):
        raise ValueError(f"{what}: the kernels take multiples of 128 up to {most}")


def _check_kernel_device(*tensors: torch.Tensor):
    """The kernels' own requirements, on a tensor that is not on the CPU:
    contiguous and 16-byte aligned (gamma and beta too). Returns the kernel
    library."""
    x = tensors[0]
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    lib = cuda_build.library()
    check_kernel_width(lib, x.shape[1], f"width {x.shape[1]}")
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in tensors):
        raise ValueError("the kernel reads 16-byte vectors: tensors must be contiguous and "
                         "16-byte aligned")
    return lib


def fused_ln_fwd(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                 eps: float) -> torch.Tensor:
    """LayerNorm of each row of x (R, D), float32 or bfloat16; gamma, beta
    (D,) float32. Returns y in x's dtype. Counts each kernel launch in
    ``fused_ln_fwd.launches``."""
    _check(x, gamma, beta)
    if cuda_build.plain_device(x):
        return reference_ln_fwd(x, gamma, beta, eps)
    y = torch.empty_like(x)
    lib = _check_kernel_device(x, gamma, beta, y)
    with torch.cuda.device(x.device):
        err = lib.sc_layer_norm_fwd(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(), x.shape[0],
            x.shape[1], cuda_build.DTYPE_CODES[x.dtype], eps,
            torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(lib, err, "fused_ln_fwd launch")
    fused_ln_fwd.launches += 1
    return y


def fused_ln_bwd(x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor,
                 eps: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of :func:`fused_ln_fwd` given dy (x's shape; cast to x's
    dtype): dx in x's dtype, dgamma and dbeta (D,) float32. dgamma and
    dbeta are deterministic: the same inputs give the same bits. Counts each
    kernel launch in ``fused_ln_bwd.launches``."""
    _check(x, gamma)
    if dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"dy must be {tuple(x.shape)} on {x.device}; got "
                         f"{tuple(dy.shape)} on {dy.device}")
    dy = dy.to(x.dtype).contiguous()
    if cuda_build.plain_device(x):
        return reference_ln_bwd(x, gamma, dy, eps)
    dx = torch.empty_like(x)
    lib = _check_kernel_device(x, gamma, dy, dx)
    R, D = x.shape
    code = cuda_build.DTYPE_CODES[x.dtype]
    with torch.cuda.device(x.device):
        blocks = lib.sc_layer_norm_bwd_blocks(R, D, code)
    if blocks < 1:
        raise RuntimeError(f"fused_ln_bwd: no grid for ({R}, {D}) {x.dtype}")
    part = torch.empty((blocks, 2 * D), dtype=torch.float32, device=x.device)
    dgdb = torch.empty((2 * D,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.sc_layer_norm_bwd(
            x.data_ptr(), gamma.data_ptr(), dy.data_ptr(), dx.data_ptr(), part.data_ptr(),
            dgdb.data_ptr(), R, D, code, eps, torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(lib, err, "fused_ln_bwd launch")
    fused_ln_bwd.launches += 1
    return dx, dgdb[:D], dgdb[D:]


fused_ln_fwd.launches = 0
fused_ln_bwd.launches = 0


class FusedLayerNorm(torch.autograd.Function):
    """:func:`fused_ln_fwd` with :func:`fused_ln_bwd` as its backward; gamma
    and beta get their gradients in their own shape."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps: float):
        g, b = gamma.reshape(-1), beta.reshape(-1)
        ctx.save_for_backward(x, g)
        ctx.eps, ctx.shapes = eps, (gamma.shape, beta.shape)
        return fused_ln_fwd(x, g, b, eps)

    @staticmethod
    def backward(ctx, dy):
        x, g = ctx.saved_tensors
        dx, dg, db = fused_ln_bwd(x, g, dy, ctx.eps)
        return dx, dg.view(ctx.shapes[0]), db.view(ctx.shapes[1]), None


def fused_layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim of x (R, D) with one-pass f32 statistics,
    y in x's dtype; gamma and beta are float32 (D,) or (1, D), as in the JAX
    package. Forward and backward are the hand-written kernels on a CUDA
    tensor."""
    return FusedLayerNorm.apply(x.contiguous(), gamma, beta, eps)
