"""Fused transformer MLP, ``gelu_tanh(x W1^T + b1) W2^T + b2``.

Counterpart of ``spatial_clip_tpu/ops/fused_mlp.py``:

- :func:`fused_mlp_fwd`: the forward, with the (R, hidden) activation kept
  out of device memory (``_fwd`` -> ``_fwd_kernel``);
- :class:`FusedMLP` / :func:`fused_mlp`: the forward and its backward as one
  autograd function (``fused_mlp`` and its custom VJP), the backward
  recomputing the hidden activation in plain f32 PyTorch as ``_fused_bwd``
  does in XLA.

Weights use the port's (out, in) layout: W1 (H, W), W2 (W, H). On a CUDA
tensor :func:`fused_mlp_fwd` launches its hand-written kernel
(``csrc/fused_mlp.cu``), whose two products run inside the kernel; on a CPU
tensor it runs its plain PyTorch version (:func:`reference_mlp_fwd`). It
never falls back from one to the other: a CUDA tensor either goes through
the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from spatial_clip_tpu_torch.ops import cuda_build
from spatial_clip_tpu_torch.ops.fused_attention import _mm_f32

_gelu = functools.partial(F.gelu, approximate="tanh")  # jax.nn.gelu(approximate=True)

# The widest W whose x tile the bf16 kernel keeps in shared memory
# (``tc::kMaxResidentWidth``); a wider x streams through the weight ring.
X_RESIDENT_WIDTH = 1024


def supported(width: int, hidden: int) -> bool:
    """The JAX towers' gate on the shapes (``MLP.__call__``): hidden a
    multiple of 512 (the TPU kernel's hidden block) and width a multiple of
    128."""
    return hidden % 512 == 0 and width % 128 == 0


def reference_mlp_fwd(x: torch.Tensor, fc_w: torch.Tensor, fc_b: torch.Tensor,
                      proj_w: torch.Tensor, proj_b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version with the TPU kernel's rounding points: the
    weights and biases cast to x's dtype, ``x W1^T`` summed in f32 plus the
    cast b1 in f32, the tanh GELU in f32 rounded to x's dtype, ``h W2^T``
    summed in f32 plus the cast b2, in x's dtype."""
    dtype = x.dtype
    w1, b1, w2, b2 = (t.to(dtype) for t in (fc_w, fc_b, proj_w, proj_b))
    h = _gelu(_mm_f32(x, w1.t()) + b1.float()).to(dtype)
    return (_mm_f32(h, w2.t()) + b2.float()).to(dtype)


def _check(x, fc_w, fc_b, proj_w, proj_b) -> None:
    if x.dim() != 2 or x.shape[0] < 1:
        raise ValueError(f"x must be (R, W) with R >= 1; got {tuple(x.shape)}")
    W = x.shape[1]
    H = fc_w.shape[0] if fc_w.dim() == 2 else -1
    want = {"fc_w": (H, W), "fc_b": (H,), "proj_w": (W, H), "proj_b": (W,)}
    for name, t in zip(want, (fc_w, fc_b, proj_w, proj_b)):
        if tuple(t.shape) != want[name] or t.device != x.device:
            raise ValueError(f"{name} must be {want[name]} on {x.device}; got "
                             f"{tuple(t.shape)} on {t.device}")
    if x.dtype not in cuda_build.DTYPE_CODES:
        raise ValueError(f"x dtype {x.dtype} not taken (float32 or bfloat16)")


def fused_mlp_fwd(x: torch.Tensor, fc_w: torch.Tensor, fc_b: torch.Tensor,
                  proj_w: torch.Tensor, proj_b: torch.Tensor) -> torch.Tensor:
    """x (R, W) in the compute dtype; fc_w (H, W), fc_b (H,), proj_w (W, H),
    proj_b (W,) in any float dtype, cast to x's at use. Returns (R, W) in
    x's dtype (no residual). The kernel takes W a multiple of 128 up to its
    widest and H a multiple of 64, any R. Counts each kernel launch in
    ``fused_mlp_fwd.launches`` and in ``fused_mlp_fwd.routes`` by the body it
    takes (:func:`_route`)."""
    _check(x, fc_w, fc_b, proj_w, proj_b)
    if cuda_build.plain_device(x):
        return reference_mlp_fwd(x, fc_w, fc_b, proj_w, proj_b)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    (R, W), H = x.shape, fc_w.shape[0]
    lib = cuda_build.library()
    if W % 128 or W > lib.sc_mlp_max_width() or H % 64:
        raise ValueError(f"W={W}, H={H}: the kernel takes W a multiple of 128 up to "
                         f"{lib.sc_mlp_max_width()} and H a multiple of 64")
    x = x.contiguous()
    w1, b1, w2, b2 = (t.to(x.dtype).contiguous() for t in (fc_w, fc_b, proj_w, proj_b))
    out = torch.empty_like(x)
    if any(t.data_ptr() % 16 for t in (x, w1, b1, w2, b2)):
        raise ValueError("the kernel reads 16-byte vectors: tensors must be 16-byte aligned")
    with torch.cuda.device(x.device):
        err = lib.sc_mlp_fwd(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            out.data_ptr(), R, W, H, cuda_build.DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(lib, err, "fused_mlp_fwd launch")
    fused_mlp_fwd.launches += 1
    fused_mlp_fwd.routes[_route(W, x.dtype)] += 1
    return out


def _route(W: int, dtype: torch.dtype) -> str:
    """The kernel body a launch takes: ``f32`` (CUDA cores), ``x_resident``
    (bf16, x held in shared memory) or ``x_streamed`` (bf16, W past
    :data:`X_RESIDENT_WIDTH`)."""
    if dtype == torch.float32:
        return "f32"
    return "x_resident" if W <= X_RESIDENT_WIDTH else "x_streamed"


fused_mlp_fwd.launches = 0
fused_mlp_fwd.routes = {"x_resident": 0, "x_streamed": 0, "f32": 0}


def mlp_plan(R: int, W: int, H: int) -> dict:
    """The bf16 kernel's launch plan at this shape, from the kernel library
    (needs the card's build): 128-column output blocks a CTA owns, column
    splits, the weight ring's stages, whether x stays in shared memory,
    cluster size and CTAs."""
    lib = cuda_build.library()
    plan = (ctypes.c_int * 6)()
    cuda_build.check(lib, lib.sc_mlp_plan(R, W, H, plan), "sc_mlp_plan")
    keys = ("output_blocks", "splits", "stages", "x_resident", "cluster", "ctas")
    out = dict(zip(keys, plan))
    out["x_resident"] = bool(out["x_resident"])
    return out


class FusedMLP(torch.autograd.Function):
    """:func:`fused_mlp_fwd`, with the backward of ``_fused_bwd`` in plain
    PyTorch: x upcast to f32 and the parameters in their own dtype used in
    f32; ``pre = x W1^T + b1`` recomputed; ``dW2 = g^T gelu(pre)``,
    ``db2 = sum g``, ``dh = g W2``, ``dpre`` through the tanh GELU's
    derivative, ``dW1 = dpre^T x``, ``db1 = sum dpre``, ``dx = dpre W1``.
    dx is cast to x's dtype, each parameter gradient to its parameter's.
    Every product runs in f32 (TF32 as the caller leaves it, off by
    default), as JAX computes it on the CPU."""

    @staticmethod
    def forward(ctx, x, fc_w, fc_b, proj_w, proj_b):
        ctx.save_for_backward(x, fc_w, fc_b, proj_w, proj_b)
        return fused_mlp_fwd(x, fc_w, fc_b, proj_w, proj_b)

    @staticmethod
    def backward(ctx, g):
        x, fc_w, fc_b, proj_w, proj_b = ctx.saved_tensors
        x32, w1, w2, g32 = x.float(), fc_w.float(), proj_w.float(), g.float()
        pre = x32 @ w1.t() + fc_b.float()
        dproj_w = g32.t() @ _gelu(pre)
        dproj_b = g32.sum(dim=0)
        dpre = torch.ops.aten.gelu_backward(g32 @ w2, pre, approximate="tanh")
        dfc_w = dpre.t() @ x32
        dfc_b = dpre.sum(dim=0)
        dx = (dpre @ w1).to(x.dtype)
        return (dx, dfc_w.to(fc_w.dtype), dfc_b.to(fc_b.dtype), dproj_w.to(proj_w.dtype),
                dproj_b.to(proj_b.dtype))


def fused_mlp(x: torch.Tensor, fc_w: torch.Tensor, fc_b: torch.Tensor, proj_w: torch.Tensor,
              proj_b: torch.Tensor) -> torch.Tensor:
    """The fused MLP for x (R, W) in the compute dtype, with its gradient;
    see :func:`fused_mlp_fwd`."""
    return FusedMLP.apply(x.contiguous(), fc_w, fc_b, proj_w, proj_b)
