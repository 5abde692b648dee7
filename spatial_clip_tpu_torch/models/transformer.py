"""ViT and text transformer towers, for serving and for training.

Counterpart of ``spatial_clip_tpu.models.transformer`` on its main path:
dense projections, one-pass or two-pass LayerNorm, and attention through
the fused attention kernels (``ops.fused_attention``). Two LayerNorm
settings route through kernels of their own, with the JAX towers' gates:
``ln_impl='pallas'`` sends every LayerNorm whose width is a multiple of 128
through ``ops.fused_ln`` (others take two-pass statistics), and
``ln_gemm_impl='pallas'`` fuses each block's ln_2 -> c_fc, and with
``attn_impl='pallas'`` its ln_1 -> qkv, into ``ops.fused_ln_dense``.
``mlp_impl='pallas'`` sends each block's MLP through ``ops.fused_mlp``
where JAX's gate allows (tanh GELU, hidden a multiple of 512, width a
multiple of 128, c_fc not already fused with its LayerNorm). Three
``attn_impl`` settings run other layouts of the attention kernels
(``ops.attention_variants``): ``'pallas_inter'`` (the qkv weight's rows
permuted into head-group order; its ln_1 -> qkv fuses as ``'pallas'``'s
does), ``'pallas_t'`` (the bias added inside the kernels) and
``'pallas_split'`` (three slice projections). Parameters
carry open_clip's names and layouts (``attn.in_proj_weight`` is (3D, D),
``conv1.weight`` is OIHW). Matrices, embeddings and layer-scales are stored
in ``param_dtype`` and cast to the compute ``dtype`` at each use, as the
JAX towers cast their f32 parameters: a serving model stores them in the
compute dtype (the cast is then a no-op), a training model in float32.
LayerNorm parameters and the logit scale are always float32. Images are
NHWC, as in the JAX package.

Attention takes the kernels where JAX's gate does, and JAX's plain
routes (``ops.attention_plain``: 'einsum', 'einsum_bf16', 'xla', 'fold',
'fold_bf16') where ``attn_impl`` names one or the gate refuses the kernel
(:class:`MultiHeadAttention`). On the kernels, with grad enabled, attention
runs through :class:`QKVAttention`, whose
forward saves the logsumexp where JAX's does and whose backward is one of
the hand-written backward kernels, picked as JAX picks it; without grad it
is the inference kernel alone. Where ln_1 -> qkv is fused, attention
takes the fused kernel's qkv, as JAX's ``fused_attention`` does:
:class:`FusedAttention` with grad (the inference forward, and the backward
that recomputes the softmax statistics, the counterpart of
``_bwd_kernel``), the inference kernel alone without.

:class:`GeneMLPTower` (JAX's ``GeneMLPTower``) takes the place of the text
tower when the config sets ``gene_cfg``: a rank-weighted gene vector through
a dense embedding, residual MLP blocks and a head; only its ``ln_final``
takes ``ln_impl``.

With ``remat`` (JAX's ``nn.remat(ResidualBlock)`` with its default policy,
which saves nothing), each block runs under ``torch.utils.checkpoint``
(non-reentrant) when grad is enabled: the backward recomputes the block's
forward, with the same kernels on the same inputs, and keeps only the
block's input.

Each block also runs as two stages around its attention
(:meth:`ResidualBlock.attn_qkv`, :meth:`ResidualBlock.attn_finish`), and
the image tower as ``embed`` / ``head`` around its blocks, so that
``CLIP.encode_pair`` can run both towers' layer-i attention as one launch.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from spatial_clip_tpu_torch.ops import (
    attention_plain,
    attention_variants,
    fused_ln,
    fused_ln_dense,
    fused_mlp,
)
from spatial_clip_tpu_torch.ops import fused_attention as fa
from spatial_clip_tpu_torch.ops.fused_attention import (
    HEAD_DIMS,
    FusedAttention,
    fused_attention,
    qkv_attention,
    supported,
)

gelu_tanh = functools.partial(F.gelu, approximate="tanh")  # flax nn.gelu


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """OpenAI CLIP's sigmoid-approximated GELU."""
    return x * torch.sigmoid(1.702 * x)


def _param(*shape, dtype, device) -> nn.Parameter:
    """An uninitialized parameter; factory.init_weights fills it from a seed."""
    return nn.Parameter(torch.empty(*shape, dtype=dtype, device=device))


class Dense(nn.Module):
    """``x W^T + b`` with W (out, in) and b stored in ``param_dtype`` and cast
    to ``dtype`` at each use (flax ``nn.Dense(dtype, param_dtype)``)."""

    def __init__(self, n_in: int, n_out: int, dtype, param_dtype, device):
        super().__init__()
        self.in_features, self.out_features, self.dtype = n_in, n_out, dtype
        self.weight = _param(n_out, n_in, dtype=param_dtype, device=device)
        self.bias = _param(n_out, dtype=param_dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(self.dtype), self.bias.to(self.dtype))


def _ln_apply(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
              dtype, stats: str = "fp32") -> torch.Tensor:
    """Functional LayerNorm with f32 statistics and f32 affine, output in
    ``dtype`` (JAX's ``_ln_apply`` and ``LayerNorm``). ``stats='onepass'``:
    mean and E[x^2] in one pass, var = max(E[x^2] - mean^2, 0);
    ``'pallas'``: the fused_ln kernels where the width is a multiple of
    128, else two-pass; anything else, ``'fp32'`` the default: two-pass
    (x - mean)^2."""
    if stats == "pallas" and fused_ln.supported(x.shape[-1]):
        shape = x.shape
        y = fused_ln.fused_layer_norm(x.reshape(-1, shape[-1]).to(dtype), weight, bias, eps)
        return y.view(shape)
    xa = x.float()
    mean = xa.mean(dim=-1, keepdim=True)
    if stats == "onepass":
        var = ((xa * xa).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    else:
        var = (xa - mean).square().mean(dim=-1, keepdim=True)
    return ((xa - mean) * torch.rsqrt(var + eps) * weight + bias).to(dtype)


class LayerNorm(nn.Module):
    """LayerNorm with f32 statistics and f32 affine, output in ``dtype``;
    ``stats`` as in :func:`_ln_apply` (``onepass`` is the JAX default)."""

    def __init__(self, width: int, eps: float = 1e-5, stats: str = "onepass",
                 dtype=torch.float32, device=None):
        super().__init__()
        self.eps, self.stats, self.dtype = eps, stats, dtype
        self.weight = _param(width, dtype=torch.float32, device=device)
        self.bias = _param(width, dtype=torch.float32, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _ln_apply(x, self.weight, self.bias, self.eps, self.dtype, self.stats)

    def args(self):
        """(weight, bias, eps): the pre-LN a fused projection applies itself."""
        return self.weight, self.bias, self.eps


class LayerScale(nn.Module):
    def __init__(self, width: int, dtype, param_dtype, device):
        super().__init__()
        self.dtype = dtype
        self.gamma = _param(width, dtype=param_dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(self.dtype)


class MLP(nn.Module):
    """c_fc -> act -> c_proj. ``impl='pallas'`` runs the three as the fused
    MLP kernel where JAX's gate allows: the tanh GELU, hidden a multiple of
    512, width a multiple of 128."""

    def __init__(self, width: int, hidden: int, act: Callable, dtype, param_dtype, device,
                 impl: str = "dense"):
        super().__init__()
        self.c_fc = Dense(width, hidden, dtype, param_dtype, device)
        self.c_proj = Dense(hidden, width, dtype, param_dtype, device)
        self.act, self.impl = act, impl

    def forward(self, x: torch.Tensor, ln=None) -> torch.Tensor:
        """``ln = (weight, bias, eps)``: x is the raw residual stream and its
        pre-LN is fused into c_fc where JAX's gate allows, else applied
        two-pass here."""
        fc, proj = self.c_fc, self.c_proj
        if ln is not None:
            if fused_ln_dense.supported(fc.in_features, fc.out_features):
                shape = x.shape
                h = fused_ln_dense.fused_ln_dense(x.reshape(-1, shape[-1]).to(fc.dtype), *ln[:2],
                                                  fc.weight, fc.bias, ln[2])
                return proj(self.act(h.view(*shape[:-1], fc.out_features)))
            x = _ln_apply(x, *ln, fc.dtype)
        if (self.impl == "pallas" and self.act is gelu_tanh
                and fused_mlp.supported(fc.in_features, fc.out_features)):
            shape = x.shape
            out = fused_mlp.fused_mlp(x.reshape(-1, shape[-1]).to(fc.dtype), fc.weight, fc.bias,
                                      proj.weight, proj.bias)
            return out.view(shape)
        return proj(self.act(fc(x)))


def attention_route(impl: str, heads: int, width: int) -> str:
    """The attention a tower runs under ``attn_impl`` at this head geometry,
    as JAX's ``Attention`` routes it on a TPU: 'kernel' where JAX's gate
    (``heads_per_block``) takes a kernel setting to its kernel; else the
    plain route, the setting's own name for the five plain settings and
    'einsum' for a kernel setting whose gate fails. A mask with a batch
    dimension also sends the kernel settings to 'einsum', at call time."""
    if impl in attention_plain.PLAIN_IMPLS:
        return impl
    return "kernel" if attention_variants.attention_supported(heads, width) else "einsum"


class MultiHeadAttention(nn.Module):
    """Fused-qkv attention: one (B, L, 3D) GEMM, then attention on that raw
    output, then the output projection, routed as JAX's ``Attention`` routes
    it.

    The kernel settings ('auto', 'pallas', 'pallas3' and the layouts) take
    the kernels where JAX's gate does: its heads_per_block groups the heads
    (:func:`attention_variants.attention_supported`) and the mask has no
    batch dimension; elsewhere they take JAX's einsum attention
    (``ops.attention_plain``), as do 'einsum', 'einsum_bf16' and 'xla' always
    and 'fold' / 'fold_bf16' by their own projections. A geometry JAX's gate
    sends to its kernel but the port's kernels do not take (head_dim 16 with
    a multiple of 8 heads, head_dim 256) raises: ROADMAP Queue 2 A3.

    On the kernels, with grad enabled the GEMM and the attention run as one
    :class:`QKVAttention` (the forward, with the logsumexp where JAX saves
    it, and the hand-written backward JAX's routing picks); otherwise the
    inference kernel runs alone. The wrappers take the resident kernels up
    to their lengths and the key-tiled ones past them. Built for training
    (``seq_len`` given), a layout setting checks that its backward kernel
    takes the length, and under ``BWD_FUSE='dxdb'`` so does the dx kernel
    (both keep the sequence resident: ROADMAP Queue 2 A1 past it).
    ``impl='pallas'`` and ``'pallas_inter'`` fuse a pre-LN handed to
    :meth:`forward` into the qkv projection. The layouts, routed in JAX's
    order (``Attention.__call__``): ``'pallas_inter'`` projects with the
    weight and bias rows permuted (:func:`attention_variants.permute_rows`)
    and runs :class:`FusedAttention` interleaved; ``'pallas_t'`` projects
    without the bias and runs :class:`attention_variants.FusedAttentionT`
    with it; ``'pallas_split'`` makes q, k and v with three slices of the
    one stored weight and runs :class:`attention_variants.FusedAttentionSplit`.
    The parameters stay in the standard [q|k|v] order under every setting."""

    LAYOUTS = ("pallas_inter", "pallas_t", "pallas_split")

    def __init__(self, width: int, heads: int, dtype, param_dtype, device,
                 seq_len: Optional[int] = None, impl: str = "auto"):
        super().__init__()
        self.kernel = attention_route(impl, heads, width) == "kernel"
        head_dim = width // heads
        if self.kernel and not supported(heads, width):
            raise NotImplementedError(
                f"heads={heads} over width={width}: JAX's gate sends head_dim {head_dim} to its "
                f"attention kernel, and the port's attention kernels take head_dim in "
                f"{HEAD_DIMS} (ROADMAP Queue 2 A3)")
        if self.kernel and seq_len is not None:
            if impl in self.LAYOUTS:
                fa.check_resident(seq_len, head_dim, dtype, True, f"attn_impl={impl!r} training")
            elif fa.BWD_FUSE == "dxdb":
                fa.check_resident(seq_len, head_dim, dtype, True, "BWD_FUSE='dxdb' training")
                if not attention_variants.dx_supported(heads, width, seq_len, width, dtype):
                    raise NotImplementedError(
                        f"BWD_FUSE='dxdb' over width={width}: the dx kernel takes an input "
                        "width that is a positive multiple of 16")
        self.heads, self.dtype, self.impl = heads, dtype, impl
        self.in_proj_weight = _param(3 * width, width, dtype=param_dtype, device=device)
        self.in_proj_bias = _param(3 * width, dtype=param_dtype, device=device)
        self.out_proj = Dense(width, width, dtype, param_dtype, device)

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor] = None,
                ln=None) -> torch.Tensor:
        """``ln = (weight, bias, eps)``: x is the raw residual stream; its
        pre-LN is fused into the qkv projection under ``impl='pallas'`` or
        ``'pallas_inter'`` where JAX's gate allows, else applied two-pass
        here. ``attn_mask``: additive, (L, L) or with leading dimensions;
        leading dimensions that are not all 1 send the kernel settings to
        the einsum attention, as in JAX."""
        w, b = self.in_proj_weight, self.in_proj_bias
        impl, heads, dtype = self.impl, self.heads, self.dtype
        width = w.shape[1]
        kernel = self.kernel
        if attn_mask is not None and attn_mask.dim() > 2:
            if all(n == 1 for n in attn_mask.shape[:-2]):
                attn_mask = attn_mask.reshape(attn_mask.shape[-2:])
            else:
                kernel = False
        if ln is not None:
            B, L, D = x.shape
            if (kernel and impl in ("pallas", "pallas_inter")
                    and fused_ln_dense.supported(D, 3 * D)):
                if impl == "pallas_inter":
                    w, b = (attention_variants.permute_rows(t, heads, width // heads)
                            for t in (w, b))
                qkv = fused_ln_dense.fused_ln_dense(x.reshape(-1, D).to(dtype), *ln[:2],
                                                    w, b, ln[2]).view(B, L, 3 * D)
                return self.out_proj(self._attend(qkv, attn_mask, impl == "pallas_inter"))
            x = _ln_apply(x, *ln, dtype)
        if impl in ("fold", "fold_bf16"):
            out = self.out_proj
            return attention_plain.fold_attention(
                x.to(dtype), w.to(dtype), b.to(dtype), out.weight.to(dtype), out.bias.to(dtype),
                attn_mask, heads, impl)
        if not kernel:
            qkv = F.linear(x, w.to(dtype), b.to(dtype))
            route = impl if impl in attention_plain.PLAIN_IMPLS else "einsum"
            return self.out_proj(attention_plain.plain_attention(qkv, attn_mask, heads, route))
        if impl == "pallas_inter":
            w, b = (attention_variants.permute_rows(t, heads, width // heads) for t in (w, b))
            qkv = F.linear(x, w.to(dtype), b.to(dtype))
            return self.out_proj(self._attend(qkv, attn_mask, True))
        if impl == "pallas_t":
            qkv_nb = F.linear(x.to(dtype), w.to(dtype))
            ctx = attention_variants.fused_attention_t(qkv_nb, b.to(dtype)[None], attn_mask, heads)
            return self.out_proj(ctx)
        if impl == "pallas_split":
            # three slices of the one stored weight; their gradients land in its rows
            q, k, v = (F.linear(x, wt, bt) for wt, bt in zip(w.to(dtype).chunk(3),
                                                              b.to(dtype).chunk(3)))
            return self.out_proj(attention_variants.fused_attention_split(q, k, v, attn_mask,
                                                                          heads))
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad or b.requires_grad):
            ctx = qkv_attention(x, w, b, attn_mask, heads)
        else:
            qkv = F.linear(x, w.to(dtype), b.to(dtype))
            ctx = fused_attention(qkv, attn_mask, heads)
        return self.out_proj(ctx)

    def _attend(self, qkv: torch.Tensor, attn_mask, interleaved: bool) -> torch.Tensor:
        """Attention over a qkv made here: :class:`FusedAttention` with grad,
        the inference kernel alone without."""
        if torch.is_grad_enabled() and qkv.requires_grad:
            return FusedAttention.apply(qkv, attn_mask, self.heads, interleaved)
        return fused_attention(qkv, attn_mask, self.heads, interleaved)


class ResidualBlock(nn.Module):
    """Pre-LN block: x + ls_1(attn(ln_1(x))), then x + ls_2(mlp(ln_2(x))).

    ``ln_gemm_impl='pallas'`` hands ln_1 and ln_2 to the attention and the
    MLP to fuse into their projections, as JAX does when ``ln_stats`` is
    ``fp32`` or ``onepass`` (under ``pallas`` nothing fuses). The LayerNorm
    modules stay, holding the parameters under the same names.
    ``mlp_impl`` goes to the MLP."""

    def __init__(self, width: int, heads: int, mlp_ratio: float = 4.0,
                 ls_init_value: Optional[float] = None, norm_eps: float = 1e-5,
                 ln_stats: str = "onepass", act: Callable = gelu_tanh,
                 dtype=torch.float32, param_dtype=None, device=None,
                 seq_len: Optional[int] = None, attn_impl: str = "auto",
                 ln_gemm_impl: str = "dense", mlp_impl: str = "dense"):
        super().__init__()
        param_dtype = param_dtype or dtype
        self.fuse_ln = ln_gemm_impl == "pallas" and ln_stats in ("fp32", "onepass")
        self.ln_1 = LayerNorm(width, norm_eps, ln_stats, dtype, device)
        self.attn = MultiHeadAttention(width, heads, dtype, param_dtype, device, seq_len,
                                       attn_impl)
        self.ln_2 = LayerNorm(width, norm_eps, ln_stats, dtype, device)
        self.mlp = MLP(width, int(width * mlp_ratio), act, dtype, param_dtype, device, mlp_impl)
        scaled = ls_init_value is not None
        self.ls_1 = LayerScale(width, dtype, param_dtype, device) if scaled else nn.Identity()
        self.ls_2 = LayerScale(width, dtype, param_dtype, device) if scaled else nn.Identity()

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.fuse_ln:
            x = x + self.ls_1(self.attn(x, attn_mask, ln=self.ln_1.args()))
            return x + self.ls_2(self.mlp(x, ln=self.ln_2.args()))
        x = x + self.ls_1(self.attn(self.ln_1(x), attn_mask))
        return x + self.ls_2(self.mlp(self.ln_2(x)))

    def attn_qkv(self, x: torch.Tensor) -> torch.Tensor:
        """Zip-path stage 1 (JAX's ``attn_qkv``): ln_1, then the fused qkv
        projection in the compute dtype. The zipped driver calls it only on a
        block whose LayerNorms are not fused into the projections."""
        a = self.attn
        return F.linear(self.ln_1(x), a.in_proj_weight.to(a.dtype), a.in_proj_bias.to(a.dtype))

    def attn_finish(self, x: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
        """Zip-path stage 2 (JAX's ``attn_finish``): the output projection,
        ls_1 and the residual, then ln_2, the MLP, ls_2 and the residual."""
        x = x + self.ls_1(self.attn.out_proj(ctx))
        return x + self.ls_2(self.mlp(self.ln_2(x)))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, remat: bool = False, **block_kw):
        super().__init__()
        self.remat = remat
        self.resblocks = nn.ModuleList(
            ResidualBlock(width, heads, **block_kw) for _ in range(layers))

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        remat = self.remat and torch.is_grad_enabled()
        for block in self.resblocks:
            x = _checkpointed(block, x, attn_mask) if remat else block(x, attn_mask)
        return x


def _checkpointed(block: nn.Module, x: torch.Tensor, attn_mask) -> torch.Tensor:
    """``block(x, attn_mask)`` under a non-reentrant checkpoint. The
    block's parameters go in as inputs and are bound again for the
    recompute, which runs in the backward: under ``functional_call`` (the
    trainer's) the module's own attributes then hold other tensors."""
    names, params = zip(*block.named_parameters())

    def run(x, attn_mask, *params):
        return functional_call(block, dict(zip(names, params)), (x, attn_mask))

    return checkpoint(run, x, attn_mask, *params, use_reentrant=False)


class PatchEmbed(nn.Module):
    """Non-overlapping patchify as reshape + one GEMM. ``weight`` is the
    conv's OIHW kernel; patches flatten in (ph, pw, C) order, as in JAX."""

    def __init__(self, patch_size: int, width: int, channels: int = 3, dtype=torch.float32,
                 param_dtype=None, device=None):
        super().__init__()
        self.patch_size, self.dtype = patch_size, dtype
        self.weight = _param(width, channels, patch_size, patch_size,
                             dtype=param_dtype or dtype, device=device)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        B, H, W, C = images.shape
        p = self.patch_size
        gh, gw = H // p, W // p
        patches = images.to(self.dtype).reshape(B, gh, p, gw, p, C)
        patches = patches.permute(0, 1, 3, 2, 4, 5).reshape(B, gh * gw, p * p * C)
        return patches @ self.weight.to(self.dtype).permute(2, 3, 1, 0).reshape(p * p * C, -1)


class VisionTransformer(nn.Module):
    """ViT image tower: NHWC normalized images -> pooled, projected features."""

    def __init__(self, image_size: int, patch_size: int, width: int, layers: int,
                 heads: int, mlp_ratio: float, output_dim: int,
                 ls_init_value: Optional[float] = None, no_ln_pre: bool = False,
                 final_ln_after_pool: bool = False, pool_type: str = "tok",
                 norm_eps: float = 1e-5, ln_stats: str = "onepass",
                 act: Callable = gelu_tanh, dtype=torch.float32, param_dtype=None,
                 device=None, training: bool = False, attn_impl: str = "auto",
                 ln_gemm_impl: str = "dense", mlp_impl: str = "dense", remat: bool = False):
        super().__init__()
        if pool_type not in ("tok", "avg", "none"):
            raise ValueError(f"unknown vision pool_type {pool_type!r}")
        param_dtype = param_dtype or dtype
        self.pool_type, self.dtype = pool_type, dtype
        self.final_ln_after_pool = final_ln_after_pool
        n_patches = (image_size // patch_size) ** 2
        self.conv1 = PatchEmbed(patch_size, width, dtype=dtype, param_dtype=param_dtype,
                                device=device)
        self.class_embedding = _param(width, dtype=param_dtype, device=device)
        self.positional_embedding = _param(n_patches + 1, width, dtype=param_dtype,
                                           device=device)
        self.ln_pre = (nn.Identity() if no_ln_pre
                       else LayerNorm(width, norm_eps, ln_stats, dtype, device))
        self.transformer = Transformer(
            width, layers, heads, mlp_ratio=mlp_ratio, ls_init_value=ls_init_value,
            norm_eps=norm_eps, ln_stats=ln_stats, act=act, dtype=dtype,
            param_dtype=param_dtype, device=device,
            seq_len=n_patches + 1 if training else None, attn_impl=attn_impl,
            ln_gemm_impl=ln_gemm_impl, mlp_impl=mlp_impl, remat=remat)
        self.ln_post = LayerNorm(width, norm_eps, ln_stats, dtype, device)
        self.proj = _param(width, output_dim, dtype=param_dtype, device=device)

    def _pool(self, x: torch.Tensor) -> torch.Tensor:
        if self.pool_type == "avg":
            return x[:, 1:].mean(dim=1)
        if self.pool_type == "tok":
            return x[:, 0]
        return x.mean(dim=1)

    def embed(self, images: torch.Tensor) -> torch.Tensor:
        """Patchify, class and positional embedding, ln_pre: the rows the
        blocks take."""
        x = self.conv1(images)
        cls = self.class_embedding.to(self.dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(self.dtype)
        return self.ln_pre(x)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """Pool, ln_post and the projection, after the blocks."""
        if self.final_ln_after_pool:
            pooled = self.ln_post(self._pool(x))
        else:
            pooled = self._pool(self.ln_post(x))
        return pooled @ self.proj.to(self.dtype)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.head(self.transformer(self.embed(images)))


def text_global_pool(x: torch.Tensor, tokens: torch.Tensor, pool_type: str) -> torch.Tensor:
    if pool_type == "first":
        return x[:, 0]
    if pool_type == "last":
        return x[:, -1]
    if pool_type == "argmax":
        # the EOT token has the highest id in the CLIP vocab
        return x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
    return x.mean(dim=1)  # avg, and JAX's fallback for 'none'


def causal_mask(seq_len: int, device=None) -> torch.Tensor:
    """Additive (L, L) f32 mask: finfo(f32).min above the diagonal. Finite,
    as in the JAX towers, so a row never sums exp over only -inf."""
    neg = torch.finfo(torch.float32).min
    return torch.full((seq_len, seq_len), neg, device=device).triu_(1)


def text_head(x: torch.Tensor, text: torch.Tensor, ln_final: nn.Module, projection,
              pool_type: str, final_ln_after_pool: bool) -> torch.Tensor:
    """Final LN + pool + projection (a matrix, or a Dense when proj_bias)."""
    if final_ln_after_pool:
        pooled = ln_final(text_global_pool(x, text, pool_type))
    else:
        pooled = text_global_pool(ln_final(x), text, pool_type)
    if isinstance(projection, Dense):
        return projection(pooled)
    return pooled @ projection.to(pooled.dtype)


class TextTransformer(nn.Module):
    """Causal text tower: (B, context_length) token ids -> projected features."""

    def __init__(self, context_length: int, vocab_size: int, width: int, heads: int,
                 layers: int, mlp_ratio: float, output_dim: int,
                 ls_init_value: Optional[float] = None, no_causal_mask: bool = False,
                 pool_type: str = "argmax", final_ln_after_pool: bool = False,
                 proj_bias: bool = False, norm_eps: float = 1e-5, ln_stats: str = "onepass",
                 act: Callable = gelu_tanh, dtype=torch.float32, param_dtype=None,
                 device=None, training: bool = False, attn_impl: str = "auto",
                 ln_gemm_impl: str = "dense", mlp_impl: str = "dense", remat: bool = False):
        super().__init__()
        param_dtype = param_dtype or dtype
        self.pool_type, self.dtype = pool_type, dtype
        self.final_ln_after_pool = final_ln_after_pool
        self.token_embedding = nn.Embedding(vocab_size, width, dtype=param_dtype, device=device,
                                            _weight=torch.empty(vocab_size, width,
                                                                dtype=param_dtype, device=device))
        self.positional_embedding = _param(context_length, width, dtype=param_dtype,
                                           device=device)
        self.transformer = Transformer(
            width, layers, heads, mlp_ratio=mlp_ratio, ls_init_value=ls_init_value,
            norm_eps=norm_eps, ln_stats=ln_stats, act=act, dtype=dtype,
            param_dtype=param_dtype, device=device,
            seq_len=context_length if training else None, attn_impl=attn_impl,
            ln_gemm_impl=ln_gemm_impl, mlp_impl=mlp_impl, remat=remat)
        self.ln_final = LayerNorm(width, norm_eps, ln_stats, dtype, device)
        self.text_projection = (Dense(width, output_dim, dtype, param_dtype, device) if proj_bias
                                else _param(width, output_dim, dtype=param_dtype, device=device))
        self.register_buffer(
            "attn_mask", None if no_causal_mask else causal_mask(context_length, device),
            persistent=False)

    def embed(self, text: torch.Tensor) -> torch.Tensor:
        """Token + positional embedding in the compute dtype. The f32 table
        of a training model is gathered, then cast: the same values as
        casting the whole table first, as flax does, at a fraction of the
        bytes."""
        return (self.token_embedding(text).to(self.dtype)
                + self.positional_embedding.to(self.dtype))

    def forward(self, text: torch.Tensor) -> torch.Tensor:
        x = self.transformer(self.embed(text), self.attn_mask)
        return text_head(x, text, self.ln_final, self.text_projection, self.pool_type,
                         self.final_ln_after_pool)


class GeneMLPTower(nn.Module):
    """Rank-weighted gene-expression vector (B, num_genes) -> (B, output_dim):
    ``embed`` to ``width``, ``layers`` residual blocks ``x + proj_i(gelu(
    fc_i(ln_i(x))))`` with a 4x hidden layer and the tanh GELU, then
    ``ln_final`` and ``head``, as JAX's ``GeneMLPTower``. The vector is cast
    to the compute dtype before ``embed`` (bf16 rounds the rank weights).
    The block LayerNorms take two-pass f32 statistics (JAX's ``LayerNorm``
    default); ``ln_final`` takes ``ln_stats`` (the model's ``ln_impl``, so
    ``'pallas'`` sends it through the fused_ln kernels at a width that is a
    multiple of 128). The modules carry the flax names (``embed``, ``ln_i``,
    ``fc_i``, ``proj_i``, ``ln_final``, ``head``).

    Gene dropout is a ``keep`` mask handed to :meth:`forward` by the trainer
    (:meth:`draw_keep`, in training only): a dropped gene is zeroed and the
    rest are not rescaled, unlike ``F.dropout``."""

    def __init__(self, num_genes: int, width: int, layers: int, output_dim: int,
                 gene_dropout: float = 0.0, norm_eps: float = 1e-5, ln_stats: str = "fp32",
                 dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        param_dtype = param_dtype or dtype
        self.layers, self.gene_dropout, self.dtype = layers, gene_dropout, dtype
        self.embed = Dense(num_genes, width, dtype, param_dtype, device)
        for i in range(layers):
            self.add_module(f"ln_{i}", LayerNorm(width, norm_eps, "fp32", dtype, device))
            self.add_module(f"fc_{i}", Dense(width, 4 * width, dtype, param_dtype, device))
            self.add_module(f"proj_{i}", Dense(4 * width, width, dtype, param_dtype, device))
        self.ln_final = LayerNorm(width, norm_eps, ln_stats, dtype, device)
        self.head = Dense(width, output_dim, dtype, param_dtype, device)

    def draw_keep(self, shape, generator: torch.Generator, device=None) -> torch.Tensor:
        """The genes a training step keeps: each independently with
        probability ``1 - gene_dropout`` (a uniform draw below it)."""
        u = torch.rand(shape, generator=generator, device=device or generator.device)
        return u < 1.0 - self.gene_dropout

    def forward(self, gene_vector: torch.Tensor,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        if keep is not None:
            gene_vector = torch.where(keep, gene_vector, torch.zeros_like(gene_vector))
        x = self.embed(gene_vector.to(self.dtype))
        for i in range(self.layers):
            h = getattr(self, f"ln_{i}")(x)
            h = gelu_tanh(getattr(self, f"fc_{i}")(h))
            x = x + getattr(self, f"proj_{i}")(h)
        return self.head(self.ln_final(x))
