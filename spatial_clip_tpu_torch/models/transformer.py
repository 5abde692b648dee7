"""ViT and text transformer towers (inference).

Counterpart of ``spatial_clip_tpu.models.transformer`` on its serving path:
dense projections, one-pass or two-pass LayerNorm, and attention through
the fused attention kernel (``ops.fused_attention``). Parameters carry
open_clip's names and layouts (``attn.in_proj_weight`` is (3D, D),
``conv1.weight`` is OIHW). Matrices and embeddings are stored in the
compute dtype; LayerNorm parameters and the logit scale stay float32, as
the JAX towers cast them. Images are NHWC, as in the JAX package.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from spatial_clip_tpu_torch.ops.fused_attention import HEAD_DIMS, fused_attention, supported

gelu_tanh = functools.partial(F.gelu, approximate="tanh")  # flax nn.gelu


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """OpenAI CLIP's sigmoid-approximated GELU."""
    return x * torch.sigmoid(1.702 * x)


def _param(*shape, dtype, device) -> nn.Parameter:
    """An uninitialized parameter; factory.init_weights fills it from a seed."""
    return nn.Parameter(torch.empty(*shape, dtype=dtype, device=device))


def _linear(n_in: int, n_out: int, dtype, device) -> nn.Linear:
    return skip_init(nn.Linear, n_in, n_out, dtype=dtype, device=device)


class LayerNorm(nn.Module):
    """LayerNorm with f32 statistics and f32 affine, output in ``dtype``.

    ``stats='onepass'`` is the JAX default: mean and E[x^2] in one pass,
    var = max(E[x^2] - mean^2, 0). ``stats='fp32'`` is the two-pass
    (x - mean)^2 form."""

    def __init__(self, width: int, eps: float = 1e-5, stats: str = "onepass",
                 dtype=torch.float32, device=None):
        super().__init__()
        self.eps, self.stats, self.dtype = eps, stats, dtype
        self.weight = _param(width, dtype=torch.float32, device=device)
        self.bias = _param(width, dtype=torch.float32, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xa = x.float()
        mean = xa.mean(dim=-1, keepdim=True)
        if self.stats == "onepass":
            var = ((xa * xa).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
        else:
            var = (xa - mean).square().mean(dim=-1, keepdim=True)
        y = (xa - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return y.to(self.dtype)


class LayerScale(nn.Module):
    def __init__(self, width: int, dtype, device):
        super().__init__()
        self.gamma = _param(width, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma


class MLP(nn.Module):
    def __init__(self, width: int, hidden: int, act: Callable, dtype, device):
        super().__init__()
        self.c_fc = _linear(width, hidden, dtype, device)
        self.c_proj = _linear(hidden, width, dtype, device)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(self.act(self.c_fc(x)))


class MultiHeadAttention(nn.Module):
    """Fused-qkv attention: one (B, L, 3D) GEMM, then the fused attention
    kernel on that raw output, then the output projection."""

    def __init__(self, width: int, heads: int, dtype, device):
        super().__init__()
        if not supported(heads, width):
            raise NotImplementedError(
                f"heads={heads} over width={width}: the attention kernel takes "
                f"head_dim in {HEAD_DIMS}")
        self.heads = heads
        self.in_proj_weight = _param(3 * width, width, dtype=dtype, device=device)
        self.in_proj_bias = _param(3 * width, dtype=dtype, device=device)
        self.out_proj = _linear(width, width, dtype, device)

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        return self.out_proj(fused_attention(qkv, attn_mask, self.heads))


class ResidualBlock(nn.Module):
    """Pre-LN block: x + ls_1(attn(ln_1(x))), then x + ls_2(mlp(ln_2(x)))."""

    def __init__(self, width: int, heads: int, mlp_ratio: float = 4.0,
                 ls_init_value: Optional[float] = None, norm_eps: float = 1e-5,
                 ln_stats: str = "onepass", act: Callable = gelu_tanh,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.ln_1 = LayerNorm(width, norm_eps, ln_stats, dtype, device)
        self.attn = MultiHeadAttention(width, heads, dtype, device)
        self.ln_2 = LayerNorm(width, norm_eps, ln_stats, dtype, device)
        self.mlp = MLP(width, int(width * mlp_ratio), act, dtype, device)
        scaled = ls_init_value is not None
        self.ls_1 = LayerScale(width, dtype, device) if scaled else nn.Identity()
        self.ls_2 = LayerScale(width, dtype, device) if scaled else nn.Identity()

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.ls_1(self.attn(self.ln_1(x), attn_mask))
        return x + self.ls_2(self.mlp(self.ln_2(x)))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, **block_kw):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualBlock(width, heads, **block_kw) for _ in range(layers))

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for block in self.resblocks:
            x = block(x, attn_mask)
        return x


class PatchEmbed(nn.Module):
    """Non-overlapping patchify as reshape + one GEMM. ``weight`` is the
    conv's OIHW kernel; patches flatten in (ph, pw, C) order, as in JAX."""

    def __init__(self, patch_size: int, width: int, channels: int = 3, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.patch_size = patch_size
        self.weight = _param(width, channels, patch_size, patch_size, dtype=dtype, device=device)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        B, H, W, C = images.shape
        p = self.patch_size
        gh, gw = H // p, W // p
        patches = images.to(self.weight.dtype).reshape(B, gh, p, gw, p, C)
        patches = patches.permute(0, 1, 3, 2, 4, 5).reshape(B, gh * gw, p * p * C)
        return patches @ self.weight.permute(2, 3, 1, 0).reshape(p * p * C, -1)


class VisionTransformer(nn.Module):
    """ViT image tower: NHWC normalized images -> pooled, projected features."""

    def __init__(self, image_size: int, patch_size: int, width: int, layers: int,
                 heads: int, mlp_ratio: float, output_dim: int,
                 ls_init_value: Optional[float] = None, no_ln_pre: bool = False,
                 final_ln_after_pool: bool = False, pool_type: str = "tok",
                 norm_eps: float = 1e-5, ln_stats: str = "onepass",
                 act: Callable = gelu_tanh, dtype=torch.float32, device=None):
        super().__init__()
        if pool_type not in ("tok", "avg", "none"):
            raise ValueError(f"unknown vision pool_type {pool_type!r}")
        self.pool_type = pool_type
        self.final_ln_after_pool = final_ln_after_pool
        n_patches = (image_size // patch_size) ** 2
        self.conv1 = PatchEmbed(patch_size, width, dtype=dtype, device=device)
        self.class_embedding = _param(width, dtype=dtype, device=device)
        self.positional_embedding = _param(n_patches + 1, width, dtype=dtype, device=device)
        self.ln_pre = (nn.Identity() if no_ln_pre
                       else LayerNorm(width, norm_eps, ln_stats, dtype, device))
        self.transformer = Transformer(
            width, layers, heads, mlp_ratio=mlp_ratio, ls_init_value=ls_init_value,
            norm_eps=norm_eps, ln_stats=ln_stats, act=act, dtype=dtype, device=device)
        self.ln_post = LayerNorm(width, norm_eps, ln_stats, dtype, device)
        self.proj = _param(width, output_dim, dtype=dtype, device=device)

    def _pool(self, x: torch.Tensor) -> torch.Tensor:
        if self.pool_type == "avg":
            return x[:, 1:].mean(dim=1)
        if self.pool_type == "tok":
            return x[:, 0]
        return x.mean(dim=1)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.conv1(images)
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding
        x = self.transformer(self.ln_pre(x))
        if self.final_ln_after_pool:
            pooled = self.ln_post(self._pool(x))
        else:
            pooled = self._pool(self.ln_post(x))
        return pooled @ self.proj


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
    """Final LN + pool + projection (a matrix, or a Linear when proj_bias)."""
    if final_ln_after_pool:
        pooled = ln_final(text_global_pool(x, text, pool_type))
    else:
        pooled = text_global_pool(ln_final(x), text, pool_type)
    if isinstance(projection, nn.Linear):
        return projection(pooled)
    return pooled @ projection


class TextTransformer(nn.Module):
    """Causal text tower: (B, context_length) token ids -> projected features."""

    def __init__(self, context_length: int, vocab_size: int, width: int, heads: int,
                 layers: int, mlp_ratio: float, output_dim: int,
                 ls_init_value: Optional[float] = None, no_causal_mask: bool = False,
                 pool_type: str = "argmax", final_ln_after_pool: bool = False,
                 proj_bias: bool = False, norm_eps: float = 1e-5, ln_stats: str = "onepass",
                 act: Callable = gelu_tanh, dtype=torch.float32, device=None):
        super().__init__()
        self.pool_type = pool_type
        self.final_ln_after_pool = final_ln_after_pool
        self.token_embedding = skip_init(nn.Embedding, vocab_size, width, dtype=dtype,
                                         device=device)
        self.positional_embedding = _param(context_length, width, dtype=dtype, device=device)
        self.transformer = Transformer(
            width, layers, heads, mlp_ratio=mlp_ratio, ls_init_value=ls_init_value,
            norm_eps=norm_eps, ln_stats=ln_stats, act=act, dtype=dtype, device=device)
        self.ln_final = LayerNorm(width, norm_eps, ln_stats, dtype, device)
        self.text_projection = (_linear(width, output_dim, dtype, device) if proj_bias
                                else _param(width, output_dim, dtype=dtype, device=device))
        self.register_buffer(
            "attn_mask", None if no_causal_mask else causal_mask(context_length, device),
            persistent=False)

    def forward(self, text: torch.Tensor) -> torch.Tensor:
        x = self.token_embedding(text) + self.positional_embedding
        x = self.transformer(x, self.attn_mask)
        return text_head(x, text, self.ln_final, self.text_projection, self.pool_type,
                         self.final_ln_after_pool)
