"""timm-style vision towers (counterpart of ``spatial_clip_tpu.models.timm_model``).

open_clip wraps timm backbones as CLIP image towers with a pooling and a
projection head (``timm_model_name``, ``timm_pool``, ``timm_proj``,
``timm_proj_bias``, ``timm_drop``). The JAX package rebuilds those trunks
in flax under a registry of timm names (:data:`TRUNKS`), and so does this
module, with the same parameters under the same names and the same math:

- trunks: ConvNeXt, the plain ViT (with or without a class token; the
  ``vit_*_gap_*``, SigLIP, PE-Core, MobileCLIP-B and relpos entries), EVA
  (2-D rotary q/k on the patch tokens, SwiGLU), ViTamin (conv stem, MBConv
  stages, a ViT stage), FastViT (conv stem, RepMixer stages, an attention
  stage) and Swin (windowed attention with a relative position bias);
- heads (:class:`TimmStyleTower`): pool ``avg`` / ``''`` (mean and
  ``head_norm``), ``token``, ``map`` (:class:`MAPHead`, big_vision's), and
  ``abs_attn`` / ``rot_attn`` (:class:`AttentionPool2dHead`); proj
  ``linear``, ``mlp``, ``'none'``, and ``None`` / ``''`` (a dense layer to
  ``embed_dim`` where the widths differ).

Tensors are NHWC, as in the JAX package. Convolutions run as ``F.conv2d``
on the NHWC tensor viewed as NCHW (a channels-last layout, which the card's
convolutions take as it is), with flax's ``padding='SAME'``: ``ceil(n / s)``
outputs and the padding split low ``total // 2``, high the rest, so a 3x3
stride-2 convolution of an even size pads (0, 1) where ``padding=1`` would
pad (1, 1). A 1x1 convolution is a dense layer over the channels.

JAX builds these trunks on its ``Transformer`` with its defaults and writes
the heads' and the EVA / Swin blocks' attention as einsums: XLA runs all of
it outside any Pallas kernel. So here every trunk's LayerNorm takes
two-pass f32 statistics and every attention JAX's einsum route
(``ops.attention_plain``: :func:`~spatial_clip_tpu_torch.ops.attention_plain.plain_attention`
in the ``Transformer`` blocks, :func:`~spatial_clip_tpu_torch.ops.attention_plain.head_attention`
in the heads and the EVA / Swin blocks), whatever the model's ``ln_impl``
and ``attn_impl``: the text tower keeps those. GELU is the tanh form
throughout; LayerNorm eps is 1e-6 in ConvNeXt, MBConv, RepMixer, EVA, the
MAP head and ``head_norm``, 1e-5 in Swin, the ViT trunk's final norm and
inside ``Transformer``.

Parameters carry the flax names (``trunk.stem_conv``,
``trunk.stage0_block0.dwconv``, ``attn_pool.probe``, ``head_proj``, ...;
a ``Transformer``'s blocks as the port's ``resblocks.i``) and JAX's shapes,
with dense kernels (out, in) and convolution kernels OIHW
(``models/convert.py`` maps both); the class tokens are 1-D and the MAP
probe (1, C), as in JAX, so weight decay (``ndim >= 2``) decides as JAX's.
Matrices, kernels and embeddings are stored in ``param_dtype`` and cast to
the compute ``dtype`` at each use; LayerNorm parameters are float32.

Differences from timm that the JAX package makes and this module copies:
Swin's shifted windows take no attention mask and its patch merging
concatenates the 2x2 neighbourhood in (0,0), (0,1), (1,0), (1,1) order; the
MAP head builds ``C // 64`` heads (18 at SO400M, where timm builds 16);
there is no drop path (``timm_drop_path`` is ignored, as in JAX).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from spatial_clip_tpu_torch.models.transformer import (
    Dense,
    LayerNorm,
    Transformer,
    _param,
    gelu_tanh,
)
from spatial_clip_tpu_torch.ops.attention_plain import head_attention


def same_pads(n: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax ``padding='SAME'`` along one axis of size n: (low, high)."""
    out = -(-n // stride)
    total = max((out - 1) * stride + kernel - n, 0)
    return total // 2, total - total // 2


def same_size(n: int, stride: int) -> int:
    return -(-n // stride)


class Conv(nn.Module):
    """flax ``nn.Conv`` (``padding='SAME'``, ``feature_group_count=groups``)
    on NHWC input: weight OIHW (out, in / groups, k, k) and bias in
    ``param_dtype``, cast to ``dtype`` with the input."""

    def __init__(self, n_in: int, n_out: int, kernel: int, stride: int = 1, groups: int = 1,
                 dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        self.kernel, self.stride, self.groups, self.dtype = kernel, stride, groups, dtype
        self.weight = _param(n_out, n_in // groups, kernel, kernel,
                             dtype=param_dtype or dtype, device=device)
        self.bias = _param(n_out, dtype=param_dtype or dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        w, b = self.weight.to(self.dtype), self.bias.to(self.dtype)
        k, s = self.kernel, self.stride
        if k == 1 and s == 1 and self.groups == 1:
            return F.linear(x, w.view(w.shape[0], -1), b)
        (ht, hb), (wl, wr) = same_pads(x.shape[1], k, s), same_pads(x.shape[2], k, s)
        xc = x.permute(0, 3, 1, 2)
        if (ht, wl) == (hb, wr):
            y = F.conv2d(xc, w, b, stride=s, padding=(ht, wl), groups=self.groups)
        else:  # SAME with stride > 1 on an even size pads the high side only
            y = F.conv2d(F.pad(xc, (wl, wr, ht, hb)), w, b, stride=s, groups=self.groups)
        return y.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# trunks
# ---------------------------------------------------------------------------


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, ls_init: float = 1e-6, dtype=torch.float32, param_dtype=None,
                 device=None):
        super().__init__()
        self.dtype = dtype
        pd = param_dtype or dtype
        self.dwconv = Conv(dim, dim, 7, groups=dim, dtype=dtype, param_dtype=pd, device=device)
        self.norm = LayerNorm(dim, 1e-6, "fp32", dtype, device)
        self.pwconv1 = Dense(dim, 4 * dim, dtype, pd, device)
        self.pwconv2 = Dense(4 * dim, dim, dtype, pd, device)
        self.gamma = _param(dim, dtype=pd, device=device)
        self.ls_init = ls_init

    def init_params(self, normal) -> None:
        """JAX's initializer of the parameters no Dense, Conv or LayerNorm
        holds (``factory.init_weights`` calls it): the layer-scale."""
        self.gamma.fill_(self.ls_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.pwconv2(gelu_tanh(self.pwconv1(self.norm(self.dwconv(x)))))
        return x + h * self.gamma.to(self.dtype)


class ConvNeXtTrunk(nn.Module):
    """ConvNeXt feature trunk (NHWC): (B, H/32, W/32, dims[-1])."""

    def __init__(self, image_size: int, depths=(3, 3, 9, 3), dims=(96, 192, 384, 768),
                 dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype or dtype, device=device)
        self.depths, self.dims, self.dtype = tuple(depths), tuple(dims), dtype
        self.stem_conv = Conv(3, dims[0], 4, 4, **kw)
        self.stem_norm = LayerNorm(dims[0], 1e-6, "fp32", dtype, device)
        g = same_size(image_size, 4)
        for stage, (depth, dim) in enumerate(zip(depths, dims)):
            if stage > 0:
                self.add_module(f"ds_norm_{stage}",
                                LayerNorm(dims[stage - 1], 1e-6, "fp32", dtype, device))
                self.add_module(f"ds_conv_{stage}", Conv(dims[stage - 1], dim, 2, 2, **kw))
                g = same_size(g, 2)
            for blk in range(depth):
                self.add_module(f"stage{stage}_block{blk}", ConvNeXtBlock(dim, **kw))
        self.num_features, self.grid = dims[-1], g

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem_norm(self.stem_conv(x))
        for stage, depth in enumerate(self.depths):
            if stage > 0:
                x = getattr(self, f"ds_conv_{stage}")(getattr(self, f"ds_norm_{stage}")(x))
            for blk in range(depth):
                x = getattr(self, f"stage{stage}_block{blk}")(x)
        return x


class ViTTrunk(nn.Module):
    """Plain ViT trunk: a token grid (B, gh, gw, width), or with
    ``cls_token`` the whole sequence (B, 1 + L, width)."""

    def __init__(self, image_size: int, patch_size: int = 16, width: int = 512,
                 layers: int = 12, heads: int = 8, mlp_ratio: float = 4.0,
                 cls_token: bool = False, dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        pd = param_dtype or dtype
        self.width, self.dtype = width, dtype
        self.patch_embed = Conv(3, width, patch_size, patch_size, dtype=dtype, param_dtype=pd,
                                device=device)
        self.grid = same_size(image_size, patch_size)
        n_prefix = 1 if cls_token else 0
        self.cls = _param(width, dtype=pd, device=device) if cls_token else None
        self.pos_embed = _param(self.grid ** 2 + n_prefix, width, dtype=pd, device=device)
        self.blocks = Transformer(width, layers, heads, mlp_ratio=mlp_ratio, norm_eps=1e-5,
                                  ln_stats="fp32", act=gelu_tanh, dtype=dtype, param_dtype=pd,
                                  device=device, attn_impl="einsum")
        self.norm = LayerNorm(width, 1e-5, "fp32", dtype, device)
        self.num_features = width

    def init_params(self, normal) -> None:
        for p in (self.cls, self.pos_embed):
            if p is not None:
                normal(p, 0.02)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x)
        B, gh, gw, _ = x.shape
        x = x.reshape(B, gh * gw, self.width)
        if self.cls is not None:
            x = torch.cat([self.cls.to(self.dtype).expand(B, 1, -1), x], dim=1)
        x = self.norm(self.blocks(x + self.pos_embed.to(self.dtype)))
        return x if self.cls is not None else x.reshape(B, gh, gw, self.width)


def rope_2d(width: int, gh: int, gw: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """2-D rotary tables (sin, cos), (gh gw, width) f32: the first half of
    the angles from the row, the second from the column, each a quarter of
    the width at frequencies 10000^(-i / quarter), the halves repeated."""
    assert width % 4 == 0
    quarter = width // 4
    freqs = 1.0 / (torch.tensor(10000.0, device=device)
                   ** (torch.arange(quarter, dtype=torch.float32, device=device) / quarter))

    def axis(n):
        return torch.outer(torch.arange(n, dtype=torch.float32, device=device), freqs)

    ay = axis(gh)[:, None, :].expand(gh, gw, quarter)
    ax = axis(gw)[None, :, :].expand(gh, gw, quarter)
    ang = torch.cat([ay, ax], dim=-1).reshape(gh * gw, width // 2)
    ang = torch.cat([ang, ang], dim=-1)
    return torch.sin(ang), torch.cos(ang)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    a, b = x.chunk(2, dim=-1)
    return torch.cat([-b, a], dim=-1)


class EVATrunk(nn.Module):
    """EVA02-style ViT trunk: class token, 2-D rotary q/k on the patch
    tokens only (the class token passes through), SwiGLU MLP of hidden
    ``int(width * mlp_ratio)``. Returns (B, 1 + L, width)."""

    def __init__(self, image_size: int, patch_size: int = 16, width: int = 768,
                 layers: int = 12, heads: int = 12, mlp_ratio: float = 4.0 * 2 / 3,
                 dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        pd = param_dtype or dtype
        self.width, self.layers, self.heads, self.dtype = width, layers, heads, dtype
        self.patch_embed = Conv(3, width, patch_size, patch_size, dtype=dtype, param_dtype=pd,
                                device=device)
        self.grid = g = same_size(image_size, patch_size)
        self.cls_token = _param(width, dtype=pd, device=device)
        self.pos_embed = _param(g * g + 1, width, dtype=pd, device=device)
        hidden = int(width * mlp_ratio)
        for i in range(layers):
            blk = f"blocks_{i}"
            self.add_module(f"{blk}_ln1", LayerNorm(width, 1e-6, "fp32", dtype, device))
            self.add_module(f"{blk}_qkv", Dense(width, 3 * width, dtype, pd, device))
            self.add_module(f"{blk}_proj", Dense(width, width, dtype, pd, device))
            self.add_module(f"{blk}_ln2", LayerNorm(width, 1e-6, "fp32", dtype, device))
            self.add_module(f"{blk}_w1", Dense(width, hidden, dtype, pd, device))
            self.add_module(f"{blk}_w2", Dense(width, hidden, dtype, pd, device))
            self.add_module(f"{blk}_w3", Dense(hidden, width, dtype, pd, device))
        self.norm = LayerNorm(width, 1e-6, "fp32", dtype, device)
        self.num_features = width

    def init_params(self, normal) -> None:
        normal(self.cls_token, 0.02)
        normal(self.pos_embed, 0.02)

    def _block(self, i: int, name: str) -> nn.Module:
        return getattr(self, f"blocks_{i}_{name}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x)
        B, gh, gw, _ = x.shape
        L, W, H = gh * gw, self.width, self.heads
        hd = W // H
        x = torch.cat([self.cls_token.to(self.dtype).expand(B, 1, -1), x.reshape(B, L, W)], dim=1)
        x = x + self.pos_embed.to(self.dtype)
        sin, cos = (t.to(self.dtype)[None, :, None, :] for t in rope_2d(hd, gh, gw, x.device))

        def rope(t):  # the patch tokens only; the class token passes through
            heads_t = t[:, 1:].reshape(B, L, H, hd)
            rot = heads_t * cos + rotate_half(heads_t) * sin
            return torch.cat([t[:, :1], rot.reshape(B, L, W)], dim=1)

        for i in range(self.layers):
            q, k, v = self._block(i, "qkv")(self._block(i, "ln1")(x)).chunk(3, dim=-1)
            x = x + self._block(i, "proj")(head_attention(rope(q), rope(k), v, H))
            h = self._block(i, "ln2")(x)
            gate, up = self._block(i, "w1")(h), self._block(i, "w2")(h)
            x = x + self._block(i, "w3")(F.silu(gate) * up)
        return self.norm(x)


class MBConvBlock(nn.Module):
    """Mobile inverted bottleneck (ViTamin's conv stages)."""

    def __init__(self, dim: int, expand: int = 4, dtype=torch.float32, param_dtype=None,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype or dtype, device=device)
        hid = dim * expand
        self.norm = LayerNorm(dim, 1e-6, "fp32", dtype, device)
        self.expand = Conv(dim, hid, 1, **kw)
        self.dw = Conv(hid, hid, 3, groups=hid, **kw)
        self.project = Conv(hid, dim, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = gelu_tanh(self.dw(gelu_tanh(self.expand(self.norm(x)))))
        return x + self.project(h)


class ViTaminTrunk(nn.Module):
    """ViTamin hybrid trunk: conv stem, two MBConv stages, a ViT stage at
    stride 16. Returns (B, gh, gw, vit_width)."""

    def __init__(self, image_size: int, conv_dims=(128, 256), conv_depths=(2, 4),
                 vit_width: int = 768, vit_layers: int = 14, vit_heads: int = 12,
                 dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        pd = param_dtype or dtype
        kw = dict(dtype=dtype, param_dtype=pd, device=device)
        self.conv_depths, self.vit_width, self.dtype = tuple(conv_depths), vit_width, dtype
        self.stem_conv1 = Conv(3, conv_dims[0] // 2, 3, 2, **kw)
        self.stem_conv2 = Conv(conv_dims[0] // 2, conv_dims[0], 3, 2, **kw)
        g = same_size(same_size(image_size, 2), 2)
        for stage, (dim, depth) in enumerate(zip(conv_dims, conv_depths)):
            if stage > 0:
                self.add_module(f"ds_{stage}", Conv(conv_dims[stage - 1], dim, 2, 2, **kw))
                g = same_size(g, 2)
            for b in range(depth):
                self.add_module(f"stage{stage}_mbconv{b}", MBConvBlock(dim, **kw))
        self.vit_embed = Conv(conv_dims[-1], vit_width, 2, 2, **kw)
        self.grid = g = same_size(g, 2)
        self.pos_embed = _param(g * g, vit_width, dtype=pd, device=device)
        self.vit = Transformer(vit_width, vit_layers, vit_heads, norm_eps=1e-5, ln_stats="fp32",
                               act=gelu_tanh, attn_impl="einsum", **kw)
        self.norm = LayerNorm(vit_width, 1e-6, "fp32", dtype, device)
        self.num_features = vit_width

    def init_params(self, normal) -> None:
        normal(self.pos_embed, 0.02)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem_conv2(gelu_tanh(self.stem_conv1(x)))
        for stage, depth in enumerate(self.conv_depths):
            if stage > 0:
                x = getattr(self, f"ds_{stage}")(x)
            for b in range(depth):
                x = getattr(self, f"stage{stage}_mbconv{b}")(x)
        x = self.vit_embed(x)
        B, gh, gw, _ = x.shape
        t = x.reshape(B, gh * gw, self.vit_width) + self.pos_embed.to(self.dtype)
        return self.norm(self.vit(t)).reshape(B, gh, gw, self.vit_width)


class RepMixerBlock(nn.Module):
    """FastViT token mixing (train-time form): a depthwise 3x3 residual
    mixer, then a convolutional FFN."""

    def __init__(self, dim: int, dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype or dtype, device=device)
        self.mix_norm = LayerNorm(dim, 1e-6, "fp32", dtype, device)
        self.mixer = Conv(dim, dim, 3, groups=dim, **kw)
        self.ffn_norm = LayerNorm(dim, 1e-6, "fp32", dtype, device)
        self.ffn_fc = Conv(dim, 3 * dim, 1, **kw)
        self.ffn_proj = Conv(3 * dim, dim, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.mixer(self.mix_norm(x))
        return x + self.ffn_proj(gelu_tanh(self.ffn_fc(self.ffn_norm(x))))


class FastViTTrunk(nn.Module):
    """FastViT / MCi trunk (MobileCLIP's image encoders): conv stem, three
    RepMixer stages, an attention stage. Returns (B, H/32, W/32, dims[-1])."""

    def __init__(self, image_size: int, dims=(76, 152, 304, 608), depths=(2, 6, 10, 2),
                 dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype or dtype, device=device)
        self.depths = tuple(depths)
        self.stem1 = Conv(3, dims[0], 3, 2, **kw)
        self.stem2 = Conv(dims[0], dims[0], 3, 2, groups=dims[0], **kw)
        g = same_size(same_size(image_size, 2), 2)
        for stage, (dim, depth) in enumerate(zip(dims, depths)):
            if stage > 0:
                self.add_module(f"ds_{stage}", Conv(dims[stage - 1], dim, 2, 2, **kw))
                g = same_size(g, 2)
            if stage < 3:
                for b in range(depth):
                    self.add_module(f"stage{stage}_block{b}", RepMixerBlock(dim, **kw))
            else:
                self.attn_stage = Transformer(dim, depth, max(1, dim // 64), norm_eps=1e-5,
                                              ln_stats="fp32", act=gelu_tanh,
                                              attn_impl="einsum", **kw)
        self.norm = LayerNorm(dims[-1], 1e-6, "fp32", dtype, device)
        self.num_features, self.grid = dims[-1], g

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem2(gelu_tanh(self.stem1(x)))
        for stage, depth in enumerate(self.depths):
            if stage > 0:
                x = getattr(self, f"ds_{stage}")(x)
            if stage < 3:
                for b in range(depth):
                    x = getattr(self, f"stage{stage}_block{b}")(x)
            else:
                B, gh, gw, C = x.shape
                x = self.attn_stage(x.reshape(B, gh * gw, C)).reshape(B, gh, gw, C)
        return self.norm(x)


def swin_rel_index(window: int, device=None) -> torch.Tensor:
    """(w^2, w^2) indices into the ((2w - 1)^2, heads) relative-position
    table: (dy + w - 1) (2w - 1) + dx + w - 1."""
    r = torch.arange(window, device=device)
    coords = torch.stack(torch.meshgrid(r, r, indexing="ij"), -1).reshape(-1, 2)
    rel = coords[:, None] - coords[None, :] + (window - 1)
    return rel[..., 0] * (2 * window - 1) + rel[..., 1]


class SwinBlock(nn.Module):
    """Windowed multi-head attention with a relative position bias, shifted
    by ``shift`` when it is not 0 (with no mask, as in JAX), then an MLP."""

    def __init__(self, dim: int, heads: int, window: int = 7, shift: int = 0,
                 mlp_ratio: float = 4.0, dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        pd = param_dtype or dtype
        self.heads, self.window, self.shift, self.dtype = heads, window, shift, dtype
        self.norm1 = LayerNorm(dim, 1e-5, "fp32", dtype, device)
        self.qkv = Dense(dim, 3 * dim, dtype, pd, device)
        self.rel_bias = _param((2 * window - 1) ** 2, heads, dtype=pd, device=device)
        self.proj = Dense(dim, dim, dtype, pd, device)
        self.norm2 = LayerNorm(dim, 1e-5, "fp32", dtype, device)
        self.mlp_fc = Dense(dim, int(dim * mlp_ratio), dtype, pd, device)
        self.mlp_proj = Dense(int(dim * mlp_ratio), dim, dtype, pd, device)

    def init_params(self, normal) -> None:
        normal(self.rel_bias, 0.02)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        w, s = self.window, self.shift
        h = self.norm1(x)
        if s:
            h = torch.roll(h, shifts=(-s, -s), dims=(1, 2))
        nh, nw = H // w, W // w
        win = h.reshape(B, nh, w, nw, w, C).permute(0, 1, 3, 2, 4, 5)
        win = win.reshape(B * nh * nw, w * w, C)
        q, k, v = self.qkv(win).chunk(3, dim=-1)
        idx = swin_rel_index(w, x.device)
        bias = self.rel_bias.float()[idx].permute(2, 0, 1)  # (heads, w^2, w^2) f32
        o = self.proj(head_attention(q, k, v, self.heads, bias))
        o = o.reshape(B, nh, nw, w, w, C).permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)
        if s:
            o = torch.roll(o, shifts=(s, s), dims=(1, 2))
        x = x + o
        return x + self.mlp_proj(gelu_tanh(self.mlp_fc(self.norm2(x))))


class SwinTrunk(nn.Module):
    """Hierarchical Swin trunk: 4x4 patch embedding, patch merging between
    stages, blocks alternating unshifted and shifted windows."""

    def __init__(self, image_size: int, dims=(128, 256, 512, 1024), depths=(2, 2, 18, 2),
                 heads=(4, 8, 16, 32), window: int = 7, dtype=torch.float32, param_dtype=None,
                 device=None):
        super().__init__()
        pd = param_dtype or dtype
        kw = dict(dtype=dtype, param_dtype=pd, device=device)
        self.depths = tuple(depths)
        self.patch_embed = Conv(3, dims[0], 4, 4, **kw)
        self.embed_norm = LayerNorm(dims[0], 1e-5, "fp32", dtype, device)
        g = same_size(image_size, 4)
        for stage, (dim, depth, nh) in enumerate(zip(dims, depths, heads)):
            if stage > 0:
                self.add_module(f"merge_norm_{stage}",
                                LayerNorm(4 * dims[stage - 1], 1e-5, "fp32", dtype, device))
                self.add_module(f"merge_{stage}",
                                Dense(4 * dims[stage - 1], dim, dtype, pd, device, bias=False))
                g //= 2
            for b in range(depth):
                self.add_module(f"stage{stage}_block{b}", SwinBlock(
                    dim, nh, window, 0 if b % 2 == 0 else window // 2, **kw))
        self.norm = LayerNorm(dims[-1], 1e-5, "fp32", dtype, device)
        self.num_features, self.grid = dims[-1], g

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.embed_norm(self.patch_embed(x))
        for stage, depth in enumerate(self.depths):
            if stage > 0:  # the 2x2 neighbourhood concatenated in JAX's order, reduced
                B, H, W, C = x.shape
                x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 2, 4, 5)
                x = x.reshape(B, H // 2, W // 2, 4 * C)
                x = getattr(self, f"merge_{stage}")(getattr(self, f"merge_norm_{stage}")(x))
            for b in range(depth):
                x = getattr(self, f"stage{stage}_block{b}")(x)
        return self.norm(x)


# ---------------------------------------------------------------------------
# the registry (the JAX package's TRUNKS)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TrunkSpec:
    build: Callable[..., nn.Module]  # (image_size, dtype, param_dtype, device) -> trunk
    reduction: int  # the spatial reduction


def _convnext(depths, dims):
    return TrunkSpec(lambda size, **kw: ConvNeXtTrunk(size, depths, dims, **kw), 32)


def _vit(width, layers, heads, patch, mlp_ratio=4.0, cls_token=False):
    return TrunkSpec(lambda size, **kw: ViTTrunk(size, patch, width, layers, heads, mlp_ratio,
                                                 cls_token, **kw), patch)


def _eva(width, layers, heads, patch):
    return TrunkSpec(lambda size, **kw: EVATrunk(size, patch, width, layers, heads, **kw), patch)


def _vitamin(conv_dims, conv_depths, vit_width, vit_layers, vit_heads):
    return TrunkSpec(lambda size, **kw: ViTaminTrunk(size, conv_dims, conv_depths, vit_width,
                                                     vit_layers, vit_heads, **kw), 16)


def _fastvit(dims, depths):
    return TrunkSpec(lambda size, **kw: FastViTTrunk(size, dims, depths, **kw), 32)


def _swin(**arch):
    return TrunkSpec(lambda size, **kw: SwinTrunk(size, **arch, **kw), 32)


TRUNKS: Dict[str, TrunkSpec] = {
    "convnext_tiny": _convnext((3, 3, 9, 3), (96, 192, 384, 768)),
    "convnext_small": _convnext((3, 3, 27, 3), (96, 192, 384, 768)),
    "convnext_base": _convnext((3, 3, 27, 3), (128, 256, 512, 1024)),
    "convnext_large": _convnext((3, 3, 27, 3), (192, 384, 768, 1536)),
    "convnext_xlarge": _convnext((3, 3, 27, 3), (256, 512, 1024, 2048)),
    "convnext_xxlarge": _convnext((3, 4, 30, 3), (384, 768, 1536, 3072)),
    "vit_medium_patch16_gap_256": _vit(512, 12, 8, 16),
    "vit_base_patch16_gap_224": _vit(768, 12, 12, 16),
    "convnext_pico": _convnext((2, 2, 4, 2), (32, 64, 128, 256)),  # small trunk for tests
}
# SigLIP ViT trunks: gap-style ViTs, pooled by the MAP head (timm_pool='map')
for _p in (16, 32):
    for _sz in (224, 256, 384, 512):
        TRUNKS[f"vit_base_patch{_p}_siglip_{_sz}"] = _vit(768, 12, 12, _p)
for _sz in (256, 384, 512):
    TRUNKS[f"vit_large_patch16_siglip_{_sz}"] = _vit(1024, 24, 16, 16)
for _p, _sz in ((14, 224), (14, 378), (14, 384), (16, 256), (16, 384), (16, 512)):
    TRUNKS[f"vit_so400m_patch{_p}_siglip_{_sz}"] = _vit(1152, 27, 16, _p, mlp_ratio=3.7362)
for _sz in (256, 384):
    TRUNKS[f"vit_giantopt_patch16_siglip_{_sz}"] = _vit(1536, 40, 16, 16)
TRUNKS["vit_pico_patch16_siglip_test"] = _vit(64, 2, 2, 16)  # tiny siglip-style trunk for tests
TRUNKS.update({
    # EVA family
    "eva02_base_patch16_clip_224": _eva(768, 12, 12, 16),
    "eva02_large_patch14_clip_224": _eva(1024, 24, 16, 14),
    "eva02_large_patch14_clip_336": _eva(1024, 24, 16, 14),
    "eva02_enormous_patch14_clip_224": _eva(1792, 64, 16, 14),
    "eva_giant_patch14_224": _eva(1408, 40, 16, 14),
    "eva_pico_patch16_test": _eva(64, 2, 2, 16),
    # PE-Core: plain ViT trunks, MAP pooling
    "vit_pe_core_tiny_patch16_384": _vit(192, 12, 3, 16),
    "vit_pe_core_small_patch16_384": _vit(384, 12, 6, 16),
    "vit_pe_core_base_patch16_224": _vit(768, 12, 12, 16),
    "vit_pe_core_large_patch14_336": _vit(1024, 24, 16, 14),
    "vit_pe_core_gigantic_patch14_448": _vit(1536, 50, 16, 14),
    # ViTamin hybrids
    "vitamin_small_224": _vitamin((64, 128), (2, 4), 384, 14, 6),
    "vitamin_base_224": _vitamin((128, 256), (2, 4), 768, 14, 12),
    **{f"vitamin_large{v}_{sz}": _vitamin((160, 320), (2, 4), 1024, 31, 16)
       for v in ("", "2") for sz in (224, 256, 336, 384)},
    **{f"vitamin_xlarge_{sz}": _vitamin((192, 384), (2, 4), 1152, 32, 16)
       for sz in (256, 336, 384)},
    "vitamin_pico_test": _vitamin((16, 32), (1, 1), 64, 2, 2),
    # MobileCLIP image encoders
    "fastvit_mci1": _fastvit((64, 128, 256, 512), (2, 6, 10, 2)),
    "fastvit_mci2": _fastvit((80, 160, 320, 640), (2, 6, 10, 2)),
    "fastvit_pico_test": _fastvit((16, 32, 64, 128), (1, 1, 1, 1)),
    # MobileCLIP-B: ViT-B/16 (the MCi stem approximated by the patch conv) with
    # a class token for the config's 'token' pooling
    "vit_base_mci_224": _vit(768, 12, 12, 16, cls_token=True),
    # the relative-position ViT approximated by a learned-position cls ViT
    "vit_relpos_medium_patch16_cls_224": _vit(512, 12, 8, 16, cls_token=True),
    "swin_base_patch4_window7_224": _swin(),
    "swin_pico_test": _swin(dims=(16, 32, 64, 128), depths=(1, 1, 1, 1), heads=(1, 2, 4, 8),
                            window=2),
})


def list_timm_trunks():
    return sorted(TRUNKS)


class UnknownTrunkError(KeyError, NotImplementedError):
    """A ``timm_model_name`` outside :data:`TRUNKS`: the KeyError JAX's
    adapter raises, and the NotImplementedError of ``config.check_ported``."""


# ---------------------------------------------------------------------------
# pooling heads
# ---------------------------------------------------------------------------


class AttentionPool2dHead(nn.Module):
    """Single-query attention pooling over a (B, gh, gw, C) map, the query
    the mean token: ``rotary=False`` adds a learned position table (timm's
    AbsAttentionPool2d), ``rotary=True`` rotates k (timm's
    RotAttentionPool2d). Projected to ``out_features``."""

    def __init__(self, width: int, grid: int, out_features: int, heads: int = 8,
                 rotary: bool = False, dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        pd = param_dtype or dtype
        self.heads, self.rotary, self.dtype = heads, rotary, dtype
        self.pos_embed = None if rotary else _param(grid * grid, width, dtype=pd, device=device)
        self.q = Dense(width, width, dtype, pd, device)
        self.k = Dense(width, width, dtype, pd, device)
        self.v = Dense(width, width, dtype, pd, device)
        self.proj = Dense(width, out_features, dtype, pd, device)

    def init_params(self, normal) -> None:
        if self.pos_embed is not None:
            normal(self.pos_embed, self.pos_embed.shape[-1] ** -0.5)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        B, gh, gw, C = feat.shape
        L, H = gh * gw, self.heads
        hd = C // H
        x = feat.reshape(B, L, C)
        if self.pos_embed is not None:
            x = x + self.pos_embed.to(self.dtype)
        q, k, v = self.q(x.mean(dim=1, keepdim=True)), self.k(x), self.v(x)
        if self.rotary:
            sin, cos = (t.repeat(1, H).to(self.dtype) for t in rope_2d(hd, gh, gw, x.device))
            k = k * cos + rotate_half(k.reshape(B, L, H, hd)).reshape(B, L, C) * sin
        return self.proj(head_attention(q, k, v, H).reshape(B, C))


class MAPHead(nn.Module):
    """big_vision's MAP head (SigLIP pooling): a learned probe attends over
    the tokens with ``C // 64`` heads, then an MLP residual. The parameters
    are big_vision's (``probe`` (1, C), ``q``, ``k``, ``v``, ``out``,
    ``ln``, ``mlp_fc``, ``mlp_proj``)."""

    def __init__(self, width: int, heads: Optional[int] = None, mlp_ratio: float = 4.0,
                 norm_eps: float = 1e-6, dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        pd = param_dtype or dtype
        self.heads, self.dtype = heads or max(1, width // 64), dtype
        self.probe = _param(1, width, dtype=pd, device=device)
        self.q = Dense(width, width, dtype, pd, device)
        self.k = Dense(width, width, dtype, pd, device)
        self.v = Dense(width, width, dtype, pd, device)
        self.out = Dense(width, width, dtype, pd, device)
        self.ln = LayerNorm(width, norm_eps, "fp32", dtype, device)
        self.mlp_fc = Dense(width, int(width * mlp_ratio), dtype, pd, device)
        self.mlp_proj = Dense(int(width * mlp_ratio), width, dtype, pd, device)

    def init_params(self, normal) -> None:
        normal(self.probe, 0.02)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        B, C = feat.shape[0], feat.shape[-1]
        x = feat.reshape(B, -1, C)
        q = self.q(self.probe.to(self.dtype).expand(B, 1, C))
        out = self.out(head_attention(q, self.k(x), self.v(x), self.heads))
        h = self.mlp_proj(gelu_tanh(self.mlp_fc(self.ln(out))))
        return (out + h)[:, 0]


# ---------------------------------------------------------------------------
# the adapter
# ---------------------------------------------------------------------------


class TimmStyleTower(nn.Module):
    """The counterpart of JAX's ``TimmStyleTower`` (open_clip's TimmModel):
    ``trunk``, then the pool and the projection of the config. An unknown
    trunk name raises KeyError listing the registry. ``drop`` (timm_drop)
    must be 0: ``config.check_ported`` refuses a dropout."""

    def __init__(self, model_name: str, embed_dim: int, image_size: int = 224,
                 pool: str = "avg", proj: Optional[str] = "linear", proj_bias: bool = False,
                 drop: float = 0.0, dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        if model_name not in TRUNKS:
            raise UnknownTrunkError(f"unknown timm-style trunk '{model_name}'; available: "
                                    f"{list_timm_trunks()}")
        if drop > 0:
            raise NotImplementedError(f"timm_drop={drop}: the tower's dropout is not ported")
        pd = param_dtype or dtype
        kw = dict(dtype=dtype, param_dtype=pd, device=device)
        self.pool, self.proj, self.dtype = pool, proj, dtype
        self.trunk = TRUNKS[model_name].build(image_size, **kw)
        width, grid = self.trunk.num_features, self.trunk.grid
        self.attn_pool = self.head_norm = None
        if pool == "map":
            self.attn_pool = MAPHead(width, **kw)
        elif pool in ("abs_attn", "rot_attn"):
            self.attn_pool = AttentionPool2dHead(width, grid, embed_dim,
                                                 rotary=pool == "rot_attn", **kw)
            width = embed_dim
        elif pool != "token":  # 'avg' and the trunk's default
            self.head_norm = LayerNorm(width, 1e-6, "fp32", dtype, device)
        if proj == "linear":
            self.head_proj = Dense(width, embed_dim, dtype, pd, device, bias=proj_bias)
        elif proj == "mlp":
            self.head_mlp_fc = Dense(width, 2 * embed_dim, dtype, pd, device)
            self.head_mlp_proj = Dense(2 * embed_dim, embed_dim, dtype, pd, device,
                                       bias=proj_bias)
        elif proj in (None, "") and width != embed_dim:
            # open_clip's trunk classifier projecting to embed_dim
            self.head_fc = Dense(width, embed_dim, dtype, pd, device)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        feat = self.trunk(images)
        if self.pool == "token":  # the class token (EVA, MobileCLIP-B); a grid's mean
            x = feat[:, 0] if feat.dim() == 3 else feat.mean(dim=(1, 2))
        else:
            if feat.dim() == 3:  # a token sequence -> (B, g, g, C)
                B, L, C = feat.shape
                if math.isqrt(L) ** 2 != L:  # JAX's test for a class token
                    feat = feat[:, 1:]
                    L -= 1
                g = math.isqrt(L)
                feat = feat.reshape(B, g, g, C)
            if self.attn_pool is not None:
                x = self.attn_pool(feat)
            else:
                x = self.head_norm(feat.mean(dim=(1, 2)))
        if self.proj == "linear":
            return self.head_proj(x)
        if self.proj == "mlp":
            return self.head_mlp_proj(gelu_tanh(self.head_mlp_fc(x)))
        if self.proj in (None, "") and hasattr(self, "head_fc"):
            return self.head_fc(x)
        return x
