"""OpenAI's modified ResNet image tower.

The counterpart of ``spatial_clip_tpu.models.modified_resnet``, for the ``RN*``
configs (a list of stage depths in ``vision_cfg.layers``): a
3-convolution stem with an average pool in place of the max pool, stages
of Bottlenecks whose stride-2 blocks blur-pool (``avg_pool(stride)``)
before their 1x1 ``conv3`` and downsample through an average pool and a
1x1 convolution, and a final attention pool over the mean token. The
BatchNorms are frozen, as in JAX: their statistics are parameters that
take no gradient (JAX's ``stop_gradient``), f32 arithmetic, the result
cast back to the compute dtype.

Tensors are NHWC, as in the JAX package; every convolution is ``F.conv2d``
on the tensor viewed as NCHW (channels-last, which the card's convolutions
take as it is), a 1x1 one a dense layer over the channels. The stride-2
stem convolution pads (1, 1), as torch and JAX's explicit padding do (flax's
SAME would pad (0, 1)); every other 3x3 pads 1. The attention pool's
scores take JAX's einsum route in f32
(``ops.attention_plain.head_attention``).

Parameters carry open_clip's names (``conv1.weight``, ``bn1.running_mean``,
``layer1.0.downsample.0.weight``, ``attnpool.q_proj.weight``, ...), so an
open_clip RN state dict loads as it is (less its ``num_batches_tracked``).
Kernels are OIHW and stored in ``param_dtype``; the BatchNorm parameters
and statistics are float32.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from spatial_clip_tpu_torch.models.transformer import Dense, _param
from spatial_clip_tpu_torch.ops.attention_plain import head_attention


class RNConv(nn.Module):
    """A bias-free k x k convolution (padding k // 2 on every side) on NHWC
    input: weight OIHW in ``param_dtype``, cast to ``dtype`` with the input."""

    def __init__(self, n_in: int, n_out: int, kernel: int, stride: int = 1, dtype=torch.float32,
                 param_dtype=None, device=None):
        super().__init__()
        self.kernel, self.stride, self.dtype = kernel, stride, dtype
        self.weight = _param(n_out, n_in, kernel, kernel, dtype=param_dtype or dtype,
                             device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(self.dtype)
        if self.kernel == 1 and self.stride == 1:
            return F.linear(x, w.view(w.shape[0], -1))
        y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=self.stride, padding=self.kernel // 2)
        return y.permute(0, 2, 3, 1)


class FrozenBatchNorm(nn.Module):
    """``(x - mean) * rsqrt(var + eps) * weight + bias`` in f32, cast to the
    compute dtype; ``running_mean`` and ``running_var`` are parameters (in
    the optimizer's buffers, as in JAX) that the forward detaches."""

    def __init__(self, width: int, eps: float = 1e-5, dtype=torch.float32, device=None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        for name in ("weight", "bias", "running_mean", "running_var"):
            setattr(self, name, _param(width, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = (x.float() - self.running_mean.detach()) * torch.rsqrt(
            self.running_var.detach() + self.eps)
        return (y * self.weight + self.bias).to(self.dtype)

    def init_params(self, normal):
        if not self.weight.is_meta:
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)


def avg_pool(x: torch.Tensor, window: int) -> torch.Tensor:
    """flax ``nn.avg_pool(x, (w, w), strides=(w, w))`` (VALID) on NHWC."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), window, window).permute(0, 2, 3, 1)


class Bottleneck(nn.Module):
    """Expansion 4: 1x1, 3x3, (blur pool), 1x1, each convolution followed by
    a frozen BatchNorm, ReLU but after the last; the identity through
    ``downsample`` (avg pool, 1x1, BatchNorm) where it is given."""

    def __init__(self, n_in: int, planes: int, stride: int = 1, downsample: bool = False,
                 dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.stride = stride
        self.conv1 = RNConv(n_in, planes, 1, **kw)
        self.bn1 = FrozenBatchNorm(planes, dtype=dtype, device=device)
        self.conv2 = RNConv(planes, planes, 3, **kw)
        self.bn2 = FrozenBatchNorm(planes, dtype=dtype, device=device)
        self.conv3 = RNConv(planes, planes * 4, 1, **kw)
        self.bn3 = FrozenBatchNorm(planes * 4, dtype=dtype, device=device)
        self.downsample = (nn.Sequential(RNConv(n_in, planes * 4, 1, **kw),
                                         FrozenBatchNorm(planes * 4, dtype=dtype, device=device))
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        if self.stride > 1:
            out = avg_pool(out, self.stride)
        out = self.bn3(self.conv3(out))
        identity = x
        if self.downsample is not None:
            if self.stride > 1:
                identity = avg_pool(identity, self.stride)
            identity = self.downsample(identity)
        return torch.relu(out + identity)


class AttentionPool2d(nn.Module):
    """The mean token prepended to the HW tokens, the (HW + 1, C) positions
    added, the mean token's query against every token (``head_attention``:
    q scaled by ``hd^-1/2`` in the compute dtype, f32 softmax), then
    ``c_proj``."""

    def __init__(self, grid: int, embed_dim: int, heads: int, output_dim: int,
                 dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        param_dtype = param_dtype or dtype
        self.heads, self.dtype = heads, dtype
        self.positional_embedding = _param(grid * grid + 1, embed_dim, dtype=param_dtype,
                                           device=device)
        for name in ("q_proj", "k_proj", "v_proj"):
            setattr(self, name, Dense(embed_dim, embed_dim, dtype, param_dtype, device))
        self.c_proj = Dense(embed_dim, output_dim, dtype, param_dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        tokens = x.reshape(B, H * W, C)
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        tokens = tokens + self.positional_embedding.to(self.dtype)[None]
        out = head_attention(self.q_proj(tokens[:, :1]), self.k_proj(tokens),
                             self.v_proj(tokens), self.heads)
        return self.c_proj(out.reshape(B, C))

    def init_params(self, normal):
        normal(self.positional_embedding, self.positional_embedding.shape[1] ** -0.5)


class ModifiedResNet(nn.Module):
    """Stem (3x3 stride 2 to width / 2, 3x3 to width / 2, 3x3 to width, each
    with a frozen BatchNorm and ReLU), a 2x2 average pool, four stages of
    Bottlenecks (planes width x 2^stage, the first block of stages 2-4 at
    stride 2) and the attention pool (``heads`` = width x 32 / 64, JAX's
    CLIP) over the (image_size / 32)^2 grid."""

    def __init__(self, layers: Sequence[int], width: int, image_size: int, heads: int,
                 output_dim: int, dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype or dtype, device=device)
        self.dtype = dtype
        self.conv1 = RNConv(3, width // 2, 3, stride=2, **kw)
        self.bn1 = FrozenBatchNorm(width // 2, dtype=dtype, device=device)
        self.conv2 = RNConv(width // 2, width // 2, 3, **kw)
        self.bn2 = FrozenBatchNorm(width // 2, dtype=dtype, device=device)
        self.conv3 = RNConv(width // 2, width, 3, **kw)
        self.bn3 = FrozenBatchNorm(width, dtype=dtype, device=device)
        n_in = width
        for stage, blocks in enumerate(layers):
            planes, stride = width * 2 ** stage, 1 if stage == 0 else 2
            seq = []
            for b in range(blocks):
                s = stride if b == 0 else 1
                seq.append(Bottleneck(n_in, planes, s, b == 0 and (s > 1 or n_in != planes * 4),
                                      **kw))
                n_in = planes * 4
            self.add_module(f"layer{stage + 1}", nn.Sequential(*seq))
        self.attnpool = AttentionPool2d(image_size // 32, n_in, heads, output_dim, **kw)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.to(self.dtype)
        x = torch.relu(self.bn1(self.conv1(x)))
        x = torch.relu(self.bn2(self.conv2(x)))
        x = avg_pool(torch.relu(self.bn3(self.conv3(x))), 2)
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = stage(x)
        return self.attnpool(x)
