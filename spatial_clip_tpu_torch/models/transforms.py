"""Image preprocessing: a host stage that decodes to HWC uint8 tiles at the
model size, and a device stage that normalizes a uint8 batch.

Counterpart of ``spatial_clip_tpu.models.transforms`` for the serving and
training paths: ``normalize_batch``, the train step's fused
``augment_normalize_batch`` with its random draws made apart
(``draw_augment``), and the eval-mode host transform (resize the shortest
side, bicubic, then center-crop). Pillow is imported only where an encoded
image is decoded, so installs without it serve raw tiles and text.
"""
from __future__ import annotations

import io
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from spatial_clip_tpu_torch.models.constants import OPENAI_DATASET_MEAN, OPENAI_DATASET_STD


@dataclass
class PreprocessCfg:
    size: Union[int, Tuple[int, int]] = 224
    mean: Tuple[float, ...] = OPENAI_DATASET_MEAN
    std: Tuple[float, ...] = OPENAI_DATASET_STD

    @property
    def size_tuple(self) -> Tuple[int, int]:
        s = self.size
        return (s, s) if isinstance(s, int) else tuple(s)


def normalize_batch(images_u8: torch.Tensor,
                    mean: Sequence[float] = OPENAI_DATASET_MEAN,
                    std: Sequence[float] = OPENAI_DATASET_STD,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 (B, H, W, 3) -> normalized (B, H, W, 3) in ``dtype``; the math
    runs in f32 on the tensor's device, then casts."""
    dev = images_u8.device
    mean_arr = torch.tensor(mean, dtype=torch.float32, device=dev) * 255.0
    inv_std = 1.0 / (torch.tensor(std, dtype=torch.float32, device=dev) * 255.0)
    return ((images_u8.float() - mean_arr) * inv_std).to(dtype)


class AugmentDraws(NamedTuple):
    """Per-image random draws of :func:`augment_normalize_batch`: ``flip``
    (B,) bool, and the brightness ``b`` and contrast ``c`` factors (B,) f32
    (None without color jitter)."""
    flip: torch.Tensor
    b: Optional[torch.Tensor] = None
    c: Optional[torch.Tensor] = None


def draw_augment(batch: int, horizontal_flip_prob: float = 0.5,
                 color_jitter: Optional[float] = None,
                 generator: Optional[torch.Generator] = None,
                 device=None) -> AugmentDraws:
    """The draws of the JAX package's ``augment_normalize_batch``, from
    ``generator``: flip ~ Bernoulli(p) per image, ``b, c = 1 + U(-j, j)``.
    (Another generator than JAX's, so other values from the same seed.)"""
    def uniform():
        return torch.rand(batch, generator=generator, device=device)

    flip = uniform() < horizontal_flip_prob
    if not color_jitter:
        return AugmentDraws(flip)
    b = 1.0 + (uniform() * 2.0 - 1.0) * color_jitter
    c = 1.0 + (uniform() * 2.0 - 1.0) * color_jitter
    return AugmentDraws(flip, b, c)


def augment_normalize_batch(images_u8: torch.Tensor, draws: AugmentDraws,
                            mean: Sequence[float] = OPENAI_DATASET_MEAN,
                            std: Sequence[float] = OPENAI_DATASET_STD,
                            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Fused augment + normalize of a uint8 (B, H, W, 3) batch, with the
    math of the JAX package's ``augment_normalize_batch``: the horizontal
    flip is a select on the uint8 view; brightness/contrast jitter
    ``(x - m) c + m b`` (m the image's mean pixel) and the normalization
    ``(x - mean) / std`` compose into one affine map per image and channel,
    applied in one f32 pass, then cast to ``dtype``."""
    dev = images_u8.device
    flip = draws.flip.to(dev).view(-1, 1, 1, 1)
    x_u8 = torch.where(flip, images_u8.flip(2), images_u8)
    x = x_u8.float()
    mean_arr = torch.tensor(mean, dtype=torch.float32, device=dev) * 255.0
    inv_std = 1.0 / (torch.tensor(std, dtype=torch.float32, device=dev) * 255.0)
    if draws.b is None:
        return ((x - mean_arr) * inv_std).to(dtype)
    b = draws.b.to(dev, torch.float32).view(-1, 1, 1, 1)
    c = draws.c.to(dev, torch.float32).view(-1, 1, 1, 1)
    mean_px = x.mean(dim=(1, 2, 3), keepdim=True)
    # ((x c + m (b - c)) - mean) / std = x (c / std) + (m (b - c) - mean) / std
    scale = c * inv_std
    shift = (mean_px * (b - c) - mean_arr) * inv_std
    return torch.addcmul(shift, x, scale).to(dtype)


def decode_tile(raw: bytes, cfg: PreprocessCfg) -> np.ndarray:
    """Encoded image bytes -> (H, W, 3) uint8 RGB at the model size: the JAX
    package's eval transform at its defaults (shortest side resized with
    bicubic filtering, then center-cropped)."""
    from PIL import Image

    img = Image.open(io.BytesIO(raw)).convert("RGB")
    th, tw = cfg.size_tuple
    w, h = img.size
    if (w, h) != (tw, th):
        scale = max(th / h, tw / w)
        img = img.resize((max(tw, round(w * scale)), max(th, round(h * scale))),
                         Image.BICUBIC)
        w, h = img.size
        left, top = max(0, (w - tw) // 2), max(0, (h - th) // 2)
        img = img.crop((left, top, left + tw, top + th))
    return np.asarray(img, dtype=np.uint8)
