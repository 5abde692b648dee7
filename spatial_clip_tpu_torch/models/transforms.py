"""Image preprocessing: a host stage that decodes to HWC uint8 tiles at the
model size, and a device stage that normalizes a uint8 batch.

Counterpart of ``spatial_clip_tpu.models.transforms`` for the serving path:
``normalize_batch`` and the eval-mode host transform (resize the shortest
side, bicubic, then center-crop). Pillow is imported only where an encoded
image is decoded, so installs without it serve raw tiles and text.
"""
from __future__ import annotations

import io
from dataclasses import dataclass
from typing import Sequence, Tuple, Union

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
