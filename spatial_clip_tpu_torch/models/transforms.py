"""Image preprocessing: a host stage that crops and resizes to HWC uint8
tiles at the model size, and a device stage that normalizes a uint8 batch.

Counterpart of ``spatial_clip_tpu.models.transforms``. The host stage:
``HostImageTransform`` (train mode: a random resized crop drawn from a
seeded numpy generator; val mode: resize and center-crop; an RGB8 ndarray
already at the model size passes through untouched in val mode),
``image_transform`` (also the server's decode, in val mode). The device
stage: ``normalize_batch``, the train step's fused
``augment_normalize_batch`` with its random draws made apart
(``draw_augment``). Pillow is imported only inside the functions that use
it, so installs without it serve raw tiles and text.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from spatial_clip_tpu_torch.models.constants import OPENAI_DATASET_MEAN, OPENAI_DATASET_STD


@dataclass
class PreprocessCfg:
    size: Union[int, Tuple[int, int]] = 224
    mode: str = "RGB"
    mean: Tuple[float, ...] = OPENAI_DATASET_MEAN
    std: Tuple[float, ...] = OPENAI_DATASET_STD
    interpolation: str = "bicubic"
    resize_mode: str = "shortest"
    fill_color: int = 0

    @property
    def size_tuple(self) -> Tuple[int, int]:
        s = self.size
        return (s, s) if isinstance(s, int) else tuple(s)


@dataclass
class AugmentationCfg:
    """Train-time augmentation knobs of the host transform's random resized
    crop (``scale``, ``ratio``); the rest are carried for the config."""

    scale: Tuple[float, float] = (0.9, 1.0)
    ratio: Tuple[float, float] = (0.75, 1.3333333333333333)
    color_jitter: Optional[float] = None
    gray_scale_prob: Optional[float] = None
    horizontal_flip_prob: float = 0.0
    use_device_augment: bool = True

    @classmethod
    def from_any(cls, cfg) -> "AugmentationCfg":
        if cfg is None:
            return cls()
        if isinstance(cfg, cls):
            return cfg
        if isinstance(cfg, dict):
            d = {k: v for k, v in cfg.items() if k in {f.name for f in dataclasses.fields(cls)}}
            for key in ("scale", "ratio"):
                if key in d and d[key] is not None:
                    d[key] = tuple(d[key])
            return cls(**d)
        raise TypeError(f"Cannot build AugmentationCfg from {type(cfg)}")


def _pil_interp(name: str):
    from PIL import Image

    return {"bilinear": Image.BILINEAR, "nearest": Image.NEAREST}.get(name, Image.BICUBIC)


def _center_crop(img, size: Tuple[int, int]):
    w, h = img.size
    th, tw = size
    left = max(0, (w - tw) // 2)
    top = max(0, (h - th) // 2)
    return img.crop((left, top, left + tw, top + th))


def _resize_shortest(img, size: Tuple[int, int], interp):
    w, h = img.size
    th, tw = size
    scale = max(th / h, tw / w)
    return img.resize((max(tw, round(w * scale)), max(th, round(h * scale))), interp)


def _resize_keep_ratio(img, size: Tuple[int, int], interp, longest: float = 0.0):
    """Aspect-preserving resize between "cover" (``longest=0``: the smaller
    per-axis ratio) and "fit" (``longest=1``: the larger one)."""
    w, h = img.size
    th, tw = size
    ratio_h, ratio_w = h / th, w / tw
    ratio = max(ratio_h, ratio_w) * longest + min(ratio_h, ratio_w) * (1.0 - longest)
    return img.resize((round(w / ratio), round(h / ratio)), interp)


def _center_crop_or_pad(img, size: Tuple[int, int], fill: int = 0):
    """Center-crop to ``size``, padding with ``fill`` where the image is
    smaller than the target."""
    from PIL import Image

    th, tw = size
    w, h = img.size
    if tw > w or th > h:
        pad_left = (tw - w) // 2 if tw > w else 0
        pad_top = (th - h) // 2 if th > h else 0
        nw, nh = max(tw, w), max(th, h)
        canvas = Image.new(img.mode, (nw, nh), tuple([fill] * len(img.getbands())))
        canvas.paste(img, (pad_left, pad_top))
        img = canvas
        w, h = img.size
        if w == tw and h == th:
            return img
    top = int(round((h - th) / 2.0))
    left = int(round((w - tw) / 2.0))
    return img.crop((left, top, left + tw, top + th))


class HostImageTransform:
    """PIL image (or decoded RGB8 ndarray) -> HWC uint8 at the model size.

    Train mode samples a random resized crop as torchvision does
    (log-uniform aspect ratio, uniform area scale, ten tries, then a center
    crop) from ``rng``, a numpy generator seeded with ``seed``; val mode
    resizes by ``cfg.resize_mode`` (``shortest`` then center-crop,
    ``squash``, or ``longest`` then pad) with ``cfg.interpolation``."""

    accepts_ndarray = True

    @property
    def ndarray_fast_size(self):
        """(H, W) for which an RGB8 ndarray input is returned untouched, or
        None (train mode). Loaders decode natively only for this size."""
        if self.is_train or self.cfg.mode != "RGB":
            return None
        return self.cfg.size_tuple

    def __init__(self, cfg: PreprocessCfg, is_train: bool = False,
                 aug: Optional[AugmentationCfg] = None, seed: Optional[int] = None):
        self.cfg = cfg
        self.is_train = is_train
        self.aug = AugmentationCfg.from_any(aug)
        self.rng = np.random.default_rng(seed)

    def crop_box(self, size: Tuple[int, int]) -> Optional[Tuple[int, int, int, int]]:
        """The random resized crop's box (left, top, right, bottom) in an
        image of ``size`` (width, height), drawn from ``rng`` as torchvision
        draws it, or None after ten misses (a center crop follows). The
        draws depend on the size alone."""
        w, h = size
        area = w * h
        lo, hi = self.aug.scale
        rlo, rhi = self.aug.ratio
        for _ in range(10):
            target_area = area * self.rng.uniform(lo, hi)
            aspect = np.exp(self.rng.uniform(np.log(rlo), np.log(rhi)))
            cw = int(round(np.sqrt(target_area * aspect)))
            ch = int(round(np.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                left = int(self.rng.integers(0, w - cw + 1))
                top = int(self.rng.integers(0, h - ch + 1))
                return left, top, left + cw, top + ch
        return None

    def skip(self, size: Tuple[int, int]) -> None:
        """Advances ``rng`` as a call on an image of ``size`` (width,
        height) would, without the image: train mode draws one crop box,
        val mode nothing. A rank of a process group skips so the rows of a
        global batch that other ranks take."""
        if self.is_train:
            self.crop_box(size)

    def _random_resized_crop(self, img, interp):
        th, tw = self.cfg.size_tuple
        box = self.crop_box(img.size)
        if box is not None:
            return img.resize((tw, th), interp, box=box)
        img = _resize_shortest(img, (th, tw), interp)
        return _center_crop(img, (th, tw))

    def __call__(self, img) -> np.ndarray:
        from PIL import Image

        th, tw = self.cfg.size_tuple
        if isinstance(img, np.ndarray):
            if (not self.is_train and self.cfg.mode == "RGB" and img.dtype == np.uint8
                    and img.shape == (th, tw, 3)):
                return img
            img = Image.fromarray(img)
        if img.mode != self.cfg.mode:
            img = img.convert(self.cfg.mode)
        interp = _pil_interp(self.cfg.interpolation)
        if self.is_train:
            img = self._random_resized_crop(img, interp)
        elif img.size != (tw, th):
            mode = self.cfg.resize_mode
            if mode == "squash":
                img = img.resize((tw, th), interp)
            elif mode == "longest":
                img = _resize_keep_ratio(img, (th, tw), interp, longest=1.0)
                img = _center_crop_or_pad(img, (th, tw), fill=self.cfg.fill_color)
            else:
                if mode != "shortest":
                    raise ValueError(f"unknown resize_mode: {mode!r}")
                img = _resize_shortest(img, (th, tw), interp)
                img = _center_crop(img, (th, tw))
        return np.asarray(img, dtype=np.uint8)


def image_transform(image_size: Union[int, Tuple[int, int]] = 224, is_train: bool = False,
                    mean: Tuple[float, ...] = OPENAI_DATASET_MEAN,
                    std: Tuple[float, ...] = OPENAI_DATASET_STD,
                    interpolation: str = "bicubic", resize_mode: str = "shortest",
                    fill_color: int = 0,
                    aug_cfg: Optional[Union[dict, AugmentationCfg]] = None,
                    seed: Optional[int] = None) -> HostImageTransform:
    """The host transform for a model input size, in train or val mode."""
    cfg = PreprocessCfg(size=image_size, mean=tuple(mean), std=tuple(std),
                        interpolation=interpolation, resize_mode=resize_mode,
                        fill_color=fill_color)
    return HostImageTransform(cfg, is_train=is_train, aug=aug_cfg, seed=seed)


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


def skip_draws(preprocess_fn, size: Callable[[], Tuple[int, int]]) -> None:
    """Advances a host transform's random state as its call on one image
    would (``HostImageTransform.skip``), reading the image's (width, height)
    from ``size()`` only when the transform draws: what a dataset's
    ``skip_item`` does for the rows of a global batch that other ranks take."""
    if getattr(preprocess_fn, "is_train", False) and hasattr(preprocess_fn, "skip"):
        preprocess_fn.skip(size())
