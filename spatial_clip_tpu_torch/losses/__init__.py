"""Loss factory and signature-based dispatch (counterpart of
``spatial_clip_tpu.losses``).

:class:`LossFn` names the inputs its loss consumes in ``accepted_args`` and
ignores everything else, so one train step serves every loss. The ``clip``
and ``spatial`` kinds are ported; every other kind raises
NotImplementedError.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, FrozenSet

import torch

from spatial_clip_tpu_torch.losses.contrastive import (  # noqa: F401
    build_spatial_soft_labels,
    clip_loss,
    spatial_loss,
)

_BASE_ARGS = frozenset({"image_features", "text_features", "logit_scale", "logit_bias"})
_SPATIAL_ARGS = _BASE_ARGS | {
    "image_tile_ids",
    "text_tile_ids",
    "neighbor_tile_ids",
    "neighbor_alphas",
}
_UNPORTED = ("spatial_ring", "ring", "coca", "distill", "distill_clip", "siglip", "sigmoid")


@dataclass(frozen=True)
class LossFn:
    """A loss callable with an explicit keyword contract."""

    name: str
    fn: Callable[..., Dict[str, torch.Tensor]]
    accepted_args: FrozenSet[str]
    options: Dict[str, Any] = field(default_factory=dict)

    def __call__(self, **kwargs) -> Dict[str, torch.Tensor]:
        picked = {k: v for k, v in kwargs.items() if k in self.accepted_args}
        missing = {a for a in self.accepted_args if a not in picked and a != "logit_bias"}
        if missing:
            raise TypeError(f"loss '{self.name}' missing inputs: {sorted(missing)}")
        return self.fn(**picked)


def make_loss(kind: str = "clip", **options) -> LossFn:
    """Build a loss by name: ``clip`` or ``spatial`` (with the JAX package's
    options ``cap_logit_scale``, ``temp_reg_weight``, ``float32_logits``,
    ``neighbor_alpha_scale``, ``use_fused_kernel``)."""
    kind = kind.lower()
    if kind in ("clip", "cliploss"):
        fn = functools.partial(
            clip_loss, float32_logits=bool(options.get("float32_logits", True)))
        return LossFn("clip", fn, _BASE_ARGS, options)
    if kind in ("spatial", "spatial_multi_positive", "globalmappingmultipositive"):
        fn = functools.partial(
            spatial_loss,
            cap_logit_scale=options.get("cap_logit_scale"),
            temp_reg_weight=float(options.get("temp_reg_weight", 0.0) or 0.0),
            float32_logits=bool(options.get("float32_logits", True)),
            neighbor_alpha_scale=float(options.get("neighbor_alpha_scale", 1.0) or 1.0),
            use_fused_kernel=bool(options.get("use_fused_kernel", False)),
        )
        return LossFn("spatial", fn, _SPATIAL_ARGS, options)
    if kind in _UNPORTED:
        raise NotImplementedError(f"loss kind {kind!r} is not ported to spatial_clip_tpu_torch")
    raise ValueError(f"unknown loss kind: {kind}")
