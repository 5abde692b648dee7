"""Loss factory and signature-based dispatch (counterpart of
``spatial_clip_tpu.losses``).

:class:`LossFn` names the inputs its loss consumes in ``accepted_args`` and
ignores everything else, so one train step serves every loss; it passes
``group`` (a ``torch.distributed`` process group, the JAX package's
``axis_name``) on. The ``clip``, ``spatial``, ``spatial_ring``, ``siglip``
and ``distill`` kinds are ported; ``coca`` raises NotImplementedError
naming its ROADMAP item.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, FrozenSet

import torch

from spatial_clip_tpu_torch.losses.contrastive import (  # noqa: F401
    build_spatial_soft_labels,
    clip_loss,
    distill_clip_loss,
    gather_features,
    siglip_loss,
    spatial_loss,
)
from spatial_clip_tpu_torch.losses.ring import ring_spatial_loss

_BASE_ARGS = frozenset({"image_features", "text_features", "logit_scale", "logit_bias"})
_SPATIAL_ARGS = _BASE_ARGS | {
    "image_tile_ids",
    "text_tile_ids",
    "neighbor_tile_ids",
    "neighbor_alphas",
}
_DISTILL_ARGS = _BASE_ARGS | {"dist_image_features", "dist_text_features", "dist_logit_scale"}
# kind -> the ROADMAP Queue 1 item that ports it
_UNPORTED = {"coca": 9}


@dataclass(frozen=True)
class LossFn:
    """A loss callable with an explicit keyword contract."""

    name: str
    fn: Callable[..., Dict[str, torch.Tensor]]
    accepted_args: FrozenSet[str]
    options: Dict[str, Any] = field(default_factory=dict)

    def __call__(self, group=None, **kwargs) -> Dict[str, torch.Tensor]:
        picked = {k: v for k, v in kwargs.items() if k in self.accepted_args}
        missing = {a for a in self.accepted_args if a not in picked and a != "logit_bias"}
        if missing:
            raise TypeError(f"loss '{self.name}' missing inputs: {sorted(missing)}")
        return self.fn(**picked) if group is None else self.fn(group=group, **picked)


def make_loss(kind: str = "clip", **options) -> LossFn:
    """Build a loss by name: ``clip``, ``spatial`` (with the JAX package's
    options ``cap_logit_scale``, ``temp_reg_weight``, ``float32_logits``,
    ``neighbor_alpha_scale``, ``use_fused_kernel``), ``spatial_ring``
    (``cap_logit_scale``, ``neighbor_alpha_scale``), ``distill`` (which
    also takes the teacher's ``dist_*`` features) or ``siglip``
    (``dist_impl``)."""
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
    if kind in ("spatial_ring", "ring"):
        fn = functools.partial(
            ring_spatial_loss,
            cap_logit_scale=options.get("cap_logit_scale"),
            neighbor_alpha_scale=float(options.get("neighbor_alpha_scale", 1.0) or 1.0),
        )
        return LossFn("spatial_ring", fn, _SPATIAL_ARGS, options)
    if kind in ("distill", "distill_clip"):
        fn = functools.partial(
            distill_clip_loss, float32_logits=bool(options.get("float32_logits", True)))
        return LossFn("distill", fn, _DISTILL_ARGS, options)
    if kind in ("siglip", "sigmoid"):
        fn = functools.partial(siglip_loss, dist_impl=options.get("dist_impl", "shift"))
        return LossFn("siglip", fn, _BASE_ARGS, options)
    if kind in _UNPORTED:
        raise NotImplementedError(f"loss kind {kind!r} is not ported to spatial_clip_tpu_torch "
                                  f"(ROADMAP Queue 1 item {_UNPORTED[kind]})")
    raise ValueError(f"unknown loss kind: {kind}")
