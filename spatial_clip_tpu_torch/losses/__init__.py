"""Loss factory and signature-based dispatch (counterpart of
``spatial_clip_tpu.losses``).

:class:`LossFn` names the inputs its loss consumes in ``accepted_args`` and
ignores everything else, so one train step serves every loss; it passes
``group`` (a ``torch.distributed`` process group, the JAX package's
``axis_name``) on. Every kind of the JAX package is ported: ``clip``,
``spatial``, ``spatial_ring``, ``siglip``, ``distill`` and ``coca``.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, FrozenSet, Optional

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
from spatial_clip_tpu_torch.parallel.collectives import mean_over_ranks, rank_size

_BASE_ARGS = frozenset({"image_features", "text_features", "logit_scale", "logit_bias"})
_SPATIAL_ARGS = _BASE_ARGS | {
    "image_tile_ids",
    "text_tile_ids",
    "neighbor_tile_ids",
    "neighbor_alphas",
}
_DISTILL_ARGS = _BASE_ARGS | {"dist_image_features", "dist_text_features", "dist_logit_scale"}
_COCA_ARGS = _BASE_ARGS | {"caption_logits", "caption_labels"}


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
    (``dist_impl``), or ``coca`` (``caption_loss_weight``,
    ``contrastive_loss_weight``, ``pad_id``; it also takes the model's
    ``caption_logits`` and ``caption_labels``)."""
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
    if kind == "coca":
        fn = functools.partial(
            coca_loss, caption_loss_weight=float(options.get("caption_loss_weight", 2.0)),
            contrastive_loss_weight=float(options.get("contrastive_loss_weight", 1.0)),
            pad_id=int(options.get("pad_id", 0)))
        return LossFn("coca", fn, _COCA_ARGS, options)
    raise ValueError(f"unknown loss kind: {kind}")


def coca_loss(image_features: torch.Tensor, text_features: torch.Tensor,
              logit_scale: torch.Tensor, caption_logits: torch.Tensor,
              caption_labels: torch.Tensor, logit_bias: Optional[torch.Tensor] = None,
              group=None, caption_loss_weight: float = 2.0,
              contrastive_loss_weight: float = 1.0, pad_id: int = 0) -> Dict[str, torch.Tensor]:
    """JAX's ``coca`` kind: ``contrastive_loss`` is ``con_w * clip +
    cap_w * caption`` and ``caption_loss`` the caption term, the token CE
    over the non-pad labels (``models.coca.coca_caption_loss``). Under a
    ``group`` the caption term is the global batch's, as the JAX Trainer
    computes it over its global arrays: every rank's summed NLL over every
    rank's count of non-pad labels (with equal counts, the mean of the
    ranks' terms, JAX's ``pmean`` under ``axis_name``)."""
    from spatial_clip_tpu_torch.models.coca import caption_nll, coca_caption_loss

    con = clip_loss(image_features, text_features, logit_scale, logit_bias=logit_bias,
                    group=group)["contrastive_loss"]
    if group is None:
        cap = coca_caption_loss(caption_logits, caption_labels, pad_id)
    else:
        total, count = caption_nll(caption_logits, caption_labels, pad_id)
        count = count.detach().clone()
        torch.distributed.all_reduce(count, group=group)
        cap = mean_over_ranks(total * rank_size(group)[1] / count.clamp_min(1.0), group)
    return {"contrastive_loss": contrastive_loss_weight * con + caption_loss_weight * cap,
            "caption_loss": cap}
