"""The spatial CLIP train step (counterpart of ``spatial_clip_tpu.train.loop``).

One :meth:`Trainer.train_step` does what the JAX package's jitted step does
with ``grad_accum == 1``: normalize (and augment) the uint8 tiles on the
device, run both towers, compute the loss and its gradient, run the AdamW
chain, clamp the logit scale to ``[0, ln 100]``, and return the step
metrics. PyTorch runs eagerly, so there is no jit; the optimizer updates the
state in place. Nothing in a step waits for the device: the metrics come
back as device scalars (``lr`` as a float).

Not ported, and raising NotImplementedError: gradient accumulation,
master weights, a bf16 gradient dtype, optimizers other than AdamW, frozen
towers, a distillation teacher, a device mesh, checkpoints, ``fit`` and
``evaluate``. The JAX package's ``scan_steps`` and ``compiler_options`` are
XLA dispatch knobs with no counterpart here.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field as dfield
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from spatial_clip_tpu_torch.losses import LossFn, make_loss
from spatial_clip_tpu_torch.models.transforms import (
    AugmentDraws,
    augment_normalize_batch,
    draw_augment,
    normalize_batch,
)
from spatial_clip_tpu_torch.train.metrics import recall_at_k
from spatial_clip_tpu_torch.train.optim import AdamW, decay_mask, make_schedule, moment_dtype

LOGIT_SCALE_MAX = math.log(100.0)


@dataclass
class TrainerConfig:
    """The JAX package's TrainerConfig fields and defaults; the ones whose
    feature is not ported raise in :class:`Trainer` unless left at their
    default."""
    learning_rate: float = 5e-4
    weight_decay: float = 0.2
    betas: Tuple[float, float] = (0.9, 0.98)
    eps: float = 1e-6
    grad_clip_norm: Optional[float] = 1.0
    opt: str = "adamw"
    momentum: Optional[float] = None
    master_weights: bool = False
    mu_dtype: Optional[str] = "bf16"
    nu_dtype: Optional[str] = "bf16"
    grad_dtype: Optional[str] = None
    schedule: str = "cosine"
    warmup_steps: int = 500
    total_steps: int = 10_000
    grad_accum: int = 1
    grad_accum_mode: str = "cached"
    augment: bool = True
    horizontal_flip_prob: float = 0.5
    color_jitter: Optional[float] = None
    seed: int = 42
    log_every: int = 10
    ckpt_dir: Optional[str] = None
    save_every_steps: Optional[int] = None
    keep_ckpts: int = 3
    max_logit_scale: float = LOGIT_SCALE_MAX
    frozen_prefixes: Tuple[str, ...] = ()
    monitor: str = "R@1"
    monitor_mode: str = "max"
    step_metrics: str = "full"
    early_stop_patience: Optional[int] = None
    extra: Dict[str, Any] = dfield(default_factory=dict)


def _unported(cfg: TrainerConfig) -> None:
    for name, bad in (
        ("grad_accum", cfg.grad_accum > 1),
        ("master_weights", cfg.master_weights),
        ("grad_dtype", cfg.grad_dtype is not None),
        ("opt", (cfg.opt or "adamw").lower() not in ("adamw", "adam")),
        ("frozen_prefixes", bool(cfg.frozen_prefixes)),
        ("ckpt_dir", cfg.ckpt_dir is not None),
    ):
        if bad:
            raise NotImplementedError(
                f"TrainerConfig.{name}={getattr(cfg, name)!r} is not ported to "
                "spatial_clip_tpu_torch")


def _flat_layout(params: Dict[str, torch.Tensor]):
    """Names in flat-buffer order (the decayed parameters first), each with
    its offset, the total size, and the number of decayed elements."""
    decay = decay_mask(params)
    order = [k for k in params if decay[k]] + [k for k in params if not decay[k]]
    offsets, off = {}, 0
    for k in order:
        offsets[k] = off
        off += params[k].numel()
    n_decay = sum(params[k].numel() for k in order if decay[k])
    return order, offsets, off, n_decay


def _pack(tensors: Dict[str, torch.Tensor], layout, dtype, device, leaf: bool = False):
    """One flat buffer of ``dtype`` holding ``tensors`` at the layout's
    offsets, and views of it under the same names (leaves that require
    grad, for the parameters)."""
    order, offsets, total, _ = layout
    flat = torch.empty(total, dtype=dtype, device=device)
    views = {}
    for k in tensors:
        t = tensors[k]
        v = flat[offsets[k]:offsets[k] + t.numel()].view(t.shape)
        with torch.no_grad():
            v.copy_(t)
        views[k] = v.detach().requires_grad_(True) if leaf else v
    return flat, views


@dataclass
class TrainState:
    """Parameters (f32), Adam moments (in their storage dtypes) and counters.

    ``params``, ``mu`` and ``nu`` map the model's parameter names to views of
    one flat buffer each (``flat``), which the optimizer updates in place.
    ``count`` is Adam's step count, ``step`` the train step's;
    ``generator`` draws the augmentations."""
    step: int
    params: Dict[str, torch.Tensor]
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: int
    generator: torch.Generator
    flat: Dict[str, torch.Tensor]
    n_decay: int
    order: Tuple[str, ...]

    @classmethod
    def create(cls, params: Dict[str, torch.Tensor], mu: Dict[str, torch.Tensor],
               nu: Dict[str, torch.Tensor], count: int = 0, step: int = 0,
               mu_dtype: torch.dtype = torch.bfloat16, nu_dtype: torch.dtype = torch.bfloat16,
               seed: int = 42, device=None) -> "TrainState":
        layout = _flat_layout(params)
        device = torch.device(device) if device is not None else next(iter(params.values())).device
        p_flat, p_views = _pack(params, layout, torch.float32, device, leaf=True)
        m_flat, m_views = _pack(mu, layout, mu_dtype, device)
        n_flat, n_views = _pack(nu, layout, nu_dtype, device)
        return cls(step=step, params=p_views, mu=m_views, nu=n_views, count=count,
                   generator=torch.Generator(device=device).manual_seed(seed),
                   flat={"params": p_flat, "mu": m_flat, "nu": n_flat},
                   n_decay=layout[3], order=tuple(layout[0]))

    def by_name(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Views of a flat buffer laid out as ``flat['params']`` (such as the
        gradient of :meth:`Trainer.forward_backward`), by parameter name."""
        sizes = [self.params[k].numel() for k in self.order]
        return {k: v.view(self.params[k].shape)
                for k, v in zip(self.order, flat.split(sizes))}


class Trainer:
    """Train step over a CLIP model built with ``create_model(...,
    training=True)`` (f32 parameters, train mode, grad on).

    Batches are dicts of tensors on the model's device with the JAX
    package's schema: ``images`` (B, H, W, 3) uint8 (or already normalized
    floats), ``texts`` (B, L) token ids, ``image_tile_ids``,
    ``text_tile_ids`` (B,), ``neighbor_tile_ids`` (B, k) (-1 pads),
    ``neighbor_alphas`` (B, k)."""

    def __init__(self, model: nn.Module, loss: Optional[LossFn] = None,
                 config: Optional[TrainerConfig] = None, mesh=None, teacher=None):
        if mesh is not None or teacher is not None:
            raise NotImplementedError(
                "a device mesh and a distillation teacher are not ported to "
                "spatial_clip_tpu_torch")
        params = dict(model.named_parameters())
        if not model.training or any(
                p.dtype != torch.float32 or not p.requires_grad for p in params.values()):
            raise ValueError("the trainer takes a model with float32 parameters that require "
                             "grad, in train mode: create_model(..., training=True)")
        self.model = model
        self.loss = loss or make_loss("clip")
        self.cfg = config or TrainerConfig()
        _unported(self.cfg)
        cfg = self.cfg
        self.schedule = make_schedule(cfg.schedule, cfg.learning_rate, cfg.warmup_steps,
                                      cfg.total_steps, **(cfg.extra.get("schedule_kwargs") or {}))
        self.optimizer = AdamW(self.schedule, cfg.weight_decay, cfg.betas, cfg.eps,
                               cfg.grad_clip_norm)
        self.mu_dtype, self.nu_dtype = moment_dtype(cfg.mu_dtype), moment_dtype(cfg.nu_dtype)

    def init_state(self) -> TrainState:
        """The model's current parameters (copied), zero moments, step 0."""
        params = {k: p.detach() for k, p in self.model.named_parameters()}
        zeros = {k: torch.zeros_like(p) for k, p in params.items()}
        return TrainState.create(params, zeros, zeros, mu_dtype=self.mu_dtype,
                                 nu_dtype=self.nu_dtype, seed=self.cfg.seed)

    def prepare_images(self, images: torch.Tensor, generator: Optional[torch.Generator] = None,
                       draws: Optional[AugmentDraws] = None) -> torch.Tensor:
        """uint8 tiles -> normalized model input on the device, augmented
        when the config says so (with ``draws``, or new ones from
        ``generator``). Float images are only cast."""
        model, cfg = self.model, self.cfg
        if images.dtype != torch.uint8:
            return images.to(model.dtype)
        pp = model.preprocess_cfg
        if not cfg.augment:
            return normalize_batch(images, pp.mean, pp.std, model.dtype)
        if draws is None:
            draws = draw_augment(images.shape[0], cfg.horizontal_flip_prob, cfg.color_jitter,
                                 generator=generator, device=images.device)
        return augment_normalize_batch(images, draws, pp.mean, pp.std, model.dtype)

    def forward_backward(self, state: TrainState, batch: Dict[str, torch.Tensor],
                         draws: Optional[AugmentDraws] = None):
        """Loss, in-batch logits and the flat f32 gradient (laid out as
        ``state.flat['params']``) of one batch at the state's parameters."""
        images = self.prepare_images(batch["images"], state.generator, draws)
        features = functional_call(self.model, state.params, (images, batch["texts"]))
        loss = self.loss(**{**batch, **features})["contrastive_loss"]
        grads = torch.autograd.grad(loss, [state.params[k] for k in state.order],
                                    materialize_grads=True)  # zeros for an unused parameter
        flat_grad = torch.cat([g.reshape(-1) for g in grads])
        with torch.no_grad():
            logits = (features["image_features"] @ features["text_features"].T
                      ) * features["logit_scale"]
        return loss.detach(), logits, flat_grad

    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor],
                   draws: Optional[AugmentDraws] = None) -> Tuple[TrainState, Dict[str, Any]]:
        """One optimizer step; updates ``state`` in place and returns it with
        the step metrics: ``loss``, ``logit_scale`` (exp of the clamped
        parameter), ``lr`` (the schedule at the step before the update),
        and unless ``step_metrics='light'`` ``grad_norm`` (before clipping)
        and in-batch ``R@1/5/10``."""
        cfg = self.cfg
        loss, logits, grads = self.forward_backward(state, batch, draws)
        metrics: Dict[str, Any] = {"loss": loss}
        flat = state.flat
        state.count, grad_norm = self.optimizer.update(
            flat["params"], grads, flat["mu"], flat["nu"], state.count, state.n_decay)
        with torch.no_grad():
            logit_scale = state.params["logit_scale"]
            logit_scale.clamp_(0.0, cfg.max_logit_scale)
            metrics["logit_scale"] = logit_scale.exp()
        metrics["lr"] = self.schedule(state.step)
        if cfg.step_metrics != "light":
            metrics["grad_norm"] = grad_norm
            targets = torch.arange(logits.shape[0], device=logits.device)
            for k in (1, 5, 10):
                metrics[f"R@{k}"] = recall_at_k(logits, targets, k)
        state.step += 1
        return state, metrics

    def fit(self, *args, **kwargs):
        raise NotImplementedError("Trainer.fit is not ported to spatial_clip_tpu_torch")

    def evaluate(self, *args, **kwargs):
        raise NotImplementedError("Trainer.evaluate is not ported to spatial_clip_tpu_torch")
