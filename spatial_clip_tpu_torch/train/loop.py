"""The spatial CLIP trainer (counterpart of ``spatial_clip_tpu.train.loop``).

One :meth:`Trainer.train_step` does what the JAX package's jitted step does:
normalize (and augment) the uint8 tiles on the device, run both towers,
compute the loss and its gradient (with ``grad_accum > 1``, accumulated over
microbatches in ``cached`` or ``simple`` mode), run the optimizer chain
(``opt``: AdamW, SGD or Lion; ``frozen_prefixes`` lock parameters, LiT
style), clamp the logit scale to ``[0, ln 100]``, and return the step
metrics. With a distillation ``teacher`` (a frozen model), the loss also
takes the teacher's features of the same batch, normalized with the
teacher's mean and std and never augmented, as in the JAX package.
:meth:`Trainer.fit` drives it over iterators of numpy batches with
validation and checkpoints (``ckpt_dir``: a save every ``save_every_steps``,
on each new best ``monitor`` value and at each epoch's end, the newest
``keep_ckpts`` kept; ``fit(resume=...)`` restores the newest or a given
step, as the JAX package's fit does), and :meth:`Trainer.evaluate` computes
the full-split retrieval metrics. PyTorch runs eagerly, so there is no jit;
the optimizer updates the state in place. Nothing in a step waits for the
device: the metrics come back as device scalars (``lr`` as a float).

``debug_nans`` is the port's ``jax_debug_nans``: a step whose loss or
gradient holds a NaN raises FloatingPointError naming the step (an Inf
passes).

``mesh`` (:func:`spatial_clip_tpu_torch.parallel.mesh.make_mesh`) trains
data-parallel over a ``torch.distributed`` group, one process per device,
with the JAX Trainer's global semantics: each rank holds its rows of the
global batch (rank r the rows ``[r b, (r + 1) b)``), the loss scores them
against every rank's columns and returns the global loss, and each step's
flat gradient is all-reduced and averaged once, in a fixed order over the
whole buffer, before clipping, so every rank holds the same parameter bits
after every step. The parameters start as rank 0's. The host's random draws
(augmentation, gene dropout) are made for the global batch from the
generator every rank seeds alike, and each rank takes its rows, so a
P-rank step is the one-process step on the global batch. The metrics are
the global ones; only rank 0 logs and writes checkpoints.

Not ported, and raising NotImplementedError: master weights, a bf16
gradient dtype (ROADMAP Queue 1 item 4) and a mesh with a ``model`` axis
(item 7). The JAX package's ``scan_steps`` and ``compiler_options`` are XLA
dispatch knobs with no counterpart here.
"""
from __future__ import annotations

import logging
import math
import time
from dataclasses import dataclass, field as dfield
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.func import functional_call

from spatial_clip_tpu_torch.losses import LossFn, make_loss
from spatial_clip_tpu_torch.models.hf_model import DropoutDraws
from spatial_clip_tpu_torch.models.transforms import (
    AugmentDraws,
    augment_normalize_batch,
    draw_augment,
    normalize_batch,
)
from spatial_clip_tpu_torch.parallel.collectives import all_gather, rank_size
from spatial_clip_tpu_torch.train.checkpoints import CheckpointManager
from spatial_clip_tpu_torch.train.metrics import (
    ContrastiveMetrics,
    clip_retrieval_metrics,
    recall_at_k,
)
from spatial_clip_tpu_torch.train.optim import (
    decay_mask,
    freeze_mask,
    make_optimizer,
    make_schedule,
    moment_dtype,
)

log = logging.getLogger(__name__)

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
    debug_nans: bool = False
    extra: Dict[str, Any] = dfield(default_factory=dict)


def _unported(cfg: TrainerConfig) -> None:
    if cfg.grad_accum_mode not in ("cached", "simple"):
        raise ValueError(f"grad_accum_mode must be 'cached' or 'simple'; got "
                         f"{cfg.grad_accum_mode!r}")
    for name, bad in (
        ("master_weights", cfg.master_weights),
        ("grad_dtype", cfg.grad_dtype is not None),
    ):
        if bad:
            raise NotImplementedError(
                f"TrainerConfig.{name}={getattr(cfg, name)!r} is not ported to "
                "spatial_clip_tpu_torch (ROADMAP Queue 1 item 4)")


_ALIGN = 4  # f32 elements: every parameter's view starts on a 16-byte boundary


def _flat_layout(params: Dict[str, torch.Tensor], frozen=frozenset()):
    """Names in flat-buffer order (the decayed parameters first), each with
    its offset, the total size, the number of elements up to the end of
    the last decayed parameter, and the ``[start, end)`` range that holds
    the ``frozen`` ones (they close the decayed part and open the rest, so
    one range holds them all; (0, 0) with none). Offsets are rounded up to
    ``_ALIGN`` elements, so the kernels can read 16-byte vectors of any
    parameter; the gaps hold zeros in every flat buffer."""
    decay = decay_mask(params)
    order = ([k for k in params if decay[k] and k not in frozen]
             + [k for k in params if decay[k] and k in frozen]
             + [k for k in params if not decay[k] and k in frozen]
             + [k for k in params if not decay[k] and k not in frozen])
    offsets, off, n_decay, frozen_start, frozen_end = {}, 0, 0, None, 0
    for k in order:
        off = -(-off // _ALIGN) * _ALIGN
        offsets[k] = off
        off += params[k].numel()
        if decay[k]:
            n_decay = off
        if k in frozen:
            frozen_start = offsets[k] if frozen_start is None else frozen_start
            frozen_end = off
    return order, offsets, off, n_decay, (frozen_start or 0, frozen_end)


def _pack(tensors: Dict[str, torch.Tensor], layout, dtype, device, leaf: bool = False):
    """One flat buffer of ``dtype`` holding ``tensors`` at the layout's
    offsets, and views of it under the same names (leaves that require
    grad, for the parameters)."""
    order, offsets, total = layout[:3]
    flat = torch.zeros(total, dtype=dtype, device=device)
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
    """Parameters (f32), the optimizer's moments (in their storage dtypes)
    and counters.

    ``params``, ``mu`` and ``nu`` map the model's parameter names to views of
    one flat buffer each (``flat``), which the optimizer updates in place.
    An optimizer with one moment (SGD's trace, Lion's moment) keeps it in
    ``mu``; its ``nu`` is empty (``flat['nu']`` has no element).
    ``count`` is the optimizer's step count, ``step`` the train step's;
    ``generator`` draws the augmentations; ``frozen`` is the flat range of
    the locked parameters."""
    step: int
    params: Dict[str, torch.Tensor]
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: int
    generator: torch.Generator
    flat: Dict[str, torch.Tensor]
    n_decay: int
    order: Tuple[str, ...]
    offsets: Dict[str, int]
    frozen: Tuple[int, int] = (0, 0)

    @classmethod
    def create(cls, params: Dict[str, torch.Tensor], mu: Dict[str, torch.Tensor],
               nu: Optional[Dict[str, torch.Tensor]], count: int = 0, step: int = 0,
               mu_dtype: torch.dtype = torch.bfloat16, nu_dtype: torch.dtype = torch.bfloat16,
               seed: int = 42, device=None, frozen: Iterable[str] = ()) -> "TrainState":
        """``nu`` None: an optimizer with one moment. ``frozen``: the names
        of the locked parameters."""
        layout = _flat_layout(params, frozenset(frozen))
        device = torch.device(device) if device is not None else next(iter(params.values())).device
        p_flat, p_views = _pack(params, layout, torch.float32, device, leaf=True)
        m_flat, m_views = _pack(mu, layout, mu_dtype, device)
        if nu is None:
            n_flat, n_views = torch.zeros(0, dtype=nu_dtype, device=device), {}
        else:
            n_flat, n_views = _pack(nu, layout, nu_dtype, device)
        return cls(step=step, params=p_views, mu=m_views, nu=n_views, count=count,
                   generator=torch.Generator(device=device).manual_seed(seed),
                   flat={"params": p_flat, "mu": m_flat, "nu": n_flat},
                   n_decay=layout[3], order=tuple(layout[0]), offsets=layout[1],
                   frozen=layout[4])

    def by_name(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Views of a flat buffer laid out as ``flat['params']`` (such as the
        gradient of :meth:`Trainer.forward_backward`), by parameter name."""
        return {k: flat[self.offsets[k]:self.offsets[k] + p.numel()].view(p.shape)
                for k, p in ((k, self.params[k]) for k in self.order)}

    def flatten(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """One flat buffer laid out as ``flat['params']`` from a tensor per
        parameter, in ``order``, with zeros in the alignment gaps."""
        zeros = tensors[0].new_zeros(_ALIGN - 1)
        pieces, end = [], 0
        for k, t in zip(self.order, tensors):
            if self.offsets[k] > end:
                pieces.append(zeros[:self.offsets[k] - end])
            pieces.append(t.reshape(-1))
            end = self.offsets[k] + t.numel()
        return torch.cat(pieces)


class Trainer:
    """Train step over a CLIP or CoCa model built with ``create_model(...,
    training=True)`` (f32 parameters, train mode, grad on); CoCa trains with
    the ``coca`` loss, which also takes its caption logits.

    Batches have the JAX package's schema: ``images`` (B, H, W, 3) uint8
    (or already normalized floats), ``texts`` (B, L) token ids (for a
    model with a Gene-MLP tower, (B, num_genes) float gene vectors),
    ``image_tile_ids``, ``text_tile_ids`` (B,), ``neighbor_tile_ids`` (B, k)
    (-1 pads), ``neighbor_alphas`` (B, k): tensors on the model's device
    for :meth:`train_step`, numpy arrays for :meth:`fit` and
    :meth:`evaluate`.

    ``teacher``: a frozen CLIP model (``create_model(...)`` without
    ``training``: eval mode, no grad) on the same device, whose features
    the ``distill`` loss takes.

    ``mesh``: a data mesh (``parallel.mesh.make_mesh``) over which this
    process trains data-parallel; the model lives on the mesh's device and
    the batches hold this rank's rows of the global batch."""

    def __init__(self, model: nn.Module, loss: Optional[LossFn] = None,
                 config: Optional[TrainerConfig] = None, mesh=None, teacher=None):
        if mesh is not None and model.logit_scale.device != mesh.device:
            raise ValueError(f"the model is on {model.logit_scale.device}, the mesh's device is "
                             f"{mesh.device}")
        self.group = mesh.group if mesh is not None else None
        self.rank, self.world = rank_size(self.group)
        if teacher is not None and (teacher.training or any(
                p.requires_grad for p in teacher.parameters())):
            raise ValueError("the teacher is a frozen model in eval mode: create_model(...) "
                             "without training=True")
        params = dict(model.named_parameters())
        if not model.training or any(
                p.dtype != torch.float32 or not p.requires_grad for p in params.values()):
            raise ValueError("the trainer takes a model with float32 parameters that require "
                             "grad, in train mode: create_model(..., training=True)")
        self.model, self.teacher = model, teacher
        self.loss = loss or make_loss("clip")
        self.cfg = config or TrainerConfig()
        _unported(self.cfg)
        cfg = self.cfg
        self.schedule = make_schedule(cfg.schedule, cfg.learning_rate, cfg.warmup_steps,
                                      cfg.total_steps, **(cfg.extra.get("schedule_kwargs") or {}))
        self.optimizer = make_optimizer(cfg.opt, self.schedule, cfg.weight_decay, cfg.betas,
                                        cfg.eps, cfg.grad_clip_norm, cfg.momentum)
        if self.optimizer.moments == ("mu", "nu"):
            self.mu_dtype, self.nu_dtype = moment_dtype(cfg.mu_dtype), moment_dtype(cfg.nu_dtype)
        else:  # the JAX Trainer's moment dtypes reach only its AdamW: optax's f32
            self.mu_dtype = self.nu_dtype = torch.float32
        frozen = freeze_mask(params, cfg.frozen_prefixes) if cfg.frozen_prefixes else {}
        self.frozen = frozenset(k for k, f in frozen.items() if f)
        self.ckpt = (CheckpointManager(cfg.ckpt_dir, keep=cfg.keep_ckpts, rank=self.rank,
                                       group=self.group) if cfg.ckpt_dir else None)
        self.loss_extras: Dict[str, torch.Tensor] = {}

    def init_state(self) -> TrainState:
        """The model's current parameters (copied; under a mesh, rank 0's),
        zero moments, step 0."""
        params = {k: p.detach() for k, p in self.model.named_parameters()}
        zeros = {k: torch.zeros_like(p) for k, p in params.items()}
        state = TrainState.create(params, zeros, zeros if "nu" in self.optimizer.moments else None,
                                  mu_dtype=self.mu_dtype, nu_dtype=self.nu_dtype,
                                  seed=self.cfg.seed, frozen=self.frozen)
        if self.group is not None:
            dist.broadcast(state.flat["params"], src=dist.get_global_rank(self.group, 0),
                           group=self.group)
        return state

    def _my_rows(self, x: Optional[torch.Tensor], rows: int) -> Optional[torch.Tensor]:
        """This rank's ``rows`` rows of a global-batch tensor."""
        return None if x is None else x[self.rank * rows:(self.rank + 1) * rows]

    def prepare_images(self, images: torch.Tensor,
                       draws: Optional[AugmentDraws] = None) -> torch.Tensor:
        """uint8 tiles -> normalized model input on the device, augmented
        with ``draws`` when given. Float images are only cast."""
        model = self.model
        if images.dtype != torch.uint8:
            return images.to(model.dtype)
        pp = model.preprocess_cfg
        if draws is None:
            return normalize_batch(images, pp.mean, pp.std, model.dtype)
        return augment_normalize_batch(images, draws, pp.mean, pp.std, model.dtype)

    def _features(self, params, batch, draws: Optional[AugmentDraws],
                  gene_keep: Optional[torch.Tensor] = None, text_seed: Optional[int] = None,
                  part: int = 0) -> Dict[str, torch.Tensor]:
        images = self.prepare_images(batch["images"], draws)
        kwargs = {"gene_keep": gene_keep}
        if text_seed is not None:  # microbatch `part`'s dropout, this rank's rows of it
            kwargs["text_dropout"] = DropoutDraws(text_seed * 64 + part,
                                                  self.rank * batch["texts"].shape[0])
        features = functional_call(self.model, params, (images, batch["texts"]), kwargs)
        if self.teacher is not None:
            features.update(self._teacher_features(batch))
        return features

    def _teacher_features(self, batch) -> Dict[str, torch.Tensor]:
        """The teacher's features of the batch without grad: its own mean
        and std, no augmentation (so its attention takes the inference
        forward)."""
        t, images = self.teacher, batch["images"]
        with torch.no_grad():
            if images.dtype == torch.uint8:
                images = normalize_batch(images, t.preprocess_cfg.mean, t.preprocess_cfg.std,
                                         t.dtype)
            out = t(images.to(t.dtype), batch["texts"])
        return {"dist_image_features": out["image_features"],
                "dist_text_features": out["text_features"],
                "dist_logit_scale": out["logit_scale"]}

    def _loss(self, inputs) -> torch.Tensor:
        """The loss's ``contrastive_loss`` (under a mesh, the global loss);
        what else it returns (the distill loss's ``distill_loss``) goes to
        ``loss_extras``, detached."""
        out = self.loss(group=self.group, **inputs)
        self.loss_extras = {k: v.detach() for k, v in out.items() if k != "contrastive_loss"}
        return out["contrastive_loss"]

    def draw_gene_keep(self, state: TrainState, texts: torch.Tensor) -> Optional[torch.Tensor]:
        """The training step's gene-dropout mask over ``texts`` (B,
        num_genes), drawn from the state's generator (under a mesh, for the
        global batch, of which this rank takes its rows), or None where the
        model has no Gene-MLP tower with ``gene_dropout`` > 0. JAX draws it
        only in a training step (``rngs={'dropout': ...}``); evaluation
        keeps every gene."""
        tower = self.model.text
        if tower is None or not getattr(tower, "gene_dropout", 0) > 0:
            return None
        rows = texts.shape[0]
        keep = tower.draw_keep((rows * self.world, *texts.shape[1:]), state.generator,
                               texts.device)
        return self._my_rows(keep, rows)

    def text_dropout_seed(self, state: TrainState) -> Optional[int]:
        """The seed of a Hugging Face text tower's dropout masks in this
        training step (``hf_model.DropoutDraws``), or None where the model
        has no such tower or its rates are 0: the config's seed and the
        step, so that a step draws the same masks on the card and on the
        CPU, and ``grad_accum``'s two passes over a microbatch the same
        ones. JAX applies the encoders with ``deterministic=False`` in a
        training step, and with its own generator's masks."""
        model = self.model
        if not getattr(model, "hf_text", False) or not any(model.text.dropout_rates):
            return None
        return (self.cfg.seed * 1_000_003 + state.step) & 0xFFFFFFFF

    def _flat_grad(self, state: TrainState, loss: torch.Tensor) -> torch.Tensor:
        if self.cfg.debug_nans and torch.isnan(loss).item():
            raise FloatingPointError(f"NaN loss at step {state.step}")
        try:
            grads = torch.autograd.grad(loss, [state.params[k] for k in state.order],
                                        materialize_grads=True)  # zeros for an unused parameter
        except RuntimeError as e:  # anomaly mode names the backward function that made a NaN
            if self.cfg.debug_nans and "nan" in str(e).lower():
                raise FloatingPointError(f"NaN in the backward at step {state.step}: {e}") from e
            raise
        return state.flatten(grads)

    def _logits(self, img: torch.Tensor, txt: torch.Tensor, logit_scale: torch.Tensor):
        """In-batch logits over the global batch (every rank's features)."""
        with torch.no_grad():
            return (all_gather(img, self.group) @ all_gather(txt, self.group).T) * logit_scale

    def forward_backward(self, state: TrainState, batch: Dict[str, torch.Tensor],
                         draws: Optional[AugmentDraws] = None, logits: bool = True):
        """Loss, in-batch logits and the flat f32 gradient (laid out as
        ``state.flat['params']``) of one batch at the state's parameters;
        under a mesh the global ones: the logits over the global batch, the
        gradient the ranks' mean. ``logits=False`` returns None in their
        place and skips their product (under a mesh, their all-gathers).

        When the config augments, the augmentation draws (``draws``, or new
        ones from the state's generator) cover the whole batch (under a mesh
        the global batch, of which each rank takes its rows); with
        ``grad_accum > 1`` each microbatch takes its rows of them (a loss
        that takes the caption logits, ``coca``, raises a TypeError in
        ``cached`` mode, whose full-batch loss has only the features, as
        JAX's ``_cached_accum_grads`` does). ``cached`` mode: pass 1 embeds
        every microbatch without grad; pass 2 re-embeds one microbatch at a
        time with grad, splices its features into the cached (B, D)
        matrices and backprops the full-batch loss, adding the gradients in
        f32. As in the JAX package, the logit scale's gradient is thereby
        summed ``grad_accum`` times, the loss is the last microbatch's, and
        the logits cover the full batch. ``simple`` mode averages the
        microbatches' gradients and losses; the logits are the last
        microbatch's (under a mesh each loss scores the ranks' j-th
        microbatches together, where one process scores the global batch's
        j-th). A Gene-MLP tower's gene-dropout mask
        (:meth:`draw_gene_keep`) is drawn after the augmentation, for the
        whole batch; each microbatch takes its rows in both passes."""
        cfg = self.cfg
        images = batch["images"]
        rows = images.shape[0]
        if not (cfg.augment and images.dtype == torch.uint8):
            draws = None
        else:
            if draws is None:
                draws = draw_augment(rows * self.world, cfg.horizontal_flip_prob,
                                     cfg.color_jitter, generator=state.generator,
                                     device=images.device)
            draws = AugmentDraws(*(self._my_rows(d, rows) for d in draws))
        keep = self.draw_gene_keep(state, batch["texts"])
        seed = self.text_dropout_seed(state)
        accum = max(1, cfg.grad_accum)
        if accum == 1:
            features = self._features(state.params, batch, draws, keep, seed)
            loss = self._loss({**batch, **features})
            grads = self._flat_grad(state, loss)
            img, txt, scale = (features["image_features"], features["text_features"],
                               features["logit_scale"])
        elif rows % accum:
            raise ValueError(f"batch of {rows} does not split into grad_accum={accum} "
                             "microbatches")
        else:
            mb = rows // accum
            parts = [slice(j * mb, (j + 1) * mb) for j in range(accum)]
            mbs = [{k: v[sl] for k, v in batch.items()} for sl in parts]
            mb_draws = [None if draws is None else AugmentDraws(
                *(None if d is None else d[sl] for d in draws)) for sl in parts]
            mb_keep = [None if keep is None else keep[sl] for sl in parts]
            if cfg.grad_accum_mode == "simple":
                loss, (img, txt, scale), grads = self._simple_accum(state, mbs, mb_draws, mb_keep,
                                                                    seed)
            elif self.teacher is not None:  # as in JAX, whose cached pass never calls the teacher
                raise NotImplementedError("a distillation teacher under grad_accum > 1 takes "
                                          "grad_accum_mode='simple'")
            else:
                loss, (img, txt, scale), grads = self._cached_accum(state, batch, mbs, mb_draws,
                                                                    mb_keep, parts, seed)
        if self.group is not None:  # once a step, the whole buffer in one fixed-order reduce
            dist.all_reduce(grads, op=dist.ReduceOp.SUM, group=self.group)
            grads.div_(self.world)
        return loss.detach(), self._logits(img, txt, scale) if logits else None, grads

    def _cached_accum(self, state, batch, mbs, mb_draws, mb_keep, parts, seed=None):
        with torch.no_grad():  # pass 1: attention takes the inference kernel
            feats = [self._features(state.params, m, d, k, seed, j)
                     for j, (m, d, k) in enumerate(zip(mbs, mb_draws, mb_keep))]
        all_img = torch.cat([f["image_features"] for f in feats])
        all_txt = torch.cat([f["text_features"] for f in feats])
        del feats
        grads = None
        for j, (m, d, k, sl) in enumerate(zip(mbs, mb_draws, mb_keep, parts)):
            f = self._features(state.params, m, d, k, seed, j)
            inputs = {
                **batch,
                "image_features": all_img.slice_scatter(
                    f["image_features"].to(all_img.dtype), 0, sl.start, sl.stop),
                "text_features": all_txt.slice_scatter(
                    f["text_features"].to(all_txt.dtype), 0, sl.start, sl.stop),
                "logit_scale": f["logit_scale"],
            }
            if "logit_bias" in f:
                inputs["logit_bias"] = f["logit_bias"]
            loss = self._loss(inputs)
            g = self._flat_grad(state, loss)
            grads = g if grads is None else grads.add_(g)
        return loss, (all_img, all_txt, state.params["logit_scale"].exp()), grads

    def _simple_accum(self, state, mbs, mb_draws, mb_keep, seed=None):
        grads = loss_sum = None
        for j, (m, d, k) in enumerate(zip(mbs, mb_draws, mb_keep)):
            features = self._features(state.params, m, d, k, seed, j)
            loss = self._loss({**m, **features})
            g = self._flat_grad(state, loss)
            grads = g if grads is None else grads.add_(g)
            loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
        last = (features["image_features"], features["text_features"], features["logit_scale"])
        return loss_sum / len(mbs), last, grads.div_(len(mbs))

    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor],
                   draws: Optional[AugmentDraws] = None) -> Tuple[TrainState, Dict[str, Any]]:
        """One optimizer step; updates ``state`` in place and returns it with
        the step metrics (under a mesh, the global ones): ``loss``, what
        else the loss returned (the distill loss's ``distill_loss``; with
        ``grad_accum > 1`` the last microbatch's), ``logit_scale`` (exp of
        the clamped parameter), ``lr`` (the schedule at the step before the
        update), and unless ``step_metrics='light'`` ``grad_norm`` (before
        clipping) and in-batch ``R@1/5/10``."""
        cfg = self.cfg
        loss, logits, grads = self.forward_backward(state, batch, draws,
                                                    logits=cfg.step_metrics != "light")
        if cfg.debug_nans and torch.isnan(grads).any().item():
            raise FloatingPointError(f"NaN gradient at step {state.step}")
        metrics: Dict[str, Any] = {"loss": loss, **self.loss_extras}
        flat = state.flat
        state.count, grad_norm = self.optimizer.update(
            flat["params"], grads, flat["mu"], flat["nu"], state.count, state.n_decay,
            state.frozen)
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

    # ------------------------------------------------------------------- fit
    def _device_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The batch's numpy arrays (not ``raw_text``) on the model's device,
        copied from pinned memory without blocking the host when that
        device is a GPU."""
        device = self.model.logit_scale.device
        out = {}
        for k, v in batch.items():
            if not isinstance(v, np.ndarray) or k == "raw_text":
                continue
            t = torch.from_numpy(v)
            out[k] = (t.pin_memory().to(device, non_blocking=True) if device.type == "cuda"
                      else t.to(device))
        return out

    def fit(self, train_iter_factory: Callable[[], Iterable[Dict[str, Any]]],
            val_iter_factory: Optional[Callable[[], Iterable[Dict[str, Any]]]] = None,
            epochs: int = 1, steps_per_epoch: Optional[int] = None,
            state: Optional[TrainState] = None, logger=None,
            resume: Optional[str] = None) -> Tuple[TrainState, Dict[str, float]]:
        """Train for ``epochs`` passes over ``train_iter_factory()`` (numpy
        batches; at most ``steps_per_epoch`` each), evaluating on
        ``val_iter_factory()`` after each epoch. Metrics are read back every
        ``log_every`` steps, with ``epoch``, ``pairs_per_sec`` and
        ``pairs_per_sec_per_chip`` over the steps since the last read; the
        ``monitor`` metric picks ``best_step`` and drives early stopping.
        With ``ckpt_dir``, the state is saved every ``save_every_steps``
        steps, at each new best ``monitor`` value and at each epoch's end
        (those two with the last metrics), and the last write is waited for
        before returning. ``resume`` ("latest" or a step number) restores a
        checkpoint first, or starts fresh when there is none; as in the JAX
        package, the epochs then run from the first, on the iterators the
        factories give. Returns the state and the last metrics (``val/``
        keys included). Under a mesh every rank runs ``fit`` on its rows of
        the same global batches; ``pairs_per_sec`` counts the global batch,
        ``pairs_per_sec_per_chip`` divides it by the ranks, only rank 0
        logs, and the checkpoint calls are collective (rank 0 writes)."""
        state = state if state is not None else self.init_state()
        if resume and self.ckpt:
            try:
                state, step = self.ckpt.restore(
                    state, None if resume == "latest" else int(resume))
                log.info("Resumed from step %d", step)
            except FileNotFoundError:
                log.info("No checkpoint found; starting fresh")
        elif resume:
            log.warning("resume=%r without ckpt_dir: starting fresh", resume)
        cfg = self.cfg
        n_dev = self.world
        logger = logger if self.rank == 0 else None
        last: Dict[str, float] = {}
        sign = 1.0 if cfg.monitor_mode == "max" else -1.0
        best_score = -float("inf")
        stale_evals = 0
        self.best_step = None
        for epoch in range(epochs):
            t_data = t_step = 0.0
            n_samples = 0
            t0 = time.perf_counter()
            for i, batch in enumerate(train_iter_factory()):
                if steps_per_epoch is not None and i >= steps_per_epoch:
                    break
                bsz = int(batch["images"].shape[0]) * self.world
                dbatch = self._device_batch(batch)
                t1 = time.perf_counter()
                state, metrics = self.train_step(state, dbatch)
                if cfg.log_every and state.step % cfg.log_every == 0:
                    metrics = {k: float(v) for k, v in metrics.items()}  # waits for the step
                    t2 = time.perf_counter()
                    t_data += t1 - t0
                    t_step += t2 - t1
                    n_samples += bsz
                    pairs_per_sec = n_samples / max(t_data + t_step, 1e-9)
                    metrics.update({"epoch": epoch, "pairs_per_sec": pairs_per_sec,
                                    "pairs_per_sec_per_chip": pairs_per_sec / n_dev})
                    last = metrics
                    if logger:
                        logger.log(state.step, {f"train/{k}": v for k, v in metrics.items()})
                    t_data = t_step = 0.0
                    n_samples = 0
                else:
                    t_data += t1 - t0
                    n_samples += bsz
                if self.ckpt and cfg.save_every_steps and state.step % cfg.save_every_steps == 0:
                    self.ckpt.save(state, state.step)
                t0 = time.perf_counter()
            if val_iter_factory is not None:
                val_metrics = self.evaluate(state, val_iter_factory())
                last.update({f"val/{k}": v for k, v in val_metrics.items()})
                if logger:
                    logger.log(state.step, {f"val/{k}": v for k, v in val_metrics.items()})
                score = val_metrics.get(cfg.monitor)
                if score is not None:
                    if sign * score > best_score:
                        best_score = sign * score
                        stale_evals = 0
                        self.best_step = state.step
                        if self.ckpt:
                            self.ckpt.save(state, state.step, last)
                    else:
                        stale_evals += 1
                        if cfg.early_stop_patience and stale_evals >= cfg.early_stop_patience:
                            log.info("Early stopping at step %d (no %s improvement for %d evals)",
                                     state.step, cfg.monitor, stale_evals)
                            break
            if self.ckpt:
                self.ckpt.save(state, state.step, last)
        if self.ckpt:
            self.ckpt.wait()  # the last write is on disk before fit returns
        return state, last

    # ------------------------------------------------------------------ eval
    def evaluate(self, state: TrainState,
                 val_iter: Iterable[Dict[str, Any]]) -> Dict[str, float]:
        """Full-split retrieval eval without grad or augmentation: the mean
        of the batches' losses, the in-batch R@1/5/10 over all rows, the
        bidirectional ``clip_retrieval_metrics`` of the features gathered
        over the split, and ``num_samples``; for CoCa also
        ``val_generative_loss``, the mean over the batches of each batch's
        caption CE (pad 0). Under a mesh each rank passes its rows of the
        same global batches, the features are gathered over the ranks (the
        caption CE's sums and counts added over them), and every rank
        returns the global split's metrics."""
        from spatial_clip_tpu_torch.models.coca import caption_nll

        metrics = ContrastiveMetrics()
        losses: List[float] = []
        gen_losses: List[float] = []
        img_feats, txt_feats = [], []
        mstate = metrics.init(self.model.logit_scale.device)
        with torch.no_grad():
            for batch in val_iter:
                dbatch = self._device_batch(batch)
                features = self._features(state.params, dbatch, None)  # no augmentation
                losses.append(float(self._loss({**dbatch, **features})))
                if "caption_logits" in features:
                    nll = torch.stack(caption_nll(features["caption_logits"],
                                                  features["caption_labels"]))
                    if self.group is not None:
                        dist.all_reduce(nll, group=self.group)
                    gen_losses.append(float(nll[0] / nll[1].clamp_min(1.0)))
                img = all_gather(features["image_features"], self.group)
                txt = all_gather(features["text_features"], self.group)
                img_feats.append(img.float().cpu().numpy())
                txt_feats.append(txt.float().cpu().numpy())
                logits = (img @ txt.T) * features["logit_scale"]
                mstate = metrics.update(
                    mstate, logits, torch.arange(logits.shape[0], device=logits.device))
        if not losses:
            log.warning("evaluation split produced zero batches (split smaller than batch size?)")
            return {}
        result = {"loss": float(np.mean(losses))}
        if gen_losses:
            result["val_generative_loss"] = float(np.mean(gen_losses))
        result.update(metrics.compute(mstate))
        img, txt = np.concatenate(img_feats), np.concatenate(txt_feats)
        result.update(clip_retrieval_metrics(img, txt))
        result["num_samples"] = float(len(img))
        return result
