"""AdamW, SGD and Lion with f32 global-norm clipping, tower locking, and the
learning-rate schedules (counterpart of ``spatial_clip_tpu.train.optim``).

The JAX package chains optax transforms: clip by the global norm (summed in
f32) -> Adam (``scale_by_adam_nd``: f32 arithmetic, the step count raised
before the bias correction, moments *stored* in ``mu_dtype``/``nu_dtype``)
-> ``+ weight_decay * p`` on the parameters with ``ndim >= 2`` -> ``* -lr``
-> ``p + update``. :class:`AdamW` runs the same chain over flat buffers:
every parameter, gradient and moment of the model lies in one contiguous
tensor (decayed parameters first), so each link is a few elementwise
passes over the whole model instead of a loop over its tensors.
``torch.optim.AdamW`` is not used: it stores f32 moments.

:class:`SGD` and :class:`Lion` run the JAX package's other two chains over
the same buffers: SGD keeps an f32 momentum trace, Lion an f32 moment, and
neither has a second moment (the JAX Trainer's bf16 moment dtypes reach
only its AdamW). Tower locking (``frozen_prefixes``) comes last in every
chain, as optax's ``masked(set_to_zero())``: the frozen parameters'
gradients still count in the clipping norm and their moments still
update; only their update is zeroed. Each optimizer takes the frozen
parameters as one ``[start, end)`` range of the flat buffers.

Schedules are plain functions of the step that return a Python float,
computed in float32 as optax computes them.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

Schedule = Callable[[int], float]
_F32 = np.float32


def decay_mask(params: Dict[str, torch.Tensor]) -> Dict[str, bool]:
    """True for the parameters that receive weight decay: ``ndim >= 2``
    (biases, norm gains and the logit scale are excluded)."""
    return {k: p.ndim >= 2 for k, p in params.items()}


def jax_param_paths(names: Iterable[str]) -> Dict[str, str]:
    """The JAX package's ``/``-joined parameter path of each of this
    package's parameter names (``visual.transformer.resblocks.1.ln_1.weight``
    -> ``visual/transformer/resblocks_1/ln_1/scale``), through
    ``models/convert.py``'s name map."""
    from spatial_clip_tpu_torch.models.convert import _key_pairs

    names = set(names)
    paths = {tkey: jkey for jkey, tkey, _ in _key_pairs(lambda jkey, tkey: tkey in names)}
    missing = names - set(paths)
    if missing:
        raise ValueError(f"parameters with no JAX path: {sorted(missing)}")
    return paths


def freeze_mask(names: Iterable[str], frozen_prefixes: Sequence[str]) -> Dict[str, bool]:
    """True for the parameters under a frozen prefix. The prefixes are JAX
    paths (``visual``, ``visual/transformer/resblocks_3``), matched on whole
    path components: a prefix names a parameter only where the path goes
    on with ``/`` or ends there. (The JAX package's ``freeze_mask`` takes a
    bare ``startswith``, so ``resblocks_1`` also freezes ``resblocks_10``
    and ``resblocks_11``.)"""
    prefixes = [p.rstrip("/") for p in frozen_prefixes]
    return {name: any(path == p or path.startswith(p + "/") for p in prefixes)
            for name, path in jax_param_paths(names).items()}


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule."""
    if steps <= 0:
        return lambda count: float(_F32(init))

    def schedule(count: int) -> float:
        frac = _F32(1) - _F32(min(max(count, 0), steps)) / _F32(steps)
        return float(_F32(init - end) * frac + _F32(end))

    return schedule


def _cosine(init: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """optax.cosine_decay_schedule."""
    def schedule(count: int) -> float:
        t = _F32(min(count, decay_steps))
        cosine = _F32(0.5) * (_F32(1) + np.cos(_F32(math.pi) * t / _F32(decay_steps)))
        return float(_F32(init) * (_F32(1 - alpha) * cosine + _F32(alpha)))

    return schedule


def _join(schedules, boundaries) -> Schedule:
    """optax.join_schedules: past each boundary, the next schedule counts
    from 0."""
    def schedule(count: int) -> float:
        out = schedules[0](count)
        for boundary, s in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = s(count - boundary)
        return out

    return schedule


def cosine_lr(base_lr: float, warmup_steps: int, total_steps: int,
              end_lr: float = 0.0) -> Schedule:
    """Linear warmup from 0, then cosine decay (optax's
    ``warmup_cosine_decay_schedule``): lr is 0 at step 0."""
    warmup = max(warmup_steps, 1)
    decay = max(total_steps, warmup_steps + 1)
    alpha = 0.0 if base_lr == 0.0 else end_lr / base_lr
    return _join([_linear(0.0, base_lr, warmup), _cosine(base_lr, decay - warmup, alpha)],
                 [warmup])


def const_lr(base_lr: float, warmup_steps: int = 0, **_) -> Schedule:
    if warmup_steps <= 0:
        return lambda count: base_lr
    return _join([_linear(0.0, base_lr, warmup_steps), lambda count: base_lr], [warmup_steps])


def const_lr_cooldown(base_lr: float, warmup_steps: int, total_steps: int,
                      cooldown_steps: int, cooldown_power: float = 1.0,
                      cooldown_end_lr: float = 0.0) -> Schedule:
    """Constant lr with a polynomial cooldown tail."""
    def cooldown(count: int) -> float:
        frac = _F32(min(max(count / max(cooldown_steps, 1), 0.0), 1.0))
        decay = (_F32(1) - frac) ** _F32(cooldown_power)
        return float(_F32(cooldown_end_lr) + decay * _F32(base_lr - cooldown_end_lr))

    return _join([const_lr(base_lr, warmup_steps), cooldown], [total_steps - cooldown_steps])


def make_schedule(name: str, base_lr: float, warmup_steps: int, total_steps: int,
                  **kwargs) -> Schedule:
    name = (name or "cosine").lower()
    if name in ("cosine", "cosine_lr"):
        return cosine_lr(base_lr, warmup_steps, total_steps)
    if name in ("const", "constant"):
        return const_lr(base_lr, warmup_steps)
    if name in ("const-cooldown", "const_cooldown"):
        return const_lr_cooldown(
            base_lr, warmup_steps, total_steps,
            kwargs.get("cooldown_steps", max(total_steps // 10, 1)),
            kwargs.get("cooldown_power", 1.0), kwargs.get("cooldown_end_lr", 0.0))
    raise ValueError(f"unknown schedule: {name}")


def global_norm_f32(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, accumulated in f32
    whatever the tensors' dtype."""
    return torch.sqrt(sum(x.float().square().sum() for x in tensors))


def clip_by_global_norm_f32(tensors, max_norm: float) -> torch.Tensor:
    """Scale ``tensors`` in place by ``min(1, max_norm / max(norm, 1e-16))``
    (optax.clip_by_global_norm with the norm summed in f32). Returns the
    norm before clipping, as a device scalar: nothing waits for it."""
    tensors = list(tensors)
    norm = global_norm_f32(tensors)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-16), max=1.0)
    for t in tensors:
        t.mul_(scale)
    return norm


def moment_dtype(name: Optional[str]) -> torch.dtype:
    """``mu_dtype``/``nu_dtype`` names: 'bf16' stores a moment in bfloat16,
    None in float32 (the parameters' dtype)."""
    if name in ("bf16", "bfloat16"):
        return torch.bfloat16
    if name is None:
        return torch.float32
    raise NotImplementedError(f"moment dtype {name!r} is not ported to spatial_clip_tpu_torch")


class _Chain:
    """What the three chains share: the clipping before, the frozen range
    and the learning rate after. ``update`` runs one step in place over
    flat f32 parameter and gradient buffers whose first ``n_decay``
    elements are the decayed parameters, with flat moment buffers ``mu``
    and ``nu`` (an empty ``nu`` for an optimizer with one moment) and
    ``count`` the optimizer's step count; it returns the new count and the
    gradient's global norm before clipping."""

    moments = ("mu", "nu")

    def _clip(self, grads: torch.Tensor) -> torch.Tensor:
        if self.grad_clip_norm:
            return clip_by_global_norm_f32([grads], self.grad_clip_norm)
        return global_norm_f32([grads])

    def _apply(self, params: torch.Tensor, update: torch.Tensor, count: int,
               frozen: Tuple[int, int]) -> None:
        if frozen[1] > frozen[0]:  # masked(set_to_zero()), last in the chain
            update[frozen[0]:frozen[1]].zero_()
        # optax scale_by_learning_rate counts its own steps from 0: count - 1 here
        params.add_(update, alpha=-self.schedule(count - 1))


class AdamW(_Chain):
    """The JAX package's ``make_optimizer`` chain for ``opt='adamw'``:
    moments in their storage dtypes, f32 arithmetic, ``count`` Adam's step
    count."""

    def __init__(self, schedule: Schedule, weight_decay: float = 0.2,
                 betas: Tuple[float, float] = (0.9, 0.98), eps: float = 1e-6,
                 grad_clip_norm: Optional[float] = 1.0):
        self.schedule, self.weight_decay = schedule, weight_decay
        self.b1, self.b2 = betas
        self.eps, self.grad_clip_norm = eps, grad_clip_norm

    @torch.no_grad()
    def update(self, params: torch.Tensor, grads: torch.Tensor, mu: torch.Tensor,
               nu: torch.Tensor, count: int, n_decay: int,
               frozen: Tuple[int, int] = (0, 0)) -> Tuple[int, torch.Tensor]:
        norm = self._clip(grads)
        count += 1
        b1, b2 = self.b1, self.b2
        mu32 = mu.to(torch.float32, copy=True).mul_(b1).add_(grads, alpha=1 - b1)
        nu32 = nu.to(torch.float32, copy=True).mul_(b2).addcmul_(grads, grads, value=1 - b2)
        bc1 = float(_F32(1) - _F32(b1) ** _F32(count))
        bc2 = float(_F32(1) - _F32(b2) ** _F32(count))
        update = mu32 / bc1
        update.div_(nu32.div(bc2).sqrt_().add_(self.eps))
        if self.weight_decay and n_decay:
            update[:n_decay].add_(params[:n_decay], alpha=self.weight_decay)
        self._apply(params, update, count, frozen)
        mu.copy_(mu32)
        nu.copy_(nu32)
        return count, norm


class SGD(_Chain):
    """``opt='sgd'``: clip -> ``+ weight_decay * p`` on the decayed
    parameters -> the momentum trace ``t = g + momentum * t`` (no
    dampening, no Nesterov; ``momentum`` None is 0.9, as in the JAX
    package) -> ``* -lr``. ``mu`` holds the trace in f32."""

    moments = ("mu",)

    def __init__(self, schedule: Schedule, weight_decay: float = 0.2,
                 momentum: Optional[float] = None, grad_clip_norm: Optional[float] = 1.0):
        self.schedule, self.weight_decay = schedule, weight_decay
        self.momentum = 0.9 if momentum is None else momentum
        self.grad_clip_norm = grad_clip_norm

    @torch.no_grad()
    def update(self, params: torch.Tensor, grads: torch.Tensor, mu: torch.Tensor,
               nu: torch.Tensor, count: int, n_decay: int,
               frozen: Tuple[int, int] = (0, 0)) -> Tuple[int, torch.Tensor]:
        norm = self._clip(grads)
        count += 1
        if self.weight_decay and n_decay:
            grads[:n_decay].add_(params[:n_decay], alpha=self.weight_decay)
        mu.mul_(self.momentum).add_(grads)
        self._apply(params, mu.clone() if frozen[1] > frozen[0] else mu, count, frozen)
        return count, norm


class Lion(_Chain):
    """``opt='lion'`` (optax.lion): clip -> ``sign((1 - b1) g + b1 m)``,
    then ``m = (1 - b2) g + b2 m`` -> ``+ weight_decay * p`` on the decayed
    parameters -> ``* -lr``. ``mu`` holds the moment in f32."""

    moments = ("mu",)

    def __init__(self, schedule: Schedule, weight_decay: float = 0.2,
                 betas: Tuple[float, float] = (0.9, 0.98),
                 grad_clip_norm: Optional[float] = 1.0):
        self.schedule, self.weight_decay = schedule, weight_decay
        self.b1, self.b2 = betas
        self.grad_clip_norm = grad_clip_norm

    @torch.no_grad()
    def update(self, params: torch.Tensor, grads: torch.Tensor, mu: torch.Tensor,
               nu: torch.Tensor, count: int, n_decay: int,
               frozen: Tuple[int, int] = (0, 0)) -> Tuple[int, torch.Tensor]:
        norm = self._clip(grads)
        count += 1
        update = torch.sign(grads * (1.0 - self.b1) + mu * self.b1)
        mu.mul_(self.b2).add_(grads * (1.0 - self.b2))
        if self.weight_decay and n_decay:
            update[:n_decay].add_(params[:n_decay], alpha=self.weight_decay)
        self._apply(params, update, count, frozen)
        return count, norm


def make_optimizer(opt: str, schedule: Schedule, weight_decay: float = 0.2,
                   betas: Tuple[float, float] = (0.9, 0.98), eps: float = 1e-6,
                   grad_clip_norm: Optional[float] = 1.0,
                   momentum: Optional[float] = None) -> _Chain:
    """The chain ``opt`` names: ``adamw`` (or ``adam``), ``sgd`` or ``lion``."""
    opt = (opt or "adamw").lower()
    if opt in ("adamw", "adam"):
        return AdamW(schedule, weight_decay, betas, eps, grad_clip_norm)
    if opt == "sgd":
        return SGD(schedule, weight_decay, momentum, grad_clip_norm)
    if opt == "lion":
        return Lion(schedule, weight_decay, betas, grad_clip_norm)
    raise ValueError(f"unknown optimizer: {opt}")
