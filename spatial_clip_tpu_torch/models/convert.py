"""JAX parameter tree -> this package's state dict.

:func:`from_jax_params` takes the flax params of ``spatial_clip_tpu``'s CLIP
(nested dicts of arrays) and returns the open_clip-layout state dict the
port's :class:`~spatial_clip_tpu_torch.models.clip.CLIP` loads. For the keys
``spatial_clip_tpu.models.convert.jax_to_torch_state_dict`` exports, keys and
values are the same; it also maps layer-scale, a biased text projection and
the Gene-MLP tower, which that exporter leaves out: its flax tree
``text/embed``, ``text/ln_i``, ``text/fc_i``, ``text/proj_i``,
``text/ln_final``, ``text/head`` is ``text.embed``, ``text.ln_i``, ... here.
:func:`to_jax_params` is its inverse.

:func:`from_jax_train_state` maps a JAX ``TrainState`` (parameters and the
Adam moments, with numpy leaves) to the port's
:class:`~spatial_clip_tpu_torch.train.loop.TrainState`.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            flat.update(_flatten(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def _to_f32(tree):
    """Nested dicts of arrays (bfloat16 ones included, which torch cannot
    take from numpy) as float32 numpy arrays."""
    if isinstance(tree, dict):
        return {k: _to_f32(v) for k, v in tree.items()}
    return np.asarray(tree).astype(np.float32)


def _key_pairs(has) -> List[Tuple[str, str, Optional[Tuple[int, ...]]]]:
    """(JAX flat key, state-dict key, transpose from JAX to torch) for every
    parameter of a CLIP; ``has(jax_key, state_dict_key)`` says whether an
    optional parameter is present."""
    pairs = []

    def take(jkey: str, tkey: str, transpose=None):
        pairs.append((jkey, tkey, transpose))

    def take_ln(jprefix: str, tprefix: str):
        take(f"{jprefix}/scale", f"{tprefix}.weight")
        take(f"{jprefix}/bias", f"{tprefix}.bias")

    def take_dense(jprefix: str, tprefix: str):  # flax (in, out) -> torch (out, in)
        take(f"{jprefix}/kernel", f"{tprefix}.weight", (1, 0))
        take(f"{jprefix}/bias", f"{tprefix}.bias")

    def take_blocks(jprefix: str, tprefix: str):
        i = 0
        while has(f"{jprefix}/resblocks_{i}/ln_1/scale", f"{tprefix}.resblocks.{i}.ln_1.weight"):
            j, t = f"{jprefix}/resblocks_{i}", f"{tprefix}.resblocks.{i}"
            take_ln(f"{j}/ln_1", f"{t}.ln_1")
            take_ln(f"{j}/ln_2", f"{t}.ln_2")
            take(f"{j}/attn/qkv/kernel", f"{t}.attn.in_proj_weight", (1, 0))
            take(f"{j}/attn/qkv/bias", f"{t}.attn.in_proj_bias")
            take_dense(f"{j}/attn/out", f"{t}.attn.out_proj")
            take_dense(f"{j}/mlp/c_fc", f"{t}.mlp.c_fc")
            take_dense(f"{j}/mlp/c_proj", f"{t}.mlp.c_proj")
            for ls in ("ls_1", "ls_2"):
                if has(f"{j}/{ls}", f"{t}.{ls}.gamma"):
                    take(f"{j}/{ls}", f"{t}.{ls}.gamma")
            i += 1

    take_blocks("visual/transformer", "visual.transformer")
    take("visual/conv1/kernel", "visual.conv1.weight", (3, 2, 0, 1))  # HWIO -> OIHW
    take("visual/class_embedding", "visual.class_embedding")
    take("visual/positional_embedding", "visual.positional_embedding")
    if has("visual/ln_pre/scale", "visual.ln_pre.weight"):
        take_ln("visual/ln_pre", "visual.ln_pre")
    take_ln("visual/ln_post", "visual.ln_post")
    take("visual/proj", "visual.proj")

    if has("text/embed/kernel", "text.embed.weight"):  # the Gene-MLP tower
        take_dense("text/embed", "text.embed")
        i = 0
        while has(f"text/ln_{i}/scale", f"text.ln_{i}.weight"):
            take_ln(f"text/ln_{i}", f"text.ln_{i}")
            take_dense(f"text/fc_{i}", f"text.fc_{i}")
            take_dense(f"text/proj_{i}", f"text.proj_{i}")
            i += 1
        take_ln("text/ln_final", "text.ln_final")
        take_dense("text/head", "text.head")
    else:
        take_blocks("text/transformer", "transformer")
        take("text/token_embedding/embedding", "token_embedding.weight")
        take("text/positional_embedding", "positional_embedding")
        take_ln("text/ln_final", "ln_final")
        if has("text/text_projection/kernel", "text_projection.weight"):
            take_dense("text/text_projection", "text_projection")
        else:
            take("text/text_projection", "text_projection")

    take("logit_scale", "logit_scale")
    if has("logit_bias", "logit_bias"):
        take("logit_bias", "logit_bias")
    return pairs


def from_jax_params(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    flat = _flatten(params)
    out: Dict[str, np.ndarray] = {}
    for jkey, tkey, transpose in _key_pairs(lambda jkey, tkey: jkey in flat):
        v = flat.pop(jkey)
        out[tkey] = v if transpose is None else v.transpose(transpose)
    if flat:
        raise NotImplementedError(
            f"JAX params with no counterpart in spatial_clip_tpu_torch: {sorted(flat)}")
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}  # own, writable copies


def to_jax_params(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of :func:`from_jax_params`: this package's state dict as
    the JAX package's nested params (float32 numpy arrays)."""
    sd = {k: v.detach().to("cpu", torch.float32).numpy() for k, v in state_dict.items()}
    nested: Dict[str, Any] = {}
    for jkey, tkey, transpose in _key_pairs(lambda jkey, tkey: tkey in sd):
        v = sd.pop(tkey)
        if transpose is not None:
            v = v.transpose(np.argsort(transpose))
        node = nested
        *parents, leaf = jkey.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = np.array(v, order="C")
    if sd:
        raise NotImplementedError(
            f"state-dict keys with no counterpart in the JAX package: {sorted(sd)}")
    return nested


def find_adam_state(opt_state):
    """The Adam state (``count``, ``mu``, ``nu``) inside an optax chain's
    state, nested tuples included."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, tuple):
        for part in opt_state:
            found = find_adam_state(part)
            if found is not None:
                return found
    return None


def from_jax_train_state(state, seed: int = 42, device=None):
    """The port's TrainState from a JAX ``TrainState``: ``params`` and the
    Adam moments ``mu``/``nu`` go through :func:`from_jax_params`'s key map
    and transposes (the moments keep their storage dtype: bfloat16 where
    the JAX state stores bfloat16); Adam's ``count`` and the ``step`` are
    copied. The augmentation generator is seeded with ``seed``: JAX's random
    key has no counterpart."""
    from spatial_clip_tpu_torch.train.loop import TrainState

    adam = find_adam_state(state.opt_state)
    leaf = np.asarray(adam.mu["logit_scale"]).dtype
    mu_dtype = torch.bfloat16 if leaf.name == "bfloat16" else torch.float32
    leaf = np.asarray(adam.nu["logit_scale"]).dtype
    nu_dtype = torch.bfloat16 if leaf.name == "bfloat16" else torch.float32
    return TrainState.create(
        from_jax_params(_to_f32(state.params)), from_jax_params(_to_f32(adam.mu)),
        from_jax_params(_to_f32(adam.nu)), count=int(np.asarray(adam.count)),
        step=int(np.asarray(state.step)), mu_dtype=mu_dtype, nu_dtype=nu_dtype, seed=seed,
        device=device)
