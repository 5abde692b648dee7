"""JAX parameter tree -> this package's state dict.

:func:`from_jax_params` takes the flax params of ``spatial_clip_tpu``'s CLIP
(nested dicts of arrays) and returns the open_clip-layout state dict the
port's :class:`~spatial_clip_tpu_torch.models.clip.CLIP` loads. For the keys
``spatial_clip_tpu.models.convert.jax_to_torch_state_dict`` exports, keys and
values are the same; it also maps layer-scale and a biased text projection.
"""
from __future__ import annotations

from typing import Any, Dict

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


def from_jax_params(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    flat = _flatten(params)
    out: Dict[str, np.ndarray] = {}

    def take(jkey: str, tkey: str, transpose=None):
        v = flat.pop(jkey)
        out[tkey] = v if transpose is None else v.transpose(transpose)

    def take_ln(jprefix: str, tprefix: str):
        take(f"{jprefix}/scale", f"{tprefix}.weight")
        take(f"{jprefix}/bias", f"{tprefix}.bias")

    def take_dense(jprefix: str, tprefix: str):  # flax (in, out) -> torch (out, in)
        take(f"{jprefix}/kernel", f"{tprefix}.weight", (1, 0))
        take(f"{jprefix}/bias", f"{tprefix}.bias")

    def take_blocks(jprefix: str, tprefix: str):
        i = 0
        while f"{jprefix}/resblocks_{i}/ln_1/scale" in flat:
            j, t = f"{jprefix}/resblocks_{i}", f"{tprefix}.resblocks.{i}"
            take_ln(f"{j}/ln_1", f"{t}.ln_1")
            take_ln(f"{j}/ln_2", f"{t}.ln_2")
            take(f"{j}/attn/qkv/kernel", f"{t}.attn.in_proj_weight", (1, 0))
            take(f"{j}/attn/qkv/bias", f"{t}.attn.in_proj_bias")
            take_dense(f"{j}/attn/out", f"{t}.attn.out_proj")
            take_dense(f"{j}/mlp/c_fc", f"{t}.mlp.c_fc")
            take_dense(f"{j}/mlp/c_proj", f"{t}.mlp.c_proj")
            for ls in ("ls_1", "ls_2"):
                if f"{j}/{ls}" in flat:
                    take(f"{j}/{ls}", f"{t}.{ls}.gamma")
            i += 1

    take_blocks("visual/transformer", "visual.transformer")
    take("visual/conv1/kernel", "visual.conv1.weight", (3, 2, 0, 1))  # HWIO -> OIHW
    take("visual/class_embedding", "visual.class_embedding")
    take("visual/positional_embedding", "visual.positional_embedding")
    if "visual/ln_pre/scale" in flat:
        take_ln("visual/ln_pre", "visual.ln_pre")
    take_ln("visual/ln_post", "visual.ln_post")
    take("visual/proj", "visual.proj")

    take_blocks("text/transformer", "transformer")
    take("text/token_embedding/embedding", "token_embedding.weight")
    take("text/positional_embedding", "positional_embedding")
    take_ln("text/ln_final", "ln_final")
    if "text/text_projection/kernel" in flat:
        take_dense("text/text_projection", "text_projection")
    else:
        take("text/text_projection", "text_projection")

    take("logit_scale", "logit_scale")
    if "logit_bias" in flat:
        take("logit_bias", "logit_bias")
    if flat:
        raise NotImplementedError(
            f"JAX params with no counterpart in spatial_clip_tpu_torch: {sorted(flat)}")
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}  # own, writable copies
