"""The port's model configs against the JSON files and the JAX package's
resolution: no architecture field is dropped unseen.

The JAX package's ``_filter_kwargs`` drops every JSON key its dataclasses
lack, so it builds ViT-H / bigG / ViT-e with 64-wide heads (``head_width``
dropped) and pools the ``*-worldwide*`` text towers by the mean (``eos_id``
dropped, ``pool_type='eos'`` falling through). The port records every
dropped key and ``check_ported`` refuses those that change the function.
"""
from __future__ import annotations

import tests.helpers.torch_threads  # noqa: F401  (xdist workers share the cores)

import dataclasses
import json

import pytest

from spatial_clip_tpu.models import config as jax_config
from spatial_clip_tpu_torch.models import config as port_config

BUILTINS = port_config.list_model_configs()


def _fields(cls) -> set:
    return {f.name for f in dataclasses.fields(cls)}


def _passes(cfg) -> bool:
    try:
        port_config.check_ported(cfg)
    except NotImplementedError:
        return False
    return True


@pytest.mark.parametrize("name", BUILTINS)
def test_every_builtin_config_that_passes_is_built_with_no_field_dropped(name):
    """Each JSON key of a config that check_ported lets through lands in a
    dataclass field with its value, or is one of IGNORED_KEYS."""
    cfg = port_config.resolve_clip_cfg(name)
    if not _passes(cfg):
        return
    raw = json.loads((port_config.CONFIG_DIR / f"{name}.json").read_text())
    assert set(cfg.dropped) <= port_config.IGNORED_KEYS
    for prefix, cls, sub, obj in (("", port_config.CLIPCfg, raw, cfg),
                                  ("vision_cfg.", port_config.VisionCfg,
                                   raw.get("vision_cfg") or {}, cfg.vision_cfg),
                                  ("text_cfg.", port_config.TextCfg, raw.get("text_cfg") or {},
                                   cfg.text_cfg),
                                  ("gene_cfg.", port_config.GeneCfg, raw.get("gene_cfg") or {},
                                   cfg.gene_cfg),
                                  ("multimodal_cfg.", port_config.MultimodalCfg,
                                   raw.get("multimodal_cfg") or {}, cfg.multimodal_cfg)):
        for key, value in sub.items():
            if prefix == "" and key in ("vision_cfg", "text_cfg", "gene_cfg", "multimodal_cfg"):
                continue
            if key in _fields(cls):
                got = getattr(obj, key)
                assert got == value or (isinstance(value, list) and tuple(value) == got), \
                    f"{name}: {prefix}{key}"
            else:
                assert prefix + key in port_config.IGNORED_KEYS, f"{name}: {prefix}{key} dropped"
    v = cfg.vision_cfg
    assert v.head_width is None or v.head_width * v.heads == v.width
    assert cfg.text_cfg.pool_type in port_config.TEXT_POOL_TYPES


def test_the_builtins_that_dropped_head_width_or_eos_are_refused():
    """The configs built wrongly before (head_width dropped: ViT-H-14-378,
    ViT-H-16, the bigG family, ViT-e-14; eos pooling: the worldwide
    family) and the CLIPA tokenizer settings are refused, each naming its
    field."""
    cases = {"ViT-H-14-378": "vision_cfg.head_width=80", "ViT-H-16": "vision_cfg.head_width=80",
             "ViT-bigG-14-quickgelu": "vision_cfg.head_width=104",
             "ViT-e-14": "vision_cfg.head_width=112",
             "ViT-L-14-worldwide": "text_cfg.pool_type='eos'",
             "ViT-L-14-CLIPA": "text_cfg.tokenizer_kwargs"}
    for name, field in cases.items():
        with pytest.raises(NotImplementedError, match=field.replace("[", r"\[")):
            port_config.check_ported(port_config.resolve_clip_cfg(name))


@pytest.mark.parametrize("override,field", [
    (dict(vision_cfg={"head_width": 96}), "vision_cfg.head_width=96"),
    (dict(text_cfg={"pool_type": "eos", "eos_id": 2}), "text_cfg.pool_type='eos'"),
    (dict(text_cfg={"norm_kwargs": {"eps": 1e-6}}), "text_cfg.norm_kwargs"),
    (dict(text_cfg={"act_kwargs": {"approximate": "tanh"}}), "text_cfg.act_kwargs"),
    (dict(vision_cfg={"norm_kwargs": {"eps": 1e-6}}), "vision_cfg.norm_kwargs"),
    (dict(some_new_flag=True), "some_new_flag"),
])
def test_check_ported_refuses_what_would_change_the_function(override, field):
    cfg = port_config.resolve_clip_cfg("ViT-B-32", **override)
    with pytest.raises(NotImplementedError, match=field):
        port_config.check_ported(cfg)


def test_a_head_width_that_agrees_with_heads_passes_and_is_carried():
    cfg = port_config.resolve_clip_cfg("ViT-B-32", vision_cfg={"head_width": 64})
    port_config.check_ported(cfg)
    assert cfg.vision_cfg.head_width == 64 and cfg.vision_cfg.heads == 12
    eos = port_config.resolve_clip_cfg("ViT-L-14-worldwide")
    assert (eos.text_cfg.pool_type, eos.text_cfg.eos_id) == ("eos", 1)


def test_the_difference_from_jax_is_pinned():
    """The JAX package builds ViT-H-14-378 with 20 heads of 64 (no
    head_width field) and the worldwide text tower with eos_id dropped;
    the port carries both fields and refuses the configs instead."""
    jax_cfg = jax_config.resolve_clip_cfg("ViT-H-14-378")
    assert jax_cfg.vision_cfg.heads == 1280 // 64
    assert not hasattr(jax_cfg.vision_cfg, "head_width")
    port_cfg = port_config.resolve_clip_cfg("ViT-H-14-378")
    assert (port_cfg.vision_cfg.heads, port_cfg.vision_cfg.head_width) == (20, 80)
    assert not _passes(port_cfg)
    jax_eos = jax_config.resolve_clip_cfg("ViT-H-14-worldwide")
    assert jax_eos.text_cfg.pool_type == "eos" and not hasattr(jax_eos.text_cfg, "eos_id")
    assert port_config.resolve_clip_cfg("ViT-H-14-worldwide").text_cfg.eos_id == 2
