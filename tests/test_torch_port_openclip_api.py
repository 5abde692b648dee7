"""The port's open_clip-shaped surface against the JAX package's.

The two packages export the same public names (the lazy ImageNet tables and
zero-shot builders included); ``tokenize`` / ``decode``, the ImageNet
tables, the registry listings and ``get_model_config`` give JAX's answers;
the loss factories build the losses JAX's name; the config registration
(``register_model_config``, ``add_model_config``, ``local-dir:`` and
``hf-hub:`` names) resolves as JAX's does; ``create_model_from_pretrained``
refuses to hand back weights drawn from a seed; the upload functions raise,
naming ROADMAP Queue 1 item 11.
"""
from __future__ import annotations

import tests.helpers.torch_threads  # noqa: F401  (xdist workers share the cores)

import json
import types

import numpy as np
import pytest

import spatial_clip_tpu as jax_pkg
import spatial_clip_tpu_torch as pkg
from spatial_clip_tpu import openclip_api as jax_api
from spatial_clip_tpu.models import config as jax_config
from spatial_clip_tpu_torch import openclip_api as api
from spatial_clip_tpu_torch.models import config as port_config
from spatial_clip_tpu_torch.models.factory import create_model

LAZY = ("IMAGENET_CLASSNAMES", "OPENAI_IMAGENET_TEMPLATES", "SIMPLE_IMAGENET_TEMPLATES",
        "build_zero_shot_classifier", "build_zero_shot_classifier_legacy")


def _public(module) -> set:
    return {n for n in vars(module) if not n.startswith("_")
            and not isinstance(vars(module)[n], types.ModuleType)}


def test_public_names_equal_jax():
    """The package's names (its submodules aside) and openclip_api's equal
    JAX's, and every lazy name resolves in both."""
    assert _public(pkg) == _public(jax_pkg)
    assert {n for n in _public(api) if n not in ("annotations", "Optional")} == \
        {n for n in _public(jax_api) if n not in ("annotations", "Optional")}
    for name in LAZY:
        assert getattr(pkg, name) is not None and getattr(jax_pkg, name) is not None
    assert pkg.__version__ == jax_pkg.__version__
    assert api.openclip_compat_version == jax_api.openclip_compat_version
    with pytest.raises(AttributeError):
        pkg.no_such_name  # noqa: B018


def test_tokenize_decode_and_imagenet_tables_equal_jax():
    texts = ["a photo of a cat", "Hello, wörld! 12 ɑ", "", "spatial transcriptomics " * 20]
    ids = pkg.tokenize(texts)
    np.testing.assert_array_equal(ids, jax_pkg.tokenize(texts))
    np.testing.assert_array_equal(pkg.tokenize(texts, context_length=8),
                                  jax_pkg.tokenize(texts, context_length=8))
    for row in ids:
        assert pkg.decode(row) == jax_pkg.decode(row)
    assert "a photo of a cat" in pkg.decode(ids[0])
    assert pkg.IMAGENET_CLASSNAMES == jax_pkg.IMAGENET_CLASSNAMES
    assert len(pkg.IMAGENET_CLASSNAMES) == 1000
    for name in ("OPENAI_IMAGENET_TEMPLATES", "SIMPLE_IMAGENET_TEMPLATES"):
        ours, theirs = getattr(pkg, name), getattr(jax_pkg, name)
        assert [t("cat") for t in ours] == [t("cat") for t in theirs]


def test_listings_and_model_configs_equal_jax(monkeypatch):
    """The listings equal JAX's; the registered-config overlays start empty
    (another test module registers configs in JAX's)."""
    for module in (port_config, jax_config):
        monkeypatch.setattr(module, "_EXTRA_CONFIGS", {})
    assert pkg.list_pretrained() == jax_pkg.list_pretrained()
    assert pkg.list_openai_models() == jax_pkg.list_openai_models()
    assert len(pkg.list_openai_models()) == 18
    for tag in ("openai", "webli", "datacomp1b", "laion2b_s34b_b79k", "none"):
        assert pkg.list_pretrained_models_by_tag(tag) == jax_pkg.list_pretrained_models_by_tag(tag)
    for model in ("ViT-B-32", "RN50-quickgelu", "ViT-Test"):
        assert pkg.list_pretrained_tags_by_model(model) == \
            jax_pkg.list_pretrained_tags_by_model(model)
    assert pkg.list_models() == jax_pkg.list_models()
    for name in ("ViT-B-32", "RN50", "coca_ViT-B-32", "not-a-model"):
        assert pkg.get_model_config(name) == jax_pkg.get_model_config(name)
    assert pkg.CLIPVisionCfg is port_config.VisionCfg and pkg.CustomTextCLIP is pkg.CLIP
    assert pkg.OPENAI_DATASET_MEAN == jax_pkg.OPENAI_DATASET_MEAN


def test_loss_factories_build_the_named_losses():
    for name, kind in (("ClipLoss", "clip"), ("CoCaLoss", "coca"), ("DistillClipLoss", "distill"),
                       ("SigLipLoss", "siglip"), ("SpatialLoss", "spatial")):
        assert getattr(pkg, name)().name == kind
    assert pkg.SpatialLoss(cap_logit_scale=50.0).options["cap_logit_scale"] == 50.0
    for args, kind in (({"use_spatial_loss": True}, "spatial"), ({"siglip": True}, "siglip"),
                       ({"name": "spatial"}, "spatial"), ({}, "clip")):
        assert pkg.create_loss(args).name == kind
        assert pkg.create_loss(types.SimpleNamespace(**args)).name == kind


def test_registered_and_local_configs_resolve_as_jax(tmp_path, monkeypatch):
    """register_model_config, add_model_config (a file, a directory), a
    ``local-dir:`` name and an ``hf-hub:`` snapshot's model_cfg resolve to
    JAX's dicts, and build."""
    for module in (port_config, jax_config):
        monkeypatch.setattr(module, "_EXTRA_CONFIGS", {})
    cfg = pkg.get_model_config("ViT-Test")
    for register in (pkg.register_model_config, jax_pkg.register_model_config):
        register("org/Registered-Test", {**cfg, "embed_dim": 48})
    assert pkg.get_model_config("org-Registered-Test")["embed_dim"] == 48
    (tmp_path / "Overlay-Test.json").write_text(json.dumps(cfg))
    for add in (pkg.add_model_config, jax_pkg.add_model_config):
        add(tmp_path)
        add(tmp_path / "Overlay-Test.json")
    assert pkg.list_models() == jax_pkg.list_models()
    assert {"Overlay-Test", "org-Registered-Test"} <= set(pkg.list_models())
    for bad, error in ((tmp_path / "absent", FileNotFoundError), (tmp_path / "empty", ValueError)):
        (tmp_path / "empty").mkdir(exist_ok=True)
        with pytest.raises(error):
            pkg.add_model_config(bad)
    model = create_model("org/Registered-Test", precision="fp32", device="meta")
    assert model.cfg.embed_dim == 48

    (tmp_path / "dir").mkdir()
    (tmp_path / "dir" / "open_clip_config.json").write_text(json.dumps({"model_cfg": cfg}))
    snap = tmp_path / "hub" / "models--org--name" / "snapshots" / "rev"
    snap.mkdir(parents=True)
    (snap / "open_clip_config.json").write_text(json.dumps({"model_cfg": cfg}))
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    for name in (f"local-dir:{tmp_path / 'dir'}", "hf-hub:org/name"):
        assert pkg.get_model_config(name) == jax_pkg.get_model_config(name) == cfg
    assert port_config.hf_cache_snapshot("org/name") == jax_config.hf_cache_snapshot("org/name")
    monkeypatch.delenv("HF_HUB_CACHE")
    monkeypatch.setenv("HUGGINGFACE_HUB_CACHE", str(tmp_path / "hub"))
    assert port_config.hf_cache_snapshot("org/name") == snap
    monkeypatch.delenv("HUGGINGFACE_HUB_CACHE")
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    assert port_config.hf_cache_snapshot("org/name") == snap
    assert port_config.hf_cache_snapshot("org/other") is None
    assert pkg.get_model_config("hf-hub:org/other") is None


def test_pretrained_constructors_refuse_seed_weights_and_uploads_raise():
    with pytest.raises(RuntimeError, match="drawn from a seed"):
        pkg.create_model_from_pretrained("ViT-Test")
    model, preprocess = pkg.create_model_from_pretrained(
        "ViT-Test", require_pretrained=False, precision="fp32", device="cpu")
    assert preprocess is not None and model.cfg.embed_dim == 32
    assert pkg.create_model_from_pretrained("ViT-Test", require_pretrained=False,
                                            return_transform=False, precision="fp32",
                                            device="meta").cfg.embed_dim == 32
    with pytest.raises(RuntimeError, match="no OpenAI weights"):
        pkg.load_openai_model("ViT-Test")
    for push, args in ((pkg.push_to_hf_hub, (model, None, "org/name")),
                       (pkg.push_pretrained_to_hf_hub, ("ViT-Test", "openai", "org/name"))):
        with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
            push(*args)
