"""``forward_intermediates`` (``spatial_clip_tpu_torch.models.intermediates``)
and ``feature_take_indices`` (``ops/flops.py``) against the JAX package's,
the cases of ``tests/test_intermediates.py`` held to JAX's values: CLIP and
CoCa, every block or the last n or listed ids, NCHW and NLC, the class
prefix, the final-norm option, ``stop_early``'s depth cut, the logits and
the refusals, and the towers' kernel routes at head dim 64.

The port's seed-0 weights are carried into JAX once per model
(``to_jax_params``). All in f32 on the CPU: intermediates, features and
logits at atol 1e-5; the depth-cut run the same bits as the full one.
"""
from __future__ import annotations

import tests.helpers.torch_threads  # noqa: F401  (xdist workers share the cores)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatial_clip_tpu.models.clip import CLIP as JaxCLIP
from spatial_clip_tpu.models.coca import CoCa as JaxCoCa
from spatial_clip_tpu.models.config import resolve_clip_cfg as jax_resolve_clip_cfg
from spatial_clip_tpu.models.factory import ModelBundle
from spatial_clip_tpu.ops.flops import feature_take_indices as jax_feature_take_indices
from spatial_clip_tpu_torch import create_model
from spatial_clip_tpu_torch.models import transformer as ptransformer
from spatial_clip_tpu_torch.models.convert import to_jax_params
from spatial_clip_tpu_torch.ops import attention_plain
from spatial_clip_tpu_torch.ops.flops import feature_take_indices

SMALL = dict(vision_cfg={"image_size": 32, "patch_size": 8, "width": 64, "layers": 4, "heads": 2},
             text_cfg={"context_length": 12, "vocab_size": 128, "width": 32, "heads": 2,
                       "layers": 3})
# head dim 64: the towers take the attention kernels' routes
KERNEL = dict(vision_cfg={"image_size": 32, "patch_size": 8, "width": 128, "layers": 3,
                          "heads": 2},
              text_cfg={"context_length": 12, "vocab_size": 128, "width": 128, "heads": 2,
                        "layers": 2})
_PAIRS: dict = {}


def _pair(name: str, **kw):
    """(port model, JAX bundle on the port's weights: no flax init), built once."""
    key = (name, repr(kw))
    if key not in _PAIRS:
        model = create_model(name, precision="fp32", seed=0, device="cpu", **kw)
        cfg = jax_resolve_clip_cfg(name, **kw)
        m = cfg.multimodal_cfg
        jmodel = (JaxCoCa(cfg=cfg, multimodal_layers=m.layers, caption_queries=m.caption_queries)
                  if m is not None else JaxCLIP(cfg=cfg))
        params = jax.tree.map(jnp.asarray, to_jax_params(model.state_dict()))
        _PAIRS[key] = model, ModelBundle(model=jmodel, params=params, cfg=cfg, model_name=name)
    return _PAIRS[key]


def _inputs(model, n=2, seed=0):
    rng = np.random.default_rng(seed)
    size, ctx = model.cfg.vision_cfg.size, model.cfg.text_cfg.context_length
    images = rng.uniform(0, 1, (n, size, size, 3)).astype(np.float32)
    text = rng.integers(1, 120, (n, ctx)).astype(np.int64)
    return images, text


def _both(model, bundle, images=None, text=None, **kw):
    got = model.forward_intermediates(
        image=None if images is None else torch.from_numpy(images),
        text=None if text is None else torch.from_numpy(text), **kw)
    want = bundle.forward_intermediates(
        image=images, text=None if text is None else text.astype(np.int32), **kw)
    return got, want


def _close(got, want, atol=1e-5):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k, w in want.items():
        g = got[k]
        if isinstance(w, list):
            assert len(g) == len(w), k
            for gi, wi in zip(g, w):
                assert tuple(gi.shape) == tuple(np.shape(wi)), k
                np.testing.assert_allclose(gi.numpy(), np.asarray(wi), atol=atol, rtol=0,
                                           err_msg=k)
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol, rtol=0, err_msg=k)


@pytest.mark.parametrize("indices", [None, 0, 2, [0, 3], [-1], [-4, 1, 3], (2,)])
def test_feature_take_indices_matches_jax(indices):
    assert feature_take_indices(4, indices) == jax_feature_take_indices(4, indices)


def test_default_all_blocks_nchw_and_logits_match_jax():
    """Every block, NCHW with the class token split off (B, C, H/ps,
    W/ps), the text blocks (B, L, C), unit features, the logits both
    ways."""
    model, bundle = _pair("ViT-Test", **SMALL)
    images, text = _inputs(model)
    got, want = _both(model, bundle, images, text, output_logits=True)
    _close(got, want)
    assert len(got["image_intermediates"]) == 4 and len(got["text_intermediates"]) == 3
    assert tuple(got["image_intermediates"][0].shape) == (2, 64, 4, 4)
    assert tuple(got["text_intermediates"][0].shape) == (2, 12, 32)
    np.testing.assert_allclose(got["image_features"].norm(dim=-1).numpy(), 1.0, rtol=1e-5)
    np.testing.assert_allclose(got["image_logits"].T.numpy(), got["text_logits"].numpy())


@pytest.mark.parametrize("kw", [dict(image_indices=2), dict(image_indices=[-1]),
                                dict(image_indices=[0, 2], text_indices=1, normalize=False),
                                dict(text_indices=[-3, -1], output_logit_scale_bias=True)])
def test_indices_and_nlc_match_jax(kw):
    model, bundle = _pair("ViT-Test", **SMALL)
    images, text = _inputs(model, seed=1)
    got, want = _both(model, bundle, images, text, image_output_fmt="NLC", **kw)
    _close(got, want)
    full = model.forward_intermediates(image=torch.from_numpy(images), image_output_fmt="NLC")
    if kw.get("image_indices") == 2:  # the last two of four
        assert torch.equal(got["image_intermediates"][0], full["image_intermediates"][2])
    if kw.get("image_indices") == [-1]:
        assert torch.equal(got["image_intermediates"][0], full["image_intermediates"][3])


def test_stop_early_runs_only_the_blocks_it_needs_with_the_same_bits():
    """stop_early with intermediates_only: the same bits as the full run,
    no features, and only as many blocks run as the deepest selected (the
    einsum route's calls counted), as JAX's depth-pruned model."""
    model, bundle = _pair("ViT-Test", **SMALL)
    images, text = _inputs(model, seed=2)
    kw = dict(image_indices=[0, 1], text_indices=[0], intermediates_only=True,
              image_output_fmt="NLC")
    counter = attention_plain.plain_attention
    counter.launches = 0
    full = model.forward_intermediates(image=torch.from_numpy(images),
                                       text=torch.from_numpy(text), **kw)
    assert counter.launches == 4 + 3
    counter.launches = 0
    pruned, want = _both(model, bundle, images, text, stop_early=True, **kw)
    assert counter.launches == 2 + 1
    assert "image_features" not in pruned and "text_features" not in pruned
    for a, b in zip(full["image_intermediates"] + full["text_intermediates"],
                    pruned["image_intermediates"] + pruned["text_intermediates"]):
        assert torch.equal(a, b)
    _close(pruned, want)


def test_normalize_intermediates_and_prefix_match_jax():
    """The final norm (ln_post: two-pass f32 statistics, f32 out) over each
    selected block, and the class prefix (B, 1, C) apart."""
    model, bundle = _pair("ViT-Test", **SMALL)
    images, _ = _inputs(model, seed=3)
    got, want = _both(model, bundle, images, image_indices=[3], normalize_intermediates=True,
                      image_output_extra_tokens=True, image_output_fmt="NLC")
    _close(got, want)
    assert tuple(got["image_intermediates_prefix"][0].shape) == (2, 1, 64)
    assert got["image_intermediates"][0].dtype == torch.float32
    xi = got["image_intermediates"][0].numpy()
    assert abs(xi.mean(axis=-1)).max() < 0.2


def test_coca_forward_intermediates_matches_jax():
    """CoCa's towers under the same contract: the pooled, normalized image
    feature, the text blocks with the cls row at the end (L + 1 rows), the
    logits; and the depth cut."""
    model, bundle = _pair("coca_ViT-Test")
    images, text = _inputs(model, seed=4)
    got, want = _both(model, bundle, images, text, output_logits=True,
                      normalize_intermediates=True, image_output_extra_tokens=True)
    _close(got, want)
    assert tuple(got["text_intermediates"][0].shape) == (2, 17, 32)
    got, want = _both(model, bundle, images, text, image_output_fmt="NLC",
                      intermediates_only=True, stop_early=True, image_indices=[0],
                      text_indices=[0])
    _close(got, want)
    assert len(got["image_intermediates"]) == len(got["text_intermediates"]) == 1


def test_kernel_routes_match_jax(monkeypatch):
    """At head dim 64 the towers' blocks take the inference kernel's route
    (its wrapper called once a block, 3 + 2) and the intermediates equal
    JAX's einsum route's."""
    model, bundle = _pair("ViT-Test", **KERNEL)
    calls = []
    fwd = ptransformer.fused_attention
    monkeypatch.setattr(ptransformer, "fused_attention",
                        lambda *a: calls.append(1) or fwd(*a))
    images, text = _inputs(model, seed=5)
    got, want = _both(model, bundle, images, text, output_logits=True, image_indices=[1, 2])
    assert len(calls) == 3 + 2
    _close(got, want)


def test_unsupported_towers_and_bad_arguments_raise_as_in_jax():
    """A gene tower's text side and a timm image tower raise ValueError;
    the ViT side still works on a gene-tower model; logits need both
    inputs; an output format outside NCHW / NLC asserts."""
    genes = 256
    kw = dict(vision_cfg={"image_size": 32, "patch_size": 8, "width": 64, "layers": 2,
                          "heads": 2},
              gene_cfg={"num_genes": genes, "width": 64, "layers": 2})
    model, bundle = _pair("ViT-Test", **kw)
    images = np.zeros((1, 32, 32, 3), np.float32)
    vec = torch.zeros(1, genes)
    with pytest.raises(ValueError, match="gene-MLP"):
        model.forward_intermediates(text=vec)
    got = model.forward_intermediates(image=torch.from_numpy(images), intermediates_only=True)
    want = bundle.forward_intermediates(image=images, intermediates_only=True)
    _close(got, want)
    timm = create_model("convnext_base", precision="fp32", device="meta")
    with pytest.raises(ValueError, match="ViT vision tower"):
        timm.forward_intermediates(image=torch.zeros(1, 224, 224, 3, device="meta"))
    small, _ = _pair("ViT-Test", **SMALL)
    with pytest.raises(ValueError, match="output_logits requires both"):
        small.forward_intermediates(image=torch.zeros(1, 32, 32, 3), output_logits=True)
    with pytest.raises(AssertionError, match="NCHW or NLC"):
        small.forward_intermediates(image=torch.zeros(1, 32, 32, 3), image_output_fmt="NHWC")
