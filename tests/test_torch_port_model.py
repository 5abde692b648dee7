"""The port's CLIP towers against the JAX package on the same weights.

ViT-Test is widened to head_dim 64 (width 128, 2 heads) so both towers take
the attention kernel's geometry, as tests/test_fused_attention.py widens it.
The JAX params go through ``from_jax_params`` into the port; the same numpy
images and token ids go to both. f32 parity is held at atol 1e-4 (as the
JAX package holds its einsum and Pallas paths to each other); bf16 at a
per-row cosine of 0.999.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatial_clip_tpu import create_model as jax_create_model
from spatial_clip_tpu.models.convert import jax_to_torch_state_dict
from spatial_clip_tpu.models.tokenizer import HashTokenizer as JaxHashTokenizer
from spatial_clip_tpu.models.tokenizer import SimpleTokenizer as JaxSimpleTokenizer
from spatial_clip_tpu.models.transforms import normalize_batch as jax_normalize_batch
from spatial_clip_tpu_torch import create_model
from spatial_clip_tpu_torch.models.clip import CLIP
from spatial_clip_tpu_torch.models.config import resolve_clip_cfg
from spatial_clip_tpu_torch.models.convert import from_jax_params
from spatial_clip_tpu_torch.models.tokenizer import HashTokenizer, SimpleTokenizer
from spatial_clip_tpu_torch.models.transforms import normalize_batch

WIDE = dict(vision_cfg=dict(width=128, heads=2), text_cfg=dict(width=128, heads=2))
TEXTS = ["a cell", "tumor tile with dense lymphocytes", "EPCAM KRT8 KRT18", "stroma"]


def _cosine(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


@pytest.fixture(scope="module")
def jax_bundle():
    return jax_create_model("ViT-Test", precision="fp32", seed=0, **WIDE)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(11)
    u8 = rng.integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    ids = JaxHashTokenizer(vocab_size=512, context_length=16)(TEXTS)
    return u8, ids


def _port_model(params, precision="fp32", **overrides):
    m = create_model("ViT-Test", precision=precision, device="cpu", **{**WIDE, **overrides})
    m.load_state_dict(from_jax_params(params))
    return m


def _port_encode(model, u8, ids, normalize=False):
    with torch.inference_mode():
        x = normalize_batch(torch.from_numpy(u8), dtype=model.dtype)
        img = model.encode_image(x, normalize=normalize)
        txt = model.encode_text(torch.from_numpy(ids).long(), normalize=normalize)
    return img.float().numpy(), txt.float().numpy()


def _jax_encode(bundle, u8, ids, params, dtype=np.float32, normalize=False):
    x = jax_normalize_batch(u8, dtype=dtype)
    img = bundle.encode_image(x, params=params, normalize=normalize)
    txt = bundle.encode_text(ids, params=params, normalize=normalize)
    return np.asarray(img, np.float32), np.asarray(txt, np.float32)


def test_normalize_batch_matches_jax(inputs):
    u8, _ = inputs
    got = normalize_batch(torch.from_numpy(u8)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_normalize_batch(u8)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("attn_impl", ["auto", "pallas"])
@pytest.mark.parametrize("normalize", [False, True])
def test_towers_match_jax_f32(jax_bundle, inputs, attn_impl, normalize):
    """'auto' is the einsum path on the CPU; 'pallas' runs the Pallas kernel
    in interpret mode, the path the JAX package serves on the TPU."""
    u8, ids = inputs
    ref = jax_bundle if attn_impl == "auto" else jax_create_model(
        "ViT-Test", precision="fp32", seed=0, attn_impl=attn_impl, **WIDE)
    want = _jax_encode(ref, u8, ids, jax_bundle.params, normalize=normalize)
    got = _port_encode(_port_model(jax_bundle.params), u8, ids, normalize=normalize)
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4)


def test_towers_match_jax_bf16(jax_bundle, inputs):
    """bf16 compute with the weights stored in bf16: the two frameworks
    round at the same points but sum in other orders."""
    u8, ids = inputs
    ref = jax_create_model("ViT-Test", precision="bf16", seed=0, **WIDE)
    want = _jax_encode(ref, u8, ids, jax_bundle.params, dtype=jnp.bfloat16)
    got = _port_encode(_port_model(jax_bundle.params, "bf16"), u8, ids)
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.isfinite(g).all()
        assert _cosine(g, w).min() >= 0.999


VARIANT = dict(
    quick_gelu=True, ln_impl="fp32", init_logit_bias=-10.0,
    vision_cfg=dict(width=128, heads=2, ls_init_value=0.5, no_ln_pre=True,
                    final_ln_after_pool=True, pool_type="avg"),
    text_cfg=dict(width=128, heads=2, ls_init_value=0.5, proj_bias=True,
                  no_causal_mask=True, final_ln_after_pool=True, pool_type="last"),
)


def test_variant_config_matches_jax(inputs):
    """The other ported options: QuickGELU, two-pass LayerNorm, layer-scale,
    no ln_pre, pooling before the final LN, avg/last pooling, a biased text
    projection, no causal mask (the kernel's mask-free path), logit bias."""
    u8, ids = inputs
    ref = jax_create_model("ViT-Test", precision="fp32", seed=0, **VARIANT)
    want = _jax_encode(ref, u8, ids, ref.params)
    m = create_model("ViT-Test", precision="fp32", device="cpu", **VARIANT)
    m.load_state_dict(from_jax_params(ref.params))
    got = _port_encode(m, u8, ids)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4)
    assert float(m.logit_bias) == pytest.approx(float(ref.params["logit_bias"]))


def test_state_dict_matches_jax_export(jax_bundle):
    """from_jax_params gives jax_to_torch_state_dict's keys and values."""
    ours = from_jax_params(jax_bundle.params)
    theirs = jax_to_torch_state_dict(jax_bundle.params)
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v), err_msg=k)


def test_vit_b_32_layout_matches_jax_export():
    """The port's ViT-B-32 state dict has the keys and shapes the JAX
    package exports for it (shapes only: no weights are drawn)."""
    from spatial_clip_tpu.models.clip import CLIP as JaxCLIP
    from spatial_clip_tpu.models.config import resolve_clip_cfg as jax_resolve

    jmodel = JaxCLIP(cfg=jax_resolve("ViT-B-32"))
    shapes = jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), np.zeros((1, 224, 224, 3), np.float32),
        np.zeros((1, 77), np.int32))["params"]
    zeros = jax.tree.map(lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), shapes)
    theirs = {k: tuple(v.shape) for k, v in jax_to_torch_state_dict(zeros).items()}
    model = CLIP(resolve_clip_cfg("ViT-B-32"), dtype=torch.bfloat16, device="meta")
    ours = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert ours == theirs


@pytest.mark.parametrize("overrides,field", [
    (dict(attn_impl="einsum"), "attn_impl"),
    (dict(mlp_impl="int8"), "mlp_impl"),
    (dict(ln_gemm_impl="pallas"), "ln_gemm_impl"),
    (dict(ln_impl="compute"), "ln_impl"),
    (dict(zip_towers="on"), "zip_towers"),
    (dict(vision_cfg=dict(qk_norm=True)), "vision_cfg.qk_norm"),
    (dict(vision_cfg=dict(scaled_cosine=True)), "vision_cfg.scaled_cosine"),
    (dict(vision_cfg=dict(attentional_pool=True)), "vision_cfg.attentional_pool"),
    (dict(vision_cfg=dict(patch_dropout=0.5)), "vision_cfg.patch_dropout"),
    (dict(vision_cfg=dict(timm_model_name="vit_base")), "vision_cfg.timm_model_name"),
    (dict(vision_cfg=dict(layers=[1, 1, 1, 1])), "vision_cfg.layers"),
    (dict(vision_cfg=dict(pos_embed_type="sin_cos_2d")), "vision_cfg.pos_embed_type"),
    (dict(text_cfg=dict(qk_norm=True)), "text_cfg.qk_norm"),
    (dict(text_cfg=dict(hf_model_name="bert-base")), "text_cfg.hf_model_name"),
    (dict(text_cfg=dict(embed_cls=True)), "text_cfg.embed_cls"),
    (dict(gene_cfg=dict(num_genes=8)), "gene_cfg"),
    (dict(multimodal_cfg=dict(layers=1)), "multimodal_cfg"),
])
def test_unported_options_raise(overrides, field):
    with pytest.raises(NotImplementedError, match=field):
        create_model("ViT-Test", precision="fp32", device="meta", **overrides)


def test_unsupported_head_geometry_raises():
    """Plain ViT-Test has head_dim 16, which the attention kernel does not take."""
    with pytest.raises(NotImplementedError, match="head_dim"):
        create_model("ViT-Test", precision="fp32", device="meta")


TOKENIZER_TEXTS = [
    "a photo of a cat", "", "   ", "Hello, World!", "EPCAM KRT8 KRT18 VIM CD3E",
    "it's we're they'll I'd", "naïve café résumé", "日本語のテキスト", "emoji 🧬🔬 tiles",
    "&amp;lt;b&amp;gt;html&lt;/b&gt;", "numbers 12345 and 3.14159", "tabs\tand\nnewlines",
    "UPPER lower MiXeD", "hyphen-ated under_score slash/path", "Ωμέγα κείμενο",
    "русский текст", "a" * 300, " ".join(["token"] * 120),
    "<start_of_text> inside <end_of_text>", "mixed 漢字 and latin, punctuation!?;",
]


def test_simple_tokenizer_matches_jax_id_for_id():
    ours, theirs = SimpleTokenizer(), JaxSimpleTokenizer()
    assert ours.vocab_size == theirs.vocab_size
    np.testing.assert_array_equal(ours(TOKENIZER_TEXTS), theirs(TOKENIZER_TEXTS))
    assert ours(TOKENIZER_TEXTS[-3])[0, -1] == ours.eot_token  # truncated at 77


def test_hash_tokenizer_matches_jax_id_for_id():
    np.testing.assert_array_equal(HashTokenizer(512, 16)(TOKENIZER_TEXTS),
                                  JaxHashTokenizer(512, 16)(TOKENIZER_TEXTS))
