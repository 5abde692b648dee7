"""CoCa (``spatial_clip_tpu_torch.models.coca``), its loss and its generation
against the JAX package's ``spatial_clip_tpu.models.coca``, and the two tower
options CoCa brought (the ViT's attentional pooler, the text tower's cls
token) under plain ``CLIP``.

The port's seed-0 ``coca_ViT-Test`` weights are carried into JAX once per
module (``to_jax_params``). All in f32 on the CPU, the same math in other
summation orders: image and text features at atol 1e-5, caption logits at
atol 1e-4, the coca loss at rtol 1e-6 and every parameter's gradient at
cosine >= 0.99999 (a gradient that is zero in JAX is zero here), one
Trainer step's loss, gradient norm and logit scale at rtol 1e-5 and its
parameters at atol 1e-5, ``val_generative_loss`` at rtol 1e-6; greedy, beam
and top-k 1 / tiny top-p sampled sequences token for token. The sampled
draws themselves come from a ``torch.Generator``, not JAX's ``categorical``
bits: only their determinism and JAX's constraints are held.
"""
from __future__ import annotations

import tests.helpers.torch_threads  # noqa: F401  (xdist workers share the cores)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatial_clip_tpu.losses import make_loss as jax_make_loss
from spatial_clip_tpu.models import coca as jcoca
from spatial_clip_tpu.models.clip import CLIP as JaxCLIP
from spatial_clip_tpu.models.config import resolve_clip_cfg as jax_resolve_clip_cfg
from spatial_clip_tpu.models.factory import ModelBundle
from spatial_clip_tpu.parallel.mesh import make_mesh
from spatial_clip_tpu.train.loop import Trainer as JaxTrainer
from spatial_clip_tpu.train.loop import TrainerConfig as JaxTrainerConfig
from spatial_clip_tpu_torch import create_model
from spatial_clip_tpu_torch.losses import make_loss
from spatial_clip_tpu_torch.models import coca as pcoca
from spatial_clip_tpu_torch.models.config import check_ported, resolve_clip_cfg
from spatial_clip_tpu_torch.models.convert import _flatten, from_jax_params, to_jax_params
from spatial_clip_tpu_torch.ops import attention_plain
from spatial_clip_tpu_torch.ops import fused_attention as fa
from spatial_clip_tpu_torch.train.loop import Trainer, TrainerConfig

SOT, EOT = 1, 2


@pytest.fixture(scope="module")
def pair():
    """(port CoCa for training, f32; the JAX bundle on the same weights)."""
    model = create_model("coca_ViT-Test", precision="fp32", seed=0, device="cpu",
                         training=True)
    cfg = jax_resolve_clip_cfg("coca_ViT-Test")
    jmodel = jcoca.CoCa(cfg=cfg, multimodal_layers=cfg.multimodal_cfg.layers,
                        caption_queries=cfg.multimodal_cfg.caption_queries, dtype=jnp.float32)
    params = jax.tree.map(jnp.asarray, to_jax_params(model.state_dict()))
    return model, ModelBundle(model=jmodel, params=params, cfg=cfg, model_name="coca_ViT-Test")


def _inputs(seed, B=4, pads=True):
    """Images in [-1, 1) and token rows in [3, 512) ending in EOT, row 1
    (and every third) with a pad tail."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(-1, 1, (B, 32, 32, 3)).astype(np.float32)
    text = rng.integers(3, 512, (B, 16)).astype(np.int64)
    text[:, 0] = SOT
    text[:, -1] = EOT
    if pads:
        for r in range(1, B, 3):
            text[r, 9] = EOT
            text[r, 10:] = 0
    return images, text


def _cos(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_check_ported_outcome_of_the_five_coca_configs():
    """coca_ViT-B-32 and coca_ViT-Test build; coca_ViT-L-14 and coca_base
    are refused at text_cfg.output_tokens (a key JAX's TextCfg drops: its
    decoder has its own token embedding), coca_roberta-ViT-B-32 at its HF
    text tower, which JAX's CoCa replaces with the CLIP text tower. Past
    the first key, L-14's pooler heads (12 against 8) and coca_base's
    n_queries (256 against 65) disagree with what JAX builds."""
    for name in ("coca_ViT-B-32", "coca_ViT-Test"):
        check_ported(resolve_clip_cfg(name))
    refused = {"coca_ViT-L-14": "text_cfg.output_tokens", "coca_base": "text_cfg.output_tokens",
               "coca_roberta-ViT-B-32": "text_cfg.hf_model_name='roberta-base'"}
    for name, key in refused.items():
        with pytest.raises(NotImplementedError, match=f"^{key}"):
            check_ported(resolve_clip_cfg(name))
    for name, key in (("coca_ViT-L-14", "multimodal_cfg.attn_pooler_heads=12"),
                      ("coca_base", "multimodal_cfg.n_queries=256")):
        cfg = resolve_clip_cfg(name)
        cfg.dropped = ()
        with pytest.raises(NotImplementedError, match=f"^{key}.*builds (8|65)"):
            check_ported(cfg)


@pytest.mark.parametrize("override,key", [
    (dict(multimodal_cfg=dict(width=64)), "multimodal_cfg.width=64"),
    (dict(multimodal_cfg=dict(mlp_ratio=2)), "multimodal_cfg.mlp_ratio=2"),
    (dict(multimodal_cfg=dict(foo=1)), "multimodal_cfg.foo"),
    (dict(attn_impl="pallas"), "attn_impl='pallas'"),
    (dict(ln_impl="fp32"), "ln_impl='fp32'"),
    (dict(mlp_impl="pallas"), "mlp_impl='pallas'"),
    (dict(ln_gemm_impl="pallas"), "ln_gemm_impl='pallas'"),
    (dict(zip_towers="on"), "zip_towers='on'"),
    (dict(init_logit_bias=-10.0), "init_logit_bias"),
    (dict(vision_cfg=dict(ls_init_value=0.1)), "vision_cfg.ls_init_value"),
    (dict(vision_cfg=dict(attn_pooler_queries=9)), "vision_cfg.attn_pooler_queries=9"),
    (dict(text_cfg=dict(pool_type="last")), "text_cfg.pool_type='last'"),
])
def test_settings_jax_coca_ignores_are_refused(override, key):
    """A setting JAX's CoCa drops or never reads is refused where it is not
    the value JAX builds; the ones equal to it are taken."""
    with pytest.raises(NotImplementedError, match=key):
        check_ported(resolve_clip_cfg("coca_ViT-Test", **override))
    check_ported(resolve_clip_cfg("coca_ViT-Test", attn_impl="auto", ln_impl="onepass",
                                  multimodal_cfg=dict(width=32, heads=2, context_length=16,
                                                      vocab_size=512, mlp_ratio=4,
                                                      dim_head=16, n_queries=5,
                                                      attn_pooler_heads=8),
                                  vision_cfg=dict(attentional_pool=True, output_tokens=True,
                                                  attn_pooler_queries=5),
                                  text_cfg=dict(embed_cls=True)))


def test_forward_matches_jax(pair):
    """Features at atol 1e-5 and caption logits at atol 1e-4 (pad tails
    included); the labels are the text shifted by one; the decoder's
    attention takes JAX's einsum route, its cross-attention
    jax.nn.dot_product_attention's core, the pooler JAX's inline einsum,
    and no attention kernel runs."""
    model, bundle = pair
    images, text = _inputs(0)
    counters = (attention_plain.plain_attention, attention_plain.head_attention,
                attention_plain.dot_product_attention, fa.fused_attention,
                fa.fused_attention_lse)
    for c in counters:
        c.launches = 0
    with torch.no_grad():
        got = model(torch.from_numpy(images), torch.from_numpy(text))
    # 2 + 2 tower layers and 1 decoder layer; the pooler; the cross-attention
    assert [c.launches for c in counters] == [5, 1, 1, 0, 0]
    want = jax.jit(bundle.model.apply)({"params": bundle.params}, images, text.astype(np.int32))
    assert set(got) == set(want)
    for k, atol in (("image_features", 1e-5), ("text_features", 1e-5),
                    ("caption_logits", 1e-4), ("logit_scale", 1e-6)):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=atol, rtol=0,
                                   err_msg=k)
    assert got["caption_logits"].shape == (4, 15, 512)
    np.testing.assert_array_equal(got["caption_labels"].numpy(), text[:, 1:])
    with torch.no_grad():
        enc = model.encode_image(torch.from_numpy(images)), model.encode_text(
            torch.from_numpy(text))
    np.testing.assert_allclose(enc[0].numpy(), got["image_features"].numpy(), atol=1e-6)
    np.testing.assert_allclose(enc[1].numpy(), got["text_features"].numpy(), atol=1e-6)


def test_coca_loss_and_gradients_match_jax(pair):
    """make_loss('coca') (contrastive 1, caption 2) against JAX's loss and
    jax.value_and_grad: the loss at rtol 1e-6, the caption term too, each
    parameter's gradient at cosine >= 0.99999."""
    model, bundle = pair
    images, text = _inputs(1)
    jloss = jax_make_loss("coca", caption_loss_weight=2.0)

    def f(params):
        out = bundle.model.apply({"params": params}, images, text.astype(np.int32))
        res = jloss(**out)
        return res["contrastive_loss"], res["caption_loss"]

    (jval, jcap), jgrads = jax.jit(jax.value_and_grad(f, has_aux=True))(bundle.params)
    model.zero_grad()
    res = make_loss("coca", caption_loss_weight=2.0)(
        **model(torch.from_numpy(images), torch.from_numpy(text)))
    res["contrastive_loss"].backward()
    np.testing.assert_allclose(res["contrastive_loss"].item(), float(jval), rtol=1e-6)
    np.testing.assert_allclose(res["caption_loss"].item(), float(jcap), rtol=1e-6)
    want = from_jax_params(jax.tree.map(np.asarray, jgrads))
    for name, p in model.named_parameters():
        g, w = p.grad.numpy(), want[name].numpy()
        if name.endswith("k_proj.bias"):  # zero in exact math: a shift of every score of a row
            assert max(np.abs(g).max(), np.abs(w).max()) < 1e-6, name
        elif not np.any(w):
            assert not np.any(g), name
        elif w.ndim == 0:
            np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=name)
        else:
            assert _cos(g, w) >= 0.99999, (name, _cos(g, w))
    model.zero_grad()


def test_caption_loss_masks_pads_and_guards_an_empty_row():
    """The caption CE over non-pad labels only, over max(count, 1): an
    all-pad batch gives 0, as JAX's."""
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(2, 5, 7)).astype(np.float32)
    labels = np.array([[3, 4, 0, 0, 0], [1, 2, 3, 6, 0]])
    got = pcoca.coca_caption_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    want = jcoca.coca_caption_loss(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    zero = pcoca.coca_caption_loss(torch.from_numpy(logits), torch.zeros(2, 5, dtype=torch.long))
    assert float(zero) == 0.0


def _host(bundle):
    """The bundle with host copies of its params: the JAX Trainer's step
    donates (deletes) the arrays it is given."""
    return dataclasses.replace(bundle, params=jax.tree.map(np.array, bundle.params))


def _cfg_kw():
    return dict(learning_rate=1e-3, warmup_steps=1, total_steps=50, augment=False, seed=0,
                mu_dtype=None, nu_dtype=None)


def _batch(seed, B=4):
    rng = np.random.default_rng(seed)
    _, text = _inputs(seed, B)
    return {"images": rng.integers(0, 256, (B, 32, 32, 3), dtype=np.uint8),
            "texts": text.astype(np.int32)}


def _torch_batch(batch):
    return {"images": torch.from_numpy(batch["images"]),
            "texts": torch.from_numpy(batch["texts"]).long()}


def test_trainer_step_and_val_generative_loss_match_jax(pair):
    """One Trainer step with make_loss('coca') against the JAX Trainer:
    loss, grad_norm and logit_scale at rtol 1e-5 and every parameter at
    atol 1e-5 after it (caption_loss among the port's metrics); then
    evaluate on two batches: loss at rtol 1e-5 and val_generative_loss at
    rtol 1e-6."""
    model, bundle = pair
    jt = JaxTrainer(_host(bundle), loss=jax_make_loss("coca"),
                    config=JaxTrainerConfig(**_cfg_kw()),
                    mesh=make_mesh(devices=jax.devices()[:1]))
    jstep, jstate = jt.make_train_step(), jt.init_state()
    trainer = Trainer(model, make_loss("coca"), TrainerConfig(**_cfg_kw()))
    state = trainer.init_state()
    batch = _batch(4)
    jstate, jm = jstep(jstate, jt._device_batch(batch))
    state, m = trainer.train_step(state, _torch_batch(batch))
    for k in ("loss", "grad_norm", "logit_scale"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, atol=1e-12, err_msg=k)
    assert np.isfinite(float(m["caption_loss"])) and float(m["caption_loss"]) > 0
    want = from_jax_params(jax.tree.map(np.asarray, jstate.params))
    for k, w in want.items():
        np.testing.assert_allclose(state.params[k].detach().numpy(), w.numpy(), atol=1e-5,
                                   rtol=0, err_msg=k)
    val = [_batch(5), _batch(6)]
    jres = jt.evaluate(jstate, val)
    res = trainer.evaluate(state, val)
    np.testing.assert_allclose(res["val_generative_loss"], jres["val_generative_loss"],
                               rtol=1e-6)
    np.testing.assert_allclose(res["loss"], jres["loss"], rtol=1e-5)
    assert res["num_samples"] == jres["num_samples"] == 8


def test_grad_accum_cached_raises_for_want_of_caption_logits_as_in_jax(pair):
    """grad_accum=2 in 'cached' mode: the full-batch loss gets only the
    features, so the coca loss raises a TypeError naming the caption
    inputs, in both packages; 'simple' mode trains."""
    model, bundle = pair
    cfg_kw = {**_cfg_kw(), "grad_accum": 2}
    batch = _batch(7)
    jt = JaxTrainer(_host(bundle), loss=jax_make_loss("coca"), config=JaxTrainerConfig(**cfg_kw),
                    mesh=make_mesh(devices=jax.devices()[:1]))
    with pytest.raises(TypeError, match="caption_labels.*caption_logits"):
        jt.make_train_step()(jt.init_state(), jt._device_batch(batch))
    trainer = Trainer(model, make_loss("coca"), TrainerConfig(**cfg_kw))
    with pytest.raises(TypeError, match="caption_labels.*caption_logits"):
        trainer.train_step(trainer.init_state(), _torch_batch(batch))
    simple = Trainer(model, make_loss("coca"),
                     TrainerConfig(**{**cfg_kw, "grad_accum_mode": "simple"}))
    _, m = simple.train_step(simple.init_state(), _torch_batch(batch))
    assert np.isfinite(float(m["loss"]))


@pytest.mark.parametrize("beam", [1, 3])
def test_greedy_and_beam_match_jax(pair, beam):
    """Greedy and beam search (width 1 and 3, seq_len 10) token for token
    against JAX's; beam width 1 is greedy."""
    model, bundle = pair
    images, _ = _inputs(8, B=3)
    x = torch.from_numpy(images)
    greedy = pcoca.greedy_generate(model, x, SOT, EOT, max_len=10).numpy()
    np.testing.assert_array_equal(greedy, np.asarray(jcoca.greedy_generate(
        bundle.model, bundle.params, images, SOT, EOT, max_len=10)))
    got = pcoca.beam_search_generate(model, x, SOT, EOT, max_len=10, beam_size=beam).numpy()
    want = np.asarray(jcoca.beam_search_generate(bundle.model, bundle.params, images, SOT, EOT,
                                                 max_len=10, beam_size=beam))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (3, 16) and (got[:, 0] == SOT).all() and (got[:, 10:] == 0).all()
    if beam == 1:
        np.testing.assert_array_equal(got, greedy)


def test_beam_ties_break_as_lax_top_k(pair):
    """top_k_first against lax.top_k on rows full of ties; then a forced
    tie: with to_logits zeroed every candidate of a step has the same
    score, and both packages keep the lowest flat indices (tokens 0, 1, 2
    of beam 0), token for token."""
    rng = np.random.default_rng(9)
    x = rng.integers(0, 4, (5, 40)).astype(np.float32)
    vals, idx = pcoca.top_k_first(torch.from_numpy(x), 7)
    jvals, jidx = jax.lax.top_k(jnp.asarray(x), 7)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    model, bundle = pair
    images, _ = _inputs(10, B=2)
    kernel = model.decoder.to_logits.weight
    saved = kernel.detach().clone()
    with torch.no_grad():
        kernel.zero_()
    try:
        params = {**bundle.params, "decoder": {**bundle.params["decoder"], "to_logits": {
            "kernel": jnp.zeros_like(bundle.params["decoder"]["to_logits"]["kernel"])}}}
        got = pcoca.beam_search_generate(model, torch.from_numpy(images), SOT, EOT, max_len=6,
                                         beam_size=3).numpy()
        want = np.asarray(jcoca.beam_search_generate(bundle.model, params, images, SOT, EOT,
                                                     max_len=6, beam_size=3))
    finally:
        with torch.no_grad():
            kernel.copy_(saved)
    np.testing.assert_array_equal(got, want)
    # step 1 keeps tokens 0, 1 and 2 (EOT) of beam 0; the EOT beam then adds
    # nothing to its score while the others add -log(vocab), and wins
    assert (got[:, 1] == EOT).all() and (got[:, 2:] == 0).all()


def test_warpers_match_jax():
    """_top_k_warp (k 1, 3, 50, ties at the threshold kept) and _top_p_warp
    (p from 1e-6 to 0.9999, min tokens 1 and 3) equal JAX's on the same
    logits."""
    rng = np.random.default_rng(11)
    logits = rng.normal(size=(4, 64)).astype(np.float32) * 3
    logits[0, :5] = logits[0].max()  # a tie at the top
    for k in (1, 3, 50):
        np.testing.assert_array_equal(pcoca._top_k_warp(torch.from_numpy(logits), k).numpy(),
                                      np.asarray(jcoca._top_k_warp(jnp.asarray(logits), k)))
    for p in (1e-6, 0.1, 0.5, 0.9, 0.9999):
        for keep in (1, 3):
            np.testing.assert_array_equal(
                pcoca._top_p_warp(torch.from_numpy(logits), p, keep).numpy(),
                np.asarray(jcoca._top_p_warp(jnp.asarray(logits), p, keep)), err_msg=(p, keep))


@pytest.mark.parametrize("gtype,extra", [
    ("top_k", dict(top_k=1, min_seq_len=0)),
    ("top_k", dict(top_k=1, min_seq_len=6, repetition_penalty=1.5)),
    ("top_p", dict(top_p=1e-6, min_seq_len=4, repetition_penalty=0.7, temperature=0.5)),
])
def test_deterministic_sampling_matches_jax(pair, gtype, extra):
    """With top-k 1 or a tiny top-p only the best token survives the warper,
    so the draw is decided: the min-length and repetition-penalty
    processors, the warper and the forced final EOT give JAX's tokens;
    top-k 1 without processors is greedy up to the forced EOT. EOT is
    the token greedy picks first, so the min length decides."""
    model, bundle = pair
    images, _ = _inputs(12, B=3)
    x = torch.from_numpy(images)
    eot = int(pcoca.greedy_generate(model, x, SOT, EOT, max_len=3)[0, 1])
    got = pcoca.sample_generate(model, x, SOT, eot, max_len=9, generation_type=gtype,
                                **extra).numpy()
    want = np.asarray(jcoca.sample_generate(bundle.model, bundle.params, images, SOT, eot,
                                            jax.random.PRNGKey(0), max_len=9,
                                            generation_type=gtype, **extra))
    np.testing.assert_array_equal(got, want)
    if extra.get("min_seq_len") == 0:
        greedy = pcoca.greedy_generate(model, x, SOT, eot, max_len=9).numpy()
        ended = (greedy[:, 1:8] == eot).any(axis=1)
        np.testing.assert_array_equal(got[~ended, :8], greedy[~ended, :8])


def test_sampling_draws_from_the_generator(pair):
    """Top-p 0.9 draws: the same generator seed gives the same tokens and
    another seed others (the draws are the port's, not JAX's categorical
    bits: not compared); JAX's constraints hold (SOT, no EOT before
    min_seq_len, every row ends in EOT, pads after)."""
    model, _ = pair
    images, _ = _inputs(13, B=4)
    x = torch.from_numpy(images)

    def draw(seed):
        return pcoca.sample_generate(model, x, SOT, EOT, torch.Generator().manual_seed(seed),
                                     max_len=8, generation_type="top_p", top_p=0.9,
                                     min_seq_len=3).numpy()

    a, b, c = draw(0), draw(0), draw(1)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    for seq in (a, c):
        assert (seq[:, 0] == SOT).all() and (seq[:, 1:3] != EOT).all()
        assert (seq == EOT).any(axis=1).all() and (seq[:, 8:] == 0).all()


def test_dispatcher_and_its_errors_match_jax(pair):
    """generate() routes each generation_type to its generator with JAX's
    arguments (seq_len as max_len, num_beams as beam_size; the generators
    are held to JAX above) and raises JAX's ValueError for another type;
    sample_generate refuses a type it does not sample, with JAX's message."""
    model, bundle = pair
    images, _ = _inputs(14, B=1)
    x = torch.from_numpy(images)
    routes = {"beam_search": lambda: pcoca.beam_search_generate(model, x, SOT, EOT, max_len=5,
                                                                beam_size=2),
              "greedy": lambda: pcoca.greedy_generate(model, x, SOT, EOT, max_len=5),
              "top_k": lambda: pcoca.sample_generate(model, x, SOT, EOT, max_len=5,
                                                     generation_type="top_k", min_seq_len=0)}
    for gtype, direct in routes.items():
        got = pcoca.generate(model, x, SOT, EOT, seq_len=5, generation_type=gtype, num_beams=2,
                             min_seq_len=0)
        assert torch.equal(got, direct()), gtype
        assert tuple(got.shape) == (1, 16) and int(got[0, 0]) == SOT
    for fn, args in ((pcoca.generate, dict(generation_type="nope")),
                     (pcoca.sample_generate, dict(sot_token=SOT, eot_token=EOT,
                                                  generation_type="beam_search"))):
        jfn = getattr(jcoca, fn.__name__)
        jargs = dict(args, rng=jax.random.PRNGKey(0)) if fn is pcoca.sample_generate else args
        with pytest.raises(ValueError) as want:
            jfn(bundle.model, bundle.params, images, **jargs)
        with pytest.raises(ValueError) as got:
            fn(model, x, **args)
        assert str(got.value) == str(want.value)


def test_weight_map_round_trips(pair):
    """from_jax_params / to_jax_params are inverse on CoCa's tree, every
    JAX leaf has one port key (the pooler, the cls row, the decoder, its
    own token embedding and positions) and the shapes agree."""
    model, bundle = pair
    flat = _flatten(jax.tree.map(np.asarray, bundle.params))
    sd = from_jax_params(bundle.params)
    assert set(sd) == set(model.state_dict())
    back = _flatten(to_jax_params(sd))
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    for key in ("visual.attn_pool.query", "text.cls_emb", "token_embedding_dec.weight",
                "img_to_text_width.weight", "decoder.resblocks.0.cross_attn.kv.weight",
                "decoder.to_logits.weight", "dec_positional_embedding"):
        assert key in sd, key
    assert tuple(sd["visual.attn_pool.query"].shape) == (5, 32)  # caption_queries + 1


def test_the_differences_from_open_clip_are_jax_s(pair):
    """How JAX's CoCa (and so the port's) differs from open_clip's, pinned:
    the decoder has its own token embedding (not the text tower's);
    caption_queries + 1 pooler queries; the cls row is appended after the
    pads, and there is no pad mask (a pad position's embedding moves the
    text feature)."""
    model, bundle = pair
    assert model.token_embedding_dec.weight is not model.text.token_embedding.weight
    assert model.visual.attn_pool.query.shape[0] == model.cfg.multimodal_cfg.caption_queries + 1
    assert model.text.positional_embedding.shape[0] == model.cfg.text_cfg.context_length + 1
    _, text = _inputs(15)
    assert (text[1, 10:] == 0).all()
    t = torch.from_numpy(text[1:2])
    with torch.no_grad():
        base = model.encode_text(t)
        emb = model.text.embed(t)
        assert torch.equal(emb[0, -1], (model.text.cls_emb + model.text.positional_embedding[-1]))
        saved = model.text.positional_embedding[12].clone()
        model.text.positional_embedding[12] += torch.linspace(-1, 1, saved.numel())
        moved = model.encode_text(t)
        model.text.positional_embedding[12] = saved
    assert (moved - base).abs().max() > 1e-4


def _clip_pair(**extra):
    """A port CLIP with the pooler and the cls token at head dim 64 (the
    kernel routes under attn_impl='auto') and JAX's CLIP on its weights
    under the einsum route, JAX's route on the CPU."""
    kw = dict(vision_cfg=dict(width=128, heads=2, attentional_pool=True, attn_pooler_queries=5,
                              attn_pooler_heads=4, **extra),
              text_cfg=dict(width=128, heads=2, embed_cls=True))
    model = create_model("ViT-Test", precision="fp32", seed=0, device="cpu", training=True, **kw)
    cfg = jax_resolve_clip_cfg("ViT-Test", attn_impl="einsum", **kw)
    params = jax.tree.map(jnp.asarray, to_jax_params(model.state_dict()))
    return model, ModelBundle(model=JaxCLIP(cfg=cfg, dtype=jnp.float32), params=params, cfg=cfg)


def test_clip_with_pooler_and_cls_token_matches_jax(monkeypatch):
    """CLIP with vision_cfg.attentional_pool and text_cfg.embed_cls (L 17
    causal): the forward and the clip loss's gradients against JAX (atol
    1e-5, cosine >= 0.99999), through the attention kernels' routes
    (forward-lse and backward, 2 + 2 layers) and the pooler's einsum; one
    Trainer step at rtol 1e-5 / atol 1e-5. vision_cfg.output_tokens changes
    nothing under CLIP, as in JAX."""
    model, bundle = _clip_pair()
    images, text = _inputs(16)
    calls = dict.fromkeys(("fused_attention_lse", "fused_attention_bwd"), 0)

    def counted(name, fn):
        def wrapper(*a):
            calls[name] += 1
            return fn(*a)
        return wrapper

    for name in calls:  # the wrappers count kernel launches, none on the CPU: count calls
        monkeypatch.setattr(fa, name, counted(name, getattr(fa, name)))
    plain = (attention_plain.head_attention, attention_plain.plain_attention)
    for c in plain:
        c.launches = 0
    out = model(torch.from_numpy(images), torch.from_numpy(text))
    loss = make_loss("clip")(**out)["contrastive_loss"]
    model.zero_grad()
    loss.backward()
    assert list(calls.values()) + [c.launches for c in plain] == [4, 4, 1, 0]
    want = jax.jit(bundle.model.apply)({"params": bundle.params}, images, text.astype(np.int32))
    for k in ("image_features", "text_features"):
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(want[k]), atol=1e-5,
                                   err_msg=k)
    jloss = jax_make_loss("clip")

    def f(params):
        return jloss(**bundle.model.apply({"params": params}, images,
                                          text.astype(np.int32)))["contrastive_loss"]

    jval, jgrads = jax.jit(jax.value_and_grad(f))(bundle.params)
    np.testing.assert_allclose(loss.item(), float(jval), rtol=1e-6)
    grads = from_jax_params(jax.tree.map(np.asarray, jgrads))
    for name, p in model.named_parameters():
        if name.endswith("k_proj.bias"):  # zero in exact math
            assert max(p.grad.abs().max().item(), np.abs(grads[name].numpy()).max()) < 1e-6
        elif p.ndim:
            assert _cos(p.grad.numpy(), grads[name].numpy()) >= 0.99999, name
    model.zero_grad()
    assert {"visual.attn_pool.query", "cls_emb"} <= set(grads)
    tokens, _ = _clip_pair(output_tokens=True)
    with torch.no_grad():
        np.testing.assert_array_equal(
            tokens.encode_image(torch.from_numpy(images)).numpy(),
            model.encode_image(torch.from_numpy(images)).detach().numpy())
    jt = JaxTrainer(_host(bundle), loss=jax_make_loss("clip"), config=JaxTrainerConfig(**_cfg_kw()),
                    mesh=make_mesh(devices=jax.devices()[:1]))
    jstate, jm = jt.make_train_step()(jt.init_state(), jt._device_batch(_batch(17)))
    trainer = Trainer(model, make_loss("clip"), TrainerConfig(**_cfg_kw()))
    state, m = trainer.train_step(trainer.init_state(), _torch_batch(_batch(17)))
    for k in ("loss", "grad_norm", "logit_scale"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    for k, w in from_jax_params(jax.tree.map(np.asarray, jstate.params)).items():
        np.testing.assert_allclose(state.params[k].detach().numpy(), w.numpy(), atol=1e-5,
                                   rtol=0, err_msg=k)


def test_entry_point_trains_and_evaluates_coca(tmp_path):
    """``spatial_clip_tpu_torch.train`` with ``model.model_name=coca_ViT-Test
    loss.name=coca`` (as JAX's train.py reads loss.name) builds CoCa, trains
    two steps and reports val/ and test/ val_generative_loss; the composed
    config is JAX's."""
    from spatial_clip_tpu.config import compose as jax_compose
    from spatial_clip_tpu_torch.train import entry

    args = ["experiment=smoke_synthetic", "trainer.limit_batches=2",
            "model.model_name=coca_ViT-Test", "loss.name=coca", f"paths.root_dir={tmp_path}"]
    cfg = entry.compose_train([*args, "trainer.platform=cpu"])
    assert cfg == jax_compose(entry.CONFIG_DIR, "train", [*args, "trainer.platform=cpu"])
    value, objects = entry.train(cfg)
    assert isinstance(objects["model"], pcoca.CoCa) and objects["state"].step == 2
    metrics = objects["metrics"]
    assert np.isfinite(value) and np.isfinite(metrics["caption_loss"])
    for split in ("val", "test"):
        assert np.isfinite(metrics[f"{split}/val_generative_loss"])
        assert metrics[f"{split}/val_generative_loss"] > 0


def test_server_encodes_with_coca():
    """The embedding server takes CoCa, drawn from seed 0 or handed to it
    (``model=``): its text and raw-image embeddings are the model's
    normalized features, the same from both."""
    from spatial_clip_tpu_torch.models.transforms import normalize_batch
    from spatial_clip_tpu_torch.serve import EmbeddingService

    served = EmbeddingService("coca_ViT-Test", batch_size=3, precision="fp32", device="cpu")
    given = EmbeddingService("coca_ViT-Test", batch_size=3, device="cpu",
                             model=create_model("coca_ViT-Test", precision="fp32",
                                                device="cpu"))
    tiles = np.random.default_rng(18).integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    texts = ["a tumor tile", "stroma", "EPCAM KRT8", "lymphocytes"]
    got = []
    for service in (served, given):
        with torch.no_grad():
            want_img = service.model.encode_image(normalize_batch(torch.from_numpy(tiles)))
            want_txt = service.model.encode_text(
                torch.from_numpy(np.asarray(service.tokenizer(texts), dtype=np.int64)))
        img, txt = service.embed_images_raw(tiles.tobytes()), service.embed_texts(texts)
        np.testing.assert_allclose(img, want_img.numpy(), atol=1e-6)
        np.testing.assert_allclose(txt, want_txt.numpy(), atol=1e-6)
        got.append((img, txt))
        service.close()
    np.testing.assert_array_equal(got[0][0], got[1][0])
    np.testing.assert_array_equal(got[0][1], got[1][1])
    assert served.metadata()["model"] == given.metadata()["model"] == "coca_ViT-Test"
