"""The port's fused LayerNorm paths against the JAX package: the fused_ln
and fused_ln_dense kernels' plain versions and autograd functions against
the interpret-mode Pallas kernels, and the towers under ln_impl='pallas'
and ln_gemm_impl='pallas' against the JAX towers on the same weights.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
kernels run in Pallas interpret mode, as tests/test_fused_ln.py and
tests/test_fused_ln_dense.py run them. The same numpy inputs go to both.
ViT-Test is widened to width 128 (2 heads), so every LayerNorm and every
fused projection passes the kernels' 128-multiple gates.

Tolerances (all f32, summation order only): kernel outputs at atol 1e-5
(O(1) values), dgamma/dbeta and dkernel/dbias, sums over the rows, at
atol 1e-4; model features at atol 1e-5, model gradients at
1e-5 + 1e-4 of each gradient's largest entry.
"""
from __future__ import annotations

import tests.helpers.torch_threads  # noqa: F401  (xdist workers share the cores)

import json
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatial_clip_tpu import create_model as jax_create_model
from spatial_clip_tpu.models import constants as _jax_constants
from spatial_clip_tpu.models.clip import CLIP as _JaxCLIP
from spatial_clip_tpu.models.config import resolve_clip_cfg as _jax_resolve_clip_cfg
from spatial_clip_tpu.models.factory import ModelBundle as _JaxBundle
from spatial_clip_tpu.models.transforms import PreprocessCfg as _JaxPreprocessCfg
from spatial_clip_tpu.losses import make_loss as jax_make_loss
from spatial_clip_tpu.models.transformer import LayerNorm as JaxLayerNorm
from spatial_clip_tpu.models.transforms import normalize_batch as jax_normalize
from spatial_clip_tpu.ops import fused_ln as jln
from spatial_clip_tpu.ops import fused_ln_dense as jld
from spatial_clip_tpu.parallel.mesh import make_mesh
from spatial_clip_tpu.train.loop import Trainer as JaxTrainer
from spatial_clip_tpu.train.loop import TrainerConfig as JaxTrainerConfig
from spatial_clip_tpu_torch import create_model
from spatial_clip_tpu_torch.losses import make_loss
from spatial_clip_tpu_torch.models.convert import (
    from_jax_params,
    from_jax_train_state,
    to_jax_params,
)
from spatial_clip_tpu_torch.models.transformer import LayerNorm, MLP, _ln_apply, gelu_tanh
from spatial_clip_tpu_torch.ops import fused_ln_dense as pld
from spatial_clip_tpu_torch.ops.fused_ln import (
    fused_layer_norm,
    fused_ln_bwd,
    fused_ln_fwd,
    reference_ln_bwd,
    reference_ln_fwd,
)
from spatial_clip_tpu_torch.train.loop import Trainer, TrainerConfig

WIDE = dict(vision_cfg=dict(width=128, heads=2), text_cfg=dict(width=128, heads=2))


_JAX_WEIGHTS: dict = {}


def _jax_model(name="ViT-Test", precision="fp32", seed=0, **over):
    """JAX's bundle (``spatial_clip_tpu.create_model``'s) on the port's
    weights drawn from ``seed``: flax's op-by-op initializers take ~3.5 s a
    call on this CPU, and the weights are the port's either way. The numpy
    weights are made once per setting and shared by the module's tests;
    each call gets device arrays of its own, which a JAX Trainer's step may
    donate."""
    key = json.dumps([name, seed, over], sort_keys=True)
    if key not in _JAX_WEIGHTS:
        model = create_model(name, precision="fp32", device="cpu", seed=seed, training=True,
                             **over)
        _JAX_WEIGHTS[key] = to_jax_params(model.state_dict())
    cfg = _jax_resolve_clip_cfg(name, **over)
    return _JaxBundle(
        model=_JaxCLIP(cfg=cfg, dtype=jnp.bfloat16 if precision == "bf16" else jnp.float32),
        params=jax.tree.map(jnp.asarray, _JAX_WEIGHTS[key]), cfg=cfg, model_name=name,
        preprocess_cfg=_JaxPreprocessCfg(size=cfg.vision_cfg.image_size,
                                         mean=_jax_constants.OPENAI_DATASET_MEAN,
                                         std=_jax_constants.OPENAI_DATASET_STD))
SETTINGS = {  # the JAX model's overrides; the port takes the same
    "ln_pallas": dict(ln_impl="pallas"),
    "ln_gemm_attn_pallas": dict(ln_gemm_impl="pallas", attn_impl="pallas"),
    "ln_gemm_attn_pallas3": dict(ln_gemm_impl="pallas", attn_impl="pallas3"),
}
EPS = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _ln_inputs(seed, R, D):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(R, D)) * 2 + 0.5).astype(np.float32)
    gamma = (1 + 0.1 * rng.normal(size=(D,))).astype(np.float32)
    beta = (0.1 * rng.normal(size=(D,))).astype(np.float32)
    dy = rng.normal(size=(R, D)).astype(np.float32)
    return x, gamma, beta, dy


# ------------------------------------------------------------------- fused_ln

@pytest.mark.parametrize("R,D", [(64, 128), (96, 256), (77, 768), (50, 512)])
def test_fused_ln_plain_versions_match_jax_kernels(R, D):
    """The forward and backward kernels' plain versions against
    ``_fwd_impl`` / ``_bwd_impl`` in interpret mode, aligned and ragged R."""
    x, gamma, beta, dy = _ln_inputs(R + D, R, D)
    want_y = jln._fwd_impl(jnp.asarray(x), jnp.asarray(gamma)[None], jnp.asarray(beta)[None],
                           EPS, True)
    want_dx, want_dg, want_db = jln._bwd_impl(jnp.asarray(x), jnp.asarray(gamma)[None],
                                              jnp.asarray(dy), EPS, True)
    y = fused_ln_fwd(_t(x), _t(gamma), _t(beta), EPS)
    dx, dg, db = fused_ln_bwd(_t(x), _t(gamma), _t(dy), EPS)
    assert torch.equal(y, reference_ln_fwd(_t(x), _t(gamma), _t(beta), EPS))
    assert dg.shape == db.shape == (D,) and dg.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=1e-5)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), atol=1e-5)
    np.testing.assert_allclose(dg.numpy(), np.asarray(want_dg)[0], atol=1e-4)
    np.testing.assert_allclose(db.numpy(), np.asarray(want_db)[0], atol=1e-4)


@pytest.mark.parametrize("R", [96, 70])
def test_fused_layer_norm_vjp_matches_jax(R):
    """y and every VJP output of the autograd function against jax.vjp of
    ``fused_layer_norm`` (gamma/beta (1, D), as JAX takes them)."""
    D = 128
    x, gamma, beta, dy = _ln_inputs(R, R, D)
    y_j, vjp = jax.vjp(lambda a, g, b: jln.fused_layer_norm(a, g, b, EPS, True),
                       jnp.asarray(x), jnp.asarray(gamma)[None], jnp.asarray(beta)[None])
    want = vjp(jnp.asarray(dy))
    tx, tg, tb = (_t(a).requires_grad_() for a in (x, gamma[None], beta[None]))
    y = fused_layer_norm(tx, tg, tb, EPS)
    y.backward(_t(dy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), atol=1e-5)
    for got, w, atol in zip((tx.grad, tg.grad, tb.grad), want, (1e-5, 1e-4, 1e-4)):
        assert got.shape == w.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=atol)


def test_fused_ln_bf16_rounds_like_jax():
    """bf16 in and out, f32 statistics: at most one bf16 step (2^-8
    relative) apart where f32 sums in another order round differently."""
    x, gamma, beta, dy = _ln_inputs(3, 40, 256)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jln._fwd_impl(xb, jnp.asarray(gamma)[None], jnp.asarray(beta)[None],
                                    EPS, True), np.float32)
    got = fused_ln_fwd(_t(xb.astype(jnp.float32)).bfloat16(), _t(gamma), _t(beta), EPS)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -8, atol=1e-6)


# -------------------------------------------------------------- fused_ln_dense

def _dense_inputs(seed, R, K, N):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(R, K)) * 2 + 0.5).astype(np.float32)
    gamma = (1 + 0.1 * rng.normal(size=(K,))).astype(np.float32)
    beta = (0.1 * rng.normal(size=(K,))).astype(np.float32)
    kernel = (rng.normal(size=(K, N)) / np.sqrt(K)).astype(np.float32)  # flax (in, out)
    bias = (0.1 * rng.normal(size=(N,))).astype(np.float32)
    g = rng.normal(size=(R, N)).astype(np.float32)
    return x, gamma, beta, kernel, bias, g


@pytest.mark.parametrize("R,K,N", [(70, 128, 256), (256, 256, 384), (33, 128, 384)])
def test_ln_dense_plain_versions_match_jax_kernels(R, K, N):
    """``_fold`` and the forward / dx plain versions against ``_fold``,
    ``_fwd_pallas`` and ``_bwd_dx_pallas`` in interpret mode: y, xhat, dx."""
    x, gamma, beta, kernel, bias, g = _dense_inputs(R + K + N, R, K, N)
    w1_j, b1_j = jld._fold(gamma, beta, kernel, bias, jnp.float32)
    want_y, want_xhat = jld._fwd_pallas(jnp.asarray(x), w1_j, b1_j, EPS, True)
    want_dx = jld._bwd_dx_pallas(jnp.asarray(x), jnp.asarray(g), w1_j, EPS, True)
    w1, b1 = pld._fold(_t(gamma), _t(beta), _t(kernel.T), _t(bias), torch.float32)
    np.testing.assert_allclose(w1.numpy(), np.asarray(w1_j).T, atol=1e-7)
    np.testing.assert_allclose(b1.numpy(), np.asarray(b1_j), atol=1e-6)
    y, xhat = pld.ln_dense_fwd(_t(x), w1.contiguous(), b1, EPS)
    dx = pld.ln_dense_bwd_dx(_t(x), _t(g), w1.contiguous(), EPS)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=1e-5)
    np.testing.assert_allclose(xhat.numpy(), np.asarray(want_xhat), atol=1e-5)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), atol=1e-5)


@pytest.mark.parametrize("R", [70, 256])
def test_fused_ln_dense_vjp_matches_jax(R):
    """y and the five VJP outputs (dx, dgamma, dbeta, dkernel, dbias) of
    the autograd function against jax.vjp of ``fused_ln_dense``; the
    port's weight is the transpose of flax's kernel. Also against the JAX
    package's plain ``reference_ln_dense``."""
    K, N = 128, 256
    x, gamma, beta, kernel, bias, g = _dense_inputs(R, R, K, N)
    y_j, vjp = jax.vjp(lambda *a: jld.fused_ln_dense(*a, EPS, True),
                       *map(jnp.asarray, (x, gamma, beta, kernel, bias)))
    want = vjp(jnp.asarray(g))
    args = [_t(a).requires_grad_() for a in (x, gamma, beta, kernel.T.copy(), bias)]
    y = pld.fused_ln_dense(*args, EPS)
    y.backward(_t(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), atol=1e-5)
    ref = pld.reference_ln_dense(*(a.detach() for a in args), EPS)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jld.reference_ln_dense(
        *map(jnp.asarray, (x, gamma, beta, kernel, bias)))), atol=1e-5)
    np.testing.assert_allclose(y.detach().numpy(), ref.numpy(), atol=1e-5)
    names = ("dx", "dgamma", "dbeta", "dkernel", "dbias")
    for name, a, w in zip(names, args, want):
        w = np.asarray(w).T if name == "dkernel" else np.asarray(w)
        np.testing.assert_allclose(a.grad.numpy(), w, atol=1e-5 if name == "dx" else 1e-4,
                                   err_msg=name)


# ------------------------------------------------------------ gates, weights

def test_width_off_the_128_grid_takes_two_pass_stats():
    """D = 96: JAX's LayerNorm(stats_dtype='pallas') falls through to
    two-pass statistics; so does the port's, and the LN -> GEMM gate sends
    the MLP's pre-LN to the two-pass _ln_apply."""
    x, gamma, beta, _ = _ln_inputs(9, 24, 96)
    x = x + 30.0  # |mean| >> std: one-pass and two-pass differ here
    params = {"params": {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)}}
    want = np.asarray(JaxLayerNorm(stats_dtype="pallas").apply(params, jnp.asarray(x)))
    ln = LayerNorm(96, EPS, "pallas")
    with torch.no_grad():
        ln.weight.copy_(_t(gamma))
        ln.bias.copy_(_t(beta))
        got = ln(_t(x))
        two_pass = _ln_apply(_t(x), ln.weight, ln.bias, EPS, torch.float32)
        one_pass = _ln_apply(_t(x), ln.weight, ln.bias, EPS, torch.float32, "onepass")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert torch.equal(got, two_pass) and not torch.equal(got, one_pass)
    assert not pld.supported(96, 384) and pld.supported(128, 512)

    mlp = MLP(96, 384, gelu_tanh, torch.float32, torch.float32, "cpu")
    with torch.no_grad():
        for p in mlp.parameters():
            p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(0)) * 0.1)
        np.testing.assert_array_equal(mlp(_t(x), ln=ln.args()).numpy(),
                                      mlp(two_pass).numpy())


@pytest.fixture(scope="module")
def default_tree():
    return from_jax_params(jax_create_model("ViT-Test", precision="fp32", seed=0, **WIDE).params)


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_from_jax_params_takes_every_ln_tree(setting, default_tree):
    """The fused settings' trees (``_LNParams``, ``_DenseParams``) are the
    default tree: from_jax_params maps them with no new key, and the
    port's model of the same setting loads them. The port draws the same
    weights from a seed under every setting."""
    base = default_tree
    params = from_jax_params(jax_create_model("ViT-Test", precision="fp32", seed=0, **WIDE,
                                              **SETTINGS[setting]).params)
    assert {k: v.shape for k, v in params.items()} == {k: v.shape for k, v in base.items()}
    model = create_model("ViT-Test", precision="fp32", device="cpu", **WIDE,
                         **SETTINGS[setting])
    model.load_state_dict(params)
    seeded = [create_model("ViT-Test", precision="fp32", device="cpu", seed=0, **WIDE, **kw)
              for kw in ({}, SETTINGS[setting])]
    for (k, a), (k2, b) in zip(*(m.state_dict().items() for m in seeded)):
        assert k == k2 and torch.equal(a, b), k


# ----------------------------------------------------------------- model level

def _batch(seed, B=4, size=32, ctx=16, vocab=512, k=4):
    rng = np.random.default_rng(seed)
    tile_ids = np.arange(B, dtype=np.int32)
    return {
        "images": rng.integers(0, 256, (B, size, size, 3), dtype=np.uint8),
        "texts": rng.integers(0, vocab, (B, ctx), dtype=np.int32),
        "image_tile_ids": tile_ids,
        "text_tile_ids": tile_ids.copy(),
        "neighbor_tile_ids": rng.integers(-1, B, (B, k)).astype(np.int32),
        "neighbor_alphas": rng.uniform(0, 1, (B, k)).astype(np.float32),
    }


def _torch_batch(batch):
    return {k: _t(v).long() if k == "texts" else _t(v) for k, v in batch.items()}


# plain-version calls per model forward, (fused_ln, fused_ln_dense): JAX's
# routing. ln_impl='pallas': image ln_pre + 2 x 2 + ln_post, text 2 x 2 +
# ln_final; ln_gemm_impl='pallas': ln_1 -> qkv and ln_2 -> c_fc of 4 blocks
# under attn_impl='pallas', ln_2 -> c_fc alone under 'pallas3'. Then the
# recompute attention backward's calls per backward: the 4 blocks whose qkv
# the fused projection makes.
ROUTES = {"ln_pallas": (11, 0), "ln_gemm_attn_pallas": (0, 8), "ln_gemm_attn_pallas3": (0, 4)}
RECOMPUTE_BWD = {"ln_pallas": 0, "ln_gemm_attn_pallas": 4, "ln_gemm_attn_pallas3": 0}


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_model_features_and_gradients_match_jax(setting, monkeypatch):
    """Both towers' features (no grad) and the spatial loss's gradients for
    every parameter against the JAX model of the same setting, on the same
    weights and batch, at the model-level tolerances above; each fused
    LayerNorm JAX routes to a kernel goes through the port's wrapper."""
    from spatial_clip_tpu_torch.ops import fused_attention, fused_ln

    calls = [0, 0, 0]

    def counted(i, fn):
        def wrapper(*a):
            calls[i] += 1
            return fn(*a)
        return wrapper

    monkeypatch.setattr(fused_ln, "reference_ln_fwd", counted(0, fused_ln.reference_ln_fwd))
    monkeypatch.setattr(pld, "reference_ln_dense_fwd", counted(1, pld.reference_ln_dense_fwd))
    monkeypatch.setattr(fused_attention, "fused_attention_bwd_recompute",
                        counted(2, fused_attention.fused_attention_bwd_recompute))
    kw = SETTINGS[setting]
    jb = _jax_model(**WIDE, **kw)
    batch = _batch(3)
    x = np.array(jax_normalize(batch["images"]))
    jl = jax_make_loss("spatial", cap_logit_scale=50.0)

    def jloss(p):
        f = jb.model.apply({"params": p}, x, batch["texts"], True)
        return jl(**{**batch, **f})["contrastive_loss"], f

    (want, feats), want_g = jax.value_and_grad(jloss, has_aux=True)(jb.params)
    model = create_model("ViT-Test", precision="fp32", device="cpu", training=True, **WIDE, **kw)
    model.load_state_dict(from_jax_params(jb.params))
    tb = _torch_batch(batch)
    with torch.no_grad():
        served = model(_t(x), tb["texts"])
    assert tuple(calls[:2]) == ROUTES[setting]
    for k in ("image_features", "text_features"):
        np.testing.assert_allclose(served[k].numpy(), np.asarray(feats[k]), atol=1e-5, err_msg=k)
    loss = make_loss("spatial", cap_logit_scale=50.0)(
        **{**tb, **model(_t(x), tb["texts"])})["contrastive_loss"]
    loss.backward()
    assert calls[2] == RECOMPUTE_BWD[setting]
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    grads = {k: p.grad for k, p in model.named_parameters()}
    for k, w in from_jax_params(want_g).items():
        w = w.numpy()
        np.testing.assert_allclose(grads[k].numpy(), w, rtol=0,
                                   atol=1e-5 + 1e-4 * np.abs(w).max(), err_msg=k)


def test_three_train_steps_match_jax_trainer_ln_pallas():
    """Three Trainer steps under ln_impl='pallas' against the JAX Trainer
    (CPU, augment=False, spatial loss with the STE cap, bf16 moments; lr
    is 0 at step 0): metrics at rtol 1e-5, exact R@k, parameters at atol
    2e-5 after the three steps (updates are ~1e-3)."""
    cfg_kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=50, augment=False, seed=0)
    jb = _jax_model(ln_impl="pallas", **WIDE)
    jt = JaxTrainer(jb, loss=jax_make_loss("spatial", cap_logit_scale=50.0),
                    config=JaxTrainerConfig(**cfg_kw), mesh=make_mesh(devices=jax.devices()[:1]))
    jstep, jstate = jt.make_train_step(), jt.init_state()
    model = create_model("ViT-Test", precision="fp32", device="cpu", training=True,
                         ln_impl="pallas", **WIDE)
    model.load_state_dict(from_jax_params(jb.params))
    trainer = Trainer(model, make_loss("spatial", cap_logit_scale=50.0), TrainerConfig(**cfg_kw))
    state = trainer.init_state()
    for i in range(3):
        batch = _batch(10 + i, B=8)
        jstate, jm = jstep(jstate, jt._device_batch(batch))
        state, m = trainer.train_step(state, _torch_batch(batch))
        for k in ("loss", "grad_norm", "logit_scale", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, atol=1e-12,
                                       err_msg=f"step {i} {k}")
        for k in ("R@1", "R@5", "R@10"):
            assert float(m[k]) == float(jm[k]), (i, k)
    want = from_jax_train_state(jax.tree.map(np.asarray, jstate))
    assert (state.count, state.step) == (want.count, want.step) == (3, 3)
    for k, w in want.params.items():
        np.testing.assert_allclose(state.params[k].detach().numpy(), w.detach().numpy(),
                                   atol=2e-5, rtol=0, err_msg=k)
