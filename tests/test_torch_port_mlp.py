"""The port's fused MLP (``mlp_impl='pallas'``) against the JAX package: the
kernel's plain version and the autograd function against the interpret-mode
Pallas ``fused_mlp``, the towers and three Trainer steps under
``mlp_impl='pallas'`` against the JAX towers and Trainer on the same weights,
and the server under the setting.

On the CPU the port's wrapper runs its plain PyTorch version; the JAX kernel
runs in Pallas interpret mode, as tests/test_fused_kernel.py runs it. The same
numpy inputs go to both. ViT-Test is widened to width 128 (2 heads), so its
MLP hidden (512) passes the kernel's gate.

Tolerances: the f32 forward at atol 2e-5 (two f32 products in other summation
orders); bf16 x with f32 parameters within one bf16 step (2^-8) of the
output's largest magnitude, which a bias left unrounded would exceed; the
five gradients at rtol/atol 1e-4; model features at atol 1e-5, model
gradients at 1e-5 + 1e-4 of each gradient's largest entry.
"""
from __future__ import annotations

import tests.helpers.torch_threads  # noqa: F401  (xdist workers share the cores)

import json
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatial_clip_tpu.models import constants as _jax_constants
from spatial_clip_tpu.models.clip import CLIP as _JaxCLIP
from spatial_clip_tpu.models.config import resolve_clip_cfg as _jax_resolve_clip_cfg
from spatial_clip_tpu.models.factory import ModelBundle as _JaxBundle
from spatial_clip_tpu.models.transforms import PreprocessCfg as _JaxPreprocessCfg
from spatial_clip_tpu.losses import make_loss as jax_make_loss
from spatial_clip_tpu.models.transforms import normalize_batch as jax_normalize
from spatial_clip_tpu.ops import fused_mlp as jmlp
from spatial_clip_tpu.parallel.mesh import make_mesh
from spatial_clip_tpu.train.loop import Trainer as JaxTrainer
from spatial_clip_tpu.train.loop import TrainerConfig as JaxTrainerConfig
from spatial_clip_tpu_torch import create_model
from spatial_clip_tpu_torch.losses import make_loss
from spatial_clip_tpu_torch.models.config import CLIPCfg, check_ported
from spatial_clip_tpu_torch.models.convert import (
    from_jax_params,
    from_jax_train_state,
    to_jax_params,
)
from spatial_clip_tpu_torch.ops import fused_mlp as pm
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


def _t(x):
    return torch.from_numpy(np.array(x))


def _mlp_inputs(seed, R, W, H):
    """x and flax-layout parameters (fc_w (W, H), proj_w (H, W))."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(R, W)).astype(np.float32)
    fc_w = (rng.normal(size=(W, H)) * 0.05).astype(np.float32)
    fc_b = (rng.normal(size=(H,)) * 0.05).astype(np.float32)
    pj_w = (rng.normal(size=(H, W)) * 0.05).astype(np.float32)
    pj_b = (rng.normal(size=(W,)) * 0.05).astype(np.float32)
    return x, fc_w, fc_b, pj_w, pj_b


def _port_params(fc_w, fc_b, pj_w, pj_b):
    """The same parameters in the port's (out, in) layout."""
    return _t(fc_w.T), _t(fc_b), _t(pj_w.T), _t(pj_b)


# --------------------------------------------------------------- the kernel

@pytest.mark.parametrize("R,W,H", [(100, 128, 512), (37, 256, 1024)])
def test_plain_forward_matches_jax_kernel_f32(R, W, H):
    x, *params = _mlp_inputs(R + W, R, W, H)
    want = np.asarray(jmlp.fused_mlp(*map(jnp.asarray, (x, *params)), interpret=True))
    before = pm.fused_mlp_fwd.launches
    got = pm.fused_mlp_fwd(_t(x), *_port_params(*params))
    assert pm.fused_mlp_fwd.launches == before  # the CPU runs the plain version
    assert got.shape == (R, W) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    assert torch.equal(got, pm.reference_mlp_fwd(_t(x), *_port_params(*params)))


def test_plain_forward_rounds_like_jax_kernel_bf16():
    """bf16 x with f32 parameters: the biases and weights are rounded to
    bf16 before use and the hidden after GELU, as ``_fwd`` and
    ``_fwd_kernel`` round them. Biases of 0.5 + small offsets lose their
    offsets in bf16, so an unrounded bias would miss by more than the
    tolerance."""
    x, fc_w, fc_b, pj_w, pj_b = _mlp_inputs(3, 100, 128, 512)
    fc_b = (fc_b * 1e-2 + 0.5).astype(np.float32)
    pj_b = (pj_b * 1e-2 + 8.0).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jmlp.fused_mlp(xb, *map(jnp.asarray, (fc_w, fc_b, pj_w, pj_b)),
                                     interpret=True).astype(jnp.float32))
    got = pm.fused_mlp_fwd(_t(np.asarray(xb.astype(jnp.float32))).bfloat16(),
                           *_port_params(fc_w, fc_b, pj_w, pj_b))
    assert got.dtype == torch.bfloat16
    tol = 2 ** -8 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)
    unrounded = pm.reference_mlp_fwd(_t(np.asarray(xb.astype(jnp.float32))),
                                     *_port_params(fc_w, fc_b, pj_w, pj_b))
    assert np.abs(unrounded.numpy() - want).max() > np.abs(got.float().numpy() - want).max()


@pytest.mark.parametrize("R,W,H", [(100, 128, 512), (37, 256, 1024)])
def test_fused_mlp_grads_match_jax(R, W, H):
    """:class:`FusedMLP`'s five gradients against jax.grad of ``fused_mlp``
    with the interpret-mode kernel (its custom VJP's ``_fused_bwd``)."""
    x, *params = _mlp_inputs(R + H, R, W, H)
    g = np.random.default_rng(R).normal(size=(R, W)).astype(np.float32)

    def f(*args):
        return jnp.sum(jmlp.fused_mlp(*args, interpret=True) * g)

    want = jax.grad(f, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, (x, *params)))
    tx = _t(x).requires_grad_()
    tp = [p.requires_grad_() for p in _port_params(*params)]
    (pm.fused_mlp(tx, *tp) * _t(g)).sum().backward()
    got = [tx.grad, tp[0].grad.t(), tp[1].grad, tp[2].grad.t(), tp[3].grad]
    for name, a, e in zip(("dx", "dfc_w", "dfc_b", "dproj_w", "dproj_b"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=1e-4, atol=1e-4, err_msg=name)


def test_fused_mlp_backward_casts_to_each_dtype():
    """bf16 x with f32 parameters (a training model): dx comes back in bf16,
    each parameter's gradient in f32, as ``_fused_bwd`` casts them."""
    x, *params = _mlp_inputs(4, 8, 128, 512)
    tx = _t(x).bfloat16().requires_grad_()
    tp = [p.requires_grad_() for p in _port_params(*params)]
    out = pm.fused_mlp(tx, *tp)
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()
    assert tx.grad.dtype == torch.bfloat16
    assert all(p.grad.dtype == torch.float32 for p in tp)


def test_wrapper_rejects_what_it_does_not_take():
    x, *params = _mlp_inputs(5, 8, 128, 512)
    fc_w, fc_b, pj_w, pj_b = _port_params(*params)
    with pytest.raises(ValueError, match="proj_w"):
        pm.fused_mlp_fwd(_t(x), fc_w, fc_b, fc_w, pj_b)
    with pytest.raises(ValueError, match="x must be"):
        pm.fused_mlp_fwd(_t(x)[None], fc_w, fc_b, pj_w, pj_b)
    with pytest.raises(ValueError, match="dtype"):
        pm.fused_mlp_fwd(_t(x).double(), fc_w, fc_b, pj_w, pj_b)
    assert pm.supported(768, 3072) and pm.supported(512, 2048)
    assert not pm.supported(768, 2304) and not pm.supported(96, 512)


# ------------------------------------------------------------------ the towers

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


# the overrides (both sides take them) and the fused MLP's calls per model
# forward (2 blocks in each tower): one per block where JAX's gate holds; none
# where fused_ln_dense takes c_fc, with quick_gelu, or with a hidden (384)
# that is not a multiple of 512
SETTINGS = {
    "pallas": (dict(mlp_impl="pallas"), 4),
    "pallas_ln_gemm": (dict(mlp_impl="pallas", ln_gemm_impl="pallas"), 0),
    "pallas_quick_gelu": (dict(mlp_impl="pallas", quick_gelu=True), 0),
    "pallas_hidden_384": (dict(mlp_impl="pallas", vision_cfg=dict(width=128, heads=2,
                                                                   mlp_ratio=3.0),
                               text_cfg=dict(width=128, heads=2, mlp_ratio=3.0)), 0),
}


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_model_features_and_gradients_match_jax(setting, monkeypatch):
    """Both towers' features (no grad) and the spatial loss's gradients for
    every parameter against the JAX model of the same setting, on the same
    weights and batch; the port's MLP takes the fused kernel exactly where
    JAX's does."""
    kw, want_calls = SETTINGS[setting]
    kw = {**WIDE, **kw}
    calls = [0]

    def counted(*a):
        calls[0] += 1
        return reference(*a)

    reference = pm.reference_mlp_fwd
    monkeypatch.setattr(pm, "reference_mlp_fwd", counted)
    jb = _jax_model("ViT-Test", precision="fp32", seed=0, **kw)
    batch = _batch(3)
    x = np.array(jax_normalize(batch["images"]))
    jl = jax_make_loss("spatial", cap_logit_scale=50.0)

    def jloss(p):
        f = jb.model.apply({"params": p}, x, batch["texts"], True)
        return jl(**{**batch, **f})["contrastive_loss"], f

    (want, feats), want_g = jax.value_and_grad(jloss, has_aux=True)(jb.params)
    model = create_model("ViT-Test", precision="fp32", device="cpu", training=True, **kw)
    model.load_state_dict(from_jax_params(jb.params))
    tb = _torch_batch(batch)
    with torch.no_grad():
        served = model(_t(x), tb["texts"])
    assert calls[0] == want_calls
    for k in ("image_features", "text_features"):
        np.testing.assert_allclose(served[k].numpy(), np.asarray(feats[k]), atol=1e-5, err_msg=k)
    loss = make_loss("spatial", cap_logit_scale=50.0)(
        **{**tb, **model(_t(x), tb["texts"])})["contrastive_loss"]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    grads = {k: p.grad for k, p in model.named_parameters()}
    for k, w in from_jax_params(want_g).items():
        w = w.numpy()
        np.testing.assert_allclose(grads[k].numpy(), w, rtol=0,
                                   atol=1e-5 + 1e-4 * np.abs(w).max(), err_msg=k)


def test_three_train_steps_match_jax_trainer_mlp_pallas():
    """Three Trainer steps under mlp_impl='pallas' against the JAX Trainer
    (CPU, augment=False, spatial loss with the STE cap, bf16 moments; lr is
    0 at step 0). The Trainer's parameters are views into one flat buffer;
    the fused MLP reads them cast per use. Metrics at rtol 1e-5, exact R@k,
    parameters at atol 2e-5 after the three steps (updates are ~1e-3)."""
    cfg_kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=50, augment=False, seed=0)
    jb = _jax_model("ViT-Test", precision="fp32", seed=0, mlp_impl="pallas", **WIDE)
    jt = JaxTrainer(jb, loss=jax_make_loss("spatial", cap_logit_scale=50.0),
                    config=JaxTrainerConfig(**cfg_kw), mesh=make_mesh(devices=jax.devices()[:1]))
    jstep, jstate = jt.make_train_step(), jt.init_state()
    model = create_model("ViT-Test", precision="fp32", device="cpu", training=True,
                         mlp_impl="pallas", **WIDE)
    model.load_state_dict(from_jax_params(jb.params))
    trainer = Trainer(model, make_loss("spatial", cap_logit_scale=50.0), TrainerConfig(**cfg_kw))
    state = trainer.init_state()
    for i in range(3):
        batch = _batch(20 + i, B=8)
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


# ------------------------------------------------------------------ the server

def test_server_encodes_under_mlp_pallas(monkeypatch):
    """EmbeddingService(mlp_impl='pallas') on the CPU: the fused MLP's plain
    version in every block, embeddings equal to the dense path's on the same
    seeded weights (f32, summation order only)."""
    from spatial_clip_tpu_torch.serve import EmbeddingService

    calls = [0]
    reference = pm.reference_mlp_fwd

    def counted(*a):
        calls[0] += 1
        return reference(*a)

    monkeypatch.setattr(pm, "reference_mlp_fwd", counted)
    fused, dense = (EmbeddingService("ViT-Test", batch_size=4, precision="fp32", device="cpu",
                                     mlp_impl=impl, **WIDE) for impl in ("pallas", "dense"))
    tiles = np.random.default_rng(0).integers(0, 256, (6, 32, 32, 3), dtype=np.uint8)
    texts = ["a tumor tile", "stroma", "EPCAM KRT8"]
    got = (fused.embed_images_raw(tiles.tobytes()), fused.embed_texts(texts))
    assert calls[0] == 2 * 2 + 2  # two image batches (4 + 2), one text batch, 2 blocks each
    want = (dense.embed_images_raw(tiles.tobytes()), dense.embed_texts(texts))
    for a, e in zip(got, want):
        assert a.shape == e.shape and np.isfinite(a).all()
        np.testing.assert_allclose(a, e, atol=1e-5)
    for svc in (fused, dense):
        svc.close()


def test_int8_mlp_is_not_ported():
    from spatial_clip_tpu_torch.serve import main

    with pytest.raises(NotImplementedError, match="mlp_impl='int8'"):
        main(["--model", "ViT-Test", "--device", "cpu", "--mlp-impl", "int8", "--no-warmup"])
    check_ported(CLIPCfg(mlp_impl="pallas"))
    with pytest.raises(NotImplementedError, match="mlp_impl"):
        check_ported(CLIPCfg(mlp_impl="int8"))
