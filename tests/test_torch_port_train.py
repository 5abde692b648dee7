"""The port's training slice against the JAX package on the same inputs:
the augment/normalize stage, the losses, the schedules, the optimizer chain,
the model's loss gradients, whole train steps (with and without gradient
accumulation), fit and evaluate.

ViT-Test is widened to head_dim 64 (width 128, 2 heads), as the other port
tests widen it, so both towers take the attention kernels' geometry. Random
inputs come from numpy seeds; JAX's random draws are passed to the port.
Tolerances (all f32) are stated in each test.
"""
from __future__ import annotations

import tests.helpers.torch_threads  # noqa: F401  (xdist workers share the cores)

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from spatial_clip_tpu.models import constants as jax_constants
from spatial_clip_tpu.models.clip import CLIP as JaxCLIP
from spatial_clip_tpu.models.config import resolve_clip_cfg as jax_resolve_clip_cfg
from spatial_clip_tpu.models.factory import ModelBundle
from spatial_clip_tpu.models.transforms import PreprocessCfg
from spatial_clip_tpu.losses import make_loss as jax_make_loss
from spatial_clip_tpu.models.transforms import augment_normalize_batch as jax_augment
from spatial_clip_tpu.parallel.mesh import make_mesh
from spatial_clip_tpu.train import optim as jax_optim
from spatial_clip_tpu.train.loop import Trainer as JaxTrainer
from spatial_clip_tpu.train.loop import TrainerConfig as JaxTrainerConfig
from spatial_clip_tpu.train.metrics import recall_at_k as jax_recall_at_k
from spatial_clip_tpu_torch import create_model
from spatial_clip_tpu_torch.losses import make_loss
from spatial_clip_tpu_torch.models.convert import (
    find_adam_state,
    from_jax_params,
    from_jax_train_state,
    to_jax_params,
)
from spatial_clip_tpu_torch.models.transforms import AugmentDraws, augment_normalize_batch
from spatial_clip_tpu_torch.ops.fused_attention import fused_attention_bwd, fused_attention_lse
from spatial_clip_tpu_torch.train.loop import Trainer, TrainerConfig, TrainState
from spatial_clip_tpu_torch.train.metrics import recall_at_k
from spatial_clip_tpu_torch.train.optim import AdamW, make_schedule

WIDE = dict(vision_cfg=dict(width=128, heads=2), text_cfg=dict(width=128, heads=2))
SPATIAL_KEYS = ("image_tile_ids", "text_tile_ids", "neighbor_tile_ids", "neighbor_alphas")


_BUNDLES: dict = {}


def _jax_vit_test(**over):
    """JAX's widened ViT-Test bundle (f32) on the port's seed-0 weights
    (flax's op-by-op init takes ~3.5 s a call on this CPU, and the weights
    are the port's either way). The numpy weights are made once per setting
    and shared by the module's tests; each call gets its own device arrays,
    which a JAX Trainer's step may donate."""
    key = tuple(sorted(over.items()))
    if key not in _BUNDLES:
        model = create_model("ViT-Test", precision="fp32", device="cpu", training=True, **WIDE)
        _BUNDLES[key] = (jax_resolve_clip_cfg("ViT-Test", **WIDE, **over),
                         to_jax_params(model.state_dict()))
    cfg, params = _BUNDLES[key]
    return ModelBundle(
        model=JaxCLIP(cfg=cfg, dtype=jnp.float32), params=jax.tree.map(jnp.asarray, params),
        cfg=cfg, model_name="ViT-Test", preprocess_cfg=PreprocessCfg(
            size=cfg.vision_cfg.image_size, mean=jax_constants.OPENAI_DATASET_MEAN,
            std=jax_constants.OPENAI_DATASET_STD))


def _batch(seed, B=8, size=32, ctx=16, vocab=512, k=4):
    """A numpy batch with the trainer's schema: duplicate tile ids and -1
    neighbor padding included."""
    rng = np.random.default_rng(seed)
    tile_ids = np.arange(B, dtype=np.int32)
    tile_ids[-1] = tile_ids[0]  # a duplicated tile id
    return {
        "images": rng.integers(0, 256, (B, size, size, 3), dtype=np.uint8),
        "texts": rng.integers(0, vocab, (B, ctx), dtype=np.int32),
        "image_tile_ids": tile_ids,
        "text_tile_ids": tile_ids.copy(),
        "neighbor_tile_ids": rng.integers(-1, B, (B, k)).astype(np.int32),
        "neighbor_alphas": rng.uniform(0, 1, (B, k)).astype(np.float32),
    }


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)).long() if v.dtype == np.int32 and k == "texts"
            else torch.from_numpy(np.array(v)) for k, v in batch.items()}


# ------------------------------------------------------------------ transforms

@pytest.mark.parametrize("jitter", [None, 0.2])
def test_augment_normalize_matches_jax_with_its_draws(jitter):
    """JAX's draws (its key split into flip, b, c) passed to the port: f32
    outputs agree at atol 2e-5 (the port folds jitter and normalization into
    one scale and shift per image and channel; JAX applies them in turn)."""
    u8 = np.random.default_rng(4).integers(0, 256, (6, 16, 16, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax_augment(key, u8, horizontal_flip_prob=0.5, color_jitter=jitter))
    k_flip, k_b, k_c = jax.random.split(key, 3)
    flip = np.asarray(jax.random.bernoulli(k_flip, 0.5, (6, 1, 1, 1))).reshape(-1)
    assert 0 < flip.sum() < 6  # both branches of the select are exercised
    b = c = None
    if jitter:
        b = 1.0 + np.asarray(jax.random.uniform(k_b, (6, 1, 1, 1), minval=-jitter,
                                                maxval=jitter)).reshape(-1)
        c = 1.0 + np.asarray(jax.random.uniform(k_c, (6, 1, 1, 1), minval=-jitter,
                                                maxval=jitter)).reshape(-1)
    draws = AugmentDraws(*(None if d is None else torch.from_numpy(np.array(d))
                           for d in (flip, b, c)))
    got = augment_normalize_batch(torch.from_numpy(u8), draws).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


# ---------------------------------------------------------------------- losses

def _features(seed, B=8, D=16):
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(2, B, D)).astype(np.float32)
    return f / np.linalg.norm(f, axis=-1, keepdims=True)


@pytest.mark.parametrize("kind,options,log_scale", [
    ("spatial", dict(cap_logit_scale=50.0), math.log(100.0)),   # STE cap active
    ("spatial", dict(cap_logit_scale=50.0, temp_reg_weight=0.5), math.log(20.0)),
    ("spatial", dict(neighbor_alpha_scale=2.0), math.log(1 / 0.07)),
    ("clip", {}, math.log(1 / 0.07)),
])
def test_loss_and_grads_match_jax(kind, options, log_scale):
    """Loss and its gradients w.r.t. both feature matrices and the raw
    logit scale (through the straight-through cap, which passes the raw
    scale's gradient) at rtol 1e-5 / atol 1e-6."""
    img, txt = _features(1)
    batch = _batch(2)
    spatial = {k: batch[k] for k in SPATIAL_KEYS}

    def jloss(i, t, s):
        return jax_make_loss(kind, **options)(
            image_features=i, text_features=t, logit_scale=jnp.exp(s),
            **spatial)["contrastive_loss"]

    want, want_g = jax.value_and_grad(jloss, argnums=(0, 1, 2))(img, txt, jnp.float32(log_scale))
    ti = torch.from_numpy(img).requires_grad_()
    tt = torch.from_numpy(txt).requires_grad_()
    ts = torch.tensor(log_scale, dtype=torch.float32, requires_grad=True)
    got = make_loss(kind, **options)(
        image_features=ti, text_features=tt, logit_scale=ts.exp(),
        **{k: torch.from_numpy(v) for k, v in spatial.items()})["contrastive_loss"]
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for g, w in zip((ti.grad, tt.grad, ts.grad), want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


def test_soft_labels_weigh_every_duplicate_and_skip_padding():
    from spatial_clip_tpu.losses import build_spatial_soft_labels as jax_labels
    from spatial_clip_tpu_torch.losses import build_spatial_soft_labels

    ids = np.array([0, 1, 2, 1], np.int32)  # tile 1 twice
    nbr = np.array([[1, -1], [2, 0], [-1, -1], [0, 3]], np.int32)
    alphas = np.array([[0.5, 0.9], [0.25, 0.75], [0.3, 0.3], [-0.2, 1.0]], np.float32)
    gt = np.arange(4, dtype=np.int32)
    want = np.asarray(jax_labels(ids, gt, nbr, alphas))
    got = build_spatial_soft_labels(*map(torch.from_numpy, (ids, gt, nbr, alphas))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0, 1] == got[0, 3] > 0 and got[2, 2] == 1.0


def test_recall_at_k_matches_jax():
    logits = np.random.default_rng(0).normal(size=(12, 12)).astype(np.float32)
    targets = np.arange(12, dtype=np.int32)
    for k in (1, 5, 10, 20):
        assert recall_at_k(torch.from_numpy(logits), torch.from_numpy(targets).long(), k).item() \
            == pytest.approx(float(jax_recall_at_k(logits, targets, k)))


# ------------------------------------------------------------ schedules, optim

@pytest.mark.parametrize("name,kw", [
    ("cosine", dict(warmup_steps=10, total_steps=100)),
    ("cosine", dict(warmup_steps=0, total_steps=30)),
    ("const", dict(warmup_steps=5, total_steps=30)),
    ("const", dict(warmup_steps=0, total_steps=30)),
    ("const-cooldown", dict(warmup_steps=5, total_steps=40, cooldown_steps=10,
                            cooldown_power=2.0)),
])
def test_schedules_match_optax_step_by_step(name, kw):
    """Every step through the end of the schedule and past it, at rtol 1e-6
    or 1e-6 of the peak lr: near the end of the cosine, 1 + cos(x) cancels
    and the two f32 cos implementations differ there by ~1e-5 relative."""
    want = jax_optim.make_schedule(name, 5e-4, **kw)
    got = make_schedule(name, 5e-4, **kw)
    for step in range(kw["total_steps"] + 5):
        assert got(step) == pytest.approx(float(want(jnp.int32(step))), rel=1e-6, abs=5e-10)
    if name == "cosine":
        assert got(0) == 0.0


def test_flat_layout_aligns_every_parameter():
    """Every parameter's view starts on a 16-byte boundary (the kernels read
    16-byte vectors of gamma and beta); the gaps hold zeros in each flat
    buffer and in a flattened gradient; by_name inverts flatten."""
    shapes = {"a": (6, 5), "b": (5,), "c": (3, 2, 4), "logit_scale": (), "d": (7,)}
    params = {k: torch.randn(s) for k, s in shapes.items()}
    state = TrainState.create(params, {k: torch.ones(s) for k, s in shapes.items()},
                              {k: torch.ones(s) for k, s in shapes.items()})
    assert state.order == ("a", "c", "b", "logit_scale", "d")
    assert state.n_decay == 32 + 24  # c starts at 32, after a's 30 and a gap of 2
    for name, views in (("params", state.params), ("mu", state.mu), ("nu", state.nu)):
        flat = state.flat[name]
        covered = torch.zeros(flat.numel(), dtype=torch.bool)
        for k, v in views.items():
            assert state.offsets[k] % 4 == 0 and v.data_ptr() % 8 == 0, (name, k)
            covered[state.offsets[k]:state.offsets[k] + v.numel()] = True
        assert (flat[~covered] == 0).all() and int((~covered).sum()) == 2 + 3 + 3
    assert all(v.data_ptr() % 16 == 0 for v in state.params.values())
    grads = [torch.randn(shapes[k]) for k in state.order]
    flat = state.flatten(grads)
    assert flat.shape == state.flat["params"].shape
    back = state.by_name(flat)
    for k, g in zip(state.order, grads):
        assert torch.equal(back[k], g)


@pytest.mark.parametrize("mu,nu", [("bf16", "bf16"), (None, None), (None, "bf16")])
def test_optimizer_chain_matches_make_optimizer(mu, nu):
    """clip -> Adam (f32 math, moments stored in mu/nu dtype) -> masked decay
    -> -lr, four steps (lr is 0 at step 0). Parameters at atol 1e-6 (updates
    are ~1e-3); moments at rtol 2^-7 where stored in bf16 (the two sides may
    round an f32 value that lies on a bf16 tie differently), 1e-5 in f32."""
    rng = np.random.default_rng(0)
    shapes = {"a": (6, 5), "b": (5,), "c": (3, 2, 4), "logit_scale": ()}
    params = {k: np.asarray(rng.normal(size=s), np.float32) for k, s in shapes.items()}
    tx, _ = jax_optim.make_optimizer(params, learning_rate=1e-3, weight_decay=0.2,
                                     grad_clip_norm=1.0, schedule_name="cosine",
                                     warmup_steps=2, total_steps=20, mu_dtype=mu, nu_dtype=nu)
    jstate, jparams = tx.init(params), dict(params)
    dtypes = {None: torch.float32, "bf16": torch.bfloat16}
    zeros = {k: torch.zeros(s) for k, s in shapes.items()}
    state = TrainState.create({k: torch.from_numpy(v.copy()) for k, v in params.items()},
                              zeros, zeros, mu_dtype=dtypes[mu], nu_dtype=dtypes[nu])
    opt = AdamW(make_schedule("cosine", 1e-3, 2, 20), 0.2, (0.9, 0.98), 1e-6, 1.0)
    for step in range(4):
        grads = {k: np.asarray(rng.normal(size=s) * (3.0 if step == 1 else 0.1), np.float32)
                 for k, s in shapes.items()}  # step 1 is clipped
        updates, jstate = tx.update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        flat = state.flatten([torch.from_numpy(grads[k]) for k in state.order])
        state.count, _ = opt.update(state.flat["params"], flat, state.flat["mu"],
                                    state.flat["nu"], state.count, state.n_decay)
    adam = find_adam_state(jstate)
    assert state.count == int(adam.count) == 4
    for k in shapes:
        np.testing.assert_allclose(state.params[k].detach().numpy(), np.asarray(jparams[k]),
                                   atol=1e-6, rtol=0)
        for name, ours, theirs in (("mu", state.mu[k], adam.mu[k]), ("nu", state.nu[k], adam.nu[k])):
            bf16 = ours.dtype == torch.bfloat16
            np.testing.assert_allclose(ours.float().numpy(), np.asarray(theirs, np.float32),
                                       rtol=2 ** -7 if bf16 else 1e-5, atol=1e-12, err_msg=name)


# ----------------------------------------------------------------- model level

def _jax_spatial_features(bundle, params, x, texts):
    return bundle.model.apply({"params": params}, x, texts, True)


def test_model_loss_gradients_match_jax_pallas3():
    """Loss gradients through both towers against jax.grad with
    attn_impl='pallas3', whose attention runs the interpret-mode
    `_fwd_kernel_lse` / `_bwd_kernel3_db_lse`: every parameter's gradient,
    the qkv-bias gradients the backward kernel produces included, at
    atol 1e-5 + rtol 1e-3 of its largest entry."""
    jb = _jax_vit_test(attn_impl="pallas3")
    batch = _batch(3, B=4)
    from spatial_clip_tpu.models.transforms import normalize_batch as jax_normalize

    x = np.array(jax_normalize(batch["images"]))
    jl = jax_make_loss("spatial", cap_logit_scale=50.0, temp_reg_weight=0.1)

    def jloss(p):
        f = _jax_spatial_features(jb, p, x, batch["texts"])
        return jl(**{**batch, **f})["contrastive_loss"]

    want, want_g = jax.jit(jax.value_and_grad(jloss))(jb.params)
    model = create_model("ViT-Test", precision="fp32", device="cpu", training=True, **WIDE)
    model.load_state_dict(from_jax_params(jb.params))
    tb = _torch_batch(batch)
    before = (fused_attention_lse.launches, fused_attention_bwd.launches)
    loss = make_loss("spatial", cap_logit_scale=50.0, temp_reg_weight=0.1)(
        **{**tb, **model(torch.from_numpy(x), tb["texts"])})["contrastive_loss"]
    loss.backward()
    assert (fused_attention_lse.launches, fused_attention_bwd.launches) == before  # CPU: plain
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    want_g = from_jax_params(want_g)
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(grads) == set(want_g)
    for k, w in want_g.items():
        w = w.numpy()
        np.testing.assert_allclose(grads[k].numpy(), w, rtol=0,
                                   atol=1e-5 + 1e-3 * np.abs(w).max(), err_msg=k)


def test_three_train_steps_match_jax_trainer():
    """Three steps of the port's Trainer against the JAX Trainer (CPU,
    augment=False, spatial loss with the STE cap and temp_reg, bf16
    moments; lr is 0 at step 0, so steps 1 and 2 move the weights).
    Metrics at rtol 1e-5 (loss, grad_norm, logit_scale, lr) and exact R@k;
    after the three steps the parameters at atol 2e-5 (updates are ~1e-3),
    mu and nu at rtol 2^-7 (bf16 storage: one bf16 step where an f32 value
    lands on the other side of a rounding) + atol 2e-3 of the tensor's
    largest entry (near-zero entries carry the f32 noise of gradients summed
    with cancellation, as the key projection's are), count and step
    equal. The JAX state's conversion (from_jax_train_state) is checked on
    the way."""
    cfg_kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=50, augment=False, seed=0)
    loss_kw = dict(cap_logit_scale=50.0, temp_reg_weight=0.1)
    jb = _jax_vit_test()
    jt = JaxTrainer(jb, loss=jax_make_loss("spatial", **loss_kw),
                    config=JaxTrainerConfig(**cfg_kw), mesh=make_mesh(devices=jax.devices()[:1]))
    jstep, jstate = jt.make_train_step(), jt.init_state()

    model = create_model("ViT-Test", precision="fp32", device="cpu", training=True, **WIDE)
    model.load_state_dict(from_jax_params(jb.params))
    trainer = Trainer(model, make_loss("spatial", **loss_kw), TrainerConfig(**cfg_kw))
    state = trainer.init_state()
    for i in range(3):
        batch = _batch(10 + i)
        jstate, jm = jstep(jstate, jt._device_batch(batch))
        state, m = trainer.train_step(state, _torch_batch(batch))
        for k in ("loss", "grad_norm", "logit_scale", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, atol=1e-12,
                                       err_msg=f"step {i} {k}")
        for k in ("R@1", "R@5", "R@10"):
            assert float(m[k]) == float(jm[k]), (i, k)
    jstate = jax.tree.map(np.asarray, jstate)
    want = from_jax_train_state(jstate)
    assert (state.count, state.step) == (want.count, want.step) == (3, 3)
    # from_jax_train_state: the model's names and shapes, flax (in, out) -> torch
    # (out, in), the decayed (ndim >= 2) parameters leading the flat buffer
    assert {k: v.shape for k, v in want.params.items()} == {
        k: p.shape for k, p in model.named_parameters()}
    np.testing.assert_array_equal(
        want.params["transformer.resblocks.0.attn.in_proj_weight"].detach().numpy(),
        jstate.params["text"]["transformer"]["resblocks_0"]["attn"]["qkv"]["kernel"].T)
    assert want.n_decay == sum(v.numel() for v in want.params.values() if v.ndim >= 2)
    for k, w in want.params.items():
        np.testing.assert_allclose(state.params[k].detach().numpy(), w.detach().numpy(),
                                   atol=2e-5, rtol=0, err_msg=k)
        for name in ("mu", "nu"):
            ours, theirs = getattr(state, name)[k], getattr(want, name)[k]
            assert ours.dtype == theirs.dtype == torch.bfloat16
            theirs = theirs.float().numpy()
            np.testing.assert_allclose(ours.float().numpy(), theirs, rtol=2 ** -7,
                                       atol=2e-3 * np.abs(theirs).max(), err_msg=f"{name} {k}")


# ------------------------------------------- gradient accumulation, fit, eval

FUSED_LOSS = dict(cap_logit_scale=50.0, use_fused_kernel=True)


def _pair(cfg_kw, loss_kw=FUSED_LOSS):
    """The JAX Trainer and the port's on the same widened ViT-Test weights."""
    jb = _jax_vit_test()
    jt = JaxTrainer(jb, loss=jax_make_loss("spatial", **loss_kw),
                    config=JaxTrainerConfig(**cfg_kw), mesh=make_mesh(devices=jax.devices()[:1]))
    model = create_model("ViT-Test", precision="fp32", device="cpu", training=True, **WIDE)
    model.load_state_dict(from_jax_params(jb.params))
    return jt, Trainer(model, make_loss("spatial", **loss_kw), TrainerConfig(**cfg_kw))


@pytest.mark.parametrize("mode", ["cached", "simple"])
def test_grad_accum_steps_match_jax_trainer(mode):
    """Three steps at grad_accum=2 (microbatches of 4) with the fused loss,
    augment=False, against the JAX Trainer, at the tolerances of
    test_three_train_steps_match_jax_trainer: metrics at rtol 1e-5 and exact
    R@k (cached: full-batch 8 x 8 logits; simple: the last microbatch's
    4 x 4), parameters at atol 2e-5 after the three steps."""
    jt, trainer = _pair(dict(learning_rate=1e-3, warmup_steps=2, total_steps=50, augment=False,
                             seed=0, grad_accum=2, grad_accum_mode=mode))
    jstep, jstate = jt.make_train_step(), jt.init_state()
    state = trainer.init_state()
    for i in range(3):
        batch = _batch(20 + i)
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


def test_cached_accum_reproduces_full_batch_gradient():
    """accum=4 cached (microbatches of 4 rows, neighbors that cross them)
    against one full-batch gradient on the same parameters, fused loss, no
    augmentation: every gradient at rtol 2e-3 / atol 2e-5
    (tests/test_train_loop.py's tolerances), the logit scale's summed 4
    times (the reference's quirk); the loss equal at rtol 1e-5 and the
    logits over the full batch."""
    model = create_model("ViT-Test", precision="fp32", device="cpu", training=True, **WIDE)
    batch = _torch_batch(_batch(30, B=16))
    nbr, rows = batch["neighbor_tile_ids"], torch.arange(16)[:, None]
    assert ((nbr >= 0) & ((nbr - rows).abs() >= 4)).any()  # crosses microbatches
    runs = {}
    for accum in (1, 4):
        trainer = Trainer(model, make_loss("spatial", **FUSED_LOSS),
                          TrainerConfig(augment=False, grad_accum=accum))
        state = trainer.init_state()
        runs[accum] = (state, *trainer.forward_backward(state, batch))
    (state, loss_full, _, g_full), (_, loss_acc, logits, g_acc) = runs[1], runs[4]
    assert logits.shape == (16, 16)
    np.testing.assert_allclose(loss_acc.item(), loss_full.item(), rtol=1e-5)
    full, acc = state.by_name(g_full), state.by_name(g_acc)
    np.testing.assert_allclose(acc["logit_scale"].item(), 4 * full["logit_scale"].item(),
                               rtol=1e-4)
    for k in state.order:
        if k != "logit_scale":
            np.testing.assert_allclose(acc[k].numpy(), full[k].numpy(), rtol=2e-3, atol=2e-5,
                                       err_msg=k)


def test_batch_that_grad_accum_does_not_split_raises():
    model = create_model("ViT-Test", precision="fp32", device="cpu", training=True, **WIDE)
    trainer = Trainer(model, make_loss("spatial"), TrainerConfig(augment=False, grad_accum=3))
    with pytest.raises(ValueError, match="grad_accum=3"):
        trainer.train_step(trainer.init_state(), _torch_batch(_batch(0)))


def test_fit_and_evaluate_match_jax_fit():
    """Trainer.fit over two epochs of numpy batches (cached grad_accum=2,
    fused loss, log_every=1) with validation, against the JAX Trainer's fit
    on the same batches: every key of the last metrics (timing keys
    excepted: their values) at rtol 1e-5, the in-batch and full-split
    retrieval metrics exactly, best_step equal; then evaluate() alone gives
    the val/ metrics again."""
    cfg_kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=20, augment=False, seed=0,
                  grad_accum=2, log_every=1, monitor="loss", monitor_mode="min")
    jt, trainer = _pair(cfg_kw)
    train = [_batch(40 + i) for i in range(3)]
    val = [_batch(50 + i) for i in range(2)]
    jstate, want = jt.fit(lambda: iter(train), lambda: iter(val), epochs=2)
    state, got = trainer.fit(lambda: iter(train), lambda: iter(val), epochs=2)
    assert set(got) == set(want)
    assert state.step == int(jstate.step) == 6 and trainer.best_step == jt.best_step
    assert got["epoch"] == want["epoch"] == 1 and got["val/num_samples"] == 16.0
    timing = {"pairs_per_sec", "pairs_per_sec_per_chip"}
    for k in sorted(set(got) - timing):
        exact = "R@" in k or "rank" in k
        np.testing.assert_allclose(got[k], float(want[k]), rtol=0 if exact else 1e-5,
                                   atol=0 if exact else 1e-12, err_msg=k)
    for k in timing:
        assert got[k] > 0
    again = trainer.evaluate(state, iter(val))
    assert again == {k[4:]: v for k, v in got.items() if k.startswith("val/")}


def test_contrastive_metrics_and_retrieval_match_jax():
    from spatial_clip_tpu.train.metrics import ContrastiveMetrics as JaxMetrics
    from spatial_clip_tpu.train.metrics import clip_retrieval_metrics as jax_retrieval
    from spatial_clip_tpu_torch.train.metrics import ContrastiveMetrics, clip_retrieval_metrics

    rng = np.random.default_rng(6)
    img, txt = rng.normal(size=(2, 12, 8)).astype(np.float32)
    img[3] = img[4]  # a tie: strict > keeps both ranks
    ours, theirs = ContrastiveMetrics(), JaxMetrics()
    s, js = ours.init(), theirs.init()
    for n in (5, 7):  # k_eff = min(k, n) for the 5-column batch
        logits = rng.normal(size=(n, n)).astype(np.float32)
        s = ours.update(s, torch.from_numpy(logits), torch.arange(n))
        js = theirs.update(js, jnp.asarray(logits), jnp.arange(n))
    assert ours.compute(s) == theirs.compute(js)
    assert clip_retrieval_metrics(img, txt) == jax_retrieval(img, txt)


# -------------------------------------------------------------- what raises

@pytest.mark.parametrize("field,value", [
    ("master_weights", True), ("grad_dtype", "bf16"),
])
def test_unported_trainer_options_raise(field, value):
    model = create_model("ViT-Test", precision="fp32", device="meta", training=True, **WIDE)
    with pytest.raises(NotImplementedError, match=f"{field}.*item 4"):
        Trainer(model, config=TrainerConfig(**{field: value}))


@pytest.mark.parametrize("field,value", [("opt", "lion"), ("frozen_prefixes", ("visual",))])
def test_ported_trainer_options_build(field, value):
    """Options that raised before the open_clip-style trainer was ported:
    ``opt='lion'`` builds Lion over an f32 moment and no second moment,
    ``frozen_prefixes`` the locked set as one flat range."""
    from spatial_clip_tpu_torch.train.optim import Lion

    model = create_model("ViT-Test", precision="fp32", device="cpu", training=True, **WIDE)
    trainer = Trainer(model, config=TrainerConfig(**{field: value}))
    state = trainer.init_state()
    if field == "opt":
        assert isinstance(trainer.optimizer, Lion)
        assert state.flat["mu"].dtype == torch.float32 and state.flat["nu"].numel() == 0
    else:
        assert trainer.frozen == {k for k, _ in model.named_parameters()
                                  if k.startswith("visual.")}
        start, end = state.frozen
        assert sorted(state.order[i] for i, k in enumerate(state.order)
                      if start <= state.offsets[k] < end) == sorted(trainer.frozen)


def test_unported_losses_and_serving_models_raise():
    """``coca`` (ported with CoCa), ``siglip`` and ``distill`` (ported
    with the open_clip-style trainer) and ``spatial_ring`` (ported with
    data parallelism) build; an unknown kind raises."""
    coca = make_loss("coca")
    assert coca.name == "coca" and {"caption_logits", "caption_labels"} <= coca.accepted_args
    with pytest.raises(ValueError, match="unknown loss kind"):
        make_loss("nope")
    assert make_loss("siglip").name == "siglip" and make_loss("distill").name == "distill"
    assert make_loss("spatial_ring").name == make_loss("ring").name == "spatial_ring"
    serving = create_model("ViT-Test", precision="fp32", device="meta", **WIDE)
    with pytest.raises(ValueError, match="training=True"):
        Trainer(serving)


def test_training_model_checks_backward_geometry():
    """hd 128 in f32 at L=82 is beyond the resident backward's shared
    memory: the default setting trains it through the key-tiled kernels and
    builds; a layout setting, whose backward keeps the sequence resident,
    says so at build for training (ROADMAP A1); serving it is fine."""
    cfg = dict(vision_cfg=dict(width=256, heads=2, image_size=288, patch_size=32),
               text_cfg=dict(width=128, heads=2))
    create_model("ViT-Test", precision="fp32", device="meta", **cfg)
    create_model("ViT-Test", precision="fp32", device="meta", training=True, **cfg)
    create_model("ViT-Test", precision="fp32", device="meta", attn_impl="pallas_t", **cfg)
    with pytest.raises(NotImplementedError, match="shared memory.*A1"):
        create_model("ViT-Test", precision="fp32", device="meta", training=True,
                     attn_impl="pallas_t", **cfg)


def test_training_model_stores_f32_and_serving_model_compute_dtype():
    train = create_model("ViT-Test", precision="bf16", device="meta", training=True, **WIDE)
    serve = create_model("ViT-Test", precision="bf16", device="meta", **WIDE)
    assert train.training and not serve.training
    for k, p in train.named_parameters():
        assert p.dtype == torch.float32 and p.requires_grad, k
    dtypes = {k: p.dtype for k, p in serve.named_parameters()}
    assert dtypes["visual.proj"] == torch.bfloat16 and dtypes["logit_scale"] == torch.float32
    assert dtypes["visual.ln_post.weight"] == torch.float32


@pytest.mark.parametrize("args", [["chip_smoke.py"], ["-m", "spatial_clip_tpu_torch.bench"]])
def test_entry_points_refuse_without_a_gpu(args):
    """No CUDA here: the smoke script and the benchmark exit non-zero, say
    why, and print no result."""
    import subprocess
    import sys
    from pathlib import Path

    proc = subprocess.run([sys.executable, *args], cwd=Path(__file__).resolve().parents[1],
                          capture_output=True, text=True, timeout=120,
                          env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0, proc.stdout
    assert '"ok"' not in proc.stdout and "pairs/sec" not in proc.stdout
    assert "CUDA" in proc.stderr, proc.stderr[-2000:]
