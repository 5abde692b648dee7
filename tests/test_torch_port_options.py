"""The port's losses and optimizer options of the open_clip-style trainer
against the JAX package on the same inputs: the SigLIP and distillation
losses, SGD and Lion, tower locking, activation checkpointing (``remat``)
and the NaN check of the debug presets. Whole train steps under these
options: ``test_torch_port_trainer_options.py``.

ViT-Test is widened to head_dim 64 (width 128, 2 heads), as the other port
tests widen it, so both towers take the attention kernels' geometry (their
plain versions on the CPU). Inputs come from numpy seeds. Tolerances (f32)
are stated in each test.
"""
from __future__ import annotations

import tests.helpers.torch_threads  # noqa: F401  (xdist workers share the cores)

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from spatial_clip_tpu import create_model as jax_create_model
from spatial_clip_tpu.cli.main_train import _lock_prefixes as jax_lock_prefixes
from spatial_clip_tpu.cli.main_train import parse_args as jax_parse_args
from spatial_clip_tpu.losses import make_loss as jax_make_loss
from spatial_clip_tpu.train import optim as jax_optim
from spatial_clip_tpu_torch import create_model
from spatial_clip_tpu_torch.cli.main_train import _lock_prefixes
from spatial_clip_tpu_torch.losses import make_loss
from spatial_clip_tpu_torch.models.clip import zip_ready
from spatial_clip_tpu_torch.ops import fused_attention as pfa
from spatial_clip_tpu_torch.train.loop import Trainer, TrainerConfig, TrainState
from spatial_clip_tpu_torch.train.optim import (
    SGD,
    AdamW,
    Lion,
    freeze_mask,
    jax_param_paths,
    make_schedule,
)

WIDE = dict(vision_cfg=dict(width=128, heads=2), text_cfg=dict(width=128, heads=2))


def _batch(seed, B=8, size=32, ctx=16, vocab=512, k=4):
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
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _leaf_paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_leaf_paths(v, path) if isinstance(v, dict) else {path: v})
    return out


# ------------------------------------------------------------------- losses

def _features(seed, B=8, D=16):
    rng = np.random.default_rng(seed)
    unit = lambda x: x / np.linalg.norm(x, axis=1, keepdims=True)  # noqa: E731
    return {
        "image_features": unit(rng.normal(size=(B, D))).astype(np.float32),
        "text_features": unit(rng.normal(size=(B, D))).astype(np.float32),
        "logit_scale": np.float32(np.exp(rng.uniform(1.0, 3.0))),
        "logit_bias": np.float32(rng.uniform(-10.0, -2.0)),
        "dist_image_features": unit(rng.normal(size=(B, D))).astype(np.float32),
        "dist_text_features": unit(rng.normal(size=(B, D))).astype(np.float32),
        "dist_logit_scale": np.float32(np.exp(rng.uniform(1.0, 4.0))),
    }


@pytest.mark.parametrize("kind,options,bias", [
    ("siglip", {}, True), ("siglip", {"dist_impl": "bidir"}, True),
    ("distill", {}, False), ("distill", {}, True),
])
def test_losses_and_gradients_match_jax(kind, options, bias):
    """The loss value at f32 1e-6 relative; the gradients with respect to
    the student's features, scale and bias at 1e-6 of their largest entry
    (plus 1e-7). The teacher's inputs get no gradient in either package."""
    f = _features(3)
    if not bias:
        f.pop("logit_bias")
    students = ["image_features", "text_features", "logit_scale"] + (["logit_bias"] if bias
                                                                        else [])
    jl, ours = jax_make_loss(kind, **options), make_loss(kind, **options)

    def jfn(*xs):
        return jl(**{**f, **dict(zip(students, xs))})["contrastive_loss"]

    want, want_g = jax.value_and_grad(jfn, argnums=tuple(range(len(students))))(
        *(jnp.asarray(f[k]) for k in students))
    tf = {k: torch.tensor(v, requires_grad=k in students or k.startswith("dist_"))
          for k, v in f.items()}
    out = ours(**tf)
    out["contrastive_loss"].backward()
    np.testing.assert_allclose(out["contrastive_loss"].item(), float(want), rtol=1e-6)
    for k, w in zip(students, want_g):
        w = np.asarray(w)
        np.testing.assert_allclose(tf[k].grad.numpy(), w, rtol=0,
                                   atol=1e-7 + 1e-6 * np.abs(w).max(), err_msg=k)
    for k in ("dist_image_features", "dist_text_features", "dist_logit_scale"):
        assert tf[k].grad is None, k
    if kind == "distill":
        jout = jl(**f)
        np.testing.assert_allclose(out["distill_loss"].item(), float(jout["distill_loss"]),
                                   rtol=1e-6)


def test_siglip_needs_the_models_logit_bias():
    """JAX fails with a TypeError on a model without init_logit_bias; the
    port says what is missing, and never takes a bias of 0."""
    f = _features(4)
    f.pop("logit_bias")
    with pytest.raises(TypeError):
        jax_make_loss("siglip")(**f)
    with pytest.raises(TypeError, match="init_logit_bias"):
        make_loss("siglip")(**{k: torch.tensor(v) for k, v in f.items()})


# --------------------------------------------------------------- optimizers

def _optimizer_pair(opt, frozen, momentum):
    rng = np.random.default_rng(0)
    shapes = {"a": (6, 5), "b": (5,), "c": (3, 2, 4), "logit_scale": ()}
    params = {k: np.asarray(rng.normal(size=s), np.float32) for k, s in shapes.items()}
    tx, _ = jax_optim.make_optimizer(
        params, learning_rate=1e-2, weight_decay=0.2, grad_clip_norm=1.0,
        schedule_name="cosine", warmup_steps=2, total_steps=20, opt=opt, momentum=momentum,
        frozen_prefixes=frozen, mu_dtype="bf16", nu_dtype="bf16")  # ignored by sgd / lion
    frozen_names = {k for k in shapes if any(k.startswith(p) for p in frozen)}
    zeros = {k: torch.zeros(s) for k, s in shapes.items()}
    state = TrainState.create({k: torch.from_numpy(v.copy()) for k, v in params.items()},
                              zeros, None, mu_dtype=torch.float32, nu_dtype=torch.float32,
                              frozen=frozen_names)
    schedule = make_schedule("cosine", 1e-2, 2, 20)
    ours = (SGD(schedule, 0.2, momentum, 1.0) if opt == "sgd"
            else Lion(schedule, 0.2, (0.9, 0.98), 1.0))
    return shapes, params, tx, state, ours, rng


def _jax_moment(opt_state):
    """SGD's trace or Lion's moment inside an optax chain's state."""
    for attr in ("trace", "mu"):
        if hasattr(opt_state, attr):
            return getattr(opt_state, attr)
    if isinstance(opt_state, tuple):
        for part in opt_state:
            found = _jax_moment(part)
            if found is not None:
                return found
    return None


@pytest.mark.parametrize("opt,frozen,momentum", [
    ("sgd", (), None), ("sgd", ("a",), 0.5), ("lion", (), None), ("lion", ("c",), None),
])
def test_sgd_and_lion_match_make_optimizer(opt, frozen, momentum):
    """Five steps of the port's SGD / Lion (flat buffers, f32 moment, the
    frozen range zeroed last) against the JAX package's optax chain with
    the same clipping, decay mask and schedule (step 1 is clipped):
    parameters and the moment at atol 1e-6 + 1e-6 relative; a frozen
    parameter keeps its bits, its moment still moves."""
    shapes, params, tx, state, ours, rng = _optimizer_pair(opt, frozen, momentum)
    jstate, jparams = tx.init(params), dict(params)
    before = {k: state.params[k].detach().clone() for k in shapes}
    for step in range(5):
        grads = {k: np.asarray(rng.normal(size=s) * (3.0 if step == 1 else 0.1), np.float32)
                 for k, s in shapes.items()}
        updates, jstate = tx.update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        flat = state.flatten([torch.from_numpy(grads[k]) for k in state.order])
        state.count, _ = ours.update(state.flat["params"], flat, state.flat["mu"],
                                     state.flat["nu"], state.count, state.n_decay, state.frozen)
    moment = _jax_moment(jstate)
    assert state.count == 5 and state.flat["nu"].numel() == 0 and state.nu == {}
    for k in shapes:
        np.testing.assert_allclose(state.params[k].detach().numpy(), np.asarray(jparams[k]),
                                   atol=1e-6, rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(state.mu[k].numpy(), np.asarray(moment[k]), atol=1e-6,
                                   rtol=1e-6, err_msg=k)
        if k in frozen:
            assert torch.equal(state.params[k], before[k]) and state.mu[k].abs().sum() > 0


def test_frozen_parameters_form_one_range_and_adamw_skips_it():
    """The locked parameters close the decayed part of the flat buffers and
    open the rest, so one range holds them; AdamW zeroes their update and
    still moves their moments."""
    shapes = {"a": (6, 5), "b": (5,), "c": (3, 2, 4), "d": (7,), "logit_scale": ()}
    rng = np.random.default_rng(1)
    params = {k: torch.from_numpy(np.asarray(rng.normal(size=s), np.float32))
              for k, s in shapes.items()}
    zeros = {k: torch.zeros(s) for k, s in shapes.items()}
    state = TrainState.create(params, zeros, zeros, frozen={"a", "b"})
    start, end = state.frozen
    assert state.order[:3] == ("c", "a", "b") and state.n_decay > start
    assert start == state.offsets["a"] and end == state.offsets["b"] + 5
    before = {k: v.detach().clone() for k, v in state.params.items()}
    opt = AdamW(make_schedule("const", 1e-2, 0, 10), 0.2, (0.9, 0.98), 1e-6, 1.0)
    grads = state.flatten([torch.ones(shapes[k]) for k in state.order])
    opt.update(state.flat["params"], grads, state.flat["mu"], state.flat["nu"], 0, state.n_decay,
               state.frozen)
    for k in shapes:
        assert torch.equal(state.params[k], before[k]) == (k in ("a", "b")), k
        assert state.mu[k].float().abs().sum() > 0, k


# ------------------------------------------------------------ tower locking

LOCKS = [
    ["--lock-image-tower"],
    ["--lock-text-tower"],
    ["--lock-image-tower", "--lock-image-unlocked-groups", "1"],
    ["--lock-text-tower", "--lock-text-unlocked-layers", "1"],
    ["--lock-text-tower", "--lock-text-unlocked-layers", "1", "--lock-text-freeze-layer-norm"],
    ["--lock-image-tower", "--lock-image-unlocked-groups", "1", "--lock-text-tower"],
]


@pytest.fixture(scope="module")
def vit_test_params():
    return jax_create_model("ViT-Test", precision="fp32", seed=0, **WIDE).params


@pytest.mark.parametrize("argv", LOCKS, ids=lambda a: " ".join(a))
def test_locked_set_matches_jax_on_vit_test(argv, vit_test_params):
    """On ViT-Test (2 layers, so no block index is a prefix of another) the
    port's prefixes equal JAX's and its frozen set is JAX's freeze_mask,
    parameter for parameter, through the name map."""
    model = create_model("ViT-Test", precision="fp32", device="meta", training=True, **WIDE)
    args = jax_parse_args(["--model", "ViT-Test", *argv])
    prefixes = _lock_prefixes(model, args)
    assert prefixes == jax_lock_prefixes(types.SimpleNamespace(cfg=model.cfg), args)
    want = _leaf_paths(jax_optim.freeze_mask(vit_test_params, prefixes))
    ours = freeze_mask([k for k, _ in model.named_parameters()], prefixes)
    paths = jax_param_paths(ours)
    assert {paths[k]: bool(v) for k, v in ours.items()} == {k: bool(v) for k, v in want.items()}
    assert any(ours.values())


@pytest.fixture(scope="module")
def vit_b32_meta():
    """ViT-B-32's parameter names, unallocated (no weights drawn)."""
    from spatial_clip_tpu_torch.models.clip import CLIP
    from spatial_clip_tpu_torch.models.config import resolve_clip_cfg

    return CLIP(resolve_clip_cfg("ViT-B-32"), device=torch.device("meta"))


@pytest.mark.parametrize("argv,block", [
    (["--lock-image-tower", "--lock-image-unlocked-groups", "1"], "visual/transformer"),
    (["--lock-text-tower", "--lock-text-unlocked-layers", "1",
      "--lock-text-freeze-layer-norm"], "text/transformer"),
])
def test_locked_set_differs_from_jax_where_a_block_index_prefixes_another(argv, block,
                                                                          vit_b32_meta):
    """ViT-B-32 with the last block unlocked: JAX's bare ``startswith``
    takes ``resblocks_1`` to ``resblocks_10`` and ``resblocks_11`` and
    freezes every block; the port matches whole components and leaves
    ``resblocks_11`` trainable (and freezes ``resblocks_10``). JAX's mask is
    taken on the same parameter paths, as a tree of placeholders."""
    model = vit_b32_meta
    names = [k for k, _ in model.named_parameters()]
    prefixes = _lock_prefixes(model, jax_parse_args(argv))
    paths = jax_param_paths(names)
    tree = {}
    for path in paths.values():
        *parents, leaf = path.split("/")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = 0
    want = _leaf_paths(jax_optim.freeze_mask(tree, prefixes))
    ours = {paths[k]: v for k, v in freeze_mask(names, prefixes).items()}
    blocks = lambda mask, i: {v for k, v in mask.items()  # noqa: E731
                              if k.startswith(f"{block}/resblocks_{i}/")}
    assert blocks(want, 11) == {True} and blocks(ours, 11) == {False}
    assert blocks(want, 10) == blocks(ours, 10) == {True}
    differ = {k for k in ours if ours[k] != want[k]}
    assert differ and all(k.startswith(f"{block}/resblocks_11/") for k in differ)


# --------------------------------------------------------------------- remat

ROUTES = ("fused_attention", "fused_attention_lse", "fused_attention_bwd")


@pytest.mark.parametrize("cfg_kw", [dict(), dict(grad_accum=2)], ids=["plain", "cached2"])
def test_remat_steps_give_the_same_bits(monkeypatch, cfg_kw):
    """Three steps under remat (each block recomputed in the backward, with
    the trainer's state bound again for the recompute) and without: params,
    mu and nu the same bits. The forward-lse wrapper is called twice as
    often (the recompute), the others as often, as JAX's remat recomputes
    its forward (cached accumulation's grad-free pass 1 takes the inference
    forward either way)."""
    calls = dict.fromkeys(ROUTES, 0)

    def counted(name, fn):
        def wrapper(*a):
            calls[name] += 1
            return fn(*a)
        return wrapper

    for name in ROUTES:
        monkeypatch.setattr(pfa, name, counted(name, getattr(pfa, name)))
    states, counts = [], []
    for remat in (False, True):
        model = create_model("ViT-Test", precision="fp32", device="cpu", training=True,
                             remat=remat, **WIDE)
        trainer = Trainer(model, make_loss("spatial"),
                          TrainerConfig(learning_rate=1e-2, warmup_steps=1, total_steps=10,
                                        seed=0, **cfg_kw))
        state = trainer.init_state()
        calls.update(dict.fromkeys(ROUTES, 0))
        for i in range(3):
            state, _ = trainer.train_step(state, _torch_batch(_batch(40 + i)))
        states.append(state)
        counts.append(dict(calls))
    for k in ("params", "mu", "nu"):
        assert torch.equal(states[0].flat[k], states[1].flat[k]), k
    plain, remat = counts
    per_step = 2 * 2 * 3 * (cfg_kw.get("grad_accum") or 1)  # 2 layers x 2 towers x 3 steps
    assert plain["fused_attention_lse"] == plain["fused_attention_bwd"] == per_step
    assert remat == {**plain, "fused_attention_lse": 2 * per_step}


@pytest.mark.parametrize("zip_towers", ["off", "auto", "on"])
@pytest.mark.parametrize("remat", [False, True])
def test_zip_ready_under_remat_matches_jax(zip_towers, remat):
    """JAX's ``_zip_ready`` on the same configuration and remat (its 'auto'
    zips only on a TPU backend; on the card 'auto' runs the towers apart)."""
    from spatial_clip_tpu.models.clip import CLIP as JaxCLIP
    from spatial_clip_tpu.models.config import resolve_clip_cfg as jax_resolve

    jmodel = JaxCLIP(cfg=jax_resolve("ViT-Test", zip_towers=zip_towers, **WIDE), remat=remat)
    ours = create_model("ViT-Test", precision="fp32", device="meta", remat=remat,
                        zip_towers=zip_towers, **WIDE)
    jax_on_tpu = jax.default_backend() == "tpu"
    want = jmodel._zip_ready() and (zip_towers == "on" or jax_on_tpu)
    assert zip_ready(ours.cfg, remat) == ours._zip_ready() == want
    if remat:
        assert not want


# ----------------------------------------------------------------- NaN check

def test_debug_nans_names_the_step_and_lets_inf_pass():
    """Under debug_nans a batch whose tile holds a NaN stops the step with
    FloatingPointError naming it; without, the step runs to a NaN loss. An
    infinite loss with finite gradients passes the check, as under
    jax_debug_nans. Under anomaly mode a NaN made inside a backward
    function stops the step naming the step and that function."""
    model = create_model("ViT-Test", precision="fp32", device="cpu", training=True, **WIDE)
    batch = _torch_batch(_batch(50))
    images = batch["images"].float() / 255.0
    nan_batch = {**batch, "images": images.clone()}
    nan_batch["images"][3, 5, 5, 0] = float("nan")
    debug = Trainer(model, make_loss("spatial"), TrainerConfig(debug_nans=True, augment=False))
    state = debug.init_state()
    state, m = debug.train_step(state, {**batch, "images": images})
    assert np.isfinite(float(m["loss"]))
    with pytest.raises(FloatingPointError, match="step 1"):
        debug.train_step(state, nan_batch)
    plain = Trainer(model, make_loss("spatial"), TrainerConfig(augment=False))
    _, m = plain.train_step(plain.init_state(), nan_batch)
    assert np.isnan(float(m["loss"]))
    from spatial_clip_tpu_torch.losses import LossFn

    infinite = LossFn("inf", lambda image_features: {
        "contrastive_loss": image_features.sum() * 0.0 + float("inf")}, frozenset({
            "image_features"}))
    inf_trainer = Trainer(model, infinite, TrainerConfig(debug_nans=True, augment=False))
    _, m = inf_trainer.train_step(inf_trainer.init_state(), {**batch, "images": images})
    assert float(m["loss"]) == float("inf") and float(m["grad_norm"]) == 0.0
    with torch.autograd.set_detect_anomaly(True):
        def nan_in_backward(x):
            class Bad(torch.autograd.Function):
                @staticmethod
                def forward(ctx, t):
                    return t * 1.0

                @staticmethod
                def backward(ctx, g):
                    return g * float("nan")

            return Bad.apply(x)

        debug.loss = make_loss("clip")
        real = debug._features

        def features(*args, **kw):
            out = real(*args, **kw)
            out["image_features"] = nan_in_backward(out["image_features"])
            return out

        debug._features = features
        with pytest.raises(FloatingPointError, match="backward at step 1.*BadBackward"):
            debug.train_step(state, {**batch, "images": images})
