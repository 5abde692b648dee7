"""Whole train steps of the port's Trainer under the open_clip-style
trainer's options against the JAX Trainer: ``opt`` sgd and lion, a locked
image tower, a distillation teacher and the SigLIP loss (three steps each
from the same weights), the teacher's inputs, the teacher under gradient
accumulation, and checkpoints under SGD and Lion resumed to the bit.

ViT-Test is widened to head_dim 64 (width 128, 2 heads), as the other port
tests widen it. Inputs come from numpy seeds. Tolerances (f32) are stated
in each test.
"""
from __future__ import annotations

import shutil

import jax
import numpy as np
import pytest
import torch

from spatial_clip_tpu import create_model as jax_create_model
from spatial_clip_tpu.losses import make_loss as jax_make_loss
from spatial_clip_tpu.parallel.mesh import make_mesh
from spatial_clip_tpu.train.loop import Trainer as JaxTrainer
from spatial_clip_tpu.train.loop import TrainerConfig as JaxTrainerConfig
from spatial_clip_tpu_torch import create_model
from spatial_clip_tpu_torch.losses import make_loss
from spatial_clip_tpu_torch.models.convert import from_jax_params
from spatial_clip_tpu_torch.train.loop import Trainer, TrainerConfig

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


# ------------------------------------------------------- three Trainer steps

CASES = {
    "opt=sgd": dict(cfg=dict(opt="sgd", momentum=0.8)),
    "opt=lion": dict(cfg=dict(opt="lion", learning_rate=1e-4)),
    "frozen_prefixes=visual": dict(cfg=dict(frozen_prefixes=("visual",))),
    "teacher": dict(loss=("distill", {}), teacher=True),
    "loss=siglip": dict(loss=("siglip", {}), bias=-10.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_three_train_steps_match_jax_trainer(case):
    """Three steps of the port's Trainer against the JAX Trainer from the
    same weights (augment=False; lr is 0 at step 0). Metrics at rtol 1e-5
    (loss, grad_norm, logit_scale, lr) and exact R@k; ``distill_loss`` in
    the metrics exactly when the loss is the distill kind. After the three
    steps the parameters at atol 2e-5 (updates are ~1e-3; Lion's are lr
    times a sign, so the qkv bias's key part, whose gradient is rounding
    noise in both packages, is left out under Lion), the moment of SGD /
    Lion at atol 1e-5 + 1e-5 relative, and a frozen parameter has its
    first bits."""
    c = CASES[case]
    cfg_kw = {**dict(learning_rate=1e-3, warmup_steps=2, total_steps=50, augment=False, seed=0),
              **c.get("cfg", {})}
    kind, loss_kw = c.get("loss", ("spatial", dict(cap_logit_scale=50.0)))
    extra = {} if "bias" not in c else {"init_logit_bias": c["bias"]}
    jb = jax_create_model("ViT-Test", precision="fp32", seed=0, **extra, **WIDE)
    jteacher = teacher = None
    if c.get("teacher"):
        jteacher = jax_create_model("ViT-Test", precision="fp32", seed=5, **WIDE)
        teacher = create_model("ViT-Test", precision="fp32", device="cpu", **WIDE)
        teacher.load_state_dict(from_jax_params(jteacher.params))
    jt = JaxTrainer(jb, loss=jax_make_loss(kind, **loss_kw), config=JaxTrainerConfig(**cfg_kw),
                    mesh=make_mesh(devices=jax.devices()[:1]), teacher=jteacher)
    jstep, jstate = jt.make_train_step(), jt.init_state()
    model = create_model("ViT-Test", precision="fp32", device="cpu", training=True, **extra,
                         **WIDE)
    model.load_state_dict(from_jax_params(jb.params))
    trainer = Trainer(model, make_loss(kind, **loss_kw), TrainerConfig(**cfg_kw),
                      teacher=teacher)
    state = trainer.init_state()
    first = {k: v.detach().clone() for k, v in state.params.items()}
    for i in range(3):
        batch = _batch(20 + i)
        jstate, jm = jstep(jstate, jt._device_batch(batch))
        state, m = trainer.train_step(state, _torch_batch(batch))
        for k in ("loss", "grad_norm", "logit_scale", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, atol=1e-12,
                                       err_msg=f"step {i} {k}")
        for k in ("R@1", "R@5", "R@10"):
            assert float(m[k]) == float(jm[k]), (i, k)
        assert ("distill_loss" in m) == (kind == "distill")
    jstate = jax.tree.map(np.asarray, jstate)
    want = from_jax_params(jstate.params)
    assert state.step == 3
    for k, w in want.items():
        ours, w = state.params[k].detach().numpy(), w.numpy()
        if cfg_kw.get("opt") == "lion" and k.endswith("attn.in_proj_bias"):
            # the key part's gradient is zero in exact math, rounding noise in both
            # packages, and Lion steps by its sign: q and v only
            ours, w = ours.reshape(3, -1)[[0, 2]], w.reshape(3, -1)[[0, 2]]
        np.testing.assert_allclose(ours, w, atol=2e-5, rtol=0, err_msg=k)
    if cfg_kw.get("opt") in ("sgd", "lion"):
        moment = from_jax_params(_jax_moment(jstate.opt_state))
        for k, w in moment.items():
            assert state.mu[k].dtype == torch.float32
            np.testing.assert_allclose(state.mu[k].numpy(), w.numpy(), atol=1e-5, rtol=1e-5,
                                       err_msg=k)
    if cfg_kw.get("frozen_prefixes"):
        for k in trainer.frozen:
            assert torch.equal(state.params[k], first[k]), k
        assert trainer.frozen == {k for k in want if k.startswith("visual.")}


def test_teacher_sees_its_own_normalization_and_no_augmentation():
    """The teacher's features come from the un-augmented batch normalized
    with the teacher's mean and std, without grad (the inference route:
    no forward-lse launch counted for it), whatever the student's draws."""
    teacher = create_model("ViT-Test", precision="fp32", device="cpu", seed=3, **WIDE)
    teacher.preprocess_cfg = type(teacher.preprocess_cfg)(
        size=32, mean=(0.5, 0.5, 0.5), std=(0.25, 0.25, 0.25))
    model = create_model("ViT-Test", precision="fp32", device="cpu", training=True, **WIDE)
    trainer = Trainer(model, make_loss("distill"), TrainerConfig(color_jitter=0.3),
                      teacher=teacher)
    batch = _torch_batch(_batch(7))
    feats = trainer._teacher_features(batch)
    x = (batch["images"].float() / 255.0 - 0.5) / 0.25
    want = teacher(x, batch["texts"])
    for k in ("image_features", "text_features", "logit_scale"):
        torch.testing.assert_close(feats[f"dist_{k}"], want[k], rtol=1e-6, atol=1e-6)
    assert not any(v.requires_grad for v in feats.values())
    with pytest.raises(ValueError, match="eval mode"):
        Trainer(model, make_loss("distill"), teacher=model)


def test_teacher_under_cached_accumulation_raises_and_simple_runs():
    """JAX's cached pass never calls the teacher; the port refuses it, and
    runs the simple mode, whose microbatches each take the teacher."""
    teacher = create_model("ViT-Test", precision="fp32", device="cpu", seed=3, **WIDE)
    model = create_model("ViT-Test", precision="fp32", device="cpu", training=True, **WIDE)
    batch = _torch_batch(_batch(8))
    cached = Trainer(model, make_loss("distill"), TrainerConfig(grad_accum=2), teacher=teacher)
    with pytest.raises(NotImplementedError, match="simple"):
        cached.train_step(cached.init_state(), batch)
    simple = Trainer(model, make_loss("distill"),
                     TrainerConfig(grad_accum=2, grad_accum_mode="simple"), teacher=teacher)
    _, m = simple.train_step(simple.init_state(), batch)
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["distill_loss"]))


@pytest.mark.parametrize("opt", ["sgd", "lion"])
def test_resume_under_sgd_and_lion_takes_the_unbroken_runs_bits(tmp_path, opt):
    """A checkpoint holds what the optimizer holds (one f32 moment, an empty
    nu); a run resumed from step 2 ends with the unbroken run's state to
    the bit."""
    cfg = dict(opt=opt, learning_rate=1e-3, warmup_steps=1, total_steps=8, seed=0)
    batches = [_batch(30 + i) for i in range(4)]

    def run(ckpt_dir, resume, start):
        model = create_model("ViT-Test", precision="fp32", device="cpu", training=True, **WIDE)
        trainer = Trainer(model, make_loss("spatial"),
                          TrainerConfig(ckpt_dir=str(ckpt_dir), save_every_steps=2, **cfg))
        return trainer.fit(lambda: iter(batches[start:]), epochs=1, resume=resume)[0]

    full = run(tmp_path / "full", None, 0)
    resumed_dir = tmp_path / "resumed" / "step_2"
    resumed_dir.parent.mkdir()
    shutil.copytree(tmp_path / "full" / "step_2", resumed_dir)
    resumed = run(tmp_path / "resumed", "latest", 2)
    assert (resumed.step, resumed.count) == (full.step, full.count) == (4, 4)
    assert full.flat["mu"].dtype == torch.float32 and full.flat["nu"].numel() == 0
    for k in ("params", "mu", "nu"):
        assert torch.equal(resumed.flat[k], full.flat[k]), k
