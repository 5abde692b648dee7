"""The port's checkpoints and local weights against the JAX package's.

- ``CheckpointManager``: the same directory layout, tmp-then-rename and
  retention as the JAX manager on the same sequence of saves; the host copy
  complete when ``save`` returns.
- Resume: a port run of ViT-Test (widened to head_dim 64, as the other port
  tests widen it) saved at step 2 and resumed takes steps 3 and 4 bit for
  bit as the unbroken run, with augmentation (flips and color jitter) on;
  and, with augmentation off (the two packages draw from different
  generators), it matches the JAX Trainer resumed from its own checkpoint
  within ``test_torch_port_train.py``'s step tolerances.
- Local weights: JAX ``save_params_npz`` and ``export_torch_state_dict``
  files, a ``.safetensors`` copy and a directory holding
  ``open_clip_pytorch_model.pth`` load through the port's
  ``create_model(pretrained=...)`` and encode as JAX does (f32, atol and
  rtol 1e-4, as ``test_torch_port_model.py`` holds the towers).
"""
from __future__ import annotations

import tests.helpers.torch_threads  # noqa: F401  (xdist workers share the cores)

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatial_clip_tpu.models import constants as jax_constants
from spatial_clip_tpu.models.clip import CLIP as JaxCLIP
from spatial_clip_tpu.models.config import resolve_clip_cfg as jax_resolve_clip_cfg
from spatial_clip_tpu.models.factory import ModelBundle
from spatial_clip_tpu.models.transforms import PreprocessCfg
from spatial_clip_tpu.losses import make_loss as jax_make_loss
from spatial_clip_tpu.models.factory import load_checkpoint as jax_load_checkpoint
from spatial_clip_tpu.models.transforms import normalize_batch as jax_normalize_batch
from spatial_clip_tpu.parallel.mesh import make_mesh
from spatial_clip_tpu.train import checkpoints as jax_ckpt
from spatial_clip_tpu.train.loop import Trainer as JaxTrainer
from spatial_clip_tpu.train.loop import TrainerConfig as JaxTrainerConfig
from spatial_clip_tpu_torch import create_model
from spatial_clip_tpu_torch.losses import make_loss
from spatial_clip_tpu_torch.models.convert import (
    from_jax_params,
    from_jax_train_state,
    to_jax_params,
)
from spatial_clip_tpu_torch.models.factory import WEIGHT_FILE_NAMES
from spatial_clip_tpu_torch.models.transforms import normalize_batch
from spatial_clip_tpu_torch.train import checkpoints
from spatial_clip_tpu_torch.train.loop import Trainer, TrainerConfig

WIDE = dict(vision_cfg=dict(width=128, heads=2), text_cfg=dict(width=128, heads=2))
LOSS = dict(cap_logit_scale=50.0)


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


def _trainer(ckpt_dir=None, params=None, **cfg):
    model = create_model("ViT-Test", precision="fp32", device="cpu", training=True, seed=0,
                         **WIDE)
    if params is not None:
        model.load_state_dict(params)
    config = TrainerConfig(**{**dict(learning_rate=1e-3, warmup_steps=1, total_steps=20,
                                     seed=0, log_every=1, save_every_steps=2,
                                     ckpt_dir=None if ckpt_dir is None else str(ckpt_dir)),
                              **cfg})
    return Trainer(model, make_loss("spatial", **LOSS), config)


# ---------------------------------------------------------- the manager

def test_layout_and_retention_match_jax(tmp_path):
    """The same saves (a step saved twice, one out of order) leave the same
    directories and meta.json files as the JAX manager's, with the same
    steps listed. Then a torn write's ``.tmp_step_N``: the port does not
    count it as a step (the JAX manager does, so its retention drops a real
    checkpoint for it and its resume looks for the missing state), and a
    save of that step replaces it."""
    ours = checkpoints.CheckpointManager(tmp_path / "port", keep=2)
    theirs = jax_ckpt.CheckpointManager(str(tmp_path / "jax"), keep=2)
    state = _trainer().init_state()
    host = {"w": np.zeros(3, np.float32)}
    metrics = {"loss": 1.5, "R@1": np.float32(0.25)}
    for step, m in ((2, None), (4, metrics), (4, None), (6, metrics), (8, None), (3, metrics)):
        ours.save(state, step, m)
        theirs.save(host, step, m)
        ours.wait()
        theirs.wait()
        listing = sorted(p.name for p in ours.dir.iterdir())
        assert listing == sorted(p.name for p in theirs.dir.iterdir()), step
        assert ours.all_steps() == theirs.all_steps() and ours.latest_step() == theirs.latest_step()
        for name in listing:
            assert (json.loads((ours.dir / name / "meta.json").read_text())
                    == json.loads((theirs.dir / name / "meta.json").read_text()))
            assert sorted(p.name for p in (ours.dir / name).iterdir()) == ["meta.json", "state.pt"]
    assert ours.all_steps() == [6, 8]  # the two highest steps: step 3, saved last, went at once
    (ours.dir / ".tmp_step_9").mkdir()  # a torn write
    (ours.dir / ".tmp_step_9" / "state.pt").write_bytes(b"torn")
    assert ours.latest_step() == 8 and ours.restore(state)[1] == 8
    ours.save(state, 10)
    assert ours.all_steps() == [8, 10]
    ours.save(state, 9)
    ours.wait()
    assert sorted(p.name for p in ours.dir.iterdir()) == ["step_10", "step_9"]
    with pytest.raises(FileNotFoundError):
        checkpoints.CheckpointManager(tmp_path / "empty").restore(state)
    with pytest.raises(FileNotFoundError):
        ours.restore(state, 5)


def test_save_copies_the_whole_state_before_returning(tmp_path):
    """The optimizer writes the flat buffers in place: changing them right
    after save() (the write still in flight) must not reach the file."""
    trainer = _trainer(augment=True, color_jitter=0.2)
    state = trainer.init_state()
    state, _ = trainer.train_step(state, trainer._device_batch(_batch(0)))
    want = {k: v.clone() for k, v in state.flat.items()}
    want_gen = state.generator.get_state().clone()
    mgr = checkpoints.CheckpointManager(tmp_path)
    mgr.save(state, 1)
    for v in state.flat.values():
        v.add_(1.0)
    state.count, state.step = 99, 99
    torch.rand(7, generator=state.generator)
    mgr.wait()
    restored, step = mgr.restore(trainer.init_state())
    assert step == 1 and (restored.count, restored.step) == (1, 1)
    for k, v in want.items():
        assert torch.equal(restored.flat[k], v), k
    assert torch.equal(restored.generator.get_state(), want_gen)
    other = _trainer(mu_dtype=None).init_state()  # f32 moments: another state layout
    with pytest.raises(ValueError, match="mu"):
        mgr.restore(other)


@pytest.mark.parametrize("resume", ["latest", 2])
def test_resume_takes_the_unbroken_runs_steps_bit_for_bit(tmp_path, resume):
    """Augmentation on (flips and color jitter 0.2, drawn from the state's
    generator): 4 steps unbroken against 2 steps, a checkpoint at step 2,
    and a new trainer resumed for the next 2 batches. Every parameter,
    moment and counter, the generator's state and the last step's metrics
    are equal."""
    batches = [_batch(20 + i) for i in range(4)]
    cfg = dict(augment=True, color_jitter=0.2)
    unbroken = _trainer(**cfg)
    want_state, want = unbroken.fit(lambda: iter(batches), epochs=1)
    first = _trainer(tmp_path, **cfg)
    first.fit(lambda: iter(batches[:2]), epochs=1)
    assert first.ckpt.all_steps() == [2]
    second = _trainer(tmp_path, **cfg)
    state, got = second.fit(lambda: iter(batches[2:]), epochs=1, resume=resume)
    assert (state.step, state.count) == (want_state.step, want_state.count) == (4, 4)
    for k in ("params", "mu", "nu"):
        assert torch.equal(state.flat[k], want_state.flat[k]), k
    assert torch.equal(state.generator.get_state(), want_state.generator.get_state())
    timing = {"pairs_per_sec", "pairs_per_sec_per_chip", "epoch"}
    assert {k: v for k, v in got.items() if k not in timing} == {
        k: v for k, v in want.items() if k not in timing}
    assert second.ckpt.all_steps() == [2, 4]
    # a resume with no checkpoint starts fresh
    fresh = _trainer(tmp_path / "none", **cfg)
    assert fresh.fit(lambda: iter(()), epochs=1, resume="latest")[0].step == 0


def test_resume_matches_jax_trainer_resumed_from_its_checkpoint(tmp_path):
    """Both packages train 2 steps from the same weights, save at step 2,
    and resume in a new trainer for the next 2 batches (augment off).
    The last step's loss, grad_norm, logit_scale and lr at rtol 1e-5, R@k
    exactly; parameters at atol 2e-5; moments at rtol 2^-7 + atol 2e-3 of
    the tensor's largest entry; count and step equal."""
    batches = [_batch(30 + i) for i in range(4)]
    cfg_kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=20, augment=False, seed=0,
                  log_every=1, save_every_steps=2)

    def jax_trainer():
        return JaxTrainer(_jax_vit_test(), loss=jax_make_loss("spatial", **LOSS),
                          config=JaxTrainerConfig(ckpt_dir=str(tmp_path / "jax"), **cfg_kw),
                          mesh=make_mesh(devices=jax.devices()[:1]))

    jax_trainer().fit(lambda: iter(batches[:2]), epochs=1)
    jstate, want = jax_trainer().fit(lambda: iter(batches[2:]), epochs=1, resume="latest")
    params = from_jax_params(_jax_vit_test().params)
    _trainer(tmp_path / "port", params, augment=False).fit(lambda: iter(batches[:2]), epochs=1)
    state, got = _trainer(tmp_path / "port", params, augment=False).fit(
        lambda: iter(batches[2:]), epochs=1, resume="latest")
    for k in ("loss", "grad_norm", "logit_scale", "lr"):
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-5, atol=1e-12, err_msg=k)
    for k in ("R@1", "R@5", "R@10"):
        assert got[k] == float(want[k]), k
    ref = from_jax_train_state(jax.tree.map(np.asarray, jstate))
    assert (state.count, state.step) == (ref.count, ref.step) == (4, 4)
    for k, w in ref.params.items():
        np.testing.assert_allclose(state.params[k].detach().numpy(), w.detach().numpy(),
                                   atol=2e-5, rtol=0, err_msg=k)
        for name in ("mu", "nu"):
            theirs = getattr(ref, name)[k].float().numpy()
            np.testing.assert_allclose(getattr(state, name)[k].float().numpy(), theirs,
                                       rtol=2 ** -7, atol=2e-3 * np.abs(theirs).max(),
                                       err_msg=f"{name} {k}")


# ------------------------------------------------------------ local weights

@pytest.fixture(scope="module")
def jax_bundle():
    return _jax_vit_test()


def _encode_both(model, bundle):
    rng = np.random.default_rng(11)
    u8 = rng.integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    ids = rng.integers(0, 512, (3, 16)).astype(np.int32)
    with torch.inference_mode():
        got = (model.encode_image(normalize_batch(torch.from_numpy(u8))).numpy(),
               model.encode_text(torch.from_numpy(ids).long()).numpy())
    want = (np.asarray(bundle.encode_image(jax_normalize_batch(u8))),
            np.asarray(bundle.encode_text(ids)))
    return got, want


def _weight_files(tmp_path, bundle):
    """Each form of local weights, written from the JAX bundle's params."""
    npz = tmp_path / "params.npz"
    jax_ckpt.save_params_npz(bundle.params, str(npz))
    pth = tmp_path / "model.pth"
    jax_ckpt.export_torch_state_dict(bundle.params, str(pth))
    from safetensors.torch import save_file

    st = tmp_path / "model.safetensors"
    save_file({k: v.contiguous() for k, v in from_jax_params(bundle.params).items()}, str(st))
    snap = tmp_path / "snapshot"
    snap.mkdir()
    shutil.copy(pth, snap / "open_clip_pytorch_model.pth")
    return {"npz": npz, "pth": pth, "safetensors": st, "dir": snap}


@pytest.mark.parametrize("form", ["npz", "pth", "safetensors", "dir"])
@pytest.mark.parametrize("training", [False, True])
def test_local_weights_load_and_encode_as_jax(tmp_path, jax_bundle, form, training):
    path = _weight_files(tmp_path, jax_bundle)[form]
    model = create_model("ViT-Test", pretrained=str(path), precision="fp32", device="cpu",
                         seed=5, training=training, **WIDE)
    want_sd = from_jax_params(jax_bundle.params)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want_sd[k]), k
    (img, txt), (jimg, jtxt) = _encode_both(model, jax_bundle)
    np.testing.assert_allclose(img, jimg, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(txt, jtxt, atol=1e-4, rtol=1e-4)


def test_directory_weight_names_in_open_clips_order(tmp_path, jax_bundle):
    """Every open_clip weight-file name is found in a directory, the first
    present one wins, and a directory with none raises."""
    sd = from_jax_params(jax_bundle.params)
    from spatial_clip_tpu_torch.models.factory import resolve_weights

    with pytest.raises(FileNotFoundError, match="open_clip_pytorch_model.pth"):
        resolve_weights(tmp_path)
    for name in reversed(WEIGHT_FILE_NAMES):
        if name.endswith(".safetensors"):
            from safetensors.torch import save_file

            save_file({k: v.contiguous() for k, v in sd.items()}, str(tmp_path / name))
        else:
            torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, tmp_path / name)
        assert resolve_weights(tmp_path) == tmp_path / name
        model = create_model("ViT-Test", pretrained=str(tmp_path), precision="fp32",
                             device="cpu", **WIDE)
        assert torch.equal(model.visual.proj, sd["visual.proj"])


def test_strict_loading_and_refusals(tmp_path, jax_bundle):
    sd = from_jax_params(jax_bundle.params)
    for name, bad in (("missing", {k: v for k, v in sd.items() if k != "visual.proj"}),
                      ("extra", {**sd, "visual.extra": torch.zeros(2)}),
                      ("shape", {**sd, "visual.proj": torch.zeros(3, 3)})):
        torch.save(bad, tmp_path / f"{name}.pt")
        with pytest.raises(RuntimeError, match="visual"):
            create_model("ViT-Test", pretrained=str(tmp_path / f"{name}.pt"), precision="fp32",
                         device="cpu", **WIDE)
    for spec, error in (("hf-hub:org/model", ValueError),  # no cached snapshot
                        ("openai", FileNotFoundError),  # not a tag of ViT-Test
                        (str(tmp_path / "absent.pt"), FileNotFoundError)):
        with pytest.raises(error):
            create_model("ViT-Test", pretrained=spec, precision="fp32", device="cpu", **WIDE)
    remat = create_model("ViT-Test", precision="fp32", device="meta", remat=True, **WIDE)
    assert remat.remat and remat.visual.transformer.remat and remat.transformer.remat


def test_port_weight_files_load_in_jax(tmp_path, jax_bundle):
    """The port's save_params_npz writes the JAX layout (JAX's own loader
    reads it back to the same arrays); its export_torch_state_dict reloads
    in the port; load_params_npz reads JAX's file."""
    sd = from_jax_params(jax_bundle.params)
    checkpoints.save_params_npz(sd, tmp_path / "port.npz")
    loaded = jax_load_checkpoint(jax_bundle.params, str(tmp_path / "port.npz"))
    want, got = checkpoints.flatten_params(jax_bundle.params), checkpoints.flatten_params(loaded)
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    jax_ckpt.save_params_npz(jax_bundle.params, str(tmp_path / "jax.npz"))
    ours = checkpoints.flatten_params(checkpoints.load_params_npz(tmp_path / "jax.npz"))
    assert set(ours) == set(want)
    checkpoints.export_torch_state_dict(sd, tmp_path / "port.pth")
    model = create_model("ViT-Test", pretrained=str(tmp_path / "port.pth"), precision="fp32",
                         device="cpu", **WIDE)
    assert all(torch.equal(v, sd[k]) for k, v in model.state_dict().items())
