"""The modified ResNet image tower (``spatial_clip_tpu_torch.models.modified_resnet``)
against the JAX package's ``spatial_clip_tpu.models.modified_resnet``: the
frozen BatchNorm, the Bottleneck (stride 1 without and with a downsample,
stride 2 with one), the attention pool, the tower at RN-Test's 32 and 64
px, the CLIP forward, three Trainer steps, the weight map both ways and an
open_clip RN state dict, RN50's full-width tree, and tower locking.

Parameters come from numpy seeds on JAX's tree from ``jax.eval_shape``
(kernels normal / sqrt(fan_in), BatchNorm statistics off their init:
means normal(0.1), variances in [1, 1.5)), carried over with the port's
key map. All in f32 on the CPU; the same math in other summation orders:
features at atol 1e-5 (rtol 1e-4), losses at rtol 1e-5, parameters at atol
1e-5 after the steps; the BatchNorm statistics keep their bits.
"""
from __future__ import annotations

import tests.helpers.torch_threads  # noqa: F401  (xdist workers share the cores)

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatial_clip_tpu.cli.main_train import _lock_prefixes as jax_lock_prefixes
from spatial_clip_tpu.cli.main_train import parse_args as jax_parse_args
from spatial_clip_tpu.losses import make_loss as jax_make_loss
from spatial_clip_tpu.models import modified_resnet as jrn
from spatial_clip_tpu.models.clip import CLIP as JaxCLIP
from spatial_clip_tpu.models.config import resolve_clip_cfg as jax_resolve_clip_cfg
from spatial_clip_tpu.models.convert import torch_to_jax_params
from spatial_clip_tpu.models.factory import ModelBundle
from spatial_clip_tpu.parallel.mesh import make_mesh
from spatial_clip_tpu.train import optim as jax_optim
from spatial_clip_tpu.train.loop import Trainer as JaxTrainer
from spatial_clip_tpu.train.loop import TrainerConfig as JaxTrainerConfig
from spatial_clip_tpu_torch import create_model
from spatial_clip_tpu_torch.cli.main_train import _lock_prefixes
from spatial_clip_tpu_torch.losses import make_loss
from spatial_clip_tpu_torch.models import modified_resnet as prn
from spatial_clip_tpu_torch.models.convert import _key_pairs, from_jax_params, to_jax_params
from spatial_clip_tpu_torch.ops import attention_plain
from spatial_clip_tpu_torch.train.loop import Trainer, TrainerConfig
from spatial_clip_tpu_torch.train.optim import decay_mask, freeze_mask, jax_param_paths


def _x(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _draw(shapes, seed):
    """numpy draws on a JAX param tree (see the module docstring)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        x = rng.normal(size=leaf.shape)
        if name == "kernel":
            return (x / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        if name == "var":
            return (1.0 + 0.5 * rng.random(leaf.shape)).astype(np.float32)
        return (x * 0.1 + (1.0 if name == "scale" else 0.0)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _init(module, seed, *args):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))
    return _draw(shapes["params"], seed)


def _sub_sd(params, names):
    """A submodule's state dict from its flax params: kernels HWIO -> OIHW
    and (in, out) -> (out, in), ``scale`` / ``mean`` / ``var`` as
    ``weight`` / ``running_mean`` / ``running_var``, flax module names
    renamed by ``names``."""
    leaves = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
              "var": "running_var"}
    out = {}
    for path, v in jax.tree_util.tree_leaves_with_path(params):
        *mods, leaf = [p.key for p in path]
        v = np.asarray(v)
        if leaf == "kernel":
            v = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T
        key = ".".join([names.get(m, m) for m in mods] + [leaves.get(leaf, leaf)])
        out[key] = torch.from_numpy(np.array(v))
    return out


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=1e-4)


def test_frozen_batchnorm_matches_jax_and_takes_no_gradient():
    jm = jrn.FrozenBatchNorm()
    x = _x(0, (2, 3, 3, 8))
    params = _init(jm, 1, jnp.asarray(x))
    pm = prn.FrozenBatchNorm(8)
    pm.load_state_dict(_sub_sd(params, {}), strict=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = pm(xt)
    _close(y.detach(), jm.apply({"params": params}, jnp.asarray(x)))
    y.square().sum().backward()
    assert pm.running_mean.grad is None and pm.running_var.grad is None
    assert pm.weight.grad is not None and xt.grad is not None


@pytest.mark.parametrize("n_in,planes,stride,downsample", [
    (16, 4, 1, False),  # n_in == planes * 4: the identity as it is
    (8, 4, 1, True),  # the widths differ: a 1x1 downsample, no pool
    (16, 8, 2, True),  # blur pool before conv3, avg pool + 1x1 downsample
])
def test_bottleneck_matches_jax(n_in, planes, stride, downsample):
    jm = jrn.Bottleneck(planes=planes, stride=stride, downsample=downsample)
    x = _x(2, (2, 8, 8, n_in))
    params = _init(jm, 3, jnp.asarray(x))
    pm = prn.Bottleneck(n_in, planes, stride, downsample)
    pm.load_state_dict(_sub_sd(params, {"downsample_conv": "downsample.0",
                                        "downsample_bn": "downsample.1"}), strict=True)
    got = pm(torch.from_numpy(x)).detach()
    assert got.shape == (2, 8 // stride, 8 // stride, planes * 4)
    _close(got, jm.apply({"params": params}, jnp.asarray(x)))


def test_attention_pool_matches_jax():
    """The mean token and (HW + 1, C) positions; one head_attention call."""
    jm = jrn.AttentionPool2d(embed_dim=32, heads=2, output_dim=24)
    x = _x(4, (3, 2, 2, 32))
    params = _init(jm, 5, jnp.asarray(x))
    pm = prn.AttentionPool2d(2, 32, 2, 24)
    pm.load_state_dict(_sub_sd(params, {}), strict=True)
    before = attention_plain.head_attention.launches
    got = pm(torch.from_numpy(x)).detach()
    assert attention_plain.head_attention.launches == before + 1
    _close(got, jm.apply({"params": params}, jnp.asarray(x)))


@functools.lru_cache(maxsize=None)
def _jax_clip(size):
    """RN-Test (at ``size`` px) in JAX: config, drawn params, jitted apply
    (flax's apply runs op by op otherwise, ~10 s here)."""
    cfg = jax_resolve_clip_cfg("RN-Test", vision_cfg=dict(image_size=size))
    jm = JaxCLIP(cfg)
    params = _init(jm, size, jnp.zeros((1, size, size, 3)), jnp.zeros((1, 16), jnp.int32))
    return cfg, jax.jit(jm.apply), params


def _port_clip(size, training=False):
    model = create_model("RN-Test", precision="fp32", device="cpu", training=training,
                         vision_cfg=dict(image_size=size))
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, _jax_clip(size)[2])),
                          strict=True)
    return model


@pytest.mark.parametrize("size", [32, 64])
def test_modified_resnet_matches_jax(size):
    """RN-Test's tower (stem, 4 one-block stages, the pool over a 1x1 / 2x2
    grid) and the CLIP's features and logit scale."""
    cfg, apply, params = _jax_clip(size)
    model = _port_clip(size)
    assert isinstance(model.visual, prn.ModifiedResNet)
    assert model.visual.attnpool.heads == cfg.vision_cfg.width * 32 // 64
    images, ids = _x(6, (2, size, size, 3)), np.random.default_rng(7).integers(0, 512, (2, 16))
    want = apply({"params": params}, jnp.asarray(images), jnp.asarray(ids, jnp.int32))
    with torch.no_grad():
        got = model(torch.from_numpy(images), torch.from_numpy(ids))
    for k in ("image_features", "text_features", "logit_scale"):
        _close(got[k], want[k])


def test_stem_pads_one_on_each_side():
    """The stride-2 stem convolution of an even size pads (1, 1), as JAX's
    explicit padding (flax's SAME would pad (0, 1)): on a one-hot kernel
    picking the top-left tap, output (0, 0) reads the padding."""
    conv = prn.RNConv(1, 1, 3, stride=2)
    with torch.no_grad():
        conv.weight.zero_()
        conv.weight[0, 0, 0, 0] = 1.0
    x = torch.arange(1.0, 17.0).view(1, 4, 4, 1)
    y = conv(x)
    assert y.shape == (1, 2, 2, 1)
    assert y[0, :, :, 0].tolist() == [[0.0, 0.0], [0.0, 6.0]]


def _batch(seed, B=8, size=32, ctx=16, vocab=512, k=4):
    rng = np.random.default_rng(seed)
    tile_ids = np.arange(B, dtype=np.int32)
    tile_ids[-1] = tile_ids[0]
    return {
        "images": rng.integers(0, 256, (B, size, size, 3), dtype=np.uint8),
        "texts": rng.integers(0, vocab, (B, ctx), dtype=np.int32),
        "image_tile_ids": tile_ids,
        "text_tile_ids": tile_ids.copy(),
        "neighbor_tile_ids": rng.integers(-1, B, (B, k)).astype(np.int32),
        "neighbor_alphas": rng.uniform(0, 1, (B, k)).astype(np.float32),
    }


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)).long() if k == "texts"
            else torch.from_numpy(np.array(v)) for k, v in batch.items()}


def test_three_trainer_steps_of_rn_test_match_jax():
    """Three steps of the port's Trainer against the JAX Trainer on RN-Test
    (32 px, the spatial loss, AdamW with f32 moments, lr 0 at step 0):
    loss, grad_norm and logit_scale at rtol 1e-5, every parameter at atol
    1e-5 after the steps; every BatchNorm mean and variance keeps its bits
    in both packages (zero gradient, no weight decay)."""
    cfg_kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=50, augment=False, seed=0,
                  mu_dtype=None, nu_dtype=None)
    loss_kw = dict(cap_logit_scale=50.0)
    cfg, _, params = _jax_clip(32)
    model = _port_clip(32, training=True)
    jb = ModelBundle(model=JaxCLIP(cfg=cfg, dtype=jnp.float32), params=params, cfg=cfg)
    jt = JaxTrainer(jb, loss=jax_make_loss("spatial", **loss_kw),
                    config=JaxTrainerConfig(**cfg_kw), mesh=make_mesh(devices=jax.devices()[:1]))
    jstep, jstate = jt.make_train_step(), jt.init_state()
    trainer = Trainer(model, make_loss("spatial", **loss_kw), TrainerConfig(**cfg_kw))
    state = trainer.init_state()
    stats = {k: v.detach().clone() for k, v in state.params.items()
             if k.endswith(("running_mean", "running_var"))}
    assert len(stats) == 2 * (3 + 4 * 3 + 4)  # the stem's 3, 4 blocks x 3, 4 downsamples
    for i in range(3):
        batch = _batch(20 + i)
        jstate, jm = jstep(jstate, jt._device_batch(batch))
        state, m = trainer.train_step(state, _torch_batch(batch))
        for k in ("loss", "grad_norm", "logit_scale"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, atol=1e-12,
                                       err_msg=f"step {i} {k}")
    want = from_jax_params(jax.tree.map(np.asarray, jstate.params))
    for k, w in want.items():
        np.testing.assert_allclose(state.params[k].detach().numpy(), w.numpy(), atol=1e-5,
                                   rtol=0, err_msg=k)
    for k, v in stats.items():
        assert torch.equal(state.params[k].detach(), v), k
        assert torch.equal(want[k], v), k


def test_weight_map_round_trips_and_reads_an_open_clip_file(tmp_path):
    """from_jax_params / to_jax_params are inverse on RN-Test's tree; an
    open_clip-layout RN state dict (with num_batches_tracked) saved as a
    torch file loads through load_checkpoint to the weights JAX's
    torch_to_jax_params reads from it."""
    params = jax.tree.map(np.asarray, _jax_clip(32)[2])
    sd = from_jax_params(params)
    back = to_jax_params(sd)
    flat = lambda t: {jax.tree_util.keystr(p): np.asarray(v)  # noqa: E731
                      for p, v in jax.tree_util.tree_leaves_with_path(t)}
    a, b = flat(back), flat(params)
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    assert "visual.layer1.0.downsample.0.weight" in sd
    assert "visual.layer1.0.downsample.1.running_mean" in sd
    assert "visual.attnpool.q_proj.weight" in sd
    open_clip = dict(sd)
    for k in list(sd):
        if k.endswith("running_var"):
            open_clip[k[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(7)
    torch.save(open_clip, tmp_path / "rn.pt")
    model = create_model("RN-Test", precision="fp32", device="cpu",
                         pretrained=str(tmp_path / "rn.pt"))
    want = torch_to_jax_params({k: v.numpy() for k, v in open_clip.items()})
    for k, w in from_jax_params(jax.tree.map(np.asarray, want)).items():
        assert torch.equal(model.state_dict()[k], w), k


def test_rn50_full_width_tree_maps_one_to_one():
    """RN50 (meta device) against JAX's tree from jax.eval_shape: one to one
    through the key map with the same shapes, JAX's weight-decay mask (the
    BatchNorm statistics 1-D, no decay) and the heads / positions JAX
    builds (32 heads, a 7x7 + 1 position table)."""
    cfg = jax_resolve_clip_cfg("RN50")
    shapes = jax.eval_shape(lambda: JaxCLIP(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)), jnp.zeros((1, 77), jnp.int32)))
    jflat = {jax.tree_util.keystr(p, simple=True, separator="/"): tuple(v.shape)
             for p, v in jax.tree_util.tree_leaves_with_path(shapes["params"])}
    model = create_model("RN50", device="meta", training=True)
    ours = {k: tuple(p.shape) for k, p in model.named_parameters()}
    pairs = _key_pairs(lambda j, t: j in jflat or t in ours)
    assert sorted(j for j, _, _ in pairs) == sorted(jflat)
    assert sorted(t for _, t, _ in pairs) == sorted(ours)
    for jkey, tkey, transpose in pairs:
        want = jflat[jkey] if transpose is None else tuple(jflat[jkey][i] for i in transpose)
        assert ours[tkey] == want, (jkey, tkey)
    assert ours["visual.attnpool.positional_embedding"] == (50, 2048)
    assert model.visual.attnpool.heads == 32
    views = jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes["params"])
    jdecay = {jax.tree_util.keystr(p, simple=True, separator="/"): bool(v)
              for p, v in jax.tree_util.tree_leaves_with_path(jax_optim.decay_mask(views))}
    paths = jax_param_paths(ours)
    ours_decay = decay_mask(dict(model.named_parameters()))
    assert {paths[k]: v for k, v in ours_decay.items()} == jdecay


@pytest.mark.parametrize("groups", ["0", "1"])
def test_lock_image_groups_lock_the_whole_rn_tower(groups):
    """Under RN, --lock-image-unlocked-groups n locks the whole image tower,
    as JAX's prefixes do (a list of layers has no resblocks)."""
    model = create_model("RN-Test", precision="fp32", device="meta", training=True)
    args = jax_parse_args(["--model", "RN-Test", "--lock-image-tower",
                           "--lock-image-unlocked-groups", groups])
    prefixes = _lock_prefixes(model, args)
    assert prefixes == jax_lock_prefixes(types.SimpleNamespace(cfg=model.cfg), args) == (
        "visual",)
    frozen = freeze_mask([k for k, _ in model.named_parameters()], prefixes)
    assert {k for k, v in frozen.items() if v} == {k for k in frozen if k.startswith("visual.")}
