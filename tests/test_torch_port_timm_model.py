"""CLIP models with a timm-style image tower, against the JAX package: the
built-in configs the port takes, the parameter trees of one full-width
config per trunk family, and two Trainer steps of a ConvNeXt-pico CLIP.

- ``check_ported`` lets through 91 of the 142 built-in configs (30 before
  the timm towers, 74 before the modified ResNet and Hugging Face towers),
  each built by ``create_model`` (on the meta device: the largest, EVA02-E,
  holds 4.4e9 parameters); the SigLIP / SigLIP2 configs, whose image
  trunks are ported, are refused on their text side but for the two
  nllb-clip ones, whose text tower is the M2M100 encoder.
- One config per family at full width on the meta device against JAX's
  tree from ``jax.eval_shape``: every parameter maps one to one, with the
  same shape after the key map's transposes, the same weight-decay mask
  (JAX's ``ndim >= 2`` over JAX's shapes) and the same LiT lock.
- Two steps of the port's Trainer against the JAX Trainer (f32, CPU):
  losses at rtol 1e-5, parameters at atol 1e-5.
"""
from __future__ import annotations

import tests.helpers.torch_threads  # noqa: F401  (xdist workers share the cores)

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatial_clip_tpu.losses import make_loss as jax_make_loss
from spatial_clip_tpu.models.clip import CLIP as JaxCLIP
from spatial_clip_tpu.models.config import resolve_clip_cfg as jax_resolve_clip_cfg
from spatial_clip_tpu.models.factory import ModelBundle
from spatial_clip_tpu.parallel.mesh import make_mesh
from spatial_clip_tpu.train import optim as jax_optim
from spatial_clip_tpu.train.loop import Trainer as JaxTrainer
from spatial_clip_tpu.train.loop import TrainerConfig as JaxTrainerConfig
from spatial_clip_tpu_torch import create_model
from spatial_clip_tpu_torch.cli import main_train
from spatial_clip_tpu_torch.losses import make_loss
from spatial_clip_tpu_torch.models import config as port_config
from spatial_clip_tpu_torch.models.convert import _key_pairs, from_jax_params, to_jax_params
from spatial_clip_tpu_torch.models.timm_model import TimmStyleTower
from spatial_clip_tpu_torch.train.loop import Trainer, TrainerConfig
from spatial_clip_tpu_torch.train.optim import decay_mask, freeze_mask, jax_param_paths

BUILTINS = port_config.list_model_configs()
# one config per trunk family, at full width
FAMILIES = ["convnext_base", "vit_medium_patch16_gap_256", "PE-Core-B-16", "MobileCLIP-B",
            "EVA02-B-16", "ViTamin-B", "MobileCLIP-S1", "swin_base_patch4_window7_224"]


def _passes(name) -> bool:
    try:
        port_config.check_ported(port_config.resolve_clip_cfg(name))
    except NotImplementedError:
        return False
    return True


# the configs the modified ResNet and Hugging Face towers opened
RN_CONFIGS = ["RN-Test", *(f"RN{s}{q}" for s in ("50", "101", "50x4", "50x16", "50x64")
                           for q in ("", "-quickgelu"))]
HF_CONFIGS = ["roberta-ViT-B-32", "xlm-roberta-base-ViT-B-32", "mt5-base-ViT-B-32",
              "nllb-clip-base", "nllb-clip-base-siglip", "nllb-clip-large-siglip"]


def test_74_builtin_configs_pass_and_build():
    """93 of the 142 built-in configs pass check_ported (74 before the RN
    and HF towers, 91 before CoCa): 46 with a timm trunk (44 before, and
    the 2 nllb-clip SigLIP ones), the 11 RN ones and the 6 HF ones named
    above, and coca_ViT-B-32 and coca_ViT-Test; create_model builds each
    (meta device) with the tower its config names, CoCa for the two."""
    from spatial_clip_tpu_torch.models.coca import CoCa
    from spatial_clip_tpu_torch.models.hf_model import HFTextTower
    from spatial_clip_tpu_torch.models.modified_resnet import ModifiedResNet

    passing = [n for n in BUILTINS if _passes(n)]
    assert (len(passing), len(BUILTINS)) == (93, 142)
    assert sorted(n for n in passing if "coca" in n) == ["coca_ViT-B-32", "coca_ViT-Test"]
    timm = [n for n in passing if port_config.resolve_clip_cfg(n).vision_cfg.timm_model_name]
    assert len(timm) == 46
    rn = [n for n in passing if isinstance(port_config.resolve_clip_cfg(n).vision_cfg.layers,
                                           (list, tuple))]
    hf = [n for n in passing if port_config.resolve_clip_cfg(n).text_cfg.hf_tower]
    assert sorted(rn) == sorted(RN_CONFIGS) and sorted(hf) == sorted(HF_CONFIGS)
    for name in passing:
        model = create_model(name, device="meta")
        if name in timm:
            assert isinstance(model.visual, TimmStyleTower), name
        assert isinstance(model.visual, ModifiedResNet) == (name in rn), name
        assert isinstance(model.text, HFTextTower) == (name in hf), name
        assert isinstance(model, CoCa) == name.startswith("coca"), name


def test_siglip_configs_are_refused_on_the_text_side():
    """Each config with a SigLIP image trunk is refused, naming its text
    tower's tokenizer_kwargs (24), but for the 2 nllb-clip ones, whose
    Hugging Face text tower (the M2M100 encoder) is ported."""
    names = [n for n in BUILTINS
             if "siglip" in (port_config.resolve_clip_cfg(n).vision_cfg.timm_model_name or "")]
    assert len(names) == 26
    fields = []
    for name in names:
        if name.startswith("nllb-clip"):
            assert _passes(name), name
            continue
        with pytest.raises(NotImplementedError, match="text_cfg.tokenizer_kwargs") as err:
            port_config.check_ported(port_config.resolve_clip_cfg(name))
        fields.append(str(err.value).split("=")[0].split(" ")[0])
    assert fields.count("text_cfg.tokenizer_kwargs") == 24
    assert sorted(n for n in names if n.startswith("nllb-clip")) == [
        "nllb-clip-base-siglip", "nllb-clip-large-siglip"]


@pytest.mark.parametrize("name", FAMILIES)
def test_full_width_tree_maps_one_to_one(name):
    """The port's model on the meta device against JAX's tree from
    jax.eval_shape: the key map pairs every parameter once, the shapes
    agree after its transposes, and weight decay (the port's ndim >= 2 over
    its shapes, JAX's over JAX's) and the image tower's lock
    (``freeze_mask``) pick the same parameters."""
    cfg = jax_resolve_clip_cfg(name)
    size = cfg.vision_cfg.image_size
    ctx = cfg.text_cfg.context_length
    shapes = jax.eval_shape(lambda: JaxCLIP(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)), jnp.zeros((1, ctx), jnp.int32)))
    jflat = _shape_paths(shapes["params"])
    model = create_model(name, device="meta", training=True)
    ours = {k: tuple(p.shape) for k, p in model.named_parameters()}
    pairs = _key_pairs(lambda j, t: j in jflat or t in ours)
    assert sorted(j for j, _, _ in pairs) == sorted(jflat)
    assert sorted(t for _, t, _ in pairs) == sorted(ours)
    for jkey, tkey, transpose in pairs:
        want = jflat[jkey] if transpose is None else tuple(jflat[jkey][i] for i in transpose)
        assert ours[tkey] == want, (jkey, tkey)
    views = jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes["params"])
    jdecay = _shape_paths(jax_optim.decay_mask(views), leaf=bool)
    ours_decay = decay_mask({k: p for k, p in model.named_parameters()})
    paths = jax_param_paths(ours)
    assert {paths[k]: v for k, v in ours_decay.items()} == jdecay
    frozen = freeze_mask(ours, ["visual"])
    assert {k for k, v in frozen.items() if v} == {k for k in ours if k.startswith("visual.")}


def _shape_paths(tree, prefix="", leaf=None) -> dict:
    """'/'-joined paths of a nested dict of shape structs (their shapes) or
    of values (``leaf`` of each)."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_shape_paths(v, key, leaf))
        else:
            out[key] = leaf(v) if leaf else tuple(v.shape)
    return out


PICO = dict(vision_cfg=dict(timm_model_name="convnext_pico", timm_pool="", timm_proj="linear",
                            image_size=32))


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


def test_two_trainer_steps_of_a_convnext_pico_clip_match_jax():
    """Two steps of the port's Trainer against the JAX Trainer on a
    ConvNeXt-pico CLIP (ViT-Test's text tower; 32 px, the spatial loss, f32
    moments; lr 0 at step 0, so step 1 moves the weights): loss, grad_norm
    and logit_scale at rtol 1e-5, then every parameter at atol 1e-5."""
    cfg_kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=50, augment=False, seed=0,
                  mu_dtype=None, nu_dtype=None)
    loss_kw = dict(cap_logit_scale=50.0)
    model = create_model("ViT-Test", precision="fp32", device="cpu", training=True, **PICO)
    cfg = jax_resolve_clip_cfg("ViT-Test", **PICO)  # the same weights in JAX, no flax init
    jb = ModelBundle(model=JaxCLIP(cfg=cfg, dtype=jnp.float32),
                     params=to_jax_params(model.state_dict()), cfg=cfg)
    jt = JaxTrainer(jb, loss=jax_make_loss("spatial", **loss_kw),
                    config=JaxTrainerConfig(**cfg_kw), mesh=make_mesh(devices=jax.devices()[:1]))
    jstep, jstate = jt.make_train_step(), jt.init_state()
    trainer = Trainer(model, make_loss("spatial", **loss_kw), TrainerConfig(**cfg_kw))
    state = trainer.init_state()
    for i in range(2):
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


def test_main_train_runs_a_timm_config_on_the_cpu(tmp_path):
    """cli.main_train with a ConvNeXt-pico config given as a JSON path: one
    epoch, finite metrics, a checkpoint."""
    raw = json.loads((port_config.CONFIG_DIR / "ViT-Test.json").read_text())
    raw["vision_cfg"].update(PICO["vision_cfg"])
    path = tmp_path / "convnext-pico.json"
    path.write_text(json.dumps(raw))
    metrics = main_train.main(["--model", str(path), "--precision", "fp32", "--dataset-type",
                               "synthetic", "--synthetic-num-samples", "16",
                               "--synthetic-image-size", "32", "--batch-size", "8", "--epochs",
                               "1", "--workers", "0", "--name", "run", "--device", "cpu",
                               "--logs", str(tmp_path / "logs")])
    assert metrics and all(np.isfinite(float(v)) for v in metrics.values())
    assert (tmp_path / "logs" / "run" / "checkpoints").is_dir()
