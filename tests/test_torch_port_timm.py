"""The timm-style towers (``spatial_clip_tpu_torch.models.timm_model``)
against the JAX package's ``spatial_clip_tpu.models.timm_model``: every
registry pico trunk through ``TimmStyleTower``, parameter gradients, each
pool and projection option, a class-token ViT, flax's SAME padding, the
weight map both ways, and an open_clip-layout state dict read by both
packages.

Inputs and parameters come from numpy seeds (the parameters on JAX's
tree from ``jax.eval_shape``, at scales that keep every path's activations
O(1)), carried over with the port's key map (``models/convert.py``). All in f32 on the CPU; the same
math in other summation orders: features at rtol 1e-4 / atol 1e-5,
gradients at atol 1e-5 + rtol 1e-4.
"""
from __future__ import annotations

import tests.helpers.torch_threads  # noqa: F401  (xdist workers share the cores)

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatial_clip_tpu.models import timm_model as jtm
from spatial_clip_tpu.models.clip import CLIP as JaxCLIP
from spatial_clip_tpu.models.config import resolve_clip_cfg as jax_resolve_clip_cfg
from spatial_clip_tpu.models.convert import torch_to_jax_params
from spatial_clip_tpu_torch import create_model
from spatial_clip_tpu_torch.models import timm_model as ptm
from spatial_clip_tpu_torch.models.convert import (
    _flatten,
    _key_pairs,
    from_jax_params,
    to_jax_params,
)
from spatial_clip_tpu_torch.models.factory import load_checkpoint
from spatial_clip_tpu_torch.ops import attention_plain

PICOS = [("convnext_pico", 64), ("vit_pico_patch16_siglip_test", 32),
         ("eva_pico_patch16_test", 32), ("vitamin_pico_test", 64), ("fastvit_pico_test", 64),
         ("swin_pico_test", 64)]
EMBED = 32


def _images(seed, size, B=2):
    return np.random.default_rng(seed).normal(size=(B, size, size, 3)).astype(np.float32)


def _visual_state(params) -> dict:
    """The port's state dict of a JAX TimmStyleTower's params (the visual
    half of the key map), keys without the ``visual.`` prefix."""
    flat = _flatten({"visual": params})
    out = {}
    for jkey, tkey, transpose in _key_pairs(lambda j, t: j in flat):
        if jkey in flat:
            v = flat.pop(jkey)
            out[tkey[len("visual."):]] = torch.from_numpy(
                np.array(v if transpose is None else v.transpose(transpose)))
    assert not flat, sorted(flat)
    return out


def _random_params(shapes, seed):
    """numpy draws on a JAX param tree: kernels normal / sqrt(fan_in),
    LayerNorm scales 1 + normal(0.1), every other leaf normal(0.1)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        x = rng.normal(size=leaf.shape)
        if name == "kernel":
            return (x / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        return (x * 0.1 + (1.0 if name == "scale" else 0.0)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _init(module, seed, *args):
    """A flax module's params drawn by :func:`_random_params` on the tree
    ``jax.eval_shape`` gives (flax's own initializers run op by op here,
    ~10 s a trunk)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))
    return _random_params(shapes["params"], seed)


@functools.lru_cache(maxsize=None)
def _jax_tower(name, size, pool="avg", proj="linear", embed=EMBED, proj_bias=False):
    """JAX's tower, its params and its jitted apply (flax's apply op by op
    takes 3-12 s a pico trunk here), built once per setting."""
    jm = jtm.TimmStyleTower(model_name=name, embed_dim=embed, image_size=size, pool=pool,
                            proj=proj, proj_bias=proj_bias)
    return jm, _init(jm, len(name) + size, jnp.asarray(_images(0, size))), jax.jit(jm.apply)


def _pair(name, size, pool="avg", proj="linear", embed=EMBED, proj_bias=False):
    jm, params, _ = _jax_tower(name, size, pool, proj, embed, proj_bias)
    pm = ptm.TimmStyleTower(name, embed, size, pool=pool, proj=proj, proj_bias=proj_bias)
    pm.load_state_dict(_visual_state(params), strict=True)
    return jm, params, pm


def _check_features(name, size, pool="avg", proj="linear", embed=EMBED, proj_bias=False):
    jm, params, pm = _pair(name, size, pool, proj, embed, proj_bias)
    x = _images(1, size)
    want = np.asarray(_jax_tower(name, size, pool, proj, embed, proj_bias)[2](
        {"params": params}, jnp.asarray(x)))
    got = pm(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    return pm


@pytest.mark.parametrize("name,size", PICOS)
def test_pico_trunk_matches_jax(name, size):
    """Each registry pico trunk through TimmStyleTower (pool 'avg', proj
    'linear'): the features, and the einsum attention calls (the ViT
    stages' plain route, the EVA / Swin blocks' head attention)."""
    before = (attention_plain.plain_attention.launches, attention_plain.head_attention.launches)
    pm = _check_features(name, size)
    calls = (attention_plain.plain_attention.launches - before[0],
             attention_plain.head_attention.launches - before[1])
    blocks = sum(1 for n, _ in pm.named_modules() if n.count("resblocks.") == 1
                 and n.split(".")[-1].isdigit())
    swin = sum(1 for m in pm.modules() if isinstance(m, ptm.SwinBlock))
    eva = getattr(pm.trunk, "layers", 0) if isinstance(pm.trunk, ptm.EVATrunk) else 0
    assert calls == (blocks, swin + eva), (name, calls)


@pytest.mark.parametrize("pool,proj", [*((pool, "linear") for pool in ("avg", "", "token")),
                                       *(("map", proj) for proj in ("linear", "mlp", "none",
                                                                    None, "")),
                                       ("token", None)])
def test_pool_and_proj_options_on_the_vit_pico(pool, proj):
    """Every pool option (with proj 'linear') and every proj option (after
    the MAP head) on the ViT pico (a 2 x 2 token grid): 'token' on a grid is
    its mean; proj 'none' passes the width through; None / '' add head_fc
    only where the widths differ."""
    embed = 64 if proj == "none" else EMBED
    pm = _check_features("vit_pico_patch16_siglip_test", 32, pool, proj, embed)
    assert hasattr(pm, "head_fc") == (proj in (None, ""))


def test_map_head_builds_c_over_64_heads():
    """The MAP head's heads are C // 64 in both packages, 18 at SO400M's
    1152 (timm builds 16): a 2-head MAP head (C 128) against JAX's on the
    same probe and weights, and the 18 heads pinned."""
    assert ptm.MAPHead(1152, device="meta").heads == 18
    x = np.random.default_rng(8).normal(size=(2, 5, 128)).astype(np.float32)
    jhead = jtm.MAPHead()
    params = _init(jhead, 8, jnp.asarray(x))
    port = ptm.MAPHead(128)
    assert port.heads == 2
    sd = {"probe": params["probe"], "ln.weight": params["ln"]["scale"],
          "ln.bias": params["ln"]["bias"]}
    for name in ("q", "k", "v", "out", "mlp_fc", "mlp_proj"):  # flax (in, out) -> (out, in)
        sd[f"{name}.weight"], sd[f"{name}.bias"] = params[name]["kernel"].T, params[name]["bias"]
    port.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
    want = np.asarray(jax.jit(jhead.apply)({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(port(torch.from_numpy(x)).detach().numpy(), want, rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("pool,proj,proj_bias", [("abs_attn", "none", False),
                                                 ("rot_attn", "none", False),
                                                 ("rot_attn", "linear", True),
                                                 ("", "mlp", True)])
def test_attention_pools_and_proj_bias_on_the_convnext_pico(pool, proj, proj_bias):
    """The attention pools (learned positions, 2-D rotary k) over the
    ConvNeXt pico's 2 x 2 grid, projected to embed_dim inside the pool, and
    the biased projections."""
    _check_features("convnext_pico", 64, pool, proj, EMBED, proj_bias)


def test_cls_token_vit_matches_jax(monkeypatch):
    """A class-token ViT built small from both packages' ViTTrunk (the
    MobileCLIP-B / relpos trunk shape): the trunk's (B, 1 + L, C) sequence,
    and the adapter's 'token', 'map' and 'avg' pools (the class token
    stripped where the length is not a square)."""
    monkeypatch.setitem(jtm.TRUNKS, "vit_pico_cls_test", jtm.TrunkSpec(
        build=lambda dtype, name=None: jtm.ViTTrunk(patch_size=16, width=64, layers=2, heads=2,
                                                    cls_token=True, dtype=dtype, name=name),
        reduction=16))
    monkeypatch.setitem(ptm.TRUNKS, "vit_pico_cls_test", ptm._vit(64, 2, 2, 16, cls_token=True))
    x = _images(3, 48)
    jtrunk = jtm.ViTTrunk(patch_size=16, width=64, layers=2, heads=2, cls_token=True)
    jp = _init(jtrunk, 1, jnp.asarray(x))
    ptrunk = ptm.ViTTrunk(48, 16, 64, 2, 2, cls_token=True)
    ptrunk.load_state_dict({k[len("trunk."):]: v for k, v in
                            _visual_state({"trunk": jp}).items()}, strict=True)
    want = np.asarray(jax.jit(jtrunk.apply)({"params": jp}, jnp.asarray(x)))
    got = ptrunk(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (2, 10, 64)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    for pool in ("token", "map", "avg"):
        _check_features("vit_pico_cls_test", 48, pool, "linear")


@pytest.mark.parametrize("name,size,pool", [("convnext_pico", 64, ""),
                                            ("vit_pico_patch16_siglip_test", 32, "map"),
                                            ("eva_pico_patch16_test", 32, "token")])
def test_parameter_gradients_match_jax(name, size, pool):
    """Every parameter's gradient of sum(features * g) against jax.grad,
    through the key map's transposes."""
    jm, params, pm = _pair(name, size, pool)
    x = _images(4, size)
    g = np.random.default_rng(5).normal(size=(2, EMBED)).astype(np.float32)

    def loss(p):
        return jnp.sum(jm.apply({"params": p}, jnp.asarray(x)) * g)

    want = _visual_state(jax.jit(jax.grad(loss))(params))
    (pm(torch.from_numpy(x)) * torch.from_numpy(g)).sum().backward()
    got = {k: p.grad for k, p in pm.named_parameters()}
    assert set(got) == set(want)
    for k, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(got[k].numpy(), w, atol=1e-5 + 1e-4 * np.abs(w).max(),
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("size", [8, 9])
@pytest.mark.parametrize("groups", [1, 6])
def test_same_stride2_conv_matches_flax(size, groups):
    """A 3x3 stride-2 SAME convolution (ViTamin's and FastViT's stems; 6
    groups of 1 is FastViT's depthwise stem2) against flax.linen.Conv: at an
    even size flax pads (0, 1), at an odd one (1, 1); also a 7x7 stride-1
    depthwise one (ConvNeXt's)."""
    rng = np.random.default_rng(size + groups)
    x = rng.normal(size=(2, size, size, 6)).astype(np.float32)
    for kernel, stride in ((3, 2), (7, 1)):
        conv = fnn.Conv(6, (kernel, kernel), strides=(stride, stride), padding="SAME",
                        feature_group_count=groups)
        p = _init(conv, kernel, jnp.asarray(x))
        want = np.asarray(jax.jit(conv.apply)({"params": p}, jnp.asarray(x)))
        port = ptm.Conv(6, 6, kernel, stride, groups)
        port.load_state_dict({"weight": torch.from_numpy(np.array(p["kernel"])).permute(3, 2, 0, 1),
                              "bias": torch.from_numpy(np.array(p["bias"]))})
        got = port(torch.from_numpy(x)).detach().numpy()
        assert got.shape == want.shape == (2, -(-size // stride), -(-size // stride), 6)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert ptm.same_pads(8, 3, 2) == (0, 1) and ptm.same_pads(9, 3, 2) == (1, 1)


def test_unknown_trunk_raises_listing_the_registry():
    """An unknown name: KeyError listing the trunks in both packages (the
    port's also a NotImplementedError, as check_ported raises it)."""
    with pytest.raises(KeyError, match="convnext_pico"):
        ptm.TimmStyleTower("vit_nonexistent", EMBED)
    with pytest.raises(NotImplementedError, match="vision_cfg.timm_model_name"):
        create_model("ViT-Test", precision="fp32", device="meta",
                     vision_cfg=dict(timm_model_name="vit_nonexistent"))
    jm = jtm.TimmStyleTower(model_name="vit_nonexistent", embed_dim=EMBED)
    with pytest.raises(KeyError, match="convnext_pico"):
        jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    assert ptm.list_timm_trunks() == jtm.list_timm_trunks()


def _pico_clip_cfg(name, size, pool="", proj="linear"):
    return dict(vision_cfg=dict(timm_model_name=name, timm_pool=pool, timm_proj=proj,
                                image_size=size))


@pytest.mark.parametrize("name,size", PICOS)
def test_weight_map_round_trips(name, size):
    """from_jax_params / to_jax_params over a whole pico CLIP: JAX's tree
    maps one to one onto the model's state dict, and back bit for bit."""
    over = _pico_clip_cfg(name, size)
    jcfg = jax_resolve_clip_cfg("ViT-Test", **over)
    params = _init(JaxCLIP(jcfg), 7, jnp.zeros((1, size, size, 3)), jnp.zeros((1, 16), jnp.int32))
    model = create_model("ViT-Test", precision="fp32", device="cpu", **over)
    sd = from_jax_params(params)
    model.load_state_dict(sd, strict=True)
    back = _flatten(to_jax_params(model.state_dict()))
    flat = _flatten(params)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def _open_clip_visual(model, kind) -> dict:
    """The open_clip / timm layout of a port model's image tower, written
    out here from the timm names (the inverse of JAX's
    ``_convert_convnext_visual`` / ``_convert_timm_vit_visual``): conv
    kernels OIHW, timm's (1, 1, C) latent and (1, L, C) positions, the MAP
    pool's k and v as one ``kv``."""
    p = {k: v.detach().clone() for k, v in model.state_dict().items()}
    out, tr = {}, "visual.trunk"
    if kind == "convnext":
        out[f"{tr}.stem.0.weight"], out[f"{tr}.stem.0.bias"] = (p.pop(f"{tr}.stem_conv.weight"),
                                                                p.pop(f"{tr}.stem_conv.bias"))
        for n in ("weight", "bias"):
            out[f"{tr}.stem.1.{n}"] = p.pop(f"{tr}.stem_norm.{n}")
        for s_ in range(4):
            if s_ > 0:
                for n in ("weight", "bias"):
                    out[f"{tr}.stages.{s_}.downsample.0.{n}"] = p.pop(f"{tr}.ds_norm_{s_}.{n}")
                    out[f"{tr}.stages.{s_}.downsample.1.{n}"] = p.pop(f"{tr}.ds_conv_{s_}.{n}")
            b = 0
            while f"{tr}.stage{s_}_block{b}.gamma" in p:
                ours, theirs = f"{tr}.stage{s_}_block{b}", f"{tr}.stages.{s_}.blocks.{b}"
                for a, c in (("dwconv", "conv_dw"), ("norm", "norm"), ("pwconv1", "mlp.fc1"),
                             ("pwconv2", "mlp.fc2")):
                    for n in ("weight", "bias"):
                        out[f"{theirs}.{c}.{n}"] = p.pop(f"{ours}.{a}.{n}")
                out[f"{theirs}.gamma"] = p.pop(f"{ours}.gamma")
                b += 1
        for n in ("weight", "bias"):
            out[f"{tr}.head.norm.{n}"] = p.pop(f"visual.head_norm.{n}")
    else:
        for n in ("weight", "bias"):
            out[f"{tr}.patch_embed.proj.{n}"] = p.pop(f"{tr}.patch_embed.{n}")
            out[f"{tr}.norm.{n}"] = p.pop(f"{tr}.norm.{n}")
        out[f"{tr}.pos_embed"] = p.pop(f"{tr}.pos_embed")[None]
        i = 0
        while f"{tr}.blocks.resblocks.{i}.ln_1.weight" in p:
            ours, theirs = f"{tr}.blocks.resblocks.{i}", f"{tr}.blocks.{i}"
            out[f"{theirs}.attn.qkv.weight"] = p.pop(f"{ours}.attn.in_proj_weight")
            out[f"{theirs}.attn.qkv.bias"] = p.pop(f"{ours}.attn.in_proj_bias")
            for a, c in (("ln_1", "norm1"), ("ln_2", "norm2"), ("attn.out_proj", "attn.proj"),
                         ("mlp.c_fc", "mlp.fc1"), ("mlp.c_proj", "mlp.fc2")):
                for n in ("weight", "bias"):
                    out[f"{theirs}.{c}.{n}"] = p.pop(f"{ours}.{a}.{n}")
            i += 1
        ap, ours = f"{tr}.attn_pool", "visual.attn_pool"
        out[f"{ap}.latent"] = p.pop(f"{ours}.probe")[None]
        out[f"{ap}.kv.weight"] = torch.cat([p.pop(f"{ours}.k.weight"), p.pop(f"{ours}.v.weight")])
        out[f"{ap}.kv.bias"] = torch.cat([p.pop(f"{ours}.k.bias"), p.pop(f"{ours}.v.bias")])
        for a, c in (("q", "q"), ("out", "proj"), ("ln", "norm"), ("mlp_fc", "mlp.fc1"),
                     ("mlp_proj", "mlp.fc2")):
            for n in ("weight", "bias"):
                out[f"{ap}.{c}.{n}"] = p.pop(f"{ours}.{a}.{n}")
    out["visual.head.proj.weight"] = p.pop("visual.head_proj.weight")
    assert not [k for k in p if k.startswith("visual.")], sorted(p)
    out.update(p)  # the text tower and the logit scale: open_clip's names
    return out


@pytest.mark.parametrize("name,size,kind,pool", [("convnext_pico", 64, "convnext", ""),
                                                 ("vit_pico_patch16_siglip_test", 32, "vit",
                                                  "map")])
def test_open_clip_layout_state_dict_loads_as_in_jax(tmp_path, name, size, kind, pool):
    """An open_clip-layout state dict made here (a timm ConvNeXt pico, and a
    timm ViT pico with MAP pooling), read by JAX's ``torch_to_jax_params``
    and by the port's ``read_state_dict`` (a .pt file, loaded strictly):
    the same image and text features."""
    over = _pico_clip_cfg(name, size, pool)
    src = create_model("ViT-Test", precision="fp32", device="cpu", seed=3, **over)
    sd = _open_clip_visual(src, kind)
    path = tmp_path / "open_clip_pytorch_model.bin"
    torch.save(sd, path)
    model = create_model("ViT-Test", precision="fp32", device="cpu", seed=4, **over)
    load_checkpoint(model, tmp_path)
    jparams = torch_to_jax_params({k: v.numpy() for k, v in sd.items()})
    jm = JaxCLIP(jax_resolve_clip_cfg("ViT-Test", **over))
    x = _images(6, size)
    ids = np.random.default_rng(6).integers(0, 512, (2, 16)).astype(np.int32)
    want = jax.jit(jm.apply)({"params": jparams}, jnp.asarray(x), jnp.asarray(ids))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(ids).long())
        ref = src(torch.from_numpy(x), torch.from_numpy(ids).long())
    for key in ("image_features", "text_features"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-4,
                                   atol=1e-5, err_msg=key)
        torch.testing.assert_close(got[key], ref[key], rtol=0, atol=1e-6)
