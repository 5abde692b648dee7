"""Attention past the resident kernels' lengths, and JAX's plain attention
routes, against the JAX package.

- The route each tower takes, for every tower of the built-in configs and a
  sweep of head geometries, lengths, masks and dtypes: the port's kernel
  settings take the kernels exactly where JAX's gate (``heads_per_block``,
  a mask without a batch dimension) takes its Pallas kernels, and JAX's
  einsum attention elsewhere; the kernels run resident up to
  ``fwd_max_seq`` / ``bwd_max_seq`` and key-tiled past them.
- The plain versions the key-tiled kernels are held to (the forward, the
  forward with lse, the backward pieces and ``QKVAttention``'s gradients)
  against JAX's interpret-mode ``fused_attention``, ``_fwd_pallas_lse``,
  ``_bwd_pallas3_db_lse`` and ``qkv_attention`` at L 257, 401 and 577.
- The five plain ``attn_impl`` settings and the gate's fallback (ViT-Test as
  it is: heads of 16; a tower of 2 heads of 72) against JAX's model with the
  same ``attn_impl``: features and every parameter's gradient in f32.
- Two-layer towers at patch 14 and 224 / 336 px (L 257 / 577) against JAX:
  the features and one Trainer step.
- The key-tiled kernels' launch geometry and shared-memory formulas
  against the constants in ``csrc/attention_long.cu``.

Tolerances (f32 on both sides, the same math in other summation orders):
the context, lse and features at atol 1e-5; dqkv at 2e-5 and db at 2e-4 (dq
and dk sum L products of O(1) terms, db sums B L of them); parameter
gradients at atol 1e-5 + rtol 1e-3 of the largest entry, as
tests/test_torch_port_train.py holds them.
"""
from __future__ import annotations

import tests.helpers.torch_threads  # noqa: F401  (xdist workers share the cores)

import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatial_clip_tpu.losses import make_loss as jax_make_loss
from spatial_clip_tpu.models.clip import CLIP as JaxCLIP
from spatial_clip_tpu.models.config import resolve_clip_cfg as jax_resolve_clip_cfg
from spatial_clip_tpu.models.factory import ModelBundle
from spatial_clip_tpu.models.transforms import normalize_batch as jax_normalize
from spatial_clip_tpu.ops import attention_pair as jap
from spatial_clip_tpu.ops import fused_attention as jfa
from spatial_clip_tpu.parallel.mesh import make_mesh
from spatial_clip_tpu.train.loop import Trainer as JaxTrainer
from spatial_clip_tpu.train.loop import TrainerConfig as JaxTrainerConfig
from spatial_clip_tpu_torch import create_model
from spatial_clip_tpu_torch.losses import make_loss
from spatial_clip_tpu_torch.models import config as port_config
from spatial_clip_tpu_torch.models.convert import from_jax_params, to_jax_params
from spatial_clip_tpu_torch.models.transformer import MultiHeadAttention, attention_route
from spatial_clip_tpu_torch.ops import attention_long as al
from spatial_clip_tpu_torch.ops import attention_pair as ap
from spatial_clip_tpu_torch.ops import attention_plain, cuda_build
from spatial_clip_tpu_torch.ops import fused_attention as pfa
from spatial_clip_tpu_torch.train.loop import Trainer, TrainerConfig

KERNEL_IMPLS = ("auto", "pallas", "pallas3", "pallas_inter", "pallas_t", "pallas_split")


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _mask(L, causal):
    """None, the causal mask, ('prefix') finfo(f32).min over the first 130
    keys of every row, past the key-tiled kernels' first 128-key tile: scores
    near finfo.min, as left padding gives them, or ('row') that and all of
    row 1, a row masked in full (chip_smoke's long_mask)."""
    if not causal:
        return None
    low = np.finfo(np.float32).min
    if causal in ("prefix", "row"):
        mask = np.zeros((L, L), np.float32)
        mask[:, :130] = low
        if causal == "row":
            mask[1] = low
        return mask
    return np.triu(np.full((L, L), low, np.float32), k=1)


def _jmask(mask, L):
    return jnp.zeros((L, L), jnp.float32) if mask is None else jnp.asarray(mask)


# ------------------------------------------------------------------ the routes

def _towers(cfg):
    """(name, heads, width, L) of each transformer tower of a config."""
    v, t = cfg.vision_cfg, cfg.text_cfg
    out = []
    if not v.timm_model_name and not isinstance(v.layers, (list, tuple)):
        size = v.image_size if isinstance(v.image_size, int) else v.image_size[0]
        out.append(("vision", v.heads, v.width, (size // v.patch_size) ** 2 + 1))
    if cfg.gene_cfg is None and not t.hf_model_name and not t.hf_config:
        out.append(("text", t.heads, t.width, t.context_length))
    return out


def _jax_route(heads, width, batched_mask=False):
    """JAX's Attention on a TPU under a kernel setting: its kernel where
    ``fused_attention.supported`` holds and the mask has no batch dimension,
    else its einsum attention."""
    return "kernel" if jfa.supported(heads, width) and not batched_mask else "einsum"


@pytest.mark.parametrize("name", port_config.list_model_configs())
def test_every_config_tower_routes_as_jax(name):
    """Each tower of each built-in config: the same head geometry in both
    packages, the port's route under every kernel setting JAX's (a kernel
    JAX runs but the port's kernels do not take raises at build: head dims
    16 and 256, ROADMAP A3), and on the kernel route the resident / key-tiled
    split of the forward and backward at the tower's length."""
    ours, theirs = port_config.resolve_clip_cfg(name), jax_resolve_clip_cfg(name)
    for (tower, heads, width, L), (_, jheads, jwidth, jL) in zip(_towers(ours), _towers(theirs)):
        assert (heads, width, L) == (jheads, jwidth, jL), (name, tower)
        want = _jax_route(heads, width)
        for impl in KERNEL_IMPLS:
            assert attention_route(impl, heads, width) == want, (name, tower, impl)
        if want == "einsum":
            MultiHeadAttention(width, heads, torch.float32, torch.float32, "meta", L)
            continue
        hd = width // heads
        if hd not in pfa.HEAD_DIMS:
            with pytest.raises(NotImplementedError, match="A3"):
                MultiHeadAttention(width, heads, torch.float32, torch.float32, "meta", L)
            continue
        MultiHeadAttention(width, heads, torch.bfloat16, torch.float32, "meta", L)
        for dtype in (torch.bfloat16, torch.float32):
            for backward, limit in ((False, pfa.fwd_max_seq(hd, dtype)),
                                    (True, pfa.bwd_max_seq(hd, dtype))):
                assert pfa.kernel_route(L, hd, dtype, backward) == (
                    "resident" if L <= limit else "long"), (name, tower, dtype, backward)


@pytest.mark.parametrize("heads", [1, 2, 3, 4, 5, 6, 8, 12, 16, 18])
def test_gate_sweep_matches_jax(heads):
    """Head dims 8..256 x the heads above, with and without a batched mask:
    the plain route exactly where JAX's gate takes einsum, and each plain
    setting always on its own route; the zip gate as JAX's."""
    for hd in (8, 16, 32, 48, 64, 72, 80, 96, 104, 112, 128, 256):
        width = heads * hd
        for batched in (False, True):
            want = _jax_route(heads, width, batched)
            got = "einsum" if batched else attention_route("pallas", heads, width)
            assert got == want, (heads, hd, batched)
        for impl in attention_plain.PLAIN_IMPLS:
            assert attention_route(impl, heads, width) == impl
        # the zip path's gate: JAX's, where the pair kernel takes the head dim
        assert ap.pair_supported(heads, width, 8, 512) == (
            jap.pair_supported(heads, width, 8, 512) and hd in pfa.HEAD_DIMS), (heads, hd)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", pfa.HEAD_DIMS)
def test_resident_and_long_split_at_each_limit(hd, dtype):
    """The wrappers' route at and past each resident limit, with the limits
    of the shared-memory formulas: bf16 forward 944 / 528 / 272, backward
    640 / 352 / 192; f32 forward 256, backward 130 / 106 / 72."""
    table = {torch.bfloat16: {32: (944, 640), 64: (528, 352), 128: (272, 192)},
             torch.float32: {32: (256, 130), 64: (256, 106), 128: (256, 72)}}
    fwd, bwd = table[dtype][hd]
    assert (pfa.fwd_max_seq(hd, dtype), pfa.bwd_max_seq(hd, dtype)) == (fwd, bwd)
    for limit, backward in ((fwd, False), (bwd, True)):
        for L in (1, 256, limit):
            if L <= limit:
                assert pfa.kernel_route(L, hd, dtype, backward) == "resident"
        for L in (limit + 1, 401, 577, 1025):
            if L > limit:
                assert pfa.kernel_route(L, hd, dtype, backward) == "long"
    # the kernels that keep a sequence resident and have no key-tiled route
    assert pfa.check_resident(256, hd, dtype, False, "fused_attention_pair") is None
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 2 A1"):
        pfa.check_resident(257, hd, dtype, False, "fused_attention_pair")
    with pytest.raises(ValueError, match="shared memory"):
        pfa.check_resident(bwd + 1, hd, dtype, True, "fused_attention_t_bwd")


def test_batched_mask_takes_the_einsum_route_and_leading_ones_do_not():
    """A mask with a batch dimension sends a kernel setting to the einsum
    attention (JAX's gate); leading dimensions of 1 do not."""
    rng = np.random.default_rng(0)
    attn = MultiHeadAttention(128, 2, torch.float32, torch.float32, "cpu")
    for p in attn.parameters():
        p.data = torch.from_numpy(rng.normal(size=p.shape).astype(np.float32) * 0.1)
    x = torch.from_numpy(rng.normal(size=(2, 9, 128)).astype(np.float32))
    mask = torch.from_numpy(_mask(9, True))
    before = attention_plain.plain_attention.launches
    with torch.no_grad():
        two_d = attn(x, mask)
        lead_ones = attn(x, mask[None, None])
        assert attention_plain.plain_attention.launches == before
        batched = attn(x, mask.expand(2, 1, 9, 9))
    assert attention_plain.plain_attention.launches == before + 1
    assert torch.equal(two_d, lead_ones)
    np.testing.assert_allclose(batched.numpy(), two_d.numpy(), atol=1e-5)


# ------------------------------------------ the plain versions past 256 tokens

LONG = [(1, 257, True), (2, 401, False), (1, 577, True)]
LONG_PREFIX = [(1, 257, "prefix")]
LONG_ROW = [(1, 257, "row")]


def _long_inputs(seed, B, L, H=2, hd=64):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(B, L, 3 * H * hd)).astype(np.float32)
    g = rng.normal(size=(B, L, H * hd)).astype(np.float32)
    return qkv, g


@pytest.mark.parametrize("B,L,causal", LONG + LONG_PREFIX)
def test_long_forward_matches_jax_kernels(B, L, causal):
    """The key-tiled forward's plain version (``fused_attention_long``, and
    through ``fused_attention`` itself) and its lse option against JAX's
    interpret-mode ``fused_attention`` and ``_fwd_pallas_lse``, 2 heads of
    64; on the CPU no launch is counted."""
    qkv, _ = _long_inputs(L + B, B, L)
    mask = _mask(L, causal)
    want = np.asarray(jfa.fused_attention(jnp.asarray(qkv), None if mask is None
                                          else jnp.asarray(mask), 2, True))
    want_out, want_lse = jfa._fwd_pallas_lse(jnp.asarray(qkv), _jmask(mask, L), 2, True)
    counters = (al.fused_attention_long, al.fused_attention_long_lse, pfa.fused_attention)
    before = [c.launches for c in counters]
    out = al.fused_attention_long(_t(qkv), _t(mask), 2)
    out_lse, lse = al.fused_attention_long_lse(_t(qkv), _t(mask), 2)
    assert torch.equal(out, pfa.fused_attention(_t(qkv), _t(mask), 2))
    assert [c.launches for c in counters] == before
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(out_lse.numpy(), np.asarray(want_out), atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=1e-5)


@pytest.mark.parametrize("B,L,causal", LONG + LONG_PREFIX + LONG_ROW)
def test_long_backward_pieces_match_jax_kernel(B, L, causal):
    """The key-tiled backward's pieces on the CPU: the dQ kernel's dq
    columns and r, the dK/dV kernel's k and v columns and the db reduce,
    assembled as ``fused_attention_long_bwd`` assembles them, against JAX's
    interpret-mode ``_bwd_pallas3_db_lse`` on JAX's lse; r is the term the
    plain backward subtracts (``sum_j dp p``). The recompute options, and
    the pieces given each row's max and log sum apart (the route the
    recompute options take on the card), against JAX's interpret-mode
    recompute kernel ``_bwd_pallas3_db`` under the finfo.min masks: in the
    row masked in full ('row') p is 1 / L, where the lse of the same row
    (rounded to its max) gives 1."""
    qkv, g = _long_inputs(L + B + 1, B, L)
    mask = _mask(L, causal)
    _, lse = jfa._fwd_pallas_lse(jnp.asarray(qkv), _jmask(mask, L), 2, True)
    lse = np.asarray(lse)
    d3, db_raw = jfa._bwd_pallas3_db_lse(jnp.asarray(qkv), _jmask(mask, L), jnp.asarray(lse),
                                         jnp.asarray(g), 2, True)
    want = np.asarray(jnp.transpose(d3, (1, 2, 0, 3)).reshape(qkv.shape))
    want_db = np.asarray(jnp.transpose(db_raw, (1, 0, 2)).reshape(-1))
    tq, tm, tl, tg = _t(qkv), _t(mask), _t(lse), _t(g)
    dqkv = torch.full_like(tq, float("nan"))
    stats = al.long_bwd_dq(tq, tm, tl, tg, 2, dqkv)
    al.long_bwd_dkdv(tq, tm, stats, tg, 2, dqkv)
    db = al.long_db(dqkv)
    # from the lse, the row masked in full takes p = 1 on each of its L keys,
    # so its dq, dk and dv sum L terms of O(1): 1e-5 of them relative as well
    rtol = 1e-5 if causal == "row" else 0
    np.testing.assert_allclose(dqkv.numpy(), want, atol=2e-5, rtol=rtol)
    np.testing.assert_allclose(db.numpy(), want_db, atol=2e-4, rtol=rtol)
    whole, whole_db = al.fused_attention_long_bwd(tq, tm, tl, tg, 2)
    assert torch.equal(whole, dqkv) and torch.allclose(whole_db, db, atol=1e-4)
    # r against the plain math in f64
    q, k, v = (torch.from_numpy(qkv.astype(np.float64)).view(B, L, 3, 2, 64)
               .permute(2, 0, 3, 1, 4))
    s = q @ k.transpose(-1, -2) * 64 ** -0.5 + (0 if mask is None else torch.from_numpy(
        mask.astype(np.float64)))
    p = torch.softmax(s, dim=-1)
    dp = torch.from_numpy(g.astype(np.float64)).view(B, L, 2, 64).transpose(1, 2) @ v.transpose(
        -1, -2)
    rows = [i for i in range(L) if not (causal == "row" and i == 1)]  # f64 keeps row 1's q k
    np.testing.assert_allclose(stats.r.numpy()[..., rows],
                               (p * dp).sum(-1).transpose(0, 1).numpy()[..., rows], atol=1e-4)
    want_re, want_re_db = want, want_db
    if causal in ("prefix", "row"):
        d3, db_raw = jfa._bwd_pallas3_db(jnp.asarray(qkv), _jmask(mask, L), jnp.asarray(g), 2,
                                         True)
        want_re = np.asarray(jnp.transpose(d3, (1, 2, 0, 3)).reshape(qkv.shape))
        want_re_db = np.asarray(jnp.transpose(db_raw, (1, 0, 2)).reshape(-1))
    re_dqkv, re_db = al.fused_attention_long_bwd_recompute(tq, tm, tg, 2, db=True)
    np.testing.assert_allclose(re_dqkv.numpy(), want_re, atol=2e-5)
    np.testing.assert_allclose(re_db.numpy(), want_re_db, atol=2e-4)
    assert al.fused_attention_long_bwd_recompute(tq, tm, tg, 2, db=False)[1] is None
    _, row_max, lsum = al.fused_attention_long_lse(tq, tm, 2, parts=True)
    split, split_db = al.fused_attention_long_bwd(tq, tm, row_max, tg, 2, lsum=lsum)
    np.testing.assert_allclose(split.numpy(), want_re, atol=2e-5)
    np.testing.assert_allclose(split_db.numpy(), want_re_db, atol=2e-4)
    if causal == "row":
        # row 1's p from the max and log sum apart is 1 / L, as JAX's
        # recompute kernel forms it; from its lse, which rounds to the max, 1
        s1 = pfa._scores(*al._split_heads(tq, 2)[:2], tm, 64)[:, :, 1]
        p_split = torch.exp(s1 - row_max[:, :, 1:2].transpose(0, 1)
                            - lsum[:, :, 1:2].transpose(0, 1))
        p_lse = torch.exp(s1 - tl[:, :, 1:2].transpose(0, 1))
        torch.testing.assert_close(p_split, torch.full_like(p_split, 1.0 / L))
        assert torch.equal(p_lse, torch.ones_like(p_lse))
        assert np.abs(re_dqkv.numpy() - want).max() > 1e-2


@pytest.mark.parametrize("B,L,causal", [(1, 257, True), (2, 401, False), (1, 577, False)])
def test_long_qkv_attention_grads_match_jax(B, L, causal):
    """``QKVAttention`` past 256 tokens against jax.grad of ``qkv_attention``
    with the interpret-mode kernels: the context and dx, dW, db at rtol /
    atol 1e-4 (tests/test_torch_port_attention_bwd.py's tolerances)."""
    rng = np.random.default_rng(B * L)
    D = 128
    x = rng.normal(size=(B, L, D)).astype(np.float32)
    w = (rng.normal(size=(D, 3 * D)) * D ** -0.5).astype(np.float32)  # flax (in, out)
    b = (rng.normal(size=(3 * D,)) * 0.1).astype(np.float32)
    g = rng.normal(size=(B, L, D)).astype(np.float32)
    mask = _mask(L, causal)
    jm = None if mask is None else jnp.asarray(mask)

    def f(x_, w_, b_):
        return jnp.sum(jfa.qkv_attention(x_, w_, b_, jm, 2, True) * g)

    want_out = np.asarray(jfa.qkv_attention(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), jm,
                                            2, True))
    want = [np.asarray(t) for t in jax.grad(f, argnums=(0, 1, 2))(x, w, b)]
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(np.ascontiguousarray(w.T)).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    out = pfa.qkv_attention(tx, tw, tb, _t(mask), 2)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=1e-5)
    for got, exp in ((tx.grad, want[0]), (tw.grad.T, want[1]), (tb.grad, want[2])):
        np.testing.assert_allclose(got.numpy(), exp, atol=1e-4, rtol=1e-4)


# ------------------------------------------------- the plain routes, model level

GEOMETRY = {"ViT-Test": {},  # heads of 16: JAX's gate takes no kernel setting to its kernel
            "2x72": dict(vision_cfg=dict(width=144, heads=2),  # SO400M's text head dim
                         text_cfg=dict(width=144, heads=2))}


def _bundle_of(model, **over):
    """JAX's f32 ViT-Test (``over`` merged into its config) on the port
    model's weights: the same weights in both packages, without a second
    initialization to compile."""
    cfg = jax_resolve_clip_cfg("ViT-Test", **over)
    return ModelBundle(model=JaxCLIP(cfg=cfg, dtype=jnp.float32),
                       params=to_jax_params(model.state_dict()), cfg=cfg)


@functools.lru_cache(maxsize=None)
def _jax_bundle(geometry):
    model = create_model("ViT-Test", precision="fp32", seed=0, device="cpu", training=True,
                         **GEOMETRY[geometry])
    return _bundle_of(model, **GEOMETRY[geometry])


def _inputs_and_weights(dim):
    rng = np.random.default_rng(7)
    images = rng.integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    texts = rng.integers(0, 512, (3, 16)).astype(np.int32)
    wi, wt = (rng.normal(size=(3, dim)).astype(np.float32) for _ in range(2))
    return np.array(jax_normalize(images)), texts, wi, wt


@functools.lru_cache(maxsize=None)
def _jax_reference(geometry, attn_impl):
    """JAX's model under ``attn_impl`` on the shared weights: the features
    and every parameter's gradient of sum(features * fixed weights)."""
    jb = _jax_bundle(geometry)
    model = JaxCLIP(cfg=dataclasses.replace(jb.model.cfg, attn_impl=attn_impl), dtype=jnp.float32)
    x, texts, wi, wt = _inputs_and_weights(jb.model.cfg.embed_dim)

    def jloss(p):
        f = model.apply({"params": p}, x, texts, True)
        feats = (f["image_features"], f["text_features"])
        return jnp.sum(feats[0] * wi) + jnp.sum(feats[1] * wt), feats

    (_, feats), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jb.params)
    return [np.asarray(a) for a in feats], from_jax_params(grads)


def _model_grads(geometry, attn_impl, jax_impl=None):
    """The port's model under ``attn_impl`` on JAX's weights against JAX's
    model under ``jax_impl`` (default the same setting): features at atol
    1e-5, every parameter's gradient at atol 1e-5 + rtol 1e-3 of its largest
    entry. Returns the plain routes' calls in the port's forward."""
    jb = _jax_bundle(geometry)
    want_feats, want_g = _jax_reference(geometry, jax_impl or attn_impl)
    x, texts, wi, wt = _inputs_and_weights(jb.model.cfg.embed_dim)
    model = create_model("ViT-Test", precision="fp32", device="cpu", training=True,
                         attn_impl=attn_impl, **GEOMETRY[geometry])
    model.load_state_dict(from_jax_params(jb.params))
    counts = (attention_plain.plain_attention.launches, attention_plain.fold_attention.launches)
    out = model(torch.from_numpy(x), torch.from_numpy(texts).long())
    counts = (attention_plain.plain_attention.launches - counts[0],
              attention_plain.fold_attention.launches - counts[1])
    loss = (out["image_features"] * torch.from_numpy(wi)).sum() + (
        out["text_features"] * torch.from_numpy(wt)).sum()
    loss.backward()
    for a, w in zip((out["image_features"], out["text_features"]), want_feats):
        np.testing.assert_allclose(a.detach().numpy(), w, atol=1e-5)
    # the logit scale is not in the loss: no gradient here, zeros in JAX
    grads = {k: torch.zeros_like(p) if p.grad is None else p.grad
             for k, p in model.named_parameters()}
    assert set(grads) == set(want_g)
    for k, w in want_g.items():
        w = w.numpy()
        np.testing.assert_allclose(grads[k].numpy(), w, rtol=0,
                                   atol=1e-5 + 1e-3 * np.abs(w).max(), err_msg=k)
    return counts


@pytest.mark.parametrize("attn_impl", attention_plain.PLAIN_IMPLS)
def test_plain_settings_match_jax_model(attn_impl):
    """Each plain setting on ViT-Test against JAX's model with it: 2 + 2
    calls of its route a forward (fold has its own)."""
    counts = _model_grads("ViT-Test", attn_impl)
    assert counts == ((0, 4) if attn_impl.startswith("fold") else (4, 0))


@pytest.mark.parametrize("geometry,attn_impl", [
    ("ViT-Test", "auto"), ("ViT-Test", "pallas"), ("ViT-Test", "pallas_t"),
    ("2x72", "auto"), ("2x72", "pallas_inter"),
])
def test_gate_fallback_matches_jax_model(geometry, attn_impl):
    """A kernel setting at a geometry JAX's gate refuses runs the einsum
    attention in both packages (JAX's model under the setting computes its
    'einsum' graph there, so that graph is the reference): 4 plain calls a
    forward, no kernel wrapper counted."""
    cfg = port_config.resolve_clip_cfg("ViT-Test", **GEOMETRY[geometry])
    for tower in (cfg.vision_cfg, cfg.text_cfg):
        assert not jfa.supported(tower.heads, tower.width)
    kernels = (pfa.fused_attention, pfa.fused_attention_lse, pfa.fused_attention_bwd)
    before = [c.launches for c in kernels]
    assert _model_grads(geometry, attn_impl, "einsum") == (4, 0)
    assert [c.launches for c in kernels] == before


# ---------------------------------------- towers at 224 and 336 px, patch 14

PATCH14 = {224: 257, 336: 577}


def _patch14(size):
    return dict(vision_cfg=dict(width=128, heads=2, patch_size=14, image_size=size),
                text_cfg=dict(width=128, heads=2))


def _batch(seed, size, B=2, k=2):
    rng = np.random.default_rng(seed)
    return {
        "images": rng.integers(0, 256, (B, size, size, 3), dtype=np.uint8),
        "texts": rng.integers(0, 512, (B, 16), dtype=np.int32),
        "image_tile_ids": np.arange(B, dtype=np.int32),
        "text_tile_ids": np.arange(B, dtype=np.int32),
        "neighbor_tile_ids": rng.integers(-1, B, (B, k)).astype(np.int32),
        "neighbor_alphas": rng.uniform(0, 1, (B, k)).astype(np.float32),
    }


@pytest.mark.parametrize("size", sorted(PATCH14))
def test_patch14_towers_match_jax_forward_and_step(size):
    """Two-layer width-128 towers at patch 14 (L = PATCH14[size]) on the
    kernel route, against JAX's model (its CPU attention) on the same
    weights: the features at atol 1e-5, then one Trainer step's loss and
    gradient norm at rtol 1e-5."""
    over = _patch14(size)
    model = create_model("ViT-Test", precision="fp32", seed=0, device="cpu", training=True,
                         **over)
    jb = _bundle_of(model, **over)
    assert model.visual.positional_embedding.shape[0] == PATCH14[size]
    assert all(b.attn.kernel for b in model.visual.transformer.resblocks)
    batch = _batch(size, size)
    x = np.array(jax_normalize(batch["images"]))
    want = jax.jit(lambda p: jb.model.apply({"params": p}, x, batch["texts"], True))(jb.params)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(batch["texts"]).long())
    for k in ("image_features", "text_features"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, err_msg=k)

    cfg_kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=50, augment=False, seed=0)
    loss_kw = dict(cap_logit_scale=50.0)
    jt = JaxTrainer(jb, loss=jax_make_loss("spatial", **loss_kw),
                    config=JaxTrainerConfig(**cfg_kw), mesh=make_mesh(devices=jax.devices()[:1]))
    _, jm = jt.make_train_step()(jt.init_state(), jt._device_batch(batch))
    trainer = Trainer(model, make_loss("spatial", **loss_kw), TrainerConfig(**cfg_kw))
    tb = {k: torch.from_numpy(np.array(v)).long() if k == "texts" else torch.from_numpy(v)
          for k, v in batch.items()}
    _, m = trainer.train_step(trainer.init_state(), tb)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=k)


# ------------------------------------------------ the kernels' constants

def test_long_kernel_geometry_mirrors_the_source():
    """``attention_long``'s launch geometry and shared-memory formulas
    against the constants of ``csrc/attention_long.cu``: the bf16 plan (128
    own rows, 384 threads, 128-key forward stages, 64-row backward stages,
    at most 4 stages, the setmaxnreg split within the register file), each
    kind's shared memory and stages at every head dim, db's partial rows;
    the f32 plan (64 rows, 256 threads); every geometry within 227 KB."""
    src = (cuda_build.CSRC_DIR / "attention_long.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr (?:int|size_t) {name} = (\d+);", src).group(1))

    assert (const("kRows"), const("kTcThreads"), const("kFwdKeys"), const("kBwdTile"),
            const("kMaxStages")) == (al.ROWS, al.TC_THREADS, al.FWD_KEYS, al.BWD_TILE,
                                     al.MAX_STAGES)
    assert 128 * const("kProducerRegs") + 256 * const("kConsumerRegs") <= 65536
    assert const("kBlock") == al.BLOCK and const("kSimtThreads") == al.SIMT_THREADS
    assert const("kDbRows") == al.DB_ROWS
    assert const("kMaxSmem") == al.MAX_SMEM == pfa.MAX_SMEM_BYTES
    assert "constexpr int kPStride = kBlock + 1;" in src
    for dtype in (torch.bfloat16, torch.float32):
        for hd in pfa.HEAD_DIMS:
            sizes = [al.smem_bytes(kind, hd, dtype) for kind in al.KINDS]
            assert max(sizes) <= pfa.MAX_SMEM_BYTES and all(s % 16 == 0 for s in sizes)
    stages = {(k, hd): al.tc_layout(k, hd)["stages"] for k in al.KINDS for hd in pfa.HEAD_DIMS}
    assert stages == {(k, hd): 2 if hd == 128 else 4 for k in al.KINDS for hd in pfa.HEAD_DIMS}
    assert al.smem_bytes("fwd", 64, torch.bfloat16) == 164992
    assert al.smem_bytes("fwd", 128, torch.bfloat16) == 197760
    assert al.smem_bytes("dkdv", 128, torch.bfloat16) == 208000
    assert al.smem_bytes("dkdv", 128, torch.float32) == 220416
    assert al.blocks(32, 577, 16) == 32 * 16 * 5 and al.threads(torch.bfloat16) == 384
    assert al.blocks(32, 577, 16, torch.float32) == 32 * 16 * 10
    assert al.threads(torch.float32) == 256
    assert al.db_parts(32, 577) == 160 and al.db_chunks(32 * 577) == 73


def test_long_db_partial_rows_plain_version():
    """The bf16 backward's db partial rows on the CPU: the dQ wrapper fills
    the q columns and the dK/dV wrapper the k and v columns of one row per
    (sequence, 128 own rows), each the column sums of that block's rounded
    rows; ``long_db`` over them is db (against the sum of dqkv's values,
    f32 in another order), and a launch is counted by none on the CPU. The
    stats rows the bf16 dQ kernel hands the dK/dV kernel (``pack_stats``,
    ``unpack_stats``)."""
    B, L, H, hd = 2, 130, 2, 32
    qkv, g = _long_inputs(7, B, L, H, hd)
    tq, tg = _t(qkv).bfloat16(), _t(g).bfloat16()
    lse = al.fused_attention_long_lse(tq, None, H)[1]
    dqkv = torch.empty_like(tq)
    part = torch.full((al.db_parts(B, L), 3 * H * hd), float("nan"))
    counters = (al.long_bwd_dq, al.long_bwd_dkdv, al.long_db)
    before = [c.launches for c in counters]
    stats = al.long_bwd_dq(tq, None, lse, tg, H, dqkv, part)
    assert stats.rows is None and stats.unpacked() == (lse, stats.r)
    al.long_bwd_dkdv(tq, None, stats, tg, H, dqkv, part)
    db = al.long_db(dqkv, part)
    assert [c.launches for c in counters] == before
    assert part.shape == (4, 3 * H * hd) and torch.isfinite(part).all()
    d = dqkv.float()
    torch.testing.assert_close(part[1], d[0, 128:].sum(0), rtol=0, atol=1e-5)
    torch.testing.assert_close(part[2], d[1, :128].sum(0), rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(db, d.sum(dim=(0, 1)), rtol=1e-6, atol=1e-4)
    torch.testing.assert_close(db, al.long_db(dqkv), rtol=1e-6, atol=1e-4)
    # the stats rows: (batch, head, 64-row tile) in order, lse then r, 0 past L
    lse_s, r_s = torch.randn(2, 1, 70), torch.randn(2, 1, 70)
    rows = al.pack_stats(lse_s, r_s)
    assert rows.shape == (al.stats_rows(1, 70, 2), 2 * al.BWD_TILE) == (4, 128)
    assert torch.equal(rows[2, :64], lse_s[1, 0, :64]) and torch.equal(rows[2, 64:], r_s[1, 0, :64])
    assert torch.equal(rows[3, :6], lse_s[1, 0, 64:]) and not rows[3, 6:64].any()
    assert torch.equal(rows[3, 64:70], r_s[1, 0, 64:]) and not rows[3, 70:].any()
    lse_u, r_u = al.RowStats(lse_s, rows=rows).unpacked()
    assert torch.equal(lse_u, lse_s) and torch.equal(r_u, r_s)
    with pytest.raises(ValueError, match="bf16 kernels' only"):
        al.long_bwd_dq(_t(qkv), None, lse, _t(g), H, torch.empty_like(_t(qkv)), part)
    with pytest.raises(ValueError, match="part must be"):
        al.long_bwd_dkdv(tq, None, stats, tg, H, dqkv, part[:3])


def test_long_wrappers_check_their_inputs(monkeypatch):
    """The key-tiled wrappers refuse what their kernels do not take, on the
    CPU too: a head geometry, an lse or r of the wrong shape, a dqkv buffer
    of another dtype, bf16 row statistics off the CPU without stats rows; a
    CUDA-less device raises before any launch (meta, which the wrappers run
    as the CPU for ops/flops.py's count, is taken off the plain devices
    here)."""
    monkeypatch.setattr(cuda_build, "PLAIN_DEVICES", ("cpu",))
    qkv, g = torch.zeros(2, 9, 384), torch.zeros(2, 9, 128)
    lse = torch.zeros(2, 2, 9)
    with pytest.raises(ValueError, match="head geometry"):
        al.fused_attention_long(torch.zeros(2, 9, 288), None, 2)
    with pytest.raises(ValueError, match="lse must be"):
        al.fused_attention_long_bwd(qkv, None, torch.zeros(2, 9), g, 2)
    with pytest.raises(ValueError, match="r must be"):
        al.long_bwd_dkdv(qkv, None, al.RowStats(lse, torch.zeros(2, 2, 8)), g, 2,
                         torch.zeros_like(qkv))
    with pytest.raises(ValueError, match="take r"):
        al.long_bwd_dkdv(qkv, None, al.RowStats(lse), g, 2, torch.zeros_like(qkv))
    meta = qkv.bfloat16().to("meta")
    with pytest.raises(ValueError, match="stats rows"):
        al.long_bwd_dkdv(meta, None, al.RowStats(lse.to("meta"), lse.to("meta")),
                         g.bfloat16().to("meta"), 2, torch.empty_like(meta))
    with pytest.raises(ValueError, match="dqkv must be"):
        al.long_bwd_dq(qkv, None, lse, g, 2, torch.zeros_like(qkv, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        al.fused_attention_long_lse(qkv.to("meta"), None, 2)
