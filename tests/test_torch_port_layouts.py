"""The port's other attention layouts against the JAX package: the
interleaved, slab, seq-major-with-bias and split kernels' plain versions and
autograd functions against the interpret-mode Pallas kernels, the
interleaved order against JAX's ``heads_per_block`` / ``interleave_perm``,
and the towers under ``attn_impl`` 'pallas_inter', 'pallas_t' and
'pallas_split' against JAX's models on the same weights.

On the CPU the port's wrappers run their plain versions; the JAX kernels run
in Pallas interpret mode, as tests/test_fused_attention.py runs them (the
slab kernels through ``KERNEL_VARIANT='slab'`` on JAX's module). The same
numpy inputs go to both. The kernel geometries have two head groups each:
D 256 with 4 heads of 64 (2 heads a group) or 8 heads of 32 (4 a group), so
the interleaved order is not the standard one.

Tolerances: f32 outputs and gradients within 2e-5 max(1, |ref|) (summation
order); bf16 within one bf16 step (2^-8) of the largest magnitude; model
features at atol 1e-5 and model gradients at max(1e-5, 1e-4 of each
gradient's largest entry) (JAX's model tests'); Trainer metrics at rtol 1e-5
and parameters at atol 2e-5 (the port's other Trainer tests').
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
from spatial_clip_tpu.ops import fused_attention as jfa
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
from spatial_clip_tpu_torch.ops import attention_variants as av
from spatial_clip_tpu_torch.ops import fused_attention as pfa
from spatial_clip_tpu_torch.train.loop import Trainer, TrainerConfig

# two head groups in each tower: image 4 heads of 64, text 8 heads of 32
WIDE = dict(vision_cfg=dict(width=256, heads=4), text_cfg=dict(width=256, heads=8))


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
SETTINGS = {
    "inter": dict(attn_impl="pallas_inter"),
    "inter_ln_gemm": dict(attn_impl="pallas_inter", ln_gemm_impl="pallas"),
    "t": dict(attn_impl="pallas_t"),
    "split": dict(attn_impl="pallas_split"),
}


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _mk(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _causal(L):
    return np.triu(np.full((L, L), np.finfo(np.float32).min, np.float32), k=1)


def _close(got, ref, dtype):
    """The module docstring's kernel tolerances."""
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    got = got.detach().float().numpy()
    assert got.shape == ref.shape
    peak = np.abs(ref).max()
    atol = 2e-5 * max(1.0, peak) if dtype == torch.float32 else 2 ** -8 * peak
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


def _to_port(x, dtype):
    """A JAX array of dtype as a torch tensor of the same values."""
    return _t(np.asarray(x.astype(jnp.float32))).to(dtype).requires_grad_()


# ------------------------------------------------------- the interleaved order

@pytest.mark.parametrize("head_dim", [32, 64, 128])
def test_heads_per_block_and_perms_match_jax(head_dim):
    """heads_per_block (at its default 128 lanes and at 256, 512), and
    interleave_perm / inverse_perm for heads 1-16, against JAX's; where JAX
    finds no group (None), the port's interleave_perm raises."""
    for heads in range(1, 17):
        for lanes in (None, 256, 512):
            assert av.heads_per_block(heads, head_dim, lanes) == \
                jfa.heads_per_block(heads, head_dim, lanes), (heads, lanes)
        if jfa.heads_per_block(heads, head_dim) is None:
            with pytest.raises(NotImplementedError, match="einsum"):
                av.interleave_perm(heads, head_dim)
            continue
        perm = av.interleave_perm(heads, head_dim)
        assert perm == list(jfa.interleave_perm(heads, head_dim))
        assert av.inverse_perm(perm) == tuple(jfa.inverse_perm(perm))
    assert av.heads_per_block(12, 64) == av.heads_per_block(8, 64) == 2  # ViT-B-32's towers


def test_permute_rows_gradient_is_the_inverse_gather():
    """permute_rows of the port's (3D, Din) weight is JAX's permute_columns of
    flax's (Din, 3D) kernel, and its gradient is JAX's gather back."""
    heads, hd, din = 4, 64, 32
    w = _mk((3 * heads * hd, din), 1)
    g = _mk((3 * heads * hd, din), 2)
    perm = tuple(jfa.interleave_perm(heads, hd))
    inv = jfa.inverse_perm(perm)
    want, vjp = jax.vjp(lambda k: jfa.permute_columns(k, perm, inv), jnp.asarray(w.T))
    tw = _t(w).requires_grad_()
    out = av.permute_rows(tw, heads, hd)
    out.backward(_t(g))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want).T)
    np.testing.assert_array_equal(tw.grad.numpy(), np.asarray(vjp(jnp.asarray(g.T))[0]).T)


# ------------------------------------------------------------------ the kernels

KERNEL_CASES = [(dtype, causal) for dtype in (torch.float32, torch.bfloat16)
                for causal in (False, True)]
CASE_IDS = [f"{str(d)[6:]}-{'causal' if c else 'nomask'}" for d, c in KERNEL_CASES]


def _case(dtype, causal, seed, B=4, L=11, D=256):
    """qkv (B, L, 3D), cotangent, mask, in the case's dtype (JAX arrays)."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    qkv = jnp.asarray(_mk((B, L, 3 * D), seed), jdt)
    g = jnp.asarray(_mk((B, L, D), seed + 1, 1.0), jdt)
    return qkv, g, (_causal(L) if causal else None)


def _heads(dtype):
    return 4 if dtype == torch.float32 else 8  # hd 64 (2 a group) / 32 (4 a group)


@pytest.mark.parametrize("dtype,causal", KERNEL_CASES, ids=CASE_IDS)
def test_interleaved_forward_and_grads_match_jax_kernel(dtype, causal, monkeypatch):
    """``fused_attention(..., interleaved=True)`` and its VJP (JAX's
    ``_fwd_kernel`` with interleaved specs and ``_bwd_kernel_inter``):
    FusedAttention(interleaved) runs the port's interleaved wrappers once
    each way, and no standard attention wrapper."""
    H = _heads(dtype)
    qkv, g, mask = _case(dtype, causal, 10)
    perm = np.asarray(jfa.interleave_perm(H, 256 // H))
    qkv_i = qkv[..., perm]
    jm = None if mask is None else jnp.asarray(mask)
    want, vjp = jax.vjp(lambda q: jfa.fused_attention(q, jm, H, True, True), qkv_i)
    (want_d,) = vjp(g)
    before = (pfa.fused_attention.launches, pfa.fused_attention_bwd_recompute.launches)
    calls = _count(monkeypatch)
    tq = _to_port(qkv_i, dtype)
    out = pfa.FusedAttention.apply(tq, _t(mask), H, True)
    out.backward(_to_port(g, dtype).detach())
    assert calls == dict(_NO_CALLS, inter_fwd=1, inter_bwd=1)
    assert out.dtype == tq.grad.dtype == dtype
    _close(out, want, dtype)
    _close(tq.grad, want_d, dtype)
    # the interleaved kernel is the standard one on the permuted columns
    std = pfa.reference_attention(tq.detach()[..., np.argsort(perm)], _t(mask), H)
    assert torch.equal(out.detach(), std)
    assert (pfa.fused_attention.launches, pfa.fused_attention_bwd_recompute.launches) == before


@pytest.mark.parametrize("dtype,causal", KERNEL_CASES, ids=CASE_IDS)
def test_slab_forward_and_bwd_match_jax_kernel(dtype, causal, monkeypatch):
    """fused_attention_slab / fused_attention_slab_bwd against JAX's
    ``_fwd_pallas_slab`` / ``_bwd_pallas_slab`` (KERNEL_VARIANT='slab');
    their plain versions are the group kernel's."""
    H = _heads(dtype)
    qkv, g, mask = _case(dtype, causal, 20, B=3)
    monkeypatch.setattr(jfa, "KERNEL_VARIANT", "slab")
    jm = None if mask is None else jnp.asarray(mask)
    want, vjp = jax.vjp(lambda q: jfa.fused_attention(q, jm, H, True), qkv)
    (want_d,) = vjp(g)
    tq, tg = _to_port(qkv, dtype).detach(), _to_port(g, dtype).detach()
    out = av.fused_attention_slab(tq, _t(mask), H)
    dqkv = av.fused_attention_slab_bwd(tq, _t(mask), tg, H)
    _close(out, want, dtype)
    _close(dqkv, want_d, dtype)
    assert torch.equal(out, pfa.fused_attention(tq, _t(mask), H))
    assert torch.equal(dqkv, pfa.fused_attention_bwd_recompute(tq, _t(mask), tg, H))
    assert av.fused_attention_slab.launches == av.fused_attention_slab_bwd.launches == 0


@pytest.mark.parametrize("dtype,causal", KERNEL_CASES, ids=CASE_IDS)
def test_seq_major_forward_and_grads_match_jax_kernel(dtype, causal, monkeypatch):
    """fused_attention_t (qkv_nb, bias (1, 3D)) and its gradients for qkv_nb
    and the bias against JAX's ``fused_attention_t`` (``_fwd_kernel_t``,
    ``_bwd_kernel_t``): one seq-major call each way."""
    H = _heads(dtype)
    qkv, g, mask = _case(dtype, causal, 30)
    bias = jnp.asarray(_mk((1, 3 * 256), 33, 0.2), qkv.dtype)
    jm = None if mask is None else jnp.asarray(mask)
    want, vjp = jax.vjp(lambda q, b: jfa.fused_attention_t(q, b, jm, H, True), qkv, bias)
    want_dq, want_db = vjp(g)
    calls = _count(monkeypatch)
    tq, tb = _to_port(qkv, dtype), _to_port(bias, dtype)
    out = av.fused_attention_t(tq, tb, _t(mask), H)
    out.backward(_to_port(g, dtype).detach())
    assert calls == dict(_NO_CALLS, t_fwd=1, t_bwd=1)
    assert tb.grad.shape == (1, 768) and tb.grad.dtype == dtype
    _close(out, want, dtype)
    _close(tq.grad, want_dq, dtype)
    _close(tb.grad, want_db, dtype)
    # the kernel's math is the standard one on qkv_nb + b, rounded to the dtype
    assert torch.equal(out.detach(), pfa.reference_attention(tq.detach() + tb.detach(),
                                                             _t(mask), H))


@pytest.mark.parametrize("dtype,causal", KERNEL_CASES, ids=CASE_IDS)
def test_split_forward_and_grads_match_jax_kernel(dtype, causal, monkeypatch):
    """fused_attention_split and its dq, dk, dv against JAX's
    ``fused_attention_split`` (``_split_fwd_impl``, ``_split_bwd_impl``)."""
    H = _heads(dtype)
    qkv, g, mask = _case(dtype, causal, 40)
    q, k, v = (qkv[..., i * 256:(i + 1) * 256] for i in range(3))
    jm = None if mask is None else jnp.asarray(mask)
    want, vjp = jax.vjp(lambda *a: jfa.fused_attention_split(*a, jm, H, True), q, k, v)
    want_d = vjp(g)
    calls = _count(monkeypatch)
    parts = [_to_port(x, dtype) for x in (q, k, v)]
    out = av.fused_attention_split(*parts, _t(mask), H)
    out.backward(_to_port(g, dtype).detach())
    assert calls == dict(_NO_CALLS, split_fwd=1, split_bwd=1)
    _close(out, want, dtype)
    for p, w in zip(parts, want_d):
        _close(p.grad, w, dtype)


def test_layout_wrappers_check_their_inputs():
    """What the kernels do not take raises on the CPU too: strides other than
    the two seq-major layouts, unequal split shapes, a geometry with no
    interleaved order, a backward over the shared-memory limit; and the
    seq-major wrapper takes the contiguous (L, B, 3D) tensor and the
    transposed view alike."""
    B, L, D, H = 2, 9, 256, 4
    qkv = _t(_mk((B, L, 3 * D), 50))
    bias = _t(_mk((3 * D,), 51))
    seq_major = qkv.transpose(0, 1).contiguous()
    assert torch.equal(av.fused_attention_t_fwd(seq_major, bias, None, H),
                       av.fused_attention_t_fwd(qkv.transpose(0, 1), bias, None, H))
    with pytest.raises(ValueError, match="strides"):
        av.fused_attention_t_fwd(qkv.transpose(0, 1)[:, :, :3 * D - 3], bias[:-3], None, H)
    with pytest.raises(ValueError, match="strides"):
        av.fused_attention_t_fwd(qkv[:, ::2].transpose(0, 1), bias, None, H)
    with pytest.raises(ValueError, match="bias"):
        av.fused_attention_t_fwd(seq_major, bias[:D], None, H)
    with pytest.raises(ValueError, match="one shape"):
        av.fused_attention_split_fwd(qkv[..., :D], qkv[..., D:2 * D], qkv[:1, :, :D], None, H)
    with pytest.raises(ValueError, match="contiguous"):
        av.fused_attention_split_fwd(qkv[..., :D], qkv[..., :D].contiguous(),
                                     qkv[..., :D].contiguous(), None, H)
    with pytest.raises(ValueError, match="interleaved"):
        av.fused_attention_inter(_t(_mk((B, L, 3 * 64), 52)), None, 2)  # 2 heads of 32
    big = _t(_mk((1, 200, 3 * 256), 53))
    with pytest.raises(ValueError, match="shared memory"):
        av.fused_attention_split_bwd(*(t.contiguous() for t in big.chunk(3, -1)), None,
                                     big[..., :256], 4)
    with pytest.raises(ValueError, match="shared memory"):
        av.fused_attention_t_bwd(big.transpose(0, 1), bias, None, big[..., :256], 4)


# ------------------------------------------------------------------ the towers

_NO_CALLS = dict.fromkeys(("inter_fwd", "inter_bwd", "t_fwd", "t_bwd", "split_fwd",
                           "split_bwd", "std_fwd", "std_bwd"), 0)


def _count(monkeypatch):
    """Counts each attention wrapper's plain-version calls (what the CPU runs
    in place of each kernel launch), per layout, and the standard
    wrappers' together."""
    calls = dict(_NO_CALLS)
    for mod, name, key in ((av, "reference_attention_inter", "inter_fwd"),
                           (av, "reference_attention_inter_bwd", "inter_bwd"),
                           (av, "reference_attention_t", "t_fwd"),
                           (av, "reference_attention_t_bwd", "t_bwd"),
                           (av, "reference_attention_split", "split_fwd"),
                           (av, "reference_attention_split_bwd", "split_bwd"),
                           (pfa, "reference_attention", "std_fwd"),
                           (pfa, "reference_attention_lse", "std_fwd"),
                           (pfa, "reference_attention_bwd", "std_bwd")):
        def counted(*a, _f=getattr(mod, name), _k=key):
            calls[_k] += 1
            return _f(*a)
        monkeypatch.setattr(mod, name, counted)
    return calls


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


ROUTE = {"inter": "inter", "inter_ln_gemm": "inter", "t": "t", "split": "split"}


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_model_features_and_gradients_match_jax(setting, monkeypatch):
    """Both towers' features (no grad) and the spatial loss's gradients for
    every parameter against the JAX model of the same setting, on the same
    weights and batch. The 4 attentions (2 blocks a tower) each run the
    setting's own wrapper, forward and backward, and never a standard one;
    the state dict is the default model's."""
    kw = SETTINGS[setting]
    jb = _jax_model("ViT-Test", precision="fp32", seed=0, **WIDE, **kw)
    batch = _batch(3)
    x = np.array(jax_normalize(batch["images"]))
    jl = jax_make_loss("spatial", cap_logit_scale=50.0)

    def jloss(p):
        f = jb.model.apply({"params": p}, x, batch["texts"], True)
        return jl(**{**batch, **f})["contrastive_loss"], f

    (want, feats), want_g = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jb.params)
    model = create_model("ViT-Test", precision="fp32", device="cpu", training=True, **WIDE, **kw)
    default = create_model("ViT-Test", precision="fp32", device="cpu", seed=0, **WIDE)
    assert {k: v.shape for k, v in model.state_dict().items()} == \
        {k: v.shape for k, v in default.state_dict().items()}
    model.load_state_dict(from_jax_params(jb.params))
    calls = _count(monkeypatch)
    tb = _torch_batch(batch)
    with torch.no_grad():
        served = model(_t(x), tb["texts"])
    route = ROUTE[setting]
    assert calls == dict(_NO_CALLS, **{f"{route}_fwd": 4})
    for k in ("image_features", "text_features"):
        np.testing.assert_allclose(served[k].numpy(), np.asarray(feats[k]), atol=1e-5, err_msg=k)
    loss = make_loss("spatial", cap_logit_scale=50.0)(
        **{**tb, **model(_t(x), tb["texts"])})["contrastive_loss"]
    loss.backward()
    assert calls == dict(_NO_CALLS, **{f"{route}_fwd": 8, f"{route}_bwd": 4})
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    grads = {k: p.grad for k, p in model.named_parameters()}
    for k, w in from_jax_params(want_g).items():
        w = w.numpy()
        np.testing.assert_allclose(grads[k].numpy(), w, rtol=0,
                                   atol=max(1e-5, 1e-4 * np.abs(w).max()), err_msg=k)


def test_geometry_without_head_groups_raises(monkeypatch):
    """JAX runs its einsum attention where heads_per_block finds no group
    (2 heads of 32), and so do the port's towers under every layout and
    'auto': they build, and their forward runs the plain route (2 + 2 calls)
    and no kernel wrapper's plain version; the interleaved order itself
    raises, naming the geometry."""
    from spatial_clip_tpu_torch.ops import attention_plain

    narrow = dict(vision_cfg=dict(width=64, heads=2), text_cfg=dict(width=64, heads=2))
    with pytest.raises(NotImplementedError, match="heads=2 head_dim=32"):
        av.interleave_perm(2, 32)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.normal(size=(2, 32, 32, 3)).astype(np.float32))
    texts = torch.from_numpy(rng.integers(0, 512, (2, 16)))
    calls = _count(monkeypatch)
    for impl in ("auto", "pallas_inter", "pallas_t", "pallas_split"):
        model = create_model("ViT-Test", precision="fp32", device="cpu", attn_impl=impl,
                             **narrow)
        before = attention_plain.plain_attention.launches
        with torch.no_grad():
            model(images, texts)
        assert attention_plain.plain_attention.launches == before + 4, impl
    assert calls == _NO_CALLS


def test_three_train_steps_match_jax_trainer_pallas_t():
    """Three Trainer steps under attn_impl='pallas_t' against the JAX
    Trainer (CPU, augment=False, spatial loss with the STE cap, bf16 moments;
    lr is 0 at step 0): metrics at rtol 1e-5, exact R@k, parameters at atol
    2e-5 after the three steps."""
    cfg_kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=50, augment=False, seed=0)
    jb = _jax_model("ViT-Test", precision="fp32", seed=0, attn_impl="pallas_t", **WIDE)
    jt = JaxTrainer(jb, loss=jax_make_loss("spatial", cap_logit_scale=50.0),
                    config=JaxTrainerConfig(**cfg_kw), mesh=make_mesh(devices=jax.devices()[:1]))
    jstep, jstate = jt.make_train_step(), jt.init_state()
    model = create_model("ViT-Test", precision="fp32", device="cpu", training=True,
                         attn_impl="pallas_t", **WIDE)
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
