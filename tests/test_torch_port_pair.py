"""The port's zipped dual-tower path (``zip_towers='on'``) against the JAX
package: the pair kernel's plain version and :class:`PairAttention` against
the interpret-mode Pallas ``fused_attention_pair``, the zip gate against
JAX's ``CLIP._zip_ready``, the zipped model against the JAX model run apart,
and a cached ``grad_accum=2`` Trainer step.

On the CPU the port's wrappers run their plain versions; the JAX kernel runs
in Pallas interpret mode, as tests/test_pair_attention.py runs it. The same
numpy inputs go to both. JAX's model-level zip test runs the pair kernel in
interpret mode and is marked slow, so the zipped port model is held against
JAX's model with ``zip_towers='off'``, which JAX's own test holds equal to
'on'.

Tolerances: f32 contexts within 2e-5 max(1, |ref|) (summation order); f32
gradients within 1e-5 of the largest reference gradient (JAX's test's);
bf16 within one bf16 step (2^-8) of the largest magnitude; model features at
atol 1e-5 and model gradients at max(1e-5, 1e-4 of each gradient's largest
entry) (JAX's model test's); Trainer metrics at rtol 1e-5 and parameters at
atol 2e-5 (the port's other Trainer tests').
"""
from __future__ import annotations

import tests.helpers.torch_threads  # noqa: F401  (xdist workers share the cores)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatial_clip_tpu import create_model as jax_create_model
from spatial_clip_tpu.losses import make_loss as jax_make_loss
from spatial_clip_tpu.models.clip import CLIP as JaxCLIP
from spatial_clip_tpu.models.config import resolve_clip_cfg as jax_resolve
from spatial_clip_tpu.models.transforms import normalize_batch as jax_normalize
from spatial_clip_tpu.ops import fused_attention as jfa
from spatial_clip_tpu.parallel.mesh import make_mesh
from spatial_clip_tpu.train.loop import Trainer as JaxTrainer
from spatial_clip_tpu.train.loop import TrainerConfig as JaxTrainerConfig
from spatial_clip_tpu_torch import create_model
from spatial_clip_tpu_torch.losses import make_loss
from spatial_clip_tpu_torch.models.clip import zip_ready
from spatial_clip_tpu_torch.models.config import resolve_clip_cfg
from spatial_clip_tpu_torch.models.convert import from_jax_params, from_jax_train_state
from spatial_clip_tpu_torch.ops import attention_pair as ap
from spatial_clip_tpu_torch.ops import fused_attention as pfa
from spatial_clip_tpu_torch.train.loop import Trainer, TrainerConfig

# tests/test_pair_attention.py's tiny zip configuration: equal depth, hd 64
TINY_ZIP = dict(
    vision_cfg=dict(image_size=64, patch_size=32, width=128, layers=2, heads=2),
    text_cfg=dict(context_length=16, vocab_size=512, width=128, heads=2, layers=2),
    embed_dim=32,
)


def _t(x):
    return torch.from_numpy(np.array(x))


def _mk(shape, seed, scale=0.3):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _causal(L):
    return np.triu(np.full((L, L), -1e30, np.float32), 1)


# ------------------------------------------------------------------ the kernel

GEOMETRIES = [  # tests/test_pair_attention.py:29-35
    (50, 128, 2, 77, 128, 2),  # ViT-B/32-like (hd 64)
    (17, 256, 2, 26, 128, 4),  # unequal head dims (hd 128 and 32)
]


def _pair_inputs(La, Da, Lb, Db, B=8):
    return _mk((B, La, 3 * Da), 1), _mk((B, Lb, 3 * Db), 2), _causal(Lb)


@pytest.mark.parametrize("La,Da,Ha,Lb,Db,Hb", GEOMETRIES)
def test_pair_forward_and_grads_match_jax_kernel_f32(La, Da, Ha, Lb, Db, Hb, monkeypatch):
    qa, qb, mb = _pair_inputs(La, Da, Lb, Db)
    want = jfa.fused_attention_pair(jnp.asarray(qa), None, jnp.asarray(qb), jnp.asarray(mb),
                                    Ha, Hb, True)
    calls = {"fwd": 0, "bwd": 0}
    for name, key in (("reference_attention_pair", "fwd"),
                      ("reference_attention_pair_bwd", "bwd")):
        def counted(*a, _f=getattr(ap, name), _k=key):
            calls[_k] += 1
            return _f(*a)
        monkeypatch.setattr(ap, name, counted)
    before = (ap.fused_attention_pair.launches, ap.fused_attention_pair_bwd.launches)
    ta, tb = _t(qa).requires_grad_(), _t(qb).requires_grad_()
    oa, ob = ap.PairAttention.apply(ta, None, tb, _t(mb), Ha, Hb)
    for got, ref in ((oa, want[0]), (ob, want[1])):
        ref = np.asarray(ref)
        assert got.dtype == torch.float32 and got.shape == ref.shape
        np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0,
                                   atol=2e-5 * max(1.0, np.abs(ref).max()))

    def loss(qa, qb):
        oa, ob = jfa.fused_attention_pair(qa, None, qb, jnp.asarray(mb), Ha, Hb, True)
        return (oa * oa).sum() * 0.5 + (ob * jnp.cos(ob)).sum()

    gw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(qa), jnp.asarray(qb))
    ((oa * oa).sum() * 0.5 + (ob * torch.cos(ob)).sum()).backward()
    for got, ref in ((ta.grad, gw[0]), (tb.grad, gw[1])):
        ref = np.asarray(ref)
        assert np.abs(got.numpy() - ref).max() / (np.abs(ref).max() + 1e-9) < 1e-5
    assert calls == {"fwd": 1, "bwd": 1}  # one pair call each way
    # the CPU ran the plain version: no kernel launch was counted
    assert (ap.fused_attention_pair.launches, ap.fused_attention_pair_bwd.launches) == before


def test_pair_forward_and_grads_match_jax_kernel_bf16():
    """bf16 qkv: contexts and dqkv within one bf16 step of their largest
    magnitude. The cotangents are computed in f32 from the bf16 contexts on
    both sides and cast to bf16 by the backward, as ``_pair_bwd_impl`` casts
    them."""
    La, Da, Ha, Lb, Db, Hb = GEOMETRIES[0]
    qa, qb, mb = _pair_inputs(La, Da, Lb, Db, B=4)
    ja, jb = jnp.asarray(qa, jnp.bfloat16), jnp.asarray(qb, jnp.bfloat16)

    def loss(qa, qb):
        oa, ob = jfa.fused_attention_pair(qa, None, qb, jnp.asarray(mb), Ha, Hb, True)
        oa, ob = oa.astype(jnp.float32), ob.astype(jnp.float32)
        return (oa * oa).sum() * 0.5 + (ob * jnp.cos(ob)).sum()

    want = jfa.fused_attention_pair(ja, None, jb, jnp.asarray(mb), Ha, Hb, True)
    gw = jax.grad(loss, argnums=(0, 1))(ja, jb)
    ta = _t(np.asarray(ja.astype(jnp.float32))).bfloat16().requires_grad_()
    tb = _t(np.asarray(jb.astype(jnp.float32))).bfloat16().requires_grad_()
    oa, ob = ap.PairAttention.apply(ta, None, tb, _t(mb), Ha, Hb)
    assert oa.dtype == ob.dtype == torch.bfloat16
    oaf, obf = oa.float(), ob.float()
    ((oaf * oaf).sum() * 0.5 + (obf * torch.cos(obf)).sum()).backward()
    assert ta.grad.dtype == torch.bfloat16
    for got, ref in ((oa, want[0]), (ob, want[1]), (ta.grad, gw[0]), (tb.grad, gw[1])):
        ref = np.asarray(ref.astype(jnp.float32))
        np.testing.assert_allclose(got.detach().float().numpy(), ref, rtol=0,
                                   atol=2 ** -8 * np.abs(ref).max())


def test_pair_wrappers_check_their_inputs():
    qa, qb, mb = _pair_inputs(9, 128, 12, 128, B=2)
    with pytest.raises(ValueError, match="equal batch"):
        ap.fused_attention_pair(_t(qa), None, _t(qb)[:1], _t(mb), 2, 2)
    with pytest.raises(ValueError, match="one dtype"):
        ap.fused_attention_pair(_t(qa), None, _t(qb).bfloat16(), _t(mb), 2, 2)
    with pytest.raises(ValueError, match="head geometry"):
        ap.fused_attention_pair(_t(qa), None, _t(qb), _t(mb), 2, 3)
    with pytest.raises(ValueError, match="g must be"):
        ap.fused_attention_pair_bwd(_t(qa), None, _t(qa[..., :128]), _t(qb), _t(mb),
                                    _t(qb[..., :64]), 2, 2)
    assert ap.pair_supported(12, 768, 8, 512) and ap.pair_supported(2, 256, 4, 128)
    assert not ap.pair_supported(12, 768, 32, 512)  # text head dim 16
    # the plain versions are the single-tower plain versions, tower by tower
    oa, ob = ap.reference_attention_pair(_t(qa), None, _t(qb), _t(mb), 2, 2)
    assert torch.equal(oa, pfa.reference_attention(_t(qa), None, 2))
    assert torch.equal(ob, pfa.reference_attention(_t(qb), _t(mb), 2))


# ------------------------------------------------------------------ the gate

ZIP_CASES = {  # name: overrides of the tiny zip configuration
    "off": dict(zip_towers="off"),
    "auto": dict(zip_towers="auto"),
    "on": dict(zip_towers="on"),
    "on_unequal_depth": dict(zip_towers="on", text_cfg={**TINY_ZIP["text_cfg"], "layers": 3}),
    "on_ln_pallas": dict(zip_towers="on", ln_impl="pallas"),
    "on_ln_gemm_pallas": dict(zip_towers="on", ln_gemm_impl="pallas"),
    "on_attn_pallas3": dict(zip_towers="on", attn_impl="pallas3"),
    "on_qk_norm": dict(zip_towers="on", vision_cfg={**TINY_ZIP["vision_cfg"], "qk_norm": True}),
    "on_mlp_pallas": dict(zip_towers="on", mlp_impl="pallas"),
}


@pytest.mark.parametrize("case", sorted(ZIP_CASES))
def test_zip_gate_matches_jax(case):
    """The port's zip_ready against JAX's CLIP._zip_ready on the same
    configuration (JAX's runs on the CPU backend, where 'auto' does not
    zip)."""
    kw = {**TINY_ZIP, **ZIP_CASES[case]}
    jmodel = JaxCLIP(cfg=jax_resolve("ViT-Test", **kw))
    want = jmodel.bind({"params": {"logit_scale": jnp.zeros(())}})._zip_ready()
    assert zip_ready(resolve_clip_cfg("ViT-Test", **kw)) == want
    assert want == (case in ("on", "on_ln_pallas", "on_mlp_pallas"))


# ------------------------------------------------------------------ the model

def _batch(seed, B=8, size=64, ctx=16, vocab=512, k=4):
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


def _count_calls(monkeypatch):
    """Counts the pair wrappers' and the single-tower wrappers' plain-version
    calls (what the CPU runs in place of each kernel launch)."""
    calls = dict.fromkeys(("pair_fwd", "pair_bwd", "single_fwd", "single_bwd"), 0)
    for mod, name, key in ((ap, "reference_attention_pair", "pair_fwd"),
                           (ap, "reference_attention_pair_bwd", "pair_bwd"),
                           (pfa, "reference_attention", "single_fwd"),
                           (pfa, "reference_attention_lse", "single_fwd"),
                           (pfa, "reference_attention_bwd", "single_bwd")):
        def counted(*a, _f=getattr(mod, name), _k=key):
            calls[_k] += 1
            return _f(*a)
        monkeypatch.setattr(mod, name, counted)
    return calls


def test_zipped_model_matches_jax_model_run_apart(monkeypatch):
    """The port's model under zip_towers='on' against JAX's under 'off', on
    the same weights and batch: both towers' features without grad, then the
    spatial loss and every parameter's gradient. Each forward makes one pair
    call per layer (2 here, in place of 4 single-tower calls) and each
    backward one pair backward call per layer; no single-tower attention
    runs."""
    jb = jax_create_model("ViT-Test", precision="fp32", seed=0, zip_towers="off", **TINY_ZIP)
    batch = _batch(3)
    x = np.array(jax_normalize(batch["images"]))
    jl = jax_make_loss("spatial", cap_logit_scale=50.0)

    def jloss(p):
        f = jb.model.apply({"params": p}, x, batch["texts"], True)
        return jl(**{**batch, **f})["contrastive_loss"], f

    (want, feats), want_g = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jb.params)
    model = create_model("ViT-Test", precision="fp32", device="cpu", training=True,
                         zip_towers="on", **TINY_ZIP)
    model.load_state_dict(from_jax_params(jb.params))
    assert model._zip_ready()
    calls = _count_calls(monkeypatch)
    tb = _torch_batch(batch)
    with torch.no_grad():
        served = model(_t(x), tb["texts"])
    assert calls == dict(pair_fwd=2, pair_bwd=0, single_fwd=0, single_bwd=0)
    for k in ("image_features", "text_features"):
        np.testing.assert_allclose(served[k].numpy(), np.asarray(feats[k]), atol=1e-5, err_msg=k)
    loss = make_loss("spatial", cap_logit_scale=50.0)(
        **{**tb, **model(_t(x), tb["texts"])})["contrastive_loss"]
    loss.backward()
    assert calls == dict(pair_fwd=4, pair_bwd=2, single_fwd=0, single_bwd=0)
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    grads = {k: p.grad for k, p in model.named_parameters()}
    for k, w in from_jax_params(want_g).items():
        w = w.numpy()
        np.testing.assert_allclose(grads[k].numpy(), w, rtol=0,
                                   atol=max(1e-5, 1e-4 * np.abs(w).max()), err_msg=k)
    # one tower alone is not zipped
    with torch.no_grad():
        alone = model(images=_t(x))["image_features"]
    assert calls["pair_fwd"] == 4 and calls["single_fwd"] == 2
    np.testing.assert_allclose(alone.numpy(), served["image_features"].numpy(), atol=1e-6)


def test_cached_accum_step_zipped_matches_jax_trainer(monkeypatch):
    """One Trainer step at grad_accum=2 (cached, microbatches of 4) with the
    fused loss under zip_towers='on' against the JAX Trainer running the
    towers apart: pass 1 (no grad) and pass 2 each make one pair call per
    layer and microbatch (4 + 4), pass 2's backward one per layer and
    microbatch (4). Metrics at rtol 1e-5, exact R@k, parameters at atol
    2e-5."""
    cfg_kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=50, augment=False, seed=0,
                  grad_accum=2, grad_accum_mode="cached")
    loss_kw = dict(cap_logit_scale=50.0, use_fused_kernel=True)
    jb = jax_create_model("ViT-Test", precision="fp32", seed=0, zip_towers="off", **TINY_ZIP)
    jt = JaxTrainer(jb, loss=jax_make_loss("spatial", **loss_kw),
                    config=JaxTrainerConfig(**cfg_kw), mesh=make_mesh(devices=jax.devices()[:1]))
    model = create_model("ViT-Test", precision="fp32", device="cpu", training=True,
                         zip_towers="on", **TINY_ZIP)
    model.load_state_dict(from_jax_params(jb.params))
    trainer = Trainer(model, make_loss("spatial", **loss_kw), TrainerConfig(**cfg_kw))
    jstep, jstate = jt.make_train_step(), jt.init_state()
    state = trainer.init_state()
    batch = _batch(20)
    jstate, jm = jstep(jstate, jt._device_batch(batch))
    calls = _count_calls(monkeypatch)
    state, m = trainer.train_step(state, _torch_batch(batch))
    assert calls == dict(pair_fwd=8, pair_bwd=4, single_fwd=0, single_bwd=0)
    for k in ("loss", "grad_norm", "logit_scale", "lr"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, atol=1e-12, err_msg=k)
    for k in ("R@1", "R@5", "R@10"):
        assert float(m[k]) == float(jm[k]), k
    want = from_jax_train_state(jax.tree.map(np.asarray, jstate))
    for k, w in want.params.items():
        np.testing.assert_allclose(state.params[k].detach().numpy(), w.detach().numpy(),
                                   atol=2e-5, rtol=0, err_msg=k)


def test_profile_families_hold_the_pair_kernels():
    """`bench --profile` counts the pair kernels in the attention families."""
    from spatial_clip_tpu_torch.profile_serving import _family

    fwd, bwd = "attention (fused_attention_fwd)", "attention backward (fused_attention_bwd)"
    pair = "void (anonymous namespace)::attn_pair_{}_kernel<__nv_bfloat16, 64, 64>(Tower, Tower, int)"
    assert _family(pair.format("fwd")) == _family("attn_fwd_kernel<__nv_bfloat16, 64>") == fwd
    assert _family(pair.format("bwd")) == _family("attn_bwd_kernel<float, 64, true, true>") == bwd
