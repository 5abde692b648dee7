"""The attention backward that forms the qkv projection's input gradient in
the kernel (``BWD_FUSE='dxdb'``) against the JAX package's
``_bwd_kernel3_dx``, run in Pallas interpret mode.

On the CPU the port's wrapper runs its plain version
(``reference_attention_bwd_dx``); the same numpy inputs go to both. JAX's
weight is (Din, 3D), the port's (3D, Din): the tests hand the port ``w.T``.

f32 tolerances, as tests/test_torch_port_attention_bwd.py states them: dqkv
atol 2e-5, db atol 2e-4, and dx rtol/atol 1e-4 (it sums 3D products of
dqkv and W in another order). bf16: both round dq, dk, dv to bf16 before
the product and dx once after it; dqkv at one bf16 step (2^-8) of its
largest magnitude, db at 5e-2 / 1e-2 as that file's bf16 test, dx at one
bf16 step (ulp) at its largest magnitude (both round dx once, from f32 sums
in other orders of dqkv entries that may sit one step apart).
"""
from __future__ import annotations

import tests.helpers.torch_threads  # noqa: F401  (xdist workers share the cores)

import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatial_clip_tpu import create_model as jax_create_model
from spatial_clip_tpu.ops import attention_variants as jav
from spatial_clip_tpu.ops import fused_attention as jfa
from spatial_clip_tpu_torch import create_model
from spatial_clip_tpu_torch.losses import make_loss
from spatial_clip_tpu_torch.models.convert import from_jax_params
from spatial_clip_tpu_torch.ops import attention_variants as pav
from spatial_clip_tpu_torch.ops import cuda_build
from spatial_clip_tpu_torch.ops import fused_attention as pfa
from spatial_clip_tpu_torch.ops.attention_variants import (
    dx_supported,
    fused_attention_bwd_dx,
    reference_attention_bwd_dx,
)
from spatial_clip_tpu_torch.ops.fused_attention import lse_ok, reference_attention_bwd
from tests.test_torch_port_attention_bwd import (
    ROUTES,
    _count_routes,
    _inputs,
    _jmask,
    _qkv_attention_vs_jax,
    _t,
)

# from GEOMETRIES of test_torch_port_attention_bwd.py: hd 64, 128 and 32, causal
# and not, and the image tower's L=50 with 12 heads; Din unlike 3D
DX_GEOMETRIES = [(4, 11, 128, 2, True, 128), (2, 17, 384, 3, False, 192),
                 (2, 9, 256, 8, True, 96), (2, 50, 768, 12, False, 384)]


def _weight(seed, din, three_d):
    """JAX's (Din, 3D) qkv weight, scaled as an initialised projection."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(din, three_d)) * din ** -0.5).astype(np.float32)


def _jax_bwd_dx(qkv, mask, g, w, H):
    """``_bwd_pallas3_dx`` in interpret mode, its (3, B, L, D) cotangent and
    (n_groups, 3, lanes) bias grad in the port's layouts."""
    B, L, three_d = qkv.shape
    d3, dx, db_raw = jav._bwd_pallas3_dx(jnp.asarray(qkv), _jmask(mask, L), jnp.asarray(g),
                                         jnp.asarray(w), H, True)
    dqkv = jnp.transpose(d3, (1, 2, 0, 3)).reshape(B, L, three_d)
    db = jnp.transpose(db_raw, (1, 0, 2)).reshape(-1)
    return (np.asarray(t.astype(jnp.float32)) for t in (dqkv, dx, db))


@pytest.mark.parametrize("B,L,D,H,causal,din", DX_GEOMETRIES)
def test_plain_version_matches_jax_kernel_f32(B, L, D, H, causal, din):
    qkv, mask, g = _inputs(B * L + D + 5, B, L, D, causal)
    w = _weight(din, din, 3 * D)
    want_dqkv, want_dx, want_db = _jax_bwd_dx(qkv, mask, g, w, H)
    dqkv, dx, db = fused_attention_bwd_dx(_t(qkv), _t(mask), _t(g), _t(w.T).contiguous(), H)
    assert dqkv.shape == qkv.shape and dx.shape == (B, L, din) and db.dtype == torch.float32
    np.testing.assert_allclose(dqkv.numpy(), want_dqkv, atol=2e-5)
    np.testing.assert_allclose(db.numpy(), want_db, atol=2e-4)
    np.testing.assert_allclose(dx.numpy(), want_dx, rtol=1e-4, atol=1e-4)
    # dqkv and db are the recompute-with-db plain version's
    want = reference_attention_bwd(_t(qkv), _t(mask), None, _t(g), H)
    assert torch.equal(dqkv, want[0]) and torch.equal(db, want[1])


def test_plain_version_matches_jax_kernel_bf16():
    B, L, D, H, causal, din = 2, 50, 768, 12, False, 384
    qkv, mask, g = _inputs(3, B, L, D, causal)
    w = _weight(4, din, 3 * D)
    bf = [jnp.asarray(a).astype(jnp.bfloat16) for a in (qkv, g, w)]
    want_dqkv, want_dx, want_db = _jax_bwd_dx(bf[0], mask, bf[1], bf[2], H)
    to_bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (qkv, g, w.T.copy())]
    dqkv, dx, db = reference_attention_bwd_dx(to_bf[0], _t(mask), to_bf[1], to_bf[2], H)
    assert dqkv.dtype == dx.dtype == torch.bfloat16
    np.testing.assert_allclose(dqkv.float().numpy(), want_dqkv, rtol=0,
                               atol=2 ** -8 * np.abs(want_dqkv).max())
    np.testing.assert_allclose(db.numpy(), want_db, atol=5e-2, rtol=1e-2)
    peak = np.abs(want_dx).max()
    np.testing.assert_allclose(dx.float().numpy(), want_dx, rtol=0,
                               atol=2.0 ** (math.floor(math.log2(peak)) - 7))


# the bf16 product's edges (csrc/attention_dx.cu): one row, L past one and two
# 64-row tiles, hd 32 and 128, Din 16 / 48 / 144 (within one, past one and
# past two 64-column tiles of W, short of a 128-column pass)
DX_EDGES = [(3, 1, 128, 4, False, 16), (2, 65, 128, 1, True, 48),
            (2, 129, 128, 4, True, 144), (1, 65, 256, 2, False, 144)]


@pytest.mark.parametrize("B,L,D,H,causal,din", DX_EDGES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_jax_kernel_at_the_product_edges(dtype, B, L, D, H, causal, din):
    """The plain version the card's kernel is held to, against JAX's
    interpret-mode kernel at the product's edge shapes, at the tolerances
    of the two tests above (f32: dqkv atol 2e-5, db 2e-4, dx rtol / atol
    1e-4; bf16: dqkv one bf16 step of its largest magnitude, db atol 5e-2
    rtol 1e-2, dx one bf16 ulp at its largest magnitude)."""
    qkv, mask, g = _inputs(B * L + din, B, L, D, causal)
    w = _weight(din + 1, din, 3 * D)
    if dtype == "float32":
        want_dqkv, want_dx, want_db = _jax_bwd_dx(qkv, mask, g, w, H)
        dqkv, dx, db = fused_attention_bwd_dx(_t(qkv), _t(mask), _t(g), _t(w.T).contiguous(), H)
        np.testing.assert_allclose(dqkv.numpy(), want_dqkv, atol=2e-5)
        np.testing.assert_allclose(db.numpy(), want_db, atol=2e-4)
        np.testing.assert_allclose(dx.numpy(), want_dx, rtol=1e-4, atol=1e-4)
        return
    bf = [jnp.asarray(a).astype(jnp.bfloat16) for a in (qkv, g, w)]
    want_dqkv, want_dx, want_db = _jax_bwd_dx(bf[0], mask, bf[1], bf[2], H)
    to_bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (qkv, g, w.T.copy())]
    dqkv, dx, db = fused_attention_bwd_dx(to_bf[0], _t(mask), to_bf[1], to_bf[2], H)
    assert dx.shape == (B, L, din) and dx.dtype == torch.bfloat16
    np.testing.assert_allclose(dqkv.float().numpy(), want_dqkv, rtol=0,
                               atol=2 ** -8 * np.abs(want_dqkv).max())
    np.testing.assert_allclose(db.numpy(), want_db, atol=5e-2, rtol=1e-2)
    peak = np.abs(want_dx).max()
    np.testing.assert_allclose(dx.float().numpy(), want_dx, rtol=0,
                               atol=2.0 ** (math.floor(math.log2(peak)) - 7))


PLAN_LENGTHS = (1, 15, 16, 17, 50, 63, 64, 65, 77, 128, 129, 200, 256)


@pytest.mark.parametrize("L", PLAN_LENGTHS)
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_the_product_plan_covers_every_tile(hd, L):
    """For every geometry the bf16 kernel takes, at each cluster size
    ``bench_gemm`` times: the row groups (one or two m64 tiles) cover L,
    the passes cover Din, the 64-deep stages cover K = 3D, each CTA of a cluster
    lands an equal share of a stage's W boxes, the ring has 2 to
    ``DX_MAX_STAGES`` stages, and the shared memory holds the body and the
    ring (1024 bytes of alignment, a full and an empty barrier a stage)
    within a block's 227 KB, and within two blocks an SM wherever the body
    is."""
    for heads, din in ((1, 16), (2, 48), (3, 144), (8, 512), (12, 768), (4, 1024)):
        if not dx_supported(heads, heads * hd, L, din, torch.bfloat16):
            continue
        body = pfa.bwd_smem_bytes(L, hd, torch.bfloat16)
        depth = pav.DX_DEPTH
        for cluster in (1, 2, 4):
            p = pav.dx_plan(L, heads, hd, din, cluster=cluster)
            assert p["mt"] == (1 if L <= 64 else 2) and p["nc"] * p["mt"] == 256
            assert p["groups"] * 128 >= L > (p["groups"] - 1) * 128
            assert p["mt"] * 64 >= min(L, 128)
            assert p["passes"] * p["nc"] >= din > (p["passes"] - 1) * p["nc"]
            k = 3 * heads * hd
            assert p["n_k"] * depth >= k > (p["n_k"] - 1) * depth
            blocks = p["nc"] // 64
            boxes = blocks * depth // p["box_rows"]
            assert boxes >= cluster and boxes % cluster == 0
            assert 2 <= p["stages"] <= pav.DX_MAX_STAGES
            ring = 1024 + p["stages"] * ((p["mt"] + blocks) * 128 * depth + 16)
            assert p["smem"] == max(body, ring) <= 232448
            if body <= pav.DX_TWO_PER_SM:
                assert p["smem"] <= pav.DX_TWO_PER_SM


@pytest.mark.parametrize("tower,geometry,want", [
    ("image", (50, 12, 64, 768),
     dict(mt=1, groups=1, nc=256, passes=3, n_k=36, box_rows=64, stages=2, cluster=2)),
    ("text", (77, 8, 64, 512),
     dict(mt=2, groups=1, nc=128, passes=4, n_k=24, box_rows=64, stages=3, cluster=2)),
])
def test_the_product_plan_at_the_towers(tower, geometry, want):
    """ViT-B-32's towers (L, heads, hd, Din) at the package's constants:
    the image tower's one 64-row tile in 3 passes of 256 columns, the
    text's two 64-row tiles in 4 passes of 128, 64-deep stages of 40 / 32
    KB, 2 / 3 of them in the ring beside the body's second block an SM."""
    p = pav.dx_plan(*geometry)
    assert {k: p[k] for k in want} == want
    stage = (p["mt"] + p["nc"] // 64) * 64 * pav.DX_DEPTH * 2
    assert stage == {"image": 40960, "text": 32768}[tower]
    assert p["smem"] == 1024 + p["stages"] * (stage + 16) <= pav.DX_TWO_PER_SM


def test_the_product_plan_mirrors_the_kernel_source():
    """``dx_plan``'s constants are the kernel source's: the design
    constants' defaults (the cluster one of the sizes ``bench_gemm``
    times), the 64-deep stages, 128-row groups, two blocks' share of an
    SM."""
    from pathlib import Path

    from spatial_clip_tpu_torch import bench_gemm

    src = (Path(pav.__file__).parents[1] / "csrc" / "attention_dx.cu").read_text()
    assert int(re.search(r"#define SC_DX_CLUSTER (\d+)", src).group(1)) == pav.DX_CLUSTER
    assert int(re.search(r"#define SC_DX_MAX_STAGES (\d+)", src).group(1)) == pav.DX_MAX_STAGES
    assert "constexpr int kDepth = 64;" in src and pav.DX_DEPTH == 64
    assert "constexpr int kGroupRows = 128;" in src
    assert "constexpr size_t kTwoPerSm = (233472 - 2 * 1024) / 2;" in src
    assert pav.DX_TWO_PER_SM == (233472 - 2 * 1024) // 2
    assert {1, 4} <= {v["attn_cluster"] for v in bench_gemm.VARIANTS.values()
                      if "attn_cluster" in v}


@pytest.fixture
def bwd_fuse_dxdb():
    """BWD_FUSE='dxdb' in both packages for one test, restored after."""
    prev = jfa.BWD_FUSE, pfa.BWD_FUSE
    jfa.BWD_FUSE = pfa.BWD_FUSE = "dxdb"
    yield
    jfa.BWD_FUSE, pfa.BWD_FUSE = prev


def _count_dx_routes(monkeypatch):
    """The calls of each attention wrapper QKVAttention may pick, the dx
    wrapper last."""
    calls = _count_routes(monkeypatch)
    calls["fused_attention_bwd_dx"] = 0
    plain = pav.fused_attention_bwd_dx

    def counted(*a):
        calls["fused_attention_bwd_dx"] += 1
        return plain(*a)

    monkeypatch.setattr(pav, "fused_attention_bwd_dx", counted)
    return calls


@pytest.mark.parametrize("B,L,D,H,causal", [(4, 11, 128, 2, True), (12, 17, 384, 3, False)])
def test_qkv_attention_dxdb_matches_jax(B, L, D, H, causal, bwd_fuse_dxdb, monkeypatch):
    """Under 'dxdb' both packages' forward is unchanged (the forward-lse
    kernel where the lse is saved, B=4; the inference one where it is not,
    B=12) and the backward is the dx kernel once, whatever was saved: the
    context and dx, dW, db against jax.grad at rtol/atol 1e-4."""
    calls = _count_dx_routes(monkeypatch)
    _qkv_attention_vs_jax(B, L, D, H, causal)
    saved = lse_ok(B, L)
    assert saved == (B == 4)
    assert calls == {**dict.fromkeys(ROUTES, 0), "fused_attention": int(not saved),
                     "fused_attention_lse": int(saved), "fused_attention_bwd_dx": 1}


def test_tower_gradients_under_dxdb_match_jax(bwd_fuse_dxdb, monkeypatch):
    """A two-layer tower pair (width 128, 2 heads) with attn_impl='pallas3'
    under 'dxdb' on both sides: the loss and every parameter's gradient
    against jax.grad through the interpret-mode ``_bwd_kernel3_dx``, at
    atol 1e-5 + rtol 1e-3 of its largest entry, with one dx call per
    layer and no other attention backward."""
    from spatial_clip_tpu.losses import make_loss as jax_make_loss
    from spatial_clip_tpu.models.transforms import normalize_batch as jax_normalize
    from tests.test_torch_port_train import WIDE, _batch, _jax_spatial_features, _torch_batch

    jb = jax_create_model("ViT-Test", precision="fp32", seed=0, attn_impl="pallas3", **WIDE)
    batch = _batch(3, B=4)
    x = np.array(jax_normalize(batch["images"]))
    jl = jax_make_loss("spatial", cap_logit_scale=50.0)

    def jloss(p):
        return jl(**{**batch, **_jax_spatial_features(jb, p, x, batch["texts"])})[
            "contrastive_loss"]

    want, want_g = jax.jit(jax.value_and_grad(jloss))(jb.params)
    model = create_model("ViT-Test", precision="fp32", device="cpu", training=True,
                         attn_impl="pallas3", **WIDE)
    model.load_state_dict(from_jax_params(jb.params))
    tb = _torch_batch(batch)
    calls = _count_dx_routes(monkeypatch)
    loss = make_loss("spatial", cap_logit_scale=50.0)(
        **{**tb, **model(torch.from_numpy(x), tb["texts"])})["contrastive_loss"]
    loss.backward()
    assert calls == {**dict.fromkeys(ROUTES, 0), "fused_attention_lse": 4,
                     "fused_attention_bwd_dx": 4}  # 2 + 2 layers, the lse saved at B=4
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    want_g = from_jax_params(want_g)
    for k, p in model.named_parameters():
        w = want_g[k].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=1e-5 + 1e-3 * np.abs(w).max(), err_msg=k)


def test_dx_geometry_set():
    """The training towers' geometries are taken (Din = width); an input
    width that is not a positive multiple of 16, or an L the backward's
    shared memory cannot hold, is not."""
    for heads, width, seq in ((12, 768, 50), (8, 512, 77)):
        for dtype in (torch.bfloat16, torch.float32):
            assert dx_supported(heads, width, seq, width, dtype)
    assert dx_supported(2, 128, 166, 16, torch.bfloat16)
    assert dx_supported(2, 128, 256, 16, torch.bfloat16)
    assert not dx_supported(2, 128, 11, 100, torch.bfloat16)
    assert not dx_supported(2, 128, 11, 0, torch.float32)
    assert not dx_supported(2, 256, 193, 128, torch.bfloat16)  # hd 128
    assert not dx_supported(2, 128, 107, 128, torch.float32)


@pytest.mark.parametrize("L,din,why", [(11, 100, "multiple of 16"), (11, 8, "multiple of 16"),
                                       (167, 128, "shared memory"),
                                       (11, 128, "no kernel for device meta")])
def test_wrapper_refuses_what_the_kernel_does_not_take(L, din, why, monkeypatch):
    """Off the CPU the wrapper checks the kernel's geometry before it
    reaches the card: tensors on the meta device take that path here (meta (which the wrappers run as the CPU, for ops/flops.py's count) is taken off the plain devices here)."""
    monkeypatch.setattr(cuda_build, "PLAIN_DEVICES", ("cpu",))
    qkv = torch.empty((2, L, 384), device="meta")
    g = torch.empty((2, L, 128), device="meta")
    w = torch.empty((384, din), device="meta")
    with pytest.raises(ValueError, match=why):
        fused_attention_bwd_dx(qkv, None, g, w, 2)


def test_wrapper_checks_the_weight():
    qkv, mask, g = (_t(a) for a in _inputs(0, 2, 9, 128, True))
    for w, why in ((torch.zeros(128, 384), r"\(3D, Din\)"),
                   (torch.zeros(384, 128, dtype=torch.bfloat16), "dtype"),
                   (torch.zeros(128, 384).t(), "contiguous")):
        with pytest.raises(ValueError, match=why):
            fused_attention_bwd_dx(qkv, mask, g, w, 2)


@pytest.mark.parametrize("module,argv", [
    ("bench", ["--bwd-fuse", "dxdb"]), ("bench_dx", ["--tower", "text"]),
    ("bench_dx", ["--stages", "3"]),
    ("bench_gemm", ["--kernels", "attn_dx", "--variants", "package,attn_cluster1,attn_stages2"]),
])
def test_entry_points_take_their_flags_and_refuse_without_a_gpu(module, argv):
    """``bench --bwd-fuse``, ``bench_dx`` (its ring's stages too) and
    ``bench_gemm``'s dx kernel with its design constants parse their flags,
    then refuse: no CUDA here. BWD_FUSE is left as it was."""
    import importlib

    before = pfa.BWD_FUSE
    with pytest.raises(SystemExit, match="needs a CUDA GPU"):
        importlib.import_module(f"spatial_clip_tpu_torch.{module}").main(argv)
    assert pfa.BWD_FUSE == before


def test_bench_dx_anchors_are_in_the_source():
    """``bench_dx``'s body and product copies patch the source at one head
    loop and one product call, and set the ring's depth by its macro."""
    from pathlib import Path

    from spatial_clip_tpu_torch import bench_dx

    src = (Path(pav.__file__).parents[1] / "csrc" / "attention_dx.cu").read_text()
    assert src.count(bench_dx.PRODUCT) == 1 and src.count(bench_dx.HEAD_LOOP) == 1
    assert src.count(f"#ifndef {bench_dx.STAGES}\n") == 1
