"""The port's fused spatial cross-entropy against the JAX package's.

JAX runs its Pallas kernels in interpret mode with small blocks (16 x 32),
as tests/test_fused_kernel.py does, so its padding and masking are
exercised; the port runs the kernels' plain versions (CPU tensors). Inputs
come from numpy seeds; tolerances (f32) are stated in each test.
"""
from __future__ import annotations

import tests.helpers.torch_threads  # noqa: F401  (xdist workers share the cores)

import functools
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatial_clip_tpu.losses import make_loss as jax_make_loss
from spatial_clip_tpu.ops import fused_contrastive as jax_fc
from spatial_clip_tpu_torch.losses import make_loss
from spatial_clip_tpu_torch.ops import fused_contrastive as fc

JAX_FUSED = functools.partial(jax_fc.fused_spatial_ce, block_m=16, block_n=32, interpret=True)

CASES = {  # B, N, D, k, scale, duplicates
    "blocks": (48, 96, 32, 4, 10.0, False),
    "ragged": (19, 45, 32, 3, 7.0, False),  # no block size divides B or N
    "duplicates": (24, 40, 16, 4, 20.0, True),
}


def _case(B, N, D, k, scale, dupes, seed=0):
    """Unit rows, unique column ids (or some repeated), ground-truth columns,
    neighbor ids drawn from the column ids with a -1 share, weights in
    (-0.2, 1) so that the clamp at 0 is exercised."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    K = rng.normal(size=(N, D)).astype(np.float32)
    K /= np.linalg.norm(K, axis=1, keepdims=True)
    col_ids = rng.permutation(10_000)[:N].astype(np.int32)
    if dupes:
        col_ids[N // 2:N // 2 + 4] = col_ids[:4]
    gt = (rng.permutation(N)[:B] if B <= N else rng.integers(0, N, B)).astype(np.int32)
    nbr = np.where(rng.uniform(size=(B, k)) < 0.7, col_ids[rng.integers(0, N, (B, k))],
                   -1).astype(np.int32)
    alphas = rng.uniform(-0.2, 1.0, (B, k)).astype(np.float32)
    return q, K, col_ids, gt, nbr, alphas, np.float32(scale)


def _torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("name", CASES)
def test_loss_and_gradients_match_jax_kernels(name):
    """Per-row losses at rtol 2e-5 (atol 2e-5), and the gradients of their
    mean for q, K and the scale at rtol 1e-4 (atol 1e-5 for q and K):
    f32 summation order only."""
    q, K, col_ids, gt, nbr, alphas, s = _case(*CASES[name])
    ids = tuple(jnp.asarray(a) for a in (col_ids, gt, nbr, alphas))
    want = JAX_FUSED(jnp.asarray(q), jnp.asarray(K), *ids, jnp.float32(s))
    want_g = jax.grad(lambda a, b, c: JAX_FUSED(a, b, *ids, c).mean(), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(K), jnp.float32(s))

    tq, tk, ts = (t.requires_grad_() for t in _torch(q, K, s))
    before = (fc.spatial_ce_fwd.launches, fc.spatial_ce_dq.launches, fc.spatial_ce_dk.launches)
    got = fc.fused_spatial_ce(tq, tk, *_torch(col_ids, gt, nbr, alphas), ts)
    got.mean().backward()
    assert (fc.spatial_ce_fwd.launches, fc.spatial_ce_dq.launches,
            fc.spatial_ce_dk.launches) == before  # CPU tensors: the plain versions
    assert got.shape == (CASES[name][0],)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    for g, w in zip((tq.grad, tk.grad), want_g[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ts.grad.item(), float(want_g[2]), rtol=1e-4)


@pytest.mark.parametrize("name", CASES)
def test_plain_kernel_versions_match_jax_residuals_and_vjp(name):
    """Each kernel's plain version against what the JAX kernels give on the
    same inputs: (loss, lse, mass) against `_fwd_impl`'s outputs at rtol
    2e-5; (dq, dscale) and dK against the VJP of JAX's fused_spatial_ce for
    a random cotangent g, at rtol 1e-4 (atol 1e-6 for dq and dK)."""
    q, K, col_ids, gt, nbr, alphas, s = _case(*CASES[name], seed=1)
    B = q.shape[0]
    g = np.random.default_rng(2).uniform(0.1, 1.0, B).astype(np.float32)
    ids = tuple(jnp.asarray(a) for a in (col_ids, gt, nbr, alphas))
    w_loss, w_lse, w_mass = jax_fc._fwd_impl(jnp.asarray(q), jnp.asarray(K), *ids,
                                             jnp.float32(s), 16, 32, True)
    _, vjp = jax.vjp(lambda a, b, c: JAX_FUSED(a, b, *ids, c),
                     jnp.asarray(q), jnp.asarray(K), jnp.float32(s))
    w_dq, w_dk, w_ds = vjp(jnp.asarray(g))

    tq, tk, tcol, tgt, tnbr, talpha, ts = fc.prepare_inputs(*_torch(q, K, col_ids, gt, nbr,
                                                                    alphas, s))
    inputs = (tq, tk, tcol, tgt, tnbr, talpha, ts)
    loss, lse, mass = fc.reference_spatial_ce_fwd(*inputs)
    for got, want in ((loss, w_loss), (lse, np.asarray(w_lse)[:B, 0]),
                      (mass, np.asarray(w_mass)[:B, 0])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    tg = torch.from_numpy(g)
    dq, ds = fc.reference_spatial_ce_dq(*inputs, lse, mass, tg)
    dk = fc.reference_spatial_ce_dk(*inputs, lse, mass, tg)
    np.testing.assert_allclose(dq.numpy(), np.asarray(w_dq), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(dk.numpy(), np.asarray(w_dk), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(ds.item(), float(w_ds), rtol=1e-4)
    # the wrappers run exactly these plain versions on CPU tensors
    for got, want in zip(fc.spatial_ce_fwd(*inputs), (loss, lse, mass)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(fc.spatial_ce_dk(*inputs, lse, mass, tg), dk, rtol=0, atol=0)


# the card kernels' edges: one column, an odd width, widths either side of
# one 512-column slice, B != N with tails past every tile, 0 and 16 neighbors
EDGE_CASES = {  # B, N, D, k, scale, duplicates
    "d1": (5, 7, 1, 1, 10.0, False),
    "d65_k16": (40, 19, 65, 16, 10.0, True),
    "d511": (19, 45, 511, 3, 7.0, False),
    "d513_k0": (70, 33, 513, 0, 7.0, False),
    "b_lt_n_k16": (33, 70, 65, 16, 20.0, False),
}


@pytest.mark.parametrize("name", EDGE_CASES)
def test_plain_kernel_versions_match_jax_at_the_edges(name):
    """The plain versions the card's kernels are held to, against JAX's
    interpret-mode kernels at the kernels' edge shapes: loss, lse and mass
    at rtol 2e-5 (atol 2e-5), dq, dK and dscale of the VJP at rtol 1e-4
    (atol 1e-6): f32 summation order only. JAX's interpret mode takes no
    zero-size block, so at k = 0 it gets one neighbor of id -1 and weight
    0, which matches no column: the same labels."""
    B, N, D, k, scale, dupes = EDGE_CASES[name]
    q, K, col_ids, gt, nbr, alphas, s = _case(B, N, D, k, scale, dupes, seed=4)
    jnbr, jalphas = ((nbr, alphas) if k else
                     (np.full((B, 1), -1, np.int32), np.zeros((B, 1), np.float32)))
    ids = tuple(jnp.asarray(a) for a in (col_ids, gt, jnbr, jalphas))
    g = np.random.default_rng(5).uniform(0.1, 1.0, B).astype(np.float32)
    w_loss, w_lse, w_mass = jax_fc._fwd_impl(jnp.asarray(q), jnp.asarray(K), *ids,
                                             jnp.float32(s), 16, 32, True)
    _, vjp = jax.vjp(lambda a, b, c: JAX_FUSED(a, b, *ids, c),
                     jnp.asarray(q), jnp.asarray(K), jnp.float32(s))
    w_dq, w_dk, w_ds = vjp(jnp.asarray(g))

    inputs = fc.prepare_inputs(*_torch(q, K, col_ids, gt, nbr, alphas, s))
    assert inputs[4].shape == (B, k)
    loss, lse, mass = fc.spatial_ce_fwd(*inputs)
    for got, want in ((loss, w_loss), (lse, np.asarray(w_lse)[:B, 0]),
                      (mass, np.asarray(w_mass)[:B, 0])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    tg = torch.from_numpy(g)
    dq, ds = fc.spatial_ce_dq(*inputs, lse, mass, tg)
    dk = fc.spatial_ce_dk(*inputs, lse, mass, tg)
    assert dq.shape == (B, D) and dk.shape == (N, D)
    np.testing.assert_allclose(dq.numpy(), np.asarray(w_dq), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(dk.numpy(), np.asarray(w_dk), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(ds.item(), float(w_ds), rtol=1e-4)


PLAN_SHAPES = [(1, 1, 1), (63, 2049, 65), (2049, 63, 513), (1024, 1024, 512),
               (2048, 2048, 512), (1000, 1999, 512), (300, 700, 1536), (129, 257, 511)]


@pytest.mark.parametrize("B,N,D", PLAN_SHAPES)
@pytest.mark.parametrize("kind", [fc.FWD, fc.DQ, fc.DK])
def test_the_plan_covers_every_tile(kind, B, N, D):
    """At any resident count the plan's row blocks cover the owned rows,
    its slices (a cluster of one CTA per 512 columns, at most 8) cover D,
    its splits cover the other side's tiles with none empty and fill at
    most one wave, and its shared memory fits a block (227 KB)."""
    n_own, n_other = (N, B) if kind == fc.DK else (B, N)
    for resident in (1, 102, 117, 132, 264):
        p = fc.plan(kind, B, N, D, resident)
        assert (p["own"], p["tile"]) == (fc.OWN, fc.TILE)
        assert p["blocks"] * p["own"] >= n_own > (p["blocks"] - 1) * p["own"]
        tiles = -(-n_other // p["tile"])
        assert p["splits"] * p["per"] >= tiles > (p["splits"] - 1) * p["per"]
        if p["splits"] > 1:  # more than one split only while a wave holds them
            assert p["blocks"] * p["slices"] * (p["splits"] - 1) < resident
        assert p["slices"] * fc.COLS >= D > (p["slices"] - 1) * fc.COLS and p["slices"] <= 8
        assert p["smem"] == fc.SMEM + (p["slices"] * fc.Z_SLICE_BYTES if p["slices"] > 1 else 0)
        assert p["smem"] <= fc.MAX_SMEM


def test_the_plan_mirrors_the_kernel_source():
    """The tiles of :func:`fc.plan` are the kernel source's, and its
    shared memory the size the source asserts of ``walk::Smem``."""
    src = (Path(fc.__file__).parents[1] / "csrc" / "fused_spatial_ce.cu").read_text()
    walk = src[src.index("namespace walk {"):src.index("}  // namespace walk")]

    def const(text, name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert (const(walk, "kOwn"), const(walk, "kCols"), const(walk, "kTile")) == (
        fc.OWN, fc.COLS, fc.TILE)
    assert const(src, "kMaxDim") == fc.MAX_DIM
    assert f"constexpr size_t kMaxSmem = {fc.MAX_SMEM};" in src
    assert f"static_assert(sizeof(Smem) == {fc.SMEM}," in walk


def test_reference_spatial_ce_matches_jax():
    """The dense reference at rtol 1e-5: gt by column index, alphas clamped."""
    q, K, col_ids, gt, nbr, alphas, s = _case(*CASES["duplicates"], seed=3)
    want = jax_fc.reference_spatial_ce(*map(jnp.asarray, (q, K, col_ids, gt, nbr, alphas)),
                                       jnp.float32(s))
    got = fc.reference_spatial_ce(*_torch(q, K, col_ids, gt, nbr, alphas, s))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_kernel_input_contract_raises():
    q, K, col_ids, gt, nbr, alphas, s = fc.prepare_inputs(
        *_torch(*_case(*CASES["ragged"])))
    with pytest.raises(ValueError, match="share D"):
        fc.spatial_ce_fwd(q, K[:, :-1].contiguous(), col_ids, gt, nbr, alphas, s)
    with pytest.raises(ValueError, match="int32"):
        fc.spatial_ce_fwd(q, K, col_ids.long(), gt, nbr, alphas, s)
    with pytest.raises(ValueError, match="neighbors"):
        wide = nbr.repeat(1, 6).contiguous()
        fc.spatial_ce_fwd(q, K, col_ids, gt, wide, alphas.repeat(1, 6).contiguous(), s)
    with pytest.raises(ValueError, match="0-dim"):
        fc.spatial_ce_fwd(q, K, col_ids, gt, nbr, alphas, s.reshape(1))
    loss, lse, mass = fc.spatial_ce_fwd(q, K, col_ids, gt, nbr, alphas, s)
    with pytest.raises(ValueError, match="g must be"):
        fc.spatial_ce_dq(q, K, col_ids, gt, nbr, alphas, s, lse, mass, lse[:-1])


# ---------------------------------------------------------------- the loss

def _loss_inputs(seed, B=16, D=16, k=3, dupes=True):
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(2, B, D)).astype(np.float32)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    ids = np.arange(B, dtype=np.int32) * 3
    if dupes:
        ids[-2:] = ids[:2]  # two tile ids carried by two rows each
    spatial = {
        "image_tile_ids": ids,
        "text_tile_ids": ids.copy(),
        "neighbor_tile_ids": np.where(rng.uniform(size=(B, k)) < 0.75,
                                      ids[rng.integers(0, B, (B, k))], -1).astype(np.int32),
        "neighbor_alphas": rng.uniform(0, 1, (B, k)).astype(np.float32),
    }
    return f[0], f[1], spatial


def _both_losses(options, log_scale, img, txt, spatial):
    """JAX's and the port's loss and gradients (image, text, raw log scale)."""
    def jloss(i, t, ls):
        return jax_make_loss("spatial", **options)(
            image_features=i, text_features=t, logit_scale=jnp.exp(ls),
            **spatial)["contrastive_loss"]

    want, want_g = jax.value_and_grad(jloss, argnums=(0, 1, 2))(img, txt, jnp.float32(log_scale))
    ti, tt = (t.requires_grad_() for t in _torch(img, txt))
    ts = torch.tensor(log_scale, dtype=torch.float32, requires_grad=True)
    got = make_loss("spatial", **options)(
        image_features=ti, text_features=tt, logit_scale=ts.exp(),
        **{k: torch.from_numpy(v) for k, v in spatial.items()})["contrastive_loss"]
    got.backward()
    return (got.item(), (ti.grad, tt.grad, ts.grad)), (float(want), want_g)


@pytest.mark.parametrize("options,log_scale", [
    (dict(cap_logit_scale=50.0, use_fused_kernel=True), math.log(100.0)),  # STE cap active
    (dict(cap_logit_scale=50.0, use_fused_kernel=True), math.log(20.0)),
    (dict(neighbor_alpha_scale=2.0, use_fused_kernel=True), math.log(1 / 0.07)),
    # temp_reg takes the dense path in both packages
    (dict(cap_logit_scale=50.0, temp_reg_weight=0.5, use_fused_kernel=True), math.log(20.0)),
])
def test_spatial_loss_fused_matches_jax_with_duplicates(options, log_scale):
    """make_loss('spatial', use_fused_kernel=True) against JAX's, duplicated
    tile ids included (the fused path matches the diagonal by id): the loss
    at rtol 2e-5, the gradients for both feature matrices and the raw log
    scale (through the straight-through cap) at rtol 1e-4 / atol 1e-6."""
    img, txt, spatial = _loss_inputs(4)
    (got, got_g), (want, want_g) = _both_losses(options, log_scale, img, txt, spatial)
    np.testing.assert_allclose(got, want, rtol=2e-5)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-6)


def test_fused_and_dense_paths_agree_on_unique_ids_only():
    """Unique tile ids: fused == dense at rtol 1e-5. Duplicated ids: they
    differ, in both packages alike (the fused diagonal weighs every column
    that carries the row's id)."""
    for dupes in (False, True):
        img, txt, spatial = _loss_inputs(5, dupes=dupes)
        args = dict(image_features=torch.from_numpy(img), text_features=torch.from_numpy(txt),
                    logit_scale=torch.tensor(20.0),
                    **{k: torch.from_numpy(v) for k, v in spatial.items()})
        fused, dense = (make_loss("spatial", use_fused_kernel=f)(**args)["contrastive_loss"].item()
                        for f in (True, False))
        if dupes:
            assert abs(fused - dense) > 1e-3
        else:
            np.testing.assert_allclose(fused, dense, rtol=1e-5)
