"""The port's training attention (forward with logsumexp, backward with the
bias gradient, the recompute backward, and the qkv-projection and
fused-qkv autograd functions) against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
kernels run in Pallas interpret mode, as tests/test_fused_attention.py runs
them. The same numpy inputs go to both. The kernel tests take batches of 2,
4 or 8. JAX's routing is covered, not avoided: at B=3 and B=12 the JAX
package's ``_lse_ok`` fails and ``qkv_attention`` trains through its
recompute backward with db, and so does the port's ``QKVAttention``, with
the launches counted per route; ``BWD_FUSE='none'`` is held on both sides.

f32 tolerances: the context and lse at atol 1e-5 (both sides compute f32
scores, the row max, exp and the sums, in other orders); dqkv at atol 2e-5
and db at atol 2e-4 (dq and dk sum L products of O(1) terms, db sums B*L
of those), for both backward kernels; the projection's dx, dW, db at rtol
1e-4 / atol 1e-4.
"""
from __future__ import annotations

import tests.helpers.torch_threads  # noqa: F401  (xdist workers share the cores)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatial_clip_tpu.ops import fused_attention as jfa
from spatial_clip_tpu_torch import bench_backward
from spatial_clip_tpu_torch.ops import cuda_build
from spatial_clip_tpu_torch.ops import fused_attention as pfa
from spatial_clip_tpu_torch.ops.fused_attention import (
    FusedAttention,
    QKVAttention,
    bwd_smem_bytes,
    bwd_supported,
    fused_attention,
    fused_attention_bwd,
    fused_attention_bwd_recompute,
    fused_attention_bwd_recompute_db,
    fused_attention_lse,
    lse_ok,
    qkv_attention,
    reference_attention,
    reference_attention_bwd,
    reference_attention_lse,
)

# the geometries of tests/test_fused_attention.py (hd 64, 128, 32), masked
# and unmasked, then the two training shapes at a small batch: the image
# tower (L=50, 12 heads) and the causal text tower (L=77, 8 heads)
GEOMETRIES = [
    *[(B, L, D, H, causal) for (B, L, D, H) in [(4, 11, 128, 2), (2, 17, 384, 3), (2, 9, 256, 8)]
      for causal in (False, True)],
    (2, 50, 768, 12, False),
    (8, 77, 512, 8, True),
]


def _mask(L, causal):
    if not causal:
        return None
    return np.triu(np.full((L, L), np.finfo(np.float32).min, np.float32), k=1)


def _inputs(seed, B, L, D, causal):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(B, L, 3 * D)).astype(np.float32)
    g = rng.normal(size=(B, L, D)).astype(np.float32)
    return qkv, _mask(L, causal), g


def _jmask(mask, L):
    return jnp.zeros((L, L), jnp.float32) if mask is None else jnp.asarray(mask)


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _jax_bwd(qkv, mask, lse, g, H):
    """JAX's (3, B, L, D) cotangent and (n_groups, 3, lanes) bias grad in the
    port's layouts: dqkv (B, L, 3D) and db (3D,)."""
    B, L, three_d = qkv.shape
    d3, db_raw = jfa._bwd_pallas3_db_lse(
        jnp.asarray(qkv), _jmask(mask, L), jnp.asarray(lse), jnp.asarray(g), H, True)
    dqkv = np.asarray(jnp.transpose(d3, (1, 2, 0, 3)).reshape(B, L, three_d))
    return dqkv, np.asarray(jnp.transpose(db_raw, (1, 0, 2)).reshape(-1))


@pytest.mark.parametrize("B,L,D,H,causal", GEOMETRIES)
def test_forward_lse_matches_jax_kernel_f32(B, L, D, H, causal):
    qkv, mask, _ = _inputs(B * L + D, B, L, D, causal)
    want_out, want_lse = jfa._fwd_pallas_lse(jnp.asarray(qkv), _jmask(mask, L), H, True)
    out, lse = fused_attention_lse(_t(qkv), _t(mask), H)
    assert out.shape == (B, L, D) and lse.shape == (H, B, L) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=1e-5)
    assert torch.equal(out, reference_attention(_t(qkv), _t(mask), H))


@pytest.mark.parametrize("B,L,D,H,causal", GEOMETRIES)
def test_backward_matches_jax_kernel_f32(B, L, D, H, causal):
    qkv, mask, g = _inputs(B * L + D + 1, B, L, D, causal)
    _, lse = jfa._fwd_pallas_lse(jnp.asarray(qkv), _jmask(mask, L), H, True)
    lse = np.asarray(lse)
    want_dqkv, want_db = _jax_bwd(qkv, mask, lse, g, H)
    dqkv, db = fused_attention_bwd(_t(qkv), _t(mask), _t(lse), _t(g), H)
    assert dqkv.shape == qkv.shape and db.shape == (3 * D,) and db.dtype == torch.float32
    np.testing.assert_allclose(dqkv.numpy(), want_dqkv, atol=2e-5)
    np.testing.assert_allclose(db.numpy(), want_db, atol=2e-4)
    np.testing.assert_allclose(db.numpy(), dqkv.sum(dim=(0, 1)).numpy(), atol=1e-5)


@pytest.mark.parametrize("B,L,D,H,causal", GEOMETRIES)
def test_recompute_backward_matches_jax_kernel_f32(B, L, D, H, causal):
    """The recompute backward (no saved lse, no db) against ``_bwd_pallas``
    (``_bwd_kernel``) in interpret mode; with the lse pair's dqkv it agrees
    too, as the two compute one gradient."""
    qkv, mask, g = _inputs(B * L + D + 2, B, L, D, causal)
    want = np.asarray(jfa._bwd_pallas(jnp.asarray(qkv), _jmask(mask, L), jnp.asarray(g), H, True))
    dqkv = fused_attention_bwd_recompute(_t(qkv), _t(mask), _t(g), H)
    assert dqkv.shape == qkv.shape and dqkv.dtype == torch.float32
    np.testing.assert_allclose(dqkv.numpy(), want, atol=2e-5)
    _, lse = reference_attention_lse(_t(qkv), _t(mask), H)
    np.testing.assert_allclose(
        dqkv.numpy(), reference_attention_bwd(_t(qkv), _t(mask), lse, _t(g), H)[0].numpy(),
        atol=2e-5)


@pytest.mark.parametrize("B,L,D,H,causal", [(2, 50, 768, 12, False), (4, 77, 512, 8, True)])
def test_recompute_backward_training_shapes_match_jax_kernel_bf16(B, L, D, H, causal):
    """bf16 in and out at the towers' shapes: dqkv within one bf16 step
    (2^-8 relative) of ``_bwd_kernel``'s where f32 sums run in another
    order."""
    qkv, mask, g = _inputs(6, B, L, D, causal)
    qkv_b, g_b = jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16)
    want = np.asarray(jfa._bwd_pallas(qkv_b, _jmask(mask, L), g_b, H, True), np.float32)
    tq = torch.from_numpy(np.array(qkv_b.astype(jnp.float32))).bfloat16()
    tg = torch.from_numpy(np.array(g_b.astype(jnp.float32))).bfloat16()
    dqkv = fused_attention_bwd_recompute(tq, _t(mask), tg, H)
    assert dqkv.dtype == torch.bfloat16
    np.testing.assert_allclose(dqkv.float().numpy(), want, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("B,L,D,H,causal", [(4, 11, 128, 2, True), (2, 50, 768, 12, False)])
def test_fused_attention_grads_match_jax(B, L, D, H, causal):
    """:class:`FusedAttention` (inference forward, recompute backward)
    against jax.grad of ``fused_attention`` with the interpret-mode kernels,
    whose custom VJP runs ``_fwd_kernel`` and ``_bwd_kernel``."""
    qkv, mask, g = _inputs(B + L + 7, B, L, D, causal)
    jm = _jmask(mask, L)
    want_out = np.asarray(jfa.fused_attention(jnp.asarray(qkv), jm, H, True))
    want = np.asarray(jax.grad(lambda q: jnp.sum(jfa.fused_attention(q, jm, H, True) * g))(
        jnp.asarray(qkv)))
    tq = _t(qkv).requires_grad_()
    out = FusedAttention.apply(tq, _t(mask), H)
    (out * _t(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=1e-5)
    np.testing.assert_allclose(tq.grad.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("B,L,D,H,causal", [(2, 50, 768, 12, False), (4, 77, 512, 8, True)])
def test_training_shapes_match_jax_kernel_bf16(B, L, D, H, causal):
    """bf16 in and out, f32 statistics. The context and dqkv are one bf16
    step (2^-8 relative) apart at most where sums run in another order; lse
    is f32 from bf16-exact inputs; db sums B*L rounded values."""
    qkv, mask, g = _inputs(5, B, L, D, causal)
    qkv_b, g_b = jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16)
    want_out, want_lse = jfa._fwd_pallas_lse(qkv_b, _jmask(mask, L), H, True)
    d3, db_raw = jfa._bwd_pallas3_db_lse(qkv_b, _jmask(mask, L), want_lse, g_b, H, True)
    want_dqkv = np.asarray(jnp.transpose(d3, (1, 2, 0, 3)).reshape(B, L, 3 * D), np.float32)
    want_db = np.asarray(jnp.transpose(db_raw, (1, 0, 2)).reshape(-1))

    tq = torch.from_numpy(np.array(qkv_b.astype(jnp.float32))).bfloat16()
    tg = torch.from_numpy(np.array(g_b.astype(jnp.float32))).bfloat16()
    out, lse = fused_attention_lse(tq, _t(mask), H)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want_out, np.float32),
                               atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=1e-5, rtol=1e-6)
    dqkv, db = fused_attention_bwd(tq, _t(mask), _t(want_lse), tg, H)
    assert dqkv.dtype == torch.bfloat16
    np.testing.assert_allclose(dqkv.float().numpy(), want_dqkv, atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(db.numpy(), want_db, atol=5e-2, rtol=1e-2)


@pytest.mark.parametrize("B,L,D,H,causal", [(4, 11, 128, 2, True), (2, 50, 768, 12, False)])
def test_qkv_attention_grads_match_jax(B, L, D, H, causal):
    """The projection-fused autograd function against jax.grad of
    ``qkv_attention`` with the interpret-mode kernels: the context, dx, dW
    and the bias gradient that the backward kernel produces."""
    rng = np.random.default_rng(B + L)
    din = D // 2 if D > 128 else D
    x = rng.normal(size=(B, L, din)).astype(np.float32)
    w = (rng.normal(size=(din, 3 * D)) * din ** -0.5).astype(np.float32)  # flax (in, out)
    b = (rng.normal(size=(3 * D,)) * 0.1).astype(np.float32)
    g = rng.normal(size=(B, L, D)).astype(np.float32)
    mask = _mask(L, causal)
    jm = None if mask is None else jnp.asarray(mask)

    def f(x_, w_, b_):
        return jnp.sum(jfa.qkv_attention(x_, w_, b_, jm, H, True) * g)

    want_out = np.asarray(jfa.qkv_attention(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                            jm, H, True))
    want = [np.asarray(t) for t in jax.grad(f, argnums=(0, 1, 2))(x, w, b)]

    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(np.ascontiguousarray(w.T)).requires_grad_()  # torch (out, in)
    tb = torch.from_numpy(b).requires_grad_()
    out = qkv_attention(tx, tw, tb, _t(mask), H)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), want[0], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tw.grad.numpy().T, want[1], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tb.grad.numpy(), want[2], atol=1e-4, rtol=1e-4)


def test_qkv_attention_matches_autograd_of_plain_math():
    """Against torch autograd of the plain math (F.linear + softmax
    attention) in f64: the hand-written backward (in f32) is the true
    gradient, at atol/rtol 1e-4."""
    rng = np.random.default_rng(3)
    B, L, D, H = 2, 9, 128, 2
    x = torch.from_numpy(rng.normal(size=(B, L, D))).requires_grad_()
    w = torch.from_numpy(rng.normal(size=(3 * D, D)) * D ** -0.5).requires_grad_()
    b = torch.from_numpy(rng.normal(size=(3 * D,))).requires_grad_()
    g = torch.from_numpy(rng.normal(size=(B, L, D)))
    mask = torch.from_numpy(_mask(L, True).astype(np.float64))

    q, k, v = torch.nn.functional.linear(x, w, b).view(B, L, 3, H, D // H).permute(2, 0, 3, 1, 4)
    p = torch.softmax(q @ k.transpose(-1, -2) * (D // H) ** -0.5 + mask, dim=-1)
    want = torch.autograd.grad(((p @ v).transpose(1, 2).reshape(B, L, D) * g).sum(), (x, w, b))

    got = torch.autograd.grad(
        (qkv_attention(x.float(), w.float(), b.float(), mask.float(), H) * g.float()).sum(),
        (x, w, b))
    for a, e in zip(got, want):
        torch.testing.assert_close(a.double(), e, atol=1e-4, rtol=1e-4)


def test_cpu_path_is_the_plain_version_and_counts_nothing():
    qkv, mask, g = _inputs(0, 2, 9, 128, True)
    counters = (fused_attention, fused_attention_lse, fused_attention_bwd,
                fused_attention_bwd_recompute, fused_attention_bwd_recompute_db)
    before = tuple(c.launches for c in counters)
    out, lse = fused_attention_lse(_t(qkv), _t(mask), 2)
    dqkv, db = fused_attention_bwd(_t(qkv), _t(mask), lse, _t(g), 2)
    dqkv_re = fused_attention_bwd_recompute(_t(qkv), _t(mask), _t(g), 2)
    dqkv_re_db, db_re = fused_attention_bwd_recompute_db(_t(qkv), _t(mask), _t(g), 2)
    assert tuple(c.launches for c in counters) == before
    want_out, want_lse = reference_attention_lse(_t(qkv), _t(mask), 2)
    want_dqkv, want_db = reference_attention_bwd(_t(qkv), _t(mask), want_lse, _t(g), 2)
    want_re, want_db_re = reference_attention_bwd(_t(qkv), _t(mask), None, _t(g), 2)
    for a, e in ((out, want_out), (lse, want_lse), (dqkv, want_dqkv), (db, want_db),
                 (dqkv_re, want_re), (dqkv_re_db, want_re), (db_re, want_db_re)):
        assert torch.equal(a, e)


def test_backward_geometry_set():
    """The training geometries are in the backward's set in both dtypes;
    what a block's shared memory cannot hold is not."""
    for width, heads in ((768, 12), (512, 8)):
        for L in (50, 77):
            for dtype in (torch.bfloat16, torch.float32):
                assert bwd_supported(heads, width, L, dtype)
    assert not bwd_supported(2, 256, 73, torch.float32)  # hd 128, f32
    assert bwd_supported(2, 256, 72, torch.float32)
    assert not bwd_supported(2, 96, 16, torch.float32)  # hd 48
    assert bwd_smem_bytes(77, 64, torch.bfloat16) == 50880


@pytest.mark.parametrize("L,rows,bf16_bytes", [(50, 64, 40704), (77, 80, 50880), (256, 256, 162816)])
def test_bf16_backward_smem_formula(L, rows, bf16_bytes):
    """The bf16 (tensor-core) body at hd 64: q, k, v and do in four tiles of
    whole 16-row tiles of 64 + 8 elements, three f32 values a row and three
    f32 column sums of 64 a tile. The f32 (CUDA-core) body's formula is
    unchanged: Q, K, V, do in 16-byte padded rows, the p and ds tiles, f32
    warp rows and db partials."""
    assert bwd_smem_bytes(L, 64, torch.bfloat16) == bf16_bytes == (
        4 * rows * 72 * 2 + 3 * rows * 4 + rows // 16 * 3 * 64 * 4)
    seq_pad = (L + 7) // 8 * 8
    assert bwd_smem_bytes(L, 64, torch.float32) == (
        (4 * L * 68 + 2 * L * seq_pad) * 4 + (8 * 2 * (128 + seq_pad) + 8 * 3 * 64) * 4)
    assert bwd_smem_bytes(77, 64, torch.float32) == 152512


@pytest.mark.parametrize("hd,took,longest", [(32, 192, 256), (64, 166, 256), (128, 122, 192)])
def test_bf16_backward_takes_every_length_it_took(hd, took, longest):
    """Every bf16 length the CUDA-core body took (192 / 166 / 122 at hd 32 /
    64 / 128) is still taken, so no model that trained starts to raise; the
    tensor-core body takes every length up to 256 it took under the old cap
    (``longest``), and now up to the shared-memory limit ``bwd_max_seq``
    (640 / 352 / 192), refusing the next length; longer sequences take the
    key-tiled kernels."""
    for L in range(1, took + 1):
        assert bwd_supported(2, 2 * hd, L, torch.bfloat16)
    assert max(L for L in range(1, 257) if bwd_supported(2, 2 * hd, L, torch.bfloat16)) == longest
    limit = {32: 640, 64: 352, 128: 192}[hd]
    assert pfa.bwd_max_seq(hd, torch.bfloat16) == limit
    assert bwd_supported(2, 2 * hd, limit, torch.bfloat16)
    assert not bwd_supported(2, 2 * hd, limit + 1, torch.bfloat16)
    assert bwd_smem_bytes(limit + 1, hd, torch.bfloat16) > pfa.MAX_SMEM_BYTES


@pytest.mark.parametrize("variant", sorted(bench_backward.VARIANTS))
def test_bench_backward_parses_variants_and_refuses_without_a_gpu(variant):
    """Each ``bench_backward`` variant sets its constants through nvcc
    ``-D``, each a macro with one ``#ifndef`` default in the backward body's
    header (a flag for a macro the header lacks is refused); ``--variants``
    takes known names in order without repeats and refuses others; the
    script then refuses: no CUDA here."""
    header = (cuda_build.CSRC_DIR / bench_backward.HEADER).read_text()
    knobs, variants = bench_backward.KNOBS, bench_backward.VARIANTS
    assert bench_backward.design_flags(header, knobs, variants[variant]) == [
        f"-D{knobs[knob]}={value}" for knob, value in variants[variant].items()]
    for macro in knobs.values():
        assert header.count(f"#ifndef {macro}\n") == 1 and header.count(macro) == 3
        with pytest.raises(RuntimeError, match=macro):
            bench_backward.design_flags(header.replace(macro, "SC_OTHER"), knobs,
                                        variants[variant])
    assert bench_backward.parse_variants(f" {variant},package,{variant}", variants) == list(
        dict.fromkeys([variant, "package"]))
    with pytest.raises(ValueError, match="choose from"):
        bench_backward.parse_variants(f"{variant},no_such_variant", variants)
    with pytest.raises(ValueError, match="choose from"):
        bench_backward.parse_variants(",", variants)
    with pytest.raises(ValueError, match="choose from"):
        bench_backward.main(["--variants", "no_such_variant"])
    with pytest.raises(SystemExit, match="needs a CUDA GPU"):
        bench_backward.main(["--variants", variant, "--batch", "8"])


@pytest.mark.parametrize("make,why", [
    (lambda: (torch.zeros(2, 9, 288), None, torch.zeros(2, 2, 9), torch.zeros(2, 9, 96)),
     "head geometry"),  # hd 48; hd 128 f32 at L=80 now takes the key-tiled route
    (lambda: (torch.zeros(2, 9, 384), None, torch.zeros(2, 9, 2), torch.zeros(2, 9, 128)),
     "lse"),
    (lambda: (torch.zeros(2, 9, 384), None, torch.zeros(2, 2, 9), torch.zeros(2, 9, 64)),
     "g must be"),
    (lambda: (torch.zeros(2, 9, 384), None, torch.zeros(2, 2, 9, dtype=torch.float64),
              torch.zeros(2, 9, 128)), "lse"),
])
def test_backward_rejects_what_the_kernel_does_not_take(make, why):
    qkv, mask, lse, g = make()
    before = fused_attention_bwd.launches
    with pytest.raises(ValueError, match=why):
        fused_attention_bwd(qkv, mask, lse, g, 2)
    assert fused_attention_bwd.launches == before


def test_mask_gets_no_gradient():
    x = torch.zeros(2, 9, 128, requires_grad=True)
    mask = torch.from_numpy(_mask(9, True)).requires_grad_()
    out = QKVAttention.apply(x, torch.zeros(384, 128), torch.zeros(384), mask, 2)
    out.sum().backward()
    assert mask.grad is None and x.grad is not None
    qkv = torch.zeros(2, 9, 384, requires_grad=True)
    FusedAttention.apply(qkv, mask, 2).sum().backward()
    assert mask.grad is None and qkv.grad is not None


def test_recompute_backward_rejects_what_the_kernel_does_not_take():
    before = fused_attention_bwd_recompute.launches
    with pytest.raises(ValueError, match="head geometry"):  # hd 48
        fused_attention_bwd_recompute(torch.zeros(2, 9, 288), None, torch.zeros(2, 9, 96), 2)
    with pytest.raises(ValueError, match="g must be"):
        fused_attention_bwd_recompute(torch.zeros(2, 9, 384), None, torch.zeros(2, 9, 64), 2)
    assert fused_attention_bwd_recompute.launches == before


# ------------------------------------------------------------ JAX's routing

@pytest.mark.parametrize("L", [50, 77, 200])
def test_lse_ok_is_jax_rule(L):
    """The port's copy of ``_lse_ok`` (with ``_pick_block_b`` and
    ``_bwd_cap``) gives JAX's answer for every batch of 1..130."""
    for B in range(1, 131):
        assert lse_ok(B, L) == jfa._lse_ok(np.zeros((B, L, 3), np.float32), 1), B
    assert [B for B in range(1, 20) if not lse_ok(B, 50)] == [3, 5, 6, 7, 9, 10, 11, 12, 13, 14,
                                                              15, 17, 18, 19]


@pytest.mark.parametrize("B,L,D,H,causal", [(2, 17, 384, 3, False), (3, 9, 256, 8, True),
                                            (2, 50, 768, 12, False)])
def test_recompute_db_backward_matches_jax_kernel_f32(B, L, D, H, causal):
    """The recompute backward with db against ``_bwd_pallas3_db``
    (``_bwd_kernel3_db``) in interpret mode, its (3, B, L, D) cotangent and
    (n_groups, 3, lanes) bias gradient reordered to the port's layouts."""
    qkv, mask, g = _inputs(B * L + D + 3, B, L, D, causal)
    d3, db_raw = jfa._bwd_pallas3_db(jnp.asarray(qkv), _jmask(mask, L), jnp.asarray(g), H, True)
    want_dqkv = np.asarray(jnp.transpose(d3, (1, 2, 0, 3)).reshape(B, L, 3 * D))
    want_db = np.asarray(jnp.transpose(db_raw, (1, 0, 2)).reshape(-1))
    dqkv, db = fused_attention_bwd_recompute_db(_t(qkv), _t(mask), _t(g), H)
    assert dqkv.shape == qkv.shape and db.shape == (3 * D,) and db.dtype == torch.float32
    np.testing.assert_allclose(dqkv.numpy(), want_dqkv, atol=2e-5)
    np.testing.assert_allclose(db.numpy(), want_db, atol=2e-4)
    assert torch.equal(dqkv, fused_attention_bwd_recompute(_t(qkv), _t(mask), _t(g), H))


ROUTES = ("fused_attention", "fused_attention_lse", "fused_attention_bwd",
          "fused_attention_bwd_recompute_db", "fused_attention_bwd_recompute")


def _count_routes(monkeypatch):
    """Counts the calls of each attention wrapper that QKVAttention picks."""
    calls = dict.fromkeys(ROUTES, 0)

    def counted(name, fn):
        def wrapper(*a):
            calls[name] += 1
            return fn(*a)
        return wrapper

    for name in ROUTES:
        monkeypatch.setattr(pfa, name, counted(name, getattr(pfa, name)))
    return calls


def _qkv_attention_vs_jax(B, L, D, H, causal):
    """QKVAttention's context and its x, W, b gradients against jax.grad of
    ``qkv_attention`` with the interpret-mode kernels, at rtol/atol 1e-4."""
    rng = np.random.default_rng(B * L + D)
    din = D // 2 if D > 128 else D
    x = rng.normal(size=(B, L, din)).astype(np.float32)
    w = (rng.normal(size=(din, 3 * D)) * din ** -0.5).astype(np.float32)  # flax (in, out)
    b = (rng.normal(size=(3 * D,)) * 0.1).astype(np.float32)
    g = rng.normal(size=(B, L, D)).astype(np.float32)
    mask = _mask(L, causal)
    jm = None if mask is None else jnp.asarray(mask)

    def f(x_, w_, b_):
        return jnp.sum(jfa.qkv_attention(x_, w_, b_, jm, H, True) * g)

    want_out = np.asarray(jfa.qkv_attention(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                            jm, H, True))
    want = [np.asarray(t) for t in jax.grad(f, argnums=(0, 1, 2))(x, w, b)]
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(np.ascontiguousarray(w.T)).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    out = qkv_attention(tx, tw, tb, _t(mask), H)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=1e-5)
    for name, a, e in (("dx", tx.grad, want[0]), ("dW", tw.grad.t(), want[1]),
                       ("db", tb.grad, want[2])):
        np.testing.assert_allclose(a.numpy(), e, atol=1e-4, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("B,L,D,H,causal", [(3, 11, 128, 2, True), (3, 50, 768, 12, False),
                                            (12, 17, 384, 3, False), (12, 77, 512, 8, True)])
def test_qkv_attention_recompute_db_route_matches_jax(B, L, D, H, causal, monkeypatch):
    """At B = 3 and 12 JAX's forward saves no lse and its backward is
    ``_bwd_kernel3_db``: the port's forward is the inference kernel's and its
    backward the recompute-with-db kernel's, once each."""
    assert not lse_ok(B, L)
    calls = _count_routes(monkeypatch)
    _qkv_attention_vs_jax(B, L, D, H, causal)
    assert calls == {"fused_attention": 1, "fused_attention_lse": 0, "fused_attention_bwd": 0,
                     "fused_attention_bwd_recompute_db": 1, "fused_attention_bwd_recompute": 0}


@pytest.fixture
def bwd_fuse_none():
    """BWD_FUSE='none' in both packages for one test, restored after."""
    prev = jfa.BWD_FUSE, pfa.BWD_FUSE
    jfa.BWD_FUSE = pfa.BWD_FUSE = "none"
    yield
    jfa.BWD_FUSE, pfa.BWD_FUSE = prev


@pytest.mark.parametrize("B,L,D,H,causal", [(4, 11, 128, 2, True), (12, 17, 384, 3, False)])
def test_qkv_attention_bwd_fuse_none_matches_jax(B, L, D, H, causal, bwd_fuse_none,
                                                 monkeypatch):
    """Under BWD_FUSE='none' both backwards take the recompute, no-db kernel
    (``_bwd_kernel3``) whether or not the forward saved an lse, and db is
    the f32 sum of dqkv over (B, L)."""
    calls = _count_routes(monkeypatch)
    _qkv_attention_vs_jax(B, L, D, H, causal)
    saved = lse_ok(B, L)
    assert calls == {"fused_attention": int(not saved), "fused_attention_lse": int(saved),
                     "fused_attention_bwd": 0, "fused_attention_bwd_recompute_db": 0,
                     "fused_attention_bwd_recompute": 1}
