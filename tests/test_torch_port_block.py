"""The port's block-fused attention half (``ops.fused_block``) and its A/B
module (``bench_block``) against the JAX package.

On the CPU ``fused_block_attn`` runs its plain version,
``reference_block_attn``; the JAX kernel runs in Pallas interpret mode with
``block_cap=2``, as tests/test_fused_block.py runs it, at that test's three
shapes (a packed pair of sequences, a causal text-like block, a block of one
sequence). The same numpy inputs go to both; the port takes the weights in
its (out, in) layout, the transposes of JAX's.

Tolerances: f32 within 1e-4 absolute (f32 summation order through two
products and the attention; outputs are O(1) to O(10)); bf16 within one bf16
step (2^-8) of the output's largest magnitude (both round h, qkv, the context
and the output at the same points).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatial_clip_tpu.ops.fused_block import fused_block_attn as jax_fused_block_attn
from spatial_clip_tpu_torch import bench_block
from spatial_clip_tpu_torch.ops import fused_block as fb
from spatial_clip_tpu_torch.ops.fused_attention import reference_attention

SHAPES = [  # tests/test_fused_block.py:28-32: (B, L, D, heads), causal
    ((4, 8, 256, 4), False),
    ((4, 12, 128, 2), True),
    ((2, 16, 256, 4), False),
]


def _inputs(B, L, D, seed=0, causal=False):
    """tests/test_fused_block.py's draws: JAX layouts (w_qkv (D, 3D), w_out (D, D))."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, L, D)).astype(np.float32)
    lng = rng.normal(1, 0.1, (D,)).astype(np.float32)
    lnb = rng.normal(0, 0.1, (D,)).astype(np.float32)
    wqkv = rng.normal(0, D ** -0.5, (D, 3 * D)).astype(np.float32)
    bqkv = rng.normal(0, 0.02, (3 * D,)).astype(np.float32)
    wout = rng.normal(0, D ** -0.5, (D, D)).astype(np.float32)
    bout = rng.normal(0, 0.02, (D,)).astype(np.float32)
    mask = np.triu(np.full((L, L), -1e9, np.float32), 1) if causal else None
    return x, lng, lnb, wqkv, bqkv, wout, bout, mask


def _port_args(x, lng, lnb, wqkv, bqkv, wout, bout, mask):
    t = lambda a: None if a is None else torch.from_numpy(np.array(a))  # noqa: E731
    return (t(x), t(lng), t(lnb), t(wqkv.T), t(bqkv), t(wout.T), t(bout), t(mask))


@pytest.mark.parametrize("shape,causal", SHAPES)
def test_plain_version_matches_jax_kernel_f32(shape, causal):
    B, L, D, heads = shape
    args = _inputs(B, L, D, causal=causal)
    want = np.asarray(jax_fused_block_attn(*map(lambda a: None if a is None else jnp.asarray(a),
                                                args), heads, interpret=True, block_cap=2))
    before = fb.fused_block_attn.launches
    got = fb.fused_block_attn(*_port_args(*args), heads)
    assert fb.fused_block_attn.launches == before  # the CPU ran the plain version
    assert got.shape == (B, L, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    assert torch.equal(got, fb.reference_block_attn(*_port_args(*args), heads))


def test_plain_version_rounds_like_jax_kernel_bf16():
    """bf16 x and weights with f32 LayerNorm parameters and biases, as
    scripts/bench_block_kernel.py passes them: within one bf16 step of the
    largest output; a version that keeps qkv in f32 misses by more."""
    B, L, D, heads = 4, 12, 128, 2
    x, lng, lnb, wqkv, bqkv, wout, bout, mask = _inputs(B, L, D, seed=1, causal=True)
    jx, jwqkv, jwout = (jnp.asarray(a, jnp.bfloat16) for a in (x, wqkv, wout))
    want = np.asarray(jax_fused_block_attn(
        jx, jnp.asarray(lng), jnp.asarray(lnb), jwqkv, jnp.asarray(bqkv), jwout,
        jnp.asarray(bout), jnp.asarray(mask), heads, interpret=True, block_cap=2
    ).astype(jnp.float32))
    bf = [np.asarray(a.astype(jnp.float32)) for a in (jx, jwqkv, jwout)]
    args = _port_args(bf[0], lng, lnb, bf[1], bqkv, bf[2], bout, mask)
    args = (args[0].bfloat16(), *args[1:3], args[3].bfloat16(), args[4], args[5].bfloat16(),
            *args[6:])
    got = fb.fused_block_attn(*args, heads)
    assert got.dtype == torch.bfloat16
    tol = 2 ** -8 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)

    # the same math with qkv left in f32 lands further from the kernel
    xf, w_qkv, w_out = args[0].float(), args[3].float(), args[5].float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0)
    h = ((xf - mean) * torch.rsqrt(var + 1e-5) * args[1] + args[2]).bfloat16().float()
    qkv = h @ w_qkv.t() + args[4]
    ctx = reference_attention(qkv, args[7], heads).bfloat16().float()
    loose = xf + ctx @ w_out.t() + args[6]
    assert np.abs(loose.numpy() - want).max() > np.abs(got.float().numpy() - want).max()


def test_wrapper_checks_and_geometries():
    B, L, D, heads = 2, 8, 128, 2
    args = list(_port_args(*_inputs(B, L, D)))
    with pytest.raises(ValueError, match="w_qkv must be"):
        fb.fused_block_attn(*args[:3], args[3].t(), *args[4:], heads)
    with pytest.raises(ValueError, match="multiple of heads"):
        fb.fused_block_attn(*args, 3)
    with pytest.raises(ValueError, match="mask must be"):
        fb.fused_block_attn(*args[:7], torch.zeros(L + 1, L + 1), heads)
    with pytest.raises(ValueError, match="dtype"):
        fb.fused_block_attn(args[0].double(), *args[1:], heads)
    # the serving towers' geometries fit a block's shared memory, in bf16
    assert fb.supported(50, 768, 12, torch.bfloat16) and fb.supported(77, 512, 8, torch.bfloat16)
    assert fb.supported(17, 256, 4, torch.float32)
    assert not fb.supported(50, 768, 12, torch.float32)  # f32 rows of 768 do not fit
    assert not fb.supported(129, 512, 8, torch.bfloat16)  # L past 128
    assert not fb.supported(16, 96, 3, torch.bfloat16)  # width not a multiple of 64
    assert not fb.supported(16, 256, 16, torch.bfloat16)  # head dim 16
    # the image shape's bytes: normalized rows, 2 weight chunks, the product
    # tile, the head's q|k|v tile and the attention body's
    assert fb.smem_bytes(50, 768, 12, torch.bfloat16) == (
        64 * 776 * 2 + 2 * 64 * 72 * 2 + 64 * 68 * 4 + 50 * 192 * 2 + 50 * 72 * 2
        + 8 * 2 * (64 + 52) * 4)


def test_bench_block_draws_and_arms_agree():
    """bench_block's layers are the JAX script's draws transposed; on the
    CPU its two arms (plain versions) agree within its 0.05 limit over a
    12-layer chain in bf16; its entry points refuse to run without a GPU."""
    D = 128
    params = bench_block.layer_params(D, device="cpu")
    r = np.random.default_rng(3 + 1)
    lng, lnb = r.normal(1, 0.05, (D,)), r.normal(0, 0.05, (D,))
    wqkv = r.normal(0, D ** -0.5, (D, 3 * D))
    np.testing.assert_array_equal(params[3]["lng"].numpy(), lng.astype(np.float32))
    np.testing.assert_array_equal(params[3]["lnb"].numpy(), lnb.astype(np.float32))
    np.testing.assert_array_equal(params[3]["wqkv"].float().numpy(),
                                  torch.from_numpy(wqkv.T.astype(np.float32)).bfloat16().float())
    assert params[3]["wqkv"].shape == (3 * D, D) and params[3]["wqkv"].dtype == torch.bfloat16
    x0 = torch.from_numpy(np.random.default_rng(0).normal(0, 1, (2, 10, D)).astype(
        np.float32)).bfloat16()
    mask = torch.full((10, 10), -1e9).triu_(1)
    ys = []
    for layer in (bench_block.shipped_layer, bench_block.block_layer):
        x = x0
        for p in params:
            x = layer(x, p, mask, 2)
        ys.append(x.float())
    rel = ((ys[1] - ys[0]).abs().mean() / ys[0].abs().mean()).item()
    assert 0 < rel < bench_block.MAX_REL_DIFF
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="needs a CUDA GPU"):
            bench_block.main(["--tower", "text", "--rounds", "1"])
        with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
            bench_block.run_tower("image")
