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

import tests.helpers.torch_threads  # noqa: F401  (xdist workers share the cores)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatial_clip_tpu.ops.fused_block import fused_block_attn as jax_fused_block_attn
from spatial_clip_tpu_torch import bench_block
from spatial_clip_tpu_torch.ops import fused_block as fb
from spatial_clip_tpu_torch.ops.fused_attention import fwd_smem_bytes, reference_attention

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
    # the image shape's bf16 bytes: the 1024-byte alignment, the A slabs (12
    # K-tiles of 64 rows x 128 B), two warpgroups' two 64 x 64 staging tiles,
    # 3 ring stages of 256 W rows x 64 columns, the 9 mbarriers
    assert fb.smem_bytes(50, 768, 12, torch.bfloat16) == (
        1024 + 12 * 64 * 128 + 2 * 2 * 8192 + 3 * 256 * 64 * 2 + 9 * 8)
    # an f32 shape's: normalized rows, 2 weight chunks, the product tile, the
    # head's q|k|v tile and the attention body's
    assert fb.smem_bytes(17, 256, 4, torch.float32) == (
        32 * 260 * 4 + 2 * 64 * 68 * 4 + 32 * 68 * 4 + fb._round_up(17 * 192 * 4)
        + 17 * 68 * 4 + 8 * 2 * (64 + 20) * 4)


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


def test_the_block_plan_mirrors_the_kernel_source():
    """``plan``'s constants are the kernel source's: the design constants'
    defaults (each a size ``bench_gemm`` also times another value of), the
    64-deep stages, 16-row boxes of x and the context, 128 rows a CTA at
    most, the 227 KB a block may take."""
    import re
    from pathlib import Path

    from spatial_clip_tpu_torch import bench_gemm

    src = (Path(fb.__file__).parents[1] / "csrc" / "fused_block.cu").read_text()
    for macro, value in (("SC_BLOCK_CLUSTER", fb.CLUSTER), ("SC_BLOCK_MAX_STAGES", fb.MAX_STAGES)):
        assert int(re.search(rf"#define {macro} (\d+)", src).group(1)) == value
    assert "constexpr int kDepth = 64;" in src and fb.DEPTH == 64
    assert "constexpr int kBoxRows = 16;" in src and fb.BOX_ROWS == 16
    assert "constexpr int kMaxSeq = 128;" in src and fb.MAX_SEQ == 128
    assert "constexpr int kThreads = kConsumers + 128;" in src and fb.WARPS == 12
    assert "constexpr size_t kMaxSmem = 232448;" in src
    knobs = bench_gemm.KNOBS["block"]
    assert set(knobs.values()) == {"SC_BLOCK_CLUSTER", "SC_BLOCK_MAX_STAGES"}
    tried = {k: {v[k] for v in bench_gemm.VARIANTS.values() if k in v} for k in knobs}
    assert {1, 4} <= tried["block_cluster"] and {2, 8} <= tried["block_stages"]
    assert bench_gemm.SHAPES["block"]["image_256"] == (256, 50, 768, 12, False)


def test_the_block_plan_keys_mirror_the_c_entry():
    """``PLAN_KEYS`` names, in order, the values ``sc_block_attn_plan``
    writes, so ``kernel_plan`` reads the plan the launch runs; ``plan``
    returns the same keys."""
    import re
    from pathlib import Path

    src = (Path(fb.__file__).parents[1] / "csrc" / "fused_block.cu").read_text()
    entry = src[src.index('extern "C" int sc_block_attn_plan'):]
    n, body = re.search(r"const int values\[(\d+)\] = \{([^}]*)\};", entry).groups()
    fields = [re.sub(r"^int\((.*)\)$", r"\1", f.strip()) for f in body.split(",")]
    names = ["cluster" if f == "blk::kCluster" else f.removeprefix("p.") for f in fields]
    assert int(n) == len(names) == len(fb.PLAN_KEYS)
    assert tuple(names) == fb.PLAN_KEYS
    assert f"for (int i = 0; i < {n}; ++i) plan[i] = values[i];" in entry
    assert tuple(fb.plan(77, 512, 8)) == fb.PLAN_KEYS


BLOCK_EDGE_LENGTHS = (1, 16, 17, 50, 63, 64, 65, 77, 128)


@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("L", BLOCK_EDGE_LENGTHS)
def test_block_plan_at_the_tiles_edges(L, hd):
    """At every width from 64 to 1024 the bf16 plan's tiles cover the CTA's
    sequence (its rows rounded up to 16, one or two m64 tiles), its passes
    cover every output column, the A region holds the slabs with the pad the
    last m64 tile reads past them and the attention body's space, and the
    ring has at least two stages within 227 KB wherever ``supported`` takes
    the geometry. ``supported`` takes every geometry the f32-staged design
    took (its shared memory formula, below), and every width at L <= 80."""
    for D in range(max(64, hd), 1025, 64):
        if D % hd:
            continue
        H = D // hd
        for cluster in (1, 2, 4):
            p = fb.plan(L, D, H, cluster=cluster)
            assert p["rp"] % 16 == 0 and L <= p["rp"] < L + 16 and p["rp"] <= 128
            assert (p["mt"] - 1) * 64 < p["rp"] <= p["mt"] * 64
            assert p["nc"] * p["mt"] == 256 and p["n_k"] * 64 == D
            assert p["qkv_passes"] * p["nc"] >= 3 * D > (p["qkv_passes"] - 1) * p["nc"]
            assert p["out_passes"] * p["nc"] >= D > (p["out_passes"] - 1) * p["nc"]
            boxes = max(p["nc"] // 64, cluster)
            assert p["box_rows"] * boxes == p["nc"] and p["box_rows"] % 16 == 0
            assert p["slab"] == p["rp"] * 128 and p["a_region"] % 1024 == 0
            assert p["a_region"] >= p["n_k"] * p["slab"] + p["mt"] * 8192 - p["slab"]
            body = fwd_smem_bytes(L, hd, torch.bfloat16)
            assert p["a_region"] >= p["head_groups"] * body
            fits = [g for g in (3, 2) if -(-L // 16) <= 12 // g and g * body <= p["a_region"]]
            assert p["head_groups"] == (fits[0] if fits else 1)
            assert 2 <= p["stages"] <= fb.MAX_STAGES and p["st_tiles"] in (1, 2)
            assert p["smem"] == (1024 + p["a_region"] + 2 * p["st_tiles"] * 8192
                                 + p["stages"] * p["stage_bytes"] + 8 * (2 * p["stages"] + 3))
        took = _staged_smem_bytes(L, D, H) <= fb.MAX_SMEM_BYTES
        if took or L <= 80:
            assert fb.supported(L, D, H, torch.bfloat16), (L, D, H)
        if fb.supported(L, D, H, torch.bfloat16):
            assert fb.smem_bytes(L, D, H, torch.bfloat16) <= fb.MAX_SMEM_BYTES


def _staged_smem_bytes(seq, width, heads):
    """The bf16 shared memory of the design before the wgmma one (normalized
    rows, two 64 x 64 weight chunks, an f32 product tile, the head's q|k|v
    tile, the CUDA-core body's space): what it took."""
    hd, lp = width // heads, (seq + 15) // 16 * 16
    r = fb._round_up
    total = (r(lp * (width + 8) * 2) + 2 * r(64 * 72 * 2) + r(lp * 68 * 4)
             + r(seq * 3 * hd * 2))
    return total + seq * (hd + 8) * 2 + 8 * 2 * (hd + (seq + 3) // 4 * 4) * 4


def test_block_plan_of_the_towers_and_its_weight_bytes():
    """The towers' plans: the image tower (L 50) one m64 tile of 256-column
    passes, 12 K stages a pass, 3 stages of 32 KB; the text tower (L 77) two
    m64 tiles over 80 rows in 128-column passes; the image tower runs three
    heads at once, the text tower two. Each CTA lands all of both weights,
    half of them from L2 in a cluster of two."""
    img = fb.plan(50, 768, 12)
    assert (img["mt"], img["nc"], img["n_k"], img["qkv_passes"], img["out_passes"],
            img["st_tiles"], img["stages"], img["stage_bytes"]) == (1, 256, 12, 9, 3, 2, 3, 32768)
    assert img["head_groups"] == 3 and fb.plan(77, 512, 8)["head_groups"] == 2
    txt = fb.plan(77, 512, 8)
    assert (txt["rp"], txt["mt"], txt["nc"], txt["qkv_passes"],
            txt["out_passes"]) == (80, 2, 128, 12, 4)
    assert fb.weight_bytes(img) == (4 * 768 * 768 * 2, 2 * 768 * 768 * 2)
    assert fb.weight_bytes(fb.plan(77, 512, 8, cluster=1)) == (4 * 512 * 512 * 2,) * 2


def test_split_workspace_views():
    """The bf16 kernel's workspace: q|k|v (B, L, 3D) then the context (B, L,
    D), contiguous views of one buffer, each 16-byte aligned when the buffer
    is."""
    B, L, D = 3, 5, 128
    ws = torch.arange(fb.workspace_numel(B, L, D), dtype=torch.float32)
    qkv, ctx = fb.split_workspace(ws, B, L, D)
    assert qkv.shape == (B, L, 3 * D) and ctx.shape == (B, L, D)
    assert qkv.is_contiguous() and ctx.is_contiguous()
    assert qkv.data_ptr() == ws.data_ptr() and ctx.data_ptr() % 16 == 0
    assert ctx.view(-1)[0].item() == B * L * 3 * D


def test_reference_block_attn_is_its_qkv_through_the_attention():
    """The plain version's q|k|v (``reference_block_qkv``) is what its
    attention reads: the f32 plain version is the JAX kernel's at the test's
    tolerance, and its qkv rounds once to x's dtype in bf16."""
    B, L, D, heads = 2, 9, 128, 2
    args = _port_args(*_inputs(B, L, D, seed=4, causal=True))
    qkv = fb.reference_block_qkv(*args[:5])
    ctx = reference_attention(qkv, args[7], heads)
    o = ctx.view(B * L, D) @ args[5].t() + args[6]
    np.testing.assert_allclose(fb.reference_block_attn(*args, heads).numpy(),
                               (args[0] + o.view(B, L, D)).numpy(), atol=1e-5, rtol=0)
    bf = [a.bfloat16() if a is not None and i in (0, 3, 5) else a for i, a in enumerate(args)]
    qb = fb.reference_block_qkv(*bf[:5])
    assert qb.dtype == torch.bfloat16 and qb.shape == (B, L, 3 * D)
