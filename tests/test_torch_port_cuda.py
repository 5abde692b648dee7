"""The port on the card: the CUDA kernels against their plain PyTorch
versions, a tower and train steps (with the fused loss and gradient
accumulation too) on the card against the same on the CPU.

Needs an NVIDIA GPU with nvcc; skips without one. The tests directory's
conftest imports jax, which the GPU machine may lack, so run this file as

    python -m pytest tests/test_torch_port_cuda.py --noconftest -q
"""
from __future__ import annotations

import math
from ctypes import c_int as ctypes_int

import numpy as np
import pytest
import torch

from spatial_clip_tpu_torch import create_model
from spatial_clip_tpu_torch.models.transformer import causal_mask
from spatial_clip_tpu_torch.models.transforms import normalize_batch
from spatial_clip_tpu_torch.ops.fused_attention import fused_attention, reference_attention

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 plain versions in full f32
    return torch.device("cuda")


@pytest.mark.parametrize("B,L,D,H,causal,dtype,atol", [
    (64, 50, 768, 12, False, torch.bfloat16, 2e-2),
    (64, 77, 512, 8, True, torch.bfloat16, 2e-2),
    (4, 11, 128, 2, True, torch.float32, 1e-5),
    (3, 17, 384, 3, False, torch.float32, 1e-5),
    (2, 9, 256, 8, True, torch.float32, 1e-5),
    (2, 256, 256, 2, True, torch.float32, 1e-5),  # longest sequence, hd 128
    (2, 256, 256, 8, False, torch.bfloat16, 2e-2),
    (3, 1, 256, 4, False, torch.float32, 1e-5),
])
def test_kernel_matches_plain_version(device, B, L, D, H, causal, dtype, atol):
    gen = torch.Generator(device=device).manual_seed(B * L + D)
    qkv = torch.randn((B, L, 3 * D), generator=gen, device=device).to(dtype)
    mask = causal_mask(L, device=device) if causal else None
    before = fused_attention.launches
    out = fused_attention(qkv, mask, H)
    torch.cuda.synchronize()
    assert fused_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == (B, L, D) and torch.isfinite(out).all()
    ref = reference_attention(qkv, mask, H)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)


FWD_EDGE_LENGTHS = (1, 15, 16, 17, 50, 63, 64, 65, 77, 128, 129, 200, 256)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("L", FWD_EDGE_LENGTHS)
def test_bf16_forward_over_tile_edges(device, L, hd, causal):
    """The bf16 forward body (tensor cores; tiles of 16 query rows and 16
    keys, two passes over the keys) on each side of a tile edge and past 128
    keys, at each head dim: the context at chip_smoke phase 3's tolerance
    (2e-2), lse at phase 6's (1e-5 x max(1, |lse|)); with and without lse
    the same context, and the same bits on a rerun."""
    from spatial_clip_tpu_torch.ops.fused_attention import (
        fused_attention_lse,
        reference_attention_lse,
    )

    B, H = 3, 2
    gen = torch.Generator(device=device).manual_seed(L * hd + causal)
    qkv = torch.randn((B, L, 3 * H * hd), generator=gen, device=device).to(torch.bfloat16)
    mask = causal_mask(L, device=device) if causal else None
    out = fused_attention(qkv, mask, H)
    out_lse, lse = fused_attention_lse(qkv, mask, H)
    again = fused_attention(qkv, mask, H)
    torch.cuda.synchronize()
    want, want_lse = reference_attention_lse(qkv, mask, H)
    assert torch.equal(out, again) and torch.equal(out, out_lse)
    torch.testing.assert_close(out.float(), want.float(), rtol=0, atol=2e-2)
    torch.testing.assert_close(lse, want_lse, rtol=0,
                               atol=1e-5 * max(1.0, want_lse.abs().max().item()))


@pytest.mark.parametrize("hd", [64, 128])
def test_pair_and_layout_forwards_equal_standard_at_long_length(device, hd):
    """At L=200 (13 key chunks) the pair forward and the interleaved, slab,
    split and seq-major forwards give the standard launch's bits."""
    from spatial_clip_tpu_torch.ops import attention_pair as ap
    from spatial_clip_tpu_torch.ops import attention_variants as av

    B, L, H = 3, 200, 2
    D = H * hd
    gen = torch.Generator(device=device).manual_seed(hd)
    qkv = torch.randn((B, L, 3 * D), generator=gen, device=device).to(torch.bfloat16)
    qkv_b = torch.randn((B, 77, 3 * 512), generator=gen, device=device).to(torch.bfloat16)
    bias = (0.3 * torch.randn((3 * D,), generator=gen, device=device)).to(torch.bfloat16)
    mask = causal_mask(L, device=device)
    std = fused_attention(qkv, mask, H)
    oa, ob = ap.fused_attention_pair(qkv, mask, qkv_b, None, H, 8)
    perm = torch.tensor(av.interleave_perm(H, hd), device=device)
    q, k, v = (t.contiguous() for t in qkv.chunk(3, dim=-1))
    torch.cuda.synchronize()
    assert torch.equal(oa, std) and torch.equal(ob, fused_attention(qkv_b, None, 8))
    assert torch.equal(av.fused_attention_inter(qkv.index_select(-1, perm), mask, H), std)
    assert torch.equal(av.fused_attention_slab(qkv, mask, H), std)
    assert torch.equal(av.fused_attention_split_fwd(q, k, v, mask, H), std)
    assert torch.equal(av.fused_attention_t_fwd(qkv.transpose(0, 1), bias, mask, H),
                       fused_attention(qkv + bias, mask, H))


def test_fwd_smem_formula_matches_kernel(device):
    """``fwd_smem_bytes`` mirrors ``sc_attention_fwd_smem_bytes`` at every
    length the resident forward takes, up to ``fwd_max_seq`` (the same
    number as ``sc_attention_fwd_max_seq``), and the entry refuses the next."""
    from spatial_clip_tpu_torch.ops import cuda_build
    from spatial_clip_tpu_torch.ops.fused_attention import HEAD_DIMS, fwd_max_seq, fwd_smem_bytes

    lib = cuda_build.library()
    for hd in HEAD_DIMS:
        for dtype, code in cuda_build.DTYPE_CODES.items():
            longest = fwd_max_seq(hd, dtype)
            assert lib.sc_attention_fwd_max_seq(hd, code) == longest
            for L in range(1, longest + 1):
                assert lib.sc_attention_fwd_smem_bytes(L, hd, code) == fwd_smem_bytes(L, hd, dtype)
            assert lib.sc_attention_fwd_smem_bytes(longest + 1, hd, code) == 0


BWD_CASES = [  # B, L, D, H, causal, dtype: the training shapes, then hd 32 / 64 / 128
    (256, 50, 768, 12, False, torch.bfloat16),
    (256, 77, 512, 8, True, torch.bfloat16),
    (8, 50, 768, 12, False, torch.float32),
    (8, 77, 512, 8, True, torch.float32),
    (4, 11, 128, 2, True, torch.float32),
    (2, 17, 384, 3, False, torch.float32),
    (2, 9, 256, 8, True, torch.float32),
    (2, 72, 256, 2, True, torch.float32),  # the longest f32 hd 128 sequence taken
    (2, 166, 256, 4, True, torch.bfloat16),  # the CUDA-core body's longest bf16 hd 64
    (2, 122, 512, 4, False, torch.bfloat16),  # the CUDA-core body's longest bf16 hd 128
    (2, 256, 256, 4, True, torch.bfloat16),  # the longest bf16 hd 64 sequence taken
    (2, 192, 512, 4, False, torch.bfloat16),  # the longest bf16 hd 128 sequence taken
    (3, 1, 256, 4, False, torch.float32),  # one token, odd batch
]


def _tol(dtype, ref):
    """f32: summation order only. bf16: the kernel and its plain version
    round at the same points, so they differ where an f32 sum in another
    order lands on the other side of a bf16 rounding: one bf16 step (2^-8)
    of the largest magnitude in the output."""
    if dtype == torch.float32:
        return 2e-5 * max(1.0, ref.abs().max().item())
    return 2 ** -8 * ref.abs().max().item()


def _bwd_tol(dtype, ref):
    """The attention backwards' dqkv. f32: as _tol. bf16: one bf16 ulp at
    the largest magnitude, 2^(floor(log2 max|ref|) - 7): the tensor cores'
    f32 sums, in another order than cuBLAS's, land an element on the other
    side of a bf16 rounding, and near max|ref| that ulp exceeds 2^-8 max|ref|
    whenever max|ref| is just above a power of two."""
    if dtype == torch.float32:
        return _tol(dtype, ref)
    return 2.0 ** (math.floor(math.log2(ref.abs().max().item())) - 7)


@pytest.mark.parametrize("B,L,D,H,causal,dtype", BWD_CASES)
def test_lse_and_bwd_kernels_match_plain_version(device, B, L, D, H, causal, dtype):
    from spatial_clip_tpu_torch.ops.fused_attention import (
        fused_attention_bwd,
        fused_attention_lse,
        reference_attention_bwd,
        reference_attention_lse,
    )

    gen = torch.Generator(device=device).manual_seed(B * L + D)
    qkv = torch.randn((B, L, 3 * D), generator=gen, device=device).to(dtype)
    g = torch.randn((B, L, D), generator=gen, device=device).to(dtype)
    mask = causal_mask(L, device=device) if causal else None
    before = (fused_attention_lse.launches, fused_attention_bwd.launches)
    out, lse = fused_attention_lse(qkv, mask, H)
    dqkv, db = fused_attention_bwd(qkv, mask, lse, g, H)
    torch.cuda.synchronize()
    assert (fused_attention_lse.launches, fused_attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    want_out, want_lse = reference_attention_lse(qkv, mask, H)
    want_dqkv, want_db = reference_attention_bwd(qkv, mask, want_lse, g, H)
    torch.testing.assert_close(out.float(), want_out.float(), rtol=0,
                               atol=_tol(dtype, want_out.float()))
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-5)
    torch.testing.assert_close(dqkv.float(), want_dqkv.float(), rtol=0,
                               atol=_bwd_tol(dtype, want_dqkv.float()))
    torch.testing.assert_close(db, want_db, rtol=0, atol=_tol(dtype, want_db) + 1e-4)
    again, db_again = fused_attention_bwd(qkv, mask, lse, g, H)
    assert torch.equal(db, db_again) and torch.equal(dqkv, again)  # deterministic


@pytest.mark.parametrize("B,L,D,H,causal,dtype", BWD_CASES)
def test_recompute_bwd_kernel_matches_plain_version(device, B, L, D, H, causal, dtype):
    """The recompute backward (no saved lse, no db) against its plain
    version; the same bits on a second run."""
    from spatial_clip_tpu_torch.ops.fused_attention import (
        fused_attention_bwd_recompute,
        reference_attention_bwd,
    )

    gen = torch.Generator(device=device).manual_seed(B * L + D + 1)
    qkv = torch.randn((B, L, 3 * D), generator=gen, device=device).to(dtype)
    g = torch.randn((B, L, D), generator=gen, device=device).to(dtype)
    mask = causal_mask(L, device=device) if causal else None
    before = fused_attention_bwd_recompute.launches
    dqkv = fused_attention_bwd_recompute(qkv, mask, g, H)
    again = fused_attention_bwd_recompute(qkv, mask, g, H)
    torch.cuda.synchronize()
    assert fused_attention_bwd_recompute.launches == before + 2
    want = reference_attention_bwd(qkv, mask, None, g, H)[0]
    assert dqkv.dtype == dtype and dqkv.shape == qkv.shape
    torch.testing.assert_close(dqkv.float(), want.float(), rtol=0,
                               atol=_bwd_tol(dtype, want.float()))
    assert torch.equal(dqkv, again)


def test_bwd_smem_formula_matches_kernel(device):
    """``bwd_smem_bytes`` mirrors ``sc_attention_bwd_smem_bytes`` at every
    length up to one past ``bwd_max_seq`` (the same number as
    ``sc_attention_bwd_max_seq``) and head dim, for both bodies (the bf16
    tensor-core one: four 16-row-padded tiles, three f32 values a row, the
    tiles' db sums)."""
    from spatial_clip_tpu_torch.ops import cuda_build
    from spatial_clip_tpu_torch.ops.fused_attention import bwd_max_seq, bwd_smem_bytes

    lib = cuda_build.library()
    for hd in (32, 64, 128):
        for code, dtype in ((0, torch.float32), (1, torch.bfloat16)):
            longest = bwd_max_seq(hd, dtype)
            assert lib.sc_attention_bwd_max_seq(hd, code) == longest
            for L in range(1, longest + 2):
                assert lib.sc_attention_bwd_smem_bytes(L, hd, code) == bwd_smem_bytes(L, hd, dtype)


BWD_EDGE_LENGTHS = (1, 15, 16, 17, 50, 63, 64, 65, 77, 128, 129, "longest")


@pytest.mark.parametrize("option", ["lse_db", "recompute", "recompute_db"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("L", BWD_EDGE_LENGTHS)
def test_bf16_backward_over_tile_edges(device, L, hd, causal, option):
    """The bf16 backward body (tensor cores; 16-row query and key tiles, two
    passes, rows of up to kHold key chunks held) on each side of a tile edge
    and at the longest length it takes (``bwd_max_seq``), at each head dim,
    in each option:
    dqkv at _bwd_tol (one bf16 ulp at max|ref|), db at _tol + 1e-4 against
    the plain version on the same lse, and the same bits on a rerun."""
    from spatial_clip_tpu_torch.ops.fused_attention import (
        bwd_max_seq,
        fused_attention_bwd,
        fused_attention_bwd_recompute,
        fused_attention_bwd_recompute_db,
        fused_attention_lse,
        reference_attention_bwd,
    )

    B, H = 3, 2
    if L == "longest":  # the resident body's shared-memory limit: 640 / 352 / 192
        L = bwd_max_seq(hd, torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(L * hd + causal)
    qkv = torch.randn((B, L, 3 * H * hd), generator=gen, device=device).to(torch.bfloat16)
    g = torch.randn((B, L, H * hd), generator=gen, device=device).to(torch.bfloat16)
    mask = causal_mask(L, device=device) if causal else None
    lse = fused_attention_lse(qkv, mask, H)[1]
    run = {"lse_db": lambda: fused_attention_bwd(qkv, mask, lse, g, H),
           "recompute": lambda: (fused_attention_bwd_recompute(qkv, mask, g, H), None),
           "recompute_db": lambda: fused_attention_bwd_recompute_db(qkv, mask, g, H)}[option]
    (dqkv, db), (again, db_again) = run(), run()
    torch.cuda.synchronize()
    want, want_db = reference_attention_bwd(qkv, mask, lse if option == "lse_db" else None, g, H)
    assert torch.equal(dqkv, again) and torch.isfinite(dqkv.float()).all()
    torch.testing.assert_close(dqkv.float(), want.float(), rtol=0,
                               atol=_bwd_tol(torch.bfloat16, want.float()))
    if db is not None:
        assert torch.equal(db, db_again)
        torch.testing.assert_close(db, want_db, rtol=0,
                                   atol=_tol(torch.bfloat16, want_db) + 1e-4)


@pytest.mark.parametrize("hd", [64, 128])
def test_pair_layout_dx_backwards_equal_standard_at_long_length(device, hd):
    """At L=180 (12 key chunks, more than the block's 8 warps and than
    kHold) the pair backward (each tower in a block of the larger tower's
    warps), the interleaved, slab, split and seq-major backwards (the last
    with db within f32 tolerance) and the dx kernel's dqkv (8 warps, heads
    in turn) give the standard launches' bits."""
    from spatial_clip_tpu_torch.ops import attention_pair as ap
    from spatial_clip_tpu_torch.ops import attention_variants as av
    from spatial_clip_tpu_torch.ops.fused_attention import (
        fused_attention_bwd_recompute,
        fused_attention_bwd_recompute_db,
    )

    B, L, H = 3, 180, 2
    D = H * hd
    gen = torch.Generator(device=device).manual_seed(hd + 1)
    qkv = torch.randn((B, L, 3 * D), generator=gen, device=device).to(torch.bfloat16)
    g = torch.randn((B, L, D), generator=gen, device=device).to(torch.bfloat16)
    qkv_b = torch.randn((B, 77, 3 * 512), generator=gen, device=device).to(torch.bfloat16)
    g_b = torch.randn((B, 77, 512), generator=gen, device=device).to(torch.bfloat16)
    w = (0.05 * torch.randn((3 * D, 64), generator=gen, device=device)).to(torch.bfloat16)
    bias = (0.3 * torch.randn((3 * D,), generator=gen, device=device)).to(torch.bfloat16)
    mask = causal_mask(L, device=device)
    std = fused_attention_bwd_recompute(qkv, mask, g, H)
    std_db = fused_attention_bwd_recompute_db(qkv, mask, g, H)
    da, db_ = ap.fused_attention_pair_bwd(qkv_b, None, g_b, qkv, mask, g, 8, H)
    perm = torch.tensor(av.interleave_perm(H, hd), device=device)
    q, k, v = (t.contiguous() for t in qkv.chunk(3, dim=-1))
    dx_out = av.fused_attention_bwd_dx(qkv, mask, g, w, H)
    torch.cuda.synchronize()
    assert torch.equal(db_, std) and torch.equal(da, fused_attention_bwd_recompute(
        qkv_b, None, g_b, 8))
    assert torch.equal(av.fused_attention_inter_bwd(qkv.index_select(-1, perm), mask, g, H),
                       std.index_select(-1, perm))
    assert torch.equal(av.fused_attention_slab_bwd(qkv, mask, g, H), std)
    assert torch.equal(torch.cat(av.fused_attention_split_bwd(q, k, v, mask, g, H), -1), std)
    t_d, t_db = av.fused_attention_t_bwd(qkv.transpose(0, 1), bias, mask, g, H)
    with_b = fused_attention_bwd_recompute_db(qkv + bias, mask, g, H)
    assert torch.equal(t_d, with_b[0])
    torch.testing.assert_close(t_db, with_b[1], rtol=0, atol=_tol(torch.float32, with_b[1]) + 1e-4)
    assert torch.equal(dx_out[0], std_db[0])


def test_cuda_tensor_never_falls_back(device):
    with pytest.raises(ValueError, match="head geometry"):
        fused_attention(torch.zeros(2, 9, 96, device=device), None, 2)
    with pytest.raises(ValueError, match="mask"):
        fused_attention(torch.zeros(2, 9, 384, device=device), torch.zeros(9, 9), 2)
    shifted = torch.zeros(2 * 9 * 384 + 1, dtype=torch.bfloat16, device=device)[1:]
    with pytest.raises(ValueError, match="16-byte aligned"):
        fused_attention(shifted.view(2, 9, 384), None, 2)
    from spatial_clip_tpu_torch.ops.fused_attention import (
        fused_attention_bwd,
        fused_attention_bwd_recompute,
    )

    from spatial_clip_tpu_torch.ops import attention_long as al

    # hd 128 f32 at L=80, past the resident backward's 72: the key-tiled kernels
    before = (al.long_bwd_dq.launches, al.long_bwd_dkdv.launches, al.long_db.launches)
    fused_attention_bwd(torch.zeros(2, 80, 768, device=device), None,
                        torch.zeros(2, 2, 80, device=device),
                        torch.zeros(2, 80, 256, device=device), 2)
    fused_attention_bwd_recompute(torch.zeros(2, 80, 768, device=device), None,
                                  torch.zeros(2, 80, 256, device=device), 2)
    torch.cuda.synchronize()
    assert (al.long_bwd_dq.launches, al.long_bwd_dkdv.launches, al.long_db.launches) == (
        before[0] + 2, before[1] + 2, before[2] + 1)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fused_attention_bwd_recompute(shifted.view(2, 9, 384), None,
                                      torch.zeros(2, 9, 128, dtype=torch.bfloat16,
                                                  device=device), 2)
    from spatial_clip_tpu_torch.ops import attention_variants as av

    qkv = torch.zeros(2, 9, 384, dtype=torch.bfloat16, device=device)
    g = torch.zeros(2, 9, 128, dtype=torch.bfloat16, device=device)
    with pytest.raises(ValueError, match="on its device"):
        av.fused_attention_bwd_dx(qkv, None, g, torch.zeros(384, 128, dtype=torch.bfloat16), 2)
    with pytest.raises(ValueError, match="multiple of 16"):
        av.fused_attention_bwd_dx(qkv, None, g, torch.zeros(384, 24, dtype=torch.bfloat16,
                                                            device=device), 2)


def test_dx_bwd_failed_launch_raises(device, monkeypatch):
    """A dx launch the kernels' source refuses (a head dim it has no body
    for) raises; it never gives way to the plain version."""
    from spatial_clip_tpu_torch.ops import attention_variants as av

    qkv = torch.zeros(2, 9, 384, dtype=torch.bfloat16, device=device)
    g = torch.zeros(2, 9, 128, dtype=torch.bfloat16, device=device)
    w = torch.zeros(384, 128, dtype=torch.bfloat16, device=device)
    real = av._dims
    monkeypatch.setattr(av, "_dims", lambda *a: (lambda d: (*d[:3], 48, *d[4:]))(real(*a)))
    before = av.fused_attention_bwd_dx.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        av.fused_attention_bwd_dx(qkv, None, g, w, 2)
    assert av.fused_attention_bwd_dx.launches == before


def test_tower_on_card_matches_cpu(device):
    """Widened ViT-Test in f32: the card (kernel) against the CPU (plain)."""
    wide = dict(vision_cfg=dict(width=128, heads=2), text_cfg=dict(width=128, heads=2))
    cpu = create_model("ViT-Test", precision="fp32", device="cpu", **wide)
    gpu = create_model("ViT-Test", precision="fp32", device=device, **wide)
    u8 = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (3, 32, 32, 3), np.uint8))
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 512, (3, 16))).long()
    before = fused_attention.launches
    with torch.inference_mode():
        img = gpu.encode_image(normalize_batch(u8.to(device))).cpu()
        txt = gpu.encode_text(ids.to(device)).cpu()
        want_img = cpu.encode_image(normalize_batch(u8))
        want_txt = cpu.encode_text(ids)
    assert fused_attention.launches == before + 2 * 2  # 2 layers per tower
    torch.testing.assert_close(img, want_img, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(txt, want_txt, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", ["RN50", "xlm-roberta-base-ViT-B-32"])
def test_rn_and_hf_towers_in_bf16_on_card_match_cpu(device, name):
    """RN50 and xlm-roberta-base-ViT-B-32 (transformers' class defaults) in
    bf16 on the card against the same weights in f32 on the CPU: 4 tiles
    and 4 id rows inside the tower's vocab with pad tails, per-row cosine
    >= 0.99 for both towers."""
    from spatial_clip_tpu_torch.bench import hf_ids

    cpu = create_model(name, precision="fp32", device="cpu")
    gpu = create_model(name, precision="bf16", device=device)
    rng = np.random.default_rng(4)
    u8 = torch.from_numpy(rng.integers(0, 256, (4, 224, 224, 3), np.uint8))
    t = cpu.cfg.text_cfg
    vocab = cpu.text.vocab_size if cpu.hf_text else t.vocab_size
    ids = torch.from_numpy(hf_ids(rng, 4, t.context_length, vocab, t.pad_id))
    with torch.inference_mode():
        got = gpu(normalize_batch(u8.to(device), dtype=torch.bfloat16), ids.to(device))
        want = cpu(normalize_batch(u8), ids)
    for k in ("image_features", "text_features"):
        cos = (got[k].float().cpu() * want[k]).sum(-1)
        assert cos.min().item() >= 0.99, (k, cos)


def test_train_step_on_card_matches_cpu(device):
    """Widened ViT-Test in f32: two Trainer steps (lr is 0 at the first) on
    the card, through the training kernels, against the CPU's plain path.
    Loss and gradient norm at rtol 1e-4, parameters at atol 1e-5 (updates
    are ~1e-3), Adam moments (bf16) at rtol 2^-7 + 2e-3 of their largest
    entry."""
    from spatial_clip_tpu_torch.losses import make_loss
    from spatial_clip_tpu_torch.models.transforms import AugmentDraws
    from spatial_clip_tpu_torch.ops.fused_attention import fused_attention_bwd, fused_attention_lse
    from spatial_clip_tpu_torch.train.loop import Trainer, TrainerConfig

    wide = dict(vision_cfg=dict(width=128, heads=2), text_cfg=dict(width=128, heads=2))
    cfg = TrainerConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10, augment=True,
                        color_jitter=0.2, seed=0)
    rng = np.random.default_rng(5)
    B = 8
    batch = {
        "images": torch.from_numpy(rng.integers(0, 256, (B, 32, 32, 3), np.uint8)),
        "texts": torch.from_numpy(rng.integers(0, 512, (B, 16))),
        "image_tile_ids": torch.arange(B), "text_tile_ids": torch.arange(B),
        "neighbor_tile_ids": torch.from_numpy(rng.integers(-1, B, (B, 4))),
        "neighbor_alphas": torch.from_numpy(rng.uniform(0, 1, (B, 4)).astype(np.float32)),
    }
    draws = AugmentDraws(torch.from_numpy(rng.random(B) < 0.5),
                         torch.from_numpy(rng.uniform(0.8, 1.2, B).astype(np.float32)),
                         torch.from_numpy(rng.uniform(0.8, 1.2, B).astype(np.float32)))
    runs = {}
    for dev in ("cpu", device):
        trainer = Trainer(create_model("ViT-Test", precision="fp32", device=dev, training=True,
                                       **wide), make_loss("spatial", cap_logit_scale=50.0), cfg)
        state = trainer.init_state()
        before = (fused_attention_lse.launches, fused_attention_bwd.launches)
        metrics = []
        for _ in range(2):
            state, m = trainer.train_step(
                state, {k: v.to(dev) for k, v in batch.items()},
                AugmentDraws(*(d.to(dev) for d in draws)))
            metrics.append({k: float(v) for k, v in m.items()})
        launches = (fused_attention_lse.launches - before[0],
                    fused_attention_bwd.launches - before[1])
        runs[str(dev)] = (state, metrics, launches)
    (cpu_state, cpu_m, cpu_n), (gpu_state, gpu_m, gpu_n) = runs["cpu"], runs[str(device)]
    assert cpu_n == (0, 0) and gpu_n == (2 * 2 * 2, 2 * 2 * 2)  # 2 towers x 2 layers x 2 steps
    for want, got in zip(cpu_m, gpu_m):
        for k in ("loss", "grad_norm", "logit_scale"):
            assert got[k] == pytest.approx(want[k], rel=1e-4), k
    for k, want in cpu_state.params.items():
        torch.testing.assert_close(gpu_state.params[k].detach().cpu(), want.detach(),
                                   atol=1e-5, rtol=0)
        for name in ("mu", "nu"):
            w = getattr(cpu_state, name)[k].float()
            torch.testing.assert_close(getattr(gpu_state, name)[k].float().cpu(), w,
                                       rtol=2 ** -7, atol=2e-3 * w.abs().max().item())


# ------------------------------------------------ fused spatial cross-entropy

def _ce_inputs(device, B, N, D=512, k=6, seed=0):
    """The kernels' inputs as the loss builds them: unit rows, unique column
    ids but one duplicated, each row's own id (rows past N take random
    columns), neighbor ids from the column ids with a -1 share, weights in
    [0, 1), scale 50."""
    from spatial_clip_tpu_torch.ops.fused_contrastive import prepare_inputs

    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.nn.functional.normalize(torch.randn((B, D), generator=gen, device=device), dim=1)
    kmat = torch.nn.functional.normalize(torch.randn((N, D), generator=gen, device=device), dim=1)
    col_ids = torch.randperm(10 * N, generator=gen, device=device)[:N]
    col_ids[N // 2] = col_ids[0]
    gt = torch.arange(B, device=device) if B <= N else torch.randint(0, N, (B,), device=device)
    picks = col_ids[torch.randint(0, N, (B, k), generator=gen, device=device)]
    nbr = torch.where(torch.rand((B, k), generator=gen, device=device) < 0.8, picks, -1)
    alphas = torch.rand((B, k), generator=gen, device=device)
    return prepare_inputs(q, kmat, col_ids, gt, nbr, alphas, torch.tensor(50.0, device=device))


@pytest.mark.parametrize("B,N", [(1024, 1024), (2048, 2048), (1000, 1999), (5, 3)])
def test_spatial_ce_kernels_match_plain_versions(device, B, N):
    """Each kernel against its plain version on the same inputs, f32
    summation order only: loss, lse, mass within 1e-5 max(1, |ref|); dq, dK
    within 1e-5 max|ref| + 1e-7; dscale within 1e-4 relative. Each launch is
    counted once, and dq, dK and dscale are the same bits on a second run."""
    from spatial_clip_tpu_torch.ops import fused_contrastive as fc

    inputs = _ce_inputs(device, B, N)
    g = torch.full((B,), 1.0 / B, device=device)
    before = (fc.spatial_ce_fwd.launches, fc.spatial_ce_dq.launches, fc.spatial_ce_dk.launches)
    outs = fc.spatial_ce_fwd(*inputs)
    dq, ds = fc.spatial_ce_dq(*inputs, outs[1], outs[2], g)
    dk = fc.spatial_ce_dk(*inputs, outs[1], outs[2], g)
    torch.cuda.synchronize()
    assert (fc.spatial_ce_fwd.launches, fc.spatial_ce_dq.launches,
            fc.spatial_ce_dk.launches) == tuple(n + 1 for n in before)
    for got, want in zip(outs, fc.reference_spatial_ce_fwd(*inputs)):
        assert ((got - want).abs() <= 1e-5 * want.abs().clamp_min(1.0)).all()
    want_dq, want_ds = fc.reference_spatial_ce_dq(*inputs, outs[1], outs[2], g)
    want_dk = fc.reference_spatial_ce_dk(*inputs, outs[1], outs[2], g)
    for got, want in ((dq, want_dq), (dk, want_dk)):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * want.abs().max().item() + 1e-7)
    assert abs(ds.item() - want_ds.item()) <= 1e-4 * abs(want_ds.item())
    dq2, ds2 = fc.spatial_ce_dq(*inputs, outs[1], outs[2], g)
    dk2 = fc.spatial_ce_dk(*inputs, outs[1], outs[2], g)
    assert torch.equal(dq, dq2) and torch.equal(ds, ds2) and torch.equal(dk, dk2)


CE_EDGE_DIMS = (1, 65, 511, 513, 1536)
CE_EDGE_SIZES = ((1, 1), (63, 2049), (2049, 63))


@pytest.mark.parametrize("B,N", CE_EDGE_SIZES)
@pytest.mark.parametrize("D", CE_EDGE_DIMS)
def test_spatial_ce_kernel_edges(device, D, B, N):
    """The kernels at their edges: one column, an odd width, either side of
    one 512-column slice (no cluster, a cluster of 2), the widest D (a
    cluster of 3), B != N with tails past every tile and split, 0 and 16
    neighbors; phase 9's tolerances, dq, dK and dscale the same bits on a
    rerun. Each chain runs whole (the plain backward on the plain
    forward's lse and mass): at a row of one column the gradient is exactly
    0 in both."""
    from spatial_clip_tpu_torch.ops import fused_contrastive as fc

    for k in (0, 16):
        inputs = _ce_inputs(device, B, N, D=D, k=k, seed=D + k)
        g = torch.full((B,), 1.0 / B, device=device)
        outs = fc.spatial_ce_fwd(*inputs)
        dq, ds = fc.spatial_ce_dq(*inputs, outs[1], outs[2], g)
        dk = fc.spatial_ce_dk(*inputs, outs[1], outs[2], g)
        dq2, ds2 = fc.spatial_ce_dq(*inputs, outs[1], outs[2], g)
        dk2 = fc.spatial_ce_dk(*inputs, outs[1], outs[2], g)
        torch.cuda.synchronize()
        plain = fc.reference_spatial_ce_fwd(*inputs)
        for got, want in zip(outs, plain):
            assert ((got - want).abs() <= 1e-5 * want.abs().clamp_min(1.0)).all()
        want_dq, want_ds = fc.reference_spatial_ce_dq(*inputs, plain[1], plain[2], g)
        want_dk = fc.reference_spatial_ce_dk(*inputs, plain[1], plain[2], g)
        for got, want in ((dq, want_dq), (dk, want_dk)):
            torch.testing.assert_close(got, want, rtol=0,
                                       atol=1e-5 * want.abs().max().item() + 1e-7)
        assert abs(ds.item() - want_ds.item()) <= 1e-4 * abs(want_ds.item())
        assert torch.equal(dq, dq2) and torch.equal(ds, ds2) and torch.equal(dk, dk2)


def test_spatial_ce_plan_covers_every_tile(device):
    """Each entry's plan on this card is the one ``fc.plan`` mirrors at the
    resident CTAs the card reports (the CPU tests hold the mirror to cover
    every tile), at the main and edge shapes."""
    from spatial_clip_tpu_torch.ops import fused_contrastive as fc

    shapes = [(1024, 1024, 512), (2048, 2048, 512), (1000, 1999, 512)]
    shapes += [(B, N, D) for D in CE_EDGE_DIMS for B, N in CE_EDGE_SIZES]
    for B, N, D in shapes:
        for kind in (fc.FWD, fc.DQ, fc.DK):
            got = fc.kernel_plan(kind, B, N, D)
            assert got["resident"] >= 1
            assert got == fc.plan(kind, B, N, D, got["resident"]), (kind, B, N, D)


def test_spatial_ce_takes_its_widest_dim_and_refuses_wider(device):
    """At D = MAX_DIM the backward's cluster of three CTAs, each with the
    cluster's partial z, still fits a block's shared memory (the launch
    would fail otherwise)."""
    from spatial_clip_tpu_torch.ops import fused_contrastive as fc

    inputs = _ce_inputs(device, 40, 70, D=fc.MAX_DIM)
    loss, lse, mass = fc.spatial_ce_fwd(*inputs)
    g = torch.ones(40, device=device)
    dk = fc.spatial_ce_dk(*inputs, lse, mass, g)
    torch.testing.assert_close(dk, fc.reference_spatial_ce_dk(*inputs, lse, mass, g),
                               rtol=0, atol=1e-5 * dk.abs().max().item() + 1e-7)
    wide = _ce_inputs(device, 4, 4, D=fc.MAX_DIM + 1)
    with pytest.raises(ValueError, match="D <="):
        fc.spatial_ce_fwd(*wide)


def test_grad_accum_fused_step_on_card_matches_cpu(device):
    """Widened ViT-Test in f32, two Trainer steps with grad_accum=2 (cached)
    and the fused loss on the card, through the attention and loss
    kernels, against the CPU's plain path: loss and gradient norm at rtol
    1e-4, parameters at atol 1e-5. Per step on the card: 2 loss forwards,
    dq and dK launches per microbatch."""
    from spatial_clip_tpu_torch.losses import make_loss
    from spatial_clip_tpu_torch.ops import fused_contrastive as fc
    from spatial_clip_tpu_torch.train.loop import Trainer, TrainerConfig

    wide = dict(vision_cfg=dict(width=128, heads=2), text_cfg=dict(width=128, heads=2))
    cfg = TrainerConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10, augment=False,
                        seed=0, grad_accum=2)
    rng = np.random.default_rng(7)
    B = 8
    batch = {
        "images": torch.from_numpy(rng.integers(0, 256, (B, 32, 32, 3), np.uint8)),
        "texts": torch.from_numpy(rng.integers(0, 512, (B, 16))),
        "image_tile_ids": torch.arange(B), "text_tile_ids": torch.arange(B),
        "neighbor_tile_ids": torch.from_numpy(rng.integers(-1, B, (B, 4))),
        "neighbor_alphas": torch.from_numpy(rng.uniform(0, 1, (B, 4)).astype(np.float32)),
    }
    counters = (fc.spatial_ce_fwd, fc.spatial_ce_dq, fc.spatial_ce_dk)
    runs = {}
    for dev in ("cpu", device):
        trainer = Trainer(create_model("ViT-Test", precision="fp32", device=dev, training=True,
                                       **wide),
                          make_loss("spatial", cap_logit_scale=50.0, use_fused_kernel=True), cfg)
        state = trainer.init_state()
        before = [c.launches for c in counters]
        metrics = []
        for _ in range(2):
            state, m = trainer.train_step(state, {k: v.to(dev) for k, v in batch.items()})
            metrics.append({k: float(v) for k, v in m.items()})
        runs[str(dev)] = (state, metrics, [c.launches - b for c, b in zip(counters, before)])
    (cpu_state, cpu_m, cpu_n), (gpu_state, gpu_m, gpu_n) = runs["cpu"], runs[str(device)]
    assert cpu_n == [0, 0, 0] and gpu_n == [2 * 2 * 2] * 3  # 2 directions x 2 microbatches x 2 steps
    for want, got in zip(cpu_m, gpu_m):
        for k in ("loss", "grad_norm", "logit_scale"):
            assert got[k] == pytest.approx(want[k], rel=1e-4), k
    for k, want in cpu_state.params.items():
        torch.testing.assert_close(gpu_state.params[k].detach().cpu(), want.detach(),
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", ["fwd", "dq", "dk"])
def test_spatial_ce_entry_refuses_short_scratch(device, kind):
    """The kernels' source sizes each entry's scratch from its own split of
    the work; given one element less, the entry refuses to launch."""
    from spatial_clip_tpu_torch.ops import cuda_build
    from spatial_clip_tpu_torch.ops import fused_contrastive as fc

    B = N = 1024
    inputs = _ce_inputs(device, B, N)
    q, kmat = inputs[0], inputs[1]
    code = {"fwd": fc.FWD, "dq": fc.DQ, "dk": fc.DK}[kind]
    scratch = fc._scratch(code, q, kmat)
    assert scratch.numel() > 0  # B = N = 1024 splits the work on an H100
    lse, mass, g = torch.ones((3, B), device=device)
    out = {"fwd": (torch.empty((3, B), device=device).unbind(0), ()),
           "dq": ((lse, mass, g), (torch.empty_like(q), torch.empty((), device=device))),
           "dk": ((lse, mass, g), (torch.empty_like(kmat),))}[kind]
    before, after = ((), out[0]) if kind == "fwd" else out
    lib = cuda_build.library()
    err = getattr(lib, f"sc_spatial_ce_{kind}")(
        *(t.data_ptr() for t in (*inputs, *before)), scratch.data_ptr(), scratch.numel() - 1,
        *(t.data_ptr() for t in after), B, N, q.shape[1], inputs[4].shape[1],
        torch.cuda.current_stream().cuda_stream)
    assert err != 0


def test_spatial_ce_cuda_tensor_never_falls_back(device, monkeypatch):
    """A CUDA input never reaches a plain version: a CPU operand beside it
    is refused, and an entry whose launch the kernels' source refuses (here
    a short scratch, for the clustered backward entries too) raises."""
    from spatial_clip_tpu_torch.ops import fused_contrastive as fc

    q, kmat, col_ids, gt, nbr, alphas, scale = _ce_inputs(device, 8, 8)
    with pytest.raises(ValueError, match="on cuda"):
        fc.spatial_ce_fwd(q, kmat.cpu(), col_ids, gt, nbr, alphas, scale)
    inputs = _ce_inputs(device, 64, 96, D=768)  # a cluster of 2
    loss, lse, mass = fc.spatial_ce_fwd(*inputs)
    g = torch.ones(64, device=device)
    for entry in (fc.spatial_ce_dq, fc.spatial_ce_dk):
        with pytest.raises(ValueError, match="on cuda"):
            entry(*inputs, lse.cpu(), mass, g)
    monkeypatch.setattr(fc, "_scratch",
                        lambda kind, q, kmat: torch.empty((0,), device=q.device))
    for entry in (fc.spatial_ce_dq, fc.spatial_ce_dk):
        before = entry.launches
        with pytest.raises(RuntimeError, match="CUDA error"):
            entry(*inputs, lse, mass, g)
        assert entry.launches == before


# ------------------------------------------------------- the LayerNorm kernels

@pytest.mark.parametrize("R,D,dtype", [
    (256 * 50, 768, torch.bfloat16), (256 * 77, 512, torch.bfloat16),
    (1001, 384, torch.float32), (77, 128, torch.bfloat16), (3, 1024, torch.float32),
])
def test_fused_ln_kernels_match_plain_versions(device, R, D, dtype):
    """Forward and backward against their plain versions, ragged rows
    included; dgamma/dbeta (f32 sums over the rows) at 1e-5 of their
    largest entry and the same bits on a second run."""
    from spatial_clip_tpu_torch.ops import fused_ln as fl

    gen = torch.Generator(device=device).manual_seed(R + D)
    x = (torch.randn((R, D), generator=gen, device=device) * 2 + 0.5).to(dtype)
    gamma = 1 + 0.1 * torch.randn((D,), generator=gen, device=device)
    beta = 0.1 * torch.randn((D,), generator=gen, device=device)
    dy = torch.randn((R, D), generator=gen, device=device).to(dtype)
    before = (fl.fused_ln_fwd.launches, fl.fused_ln_bwd.launches)
    y = fl.fused_ln_fwd(x, gamma, beta, 1e-5)
    dx, dg, db = fl.fused_ln_bwd(x, gamma, dy, 1e-5)
    dx2, dg2, db2 = fl.fused_ln_bwd(x, gamma, dy, 1e-5)
    torch.cuda.synchronize()
    assert (fl.fused_ln_fwd.launches, fl.fused_ln_bwd.launches) == (before[0] + 1, before[1] + 2)
    assert torch.equal(dg, dg2) and torch.equal(db, db2) and torch.equal(dx, dx2)
    want_y = fl.reference_ln_fwd(x, gamma, beta, 1e-5)
    want_dx, want_dg, want_db = fl.reference_ln_bwd(x, gamma, dy, 1e-5)
    assert y.dtype == dx.dtype == dtype
    for got, want, tol in ((y, want_y, _tol(dtype, want_y.float())),
                           (dx, want_dx, _tol(dtype, want_dx.float())),
                           (dg, want_dg, 1e-5 * want_dg.abs().max().item()),
                           (db, want_db, 1e-5 * want_db.abs().max().item())):
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)


@pytest.mark.parametrize("R,K,N,dtype", [
    (256 * 50, 768, 3072, torch.bfloat16), (256 * 50, 768, 2304, torch.bfloat16),
    (256 * 77, 512, 2048, torch.bfloat16), (256 * 77, 512, 1536, torch.bfloat16),
    (1000, 512, 1408, torch.bfloat16),
    (77, 128, 384, torch.bfloat16),
    (333, 256, 384, torch.float32), (5, 1024, 128, torch.float32),
])
def test_ln_dense_kernels_match_plain_versions(device, R, K, N, dtype):
    """Forward (y, xhat) and dx against their plain versions, with the
    products computed in the kernel; ragged rows included."""
    from spatial_clip_tpu_torch.ops import fused_ln_dense as fd

    gen = torch.Generator(device=device).manual_seed(R + K + N)
    x = (torch.randn((R, K), generator=gen, device=device) * 2 + 0.5).to(dtype)
    gamma = 1 + 0.1 * torch.randn((K,), generator=gen, device=device)
    beta = 0.1 * torch.randn((K,), generator=gen, device=device)
    weight = torch.randn((N, K), generator=gen, device=device) / K ** 0.5
    bias = 0.1 * torch.randn((N,), generator=gen, device=device)
    g = torch.randn((R, N), generator=gen, device=device).to(dtype)
    w1, b1 = fd._fold(gamma, beta, weight, bias, dtype)
    before = (fd.ln_dense_fwd.launches, fd.ln_dense_bwd_dx.launches)
    y, xhat = fd.ln_dense_fwd(x, w1, b1, 1e-5)
    dx = fd.ln_dense_bwd_dx(x, g, w1, 1e-5)
    torch.cuda.synchronize()
    assert (fd.ln_dense_fwd.launches, fd.ln_dense_bwd_dx.launches) == (before[0] + 1,
                                                                       before[1] + 1)
    want_y, want_xhat = fd.reference_ln_dense_fwd(x, w1, b1, 1e-5)
    want_dx = fd.reference_ln_dense_bwd_dx(x, g, w1, 1e-5)
    for got, want in ((y, want_y), (xhat, want_xhat), (dx, want_dx)):
        assert got.dtype == dtype and got.shape == want.shape
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=_tol(dtype, want.float()))


TILE_EDGE_ROWS = (1, 63, 64, 65, 127, 128, 129, 255, 257, 1000)


@pytest.mark.parametrize("R", TILE_EDGE_ROWS)
@pytest.mark.parametrize("K,N", [(128, 384), (256, 128), (512, 1408), (768, 1152), (1024, 640)])
def test_ln_dense_fwd_tile_edges(device, R, K, N):
    """The bf16 forward (wgmma, 64-row CTAs in clusters of two, 256-column
    output tiles) at every edge of the row tile and of the cluster, each
    width it takes to 1024, and N past a whole number of column tiles:
    y and xhat within one bf16 step of the plain version, the same bits on
    a rerun, one launch on the wgmma route each."""
    from spatial_clip_tpu_torch.ops import fused_ln_dense as fd

    gen = torch.Generator(device=device).manual_seed(R * 7 + K + N)
    x = (torch.randn((R, K), generator=gen, device=device) * 2 + 0.5).bfloat16()
    gamma = 1 + 0.1 * torch.randn((K,), generator=gen, device=device)
    beta = 0.1 * torch.randn((K,), generator=gen, device=device)
    weight = torch.randn((N, K), generator=gen, device=device) / K ** 0.5
    bias = 0.1 * torch.randn((N,), generator=gen, device=device)
    w1, b1 = fd._fold(gamma, beta, weight, bias, torch.bfloat16)
    before = (fd.ln_dense_fwd.launches, fd.ln_dense_fwd.routes["tc"])
    y, xhat = fd.ln_dense_fwd(x, w1, b1, 1e-5)
    y2, xhat2 = fd.ln_dense_fwd(x, w1, b1, 1e-5)
    torch.cuda.synchronize()
    assert (fd.ln_dense_fwd.launches, fd.ln_dense_fwd.routes["tc"]) == (before[0] + 2,
                                                                       before[1] + 2)
    assert torch.equal(y, y2) and torch.equal(xhat, xhat2)
    want_y, want_xhat = fd.reference_ln_dense_fwd(x, w1, b1, 1e-5)
    for got, want in ((y, want_y), (xhat, want_xhat)):
        assert got.shape == want.shape and torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=_tol(torch.bfloat16, want.float()))


def test_ln_dense_fwd_plan_covers_every_tile(device):
    """The forward's plan: its units are the row pairs times the 256-column
    tiles, its persistent grid one cluster of two a unit up to one CTA an
    SM, and each consumer's ring 3 stages deep or more up to K 768 (2 at K
    1024)."""
    from spatial_clip_tpu_torch.ops import fused_ln_dense as fd

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for R, K, N in ((256 * 50, 768, 3072), (256 * 77, 512, 1536), (1, 128, 128),
                    (1000, 1024, 1152)):
        plan = fd.ln_dense_fwd_plan(R, K, N)
        pairs = -(-(-(-R // 64)) // plan["cluster"])
        assert plan["units"] == pairs * -(-N // 256)
        assert plan["clusters"] == min(sms // plan["cluster"], plan["units"])
        assert plan["ctas"] == plan["clusters"] * plan["cluster"]
        assert plan["stages"] >= (3 if K <= 768 else 2)


@pytest.mark.parametrize("R", TILE_EDGE_ROWS)
@pytest.mark.parametrize("K", range(128, 1025, 128))
def test_ln_dense_bwd_dx_tile_edges(device, R, K):
    """The bf16 dx (wgmma; K-groups of 1, 2 or 4 CTAs owning 128 rows, up to
    3 units of 128 columns a CTA) at every edge of the row tile and of the
    cluster and every K it takes, N of 3 to 5 g tiles: within one bf16
    step of the plain version, the same bits on a rerun, one launch on the
    wgmma route each."""
    from spatial_clip_tpu_torch.ops import fused_ln_dense as fd

    N = 384 + 128 * (K // 128 % 3)
    gen = torch.Generator(device=device).manual_seed(R * 11 + K)
    x = (torch.randn((R, K), generator=gen, device=device) * 2 + 0.5).bfloat16()
    g = torch.randn((R, N), generator=gen, device=device).bfloat16()
    w1 = (torch.randn((N, K), generator=gen, device=device) / K ** 0.5).bfloat16()
    before = (fd.ln_dense_bwd_dx.launches, fd.ln_dense_bwd_dx.routes["tc"])
    dx = fd.ln_dense_bwd_dx(x, g, w1, 1e-5)
    dx2 = fd.ln_dense_bwd_dx(x, g, w1, 1e-5)
    torch.cuda.synchronize()
    assert (fd.ln_dense_bwd_dx.launches, fd.ln_dense_bwd_dx.routes["tc"]) == (before[0] + 2,
                                                                             before[1] + 2)
    assert torch.equal(dx, dx2)
    want = fd.reference_ln_dense_bwd_dx(x, g, w1, 1e-5)
    assert dx.shape == want.shape and torch.isfinite(dx).all()
    torch.testing.assert_close(dx.float(), want.float(), rtol=0,
                               atol=_tol(torch.bfloat16, want.float()))


def test_ln_dense_bwd_dx_plan_covers_every_tile(device):
    """The dx's plan: a 128-row tile a K-group of dx_k_parts(K) CTAs, up to
    3 units of 128 columns a CTA, K-groups along the rows in clusters of at
    most 8 CTAs, and a W' ring of 4 stages or more (x lands in four)."""
    from spatial_clip_tpu_torch.ops import fused_ln_dense as fd

    for R, K, N in ((256 * 50, 768, 3072), (256 * 77, 512, 1536), (1, 128, 128),
                    (1000, 1024, 1152), (300, 384, 256), (257, 640, 384), (129, 896, 128)):
        plan = fd.ln_dense_bwd_dx_plan(R, K, N)
        assert plan["row_tiles"] == -(-R // fd.DX_ROW_TILE)
        assert plan["k_parts"] == fd.dx_k_parts(K)
        assert plan["cluster"] % plan["k_parts"] == 0 and plan["cluster"] <= 8
        groups = plan["cluster"] // plan["k_parts"]
        assert plan["clusters"] == -(-plan["row_tiles"] // groups)
        assert plan["ctas"] == plan["clusters"] * plan["cluster"]
        assert plan["units"] <= 3 and plan["units"] * plan["k_parts"] >= K // 128
        assert plan["stages"] >= 4


@pytest.mark.parametrize("R", [1, 9, 1000, 4225, 33797])
@pytest.mark.parametrize("D,dtype", [(768, torch.bfloat16), (1024, torch.bfloat16),
                                     (384, torch.float32), (1024, torch.float32)])
def test_fused_ln_fwd_over_the_persistent_walk(device, R, D, dtype):
    """The fused LayerNorm forward's persistent grid (one wave of warps, each
    walking rows r, r + W, ... with the next row's loads in flight) at row
    counts below, near and many times one wave: within tolerance of the
    plain version, the same bits on a rerun, one launch each."""
    from spatial_clip_tpu_torch.ops import fused_ln as fl

    gen = torch.Generator(device=device).manual_seed(R + D)
    x = (torch.randn((R, D), generator=gen, device=device) * 2 + 0.5).to(dtype)
    gamma = 1 + 0.1 * torch.randn((D,), generator=gen, device=device)
    beta = 0.1 * torch.randn((D,), generator=gen, device=device)
    before = fl.fused_ln_fwd.launches
    y = fl.fused_ln_fwd(x, gamma, beta, 1e-5)
    y2 = fl.fused_ln_fwd(x, gamma, beta, 1e-5)
    torch.cuda.synchronize()
    assert fl.fused_ln_fwd.launches == before + 2
    assert torch.equal(y, y2) and y.dtype == dtype
    want = fl.reference_ln_fwd(x, gamma, beta, 1e-5)
    torch.testing.assert_close(y.float(), want.float(), rtol=0, atol=_tol(dtype, want.float()))


def test_ln_kernels_refuse_what_they_do_not_take(device):
    from spatial_clip_tpu_torch.ops import fused_ln as fl
    from spatial_clip_tpu_torch.ops import fused_ln_dense as fd

    ones = torch.ones(1152, device=device)
    with pytest.raises(ValueError, match="width 1152"):
        fl.fused_ln_fwd(torch.zeros(4, 1152, device=device), ones, ones, 1e-5)
    with pytest.raises(ValueError, match="width 96"):
        fl.fused_ln_bwd(torch.zeros(4, 96, device=device), ones[:96], torch.zeros(4, 96,
                                                                                device=device), 1e-5)
    shifted = torch.zeros(4 * 128 + 1, dtype=torch.bfloat16, device=device)[1:].view(4, 128)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fl.fused_ln_fwd(shifted, ones[:128], ones[:128], 1e-5)
    with pytest.raises(ValueError, match="K=1152"):
        fd.ln_dense_fwd(torch.zeros(4, 1152, device=device), torch.zeros(128, 1152, device=device),
                        torch.zeros(128, device=device), 1e-5)
    with pytest.raises(ValueError, match="N=200"):
        fd.ln_dense_bwd_dx(torch.zeros(4, 128, device=device), torch.zeros(4, 200, device=device),
                           torch.zeros(200, 128, device=device), 1e-5)


@pytest.mark.parametrize("setting,launches", [
    (dict(ln_impl="pallas"), (11, 11, 0, 0, 0)),
    (dict(ln_gemm_impl="pallas", attn_impl="pallas"), (0, 0, 8, 8, 4)),
])
def test_ln_settings_on_card_match_cpu(device, setting, launches):
    """Widened ViT-Test in f32 under each fused LayerNorm setting: loss and
    gradients of one forward+backward on the card (the kernels) against the
    CPU (plain versions), at rtol 1e-4 / atol 1e-5 + 1e-4 of each
    gradient's largest entry, with exact launch counts (fused_ln fwd, bwd,
    fused_ln_dense fwd, dx, recompute attention backward)."""
    from spatial_clip_tpu_torch.losses import make_loss
    from spatial_clip_tpu_torch.ops import fused_ln as fl
    from spatial_clip_tpu_torch.ops import fused_ln_dense as fd
    from spatial_clip_tpu_torch.ops.fused_attention import fused_attention_bwd_recompute

    wide = dict(vision_cfg=dict(width=128, heads=2), text_cfg=dict(width=128, heads=2))
    rng = np.random.default_rng(7)
    B = 4
    u8 = torch.from_numpy(rng.integers(0, 256, (B, 32, 32, 3), np.uint8))
    ids = torch.from_numpy(rng.integers(0, 512, (B, 16)))
    spatial = dict(image_tile_ids=torch.arange(B), text_tile_ids=torch.arange(B),
                   neighbor_tile_ids=torch.from_numpy(rng.integers(-1, B, (B, 4))),
                   neighbor_alphas=torch.from_numpy(rng.uniform(0, 1, (B, 4)).astype(np.float32)))
    loss_fn = make_loss("spatial", cap_logit_scale=50.0)
    runs = {}
    counters = (fl.fused_ln_fwd, fl.fused_ln_bwd, fd.ln_dense_fwd, fd.ln_dense_bwd_dx,
                fused_attention_bwd_recompute)
    for dev in ("cpu", device):
        model = create_model("ViT-Test", precision="fp32", device=dev, training=True, **wide,
                             **setting)
        for c in counters:
            c.launches = 0
        feats = model(normalize_batch(u8.to(dev)), ids.to(dev))
        loss = loss_fn(**feats, **{k: v.to(dev) for k, v in spatial.items()})["contrastive_loss"]
        loss.backward()
        torch.cuda.synchronize()
        runs[str(dev)] = (loss.item(), {k: p.grad.cpu() for k, p in model.named_parameters()},
                          tuple(c.launches for c in counters))
    (loss_cpu, g_cpu, n_cpu), (loss_gpu, g_gpu, n_gpu) = runs["cpu"], runs[str(device)]
    assert n_cpu == (0,) * 5 and n_gpu == launches
    assert loss_gpu == pytest.approx(loss_cpu, rel=1e-4)
    for k, w in g_cpu.items():
        torch.testing.assert_close(g_gpu[k], w, rtol=1e-4,
                                   atol=1e-5 + 1e-4 * w.abs().max().item(), msg=k)


# ------------------------------- the recompute-with-db backward and its routes

@pytest.mark.parametrize("B,L,D,H,causal,dtype", BWD_CASES)
def test_recompute_db_bwd_kernel_matches_plain_version(device, B, L, D, H, causal, dtype):
    """The recompute backward with db against its plain version; db the same
    bits on a second run, and dqkv the no-db option's bits."""
    from spatial_clip_tpu_torch.ops.fused_attention import (
        fused_attention_bwd_recompute,
        fused_attention_bwd_recompute_db,
        reference_attention_bwd,
    )

    gen = torch.Generator(device=device).manual_seed(B * L + D + 2)
    qkv = torch.randn((B, L, 3 * D), generator=gen, device=device).to(dtype)
    g = torch.randn((B, L, D), generator=gen, device=device).to(dtype)
    mask = causal_mask(L, device=device) if causal else None
    before = fused_attention_bwd_recompute_db.launches
    dqkv, db = fused_attention_bwd_recompute_db(qkv, mask, g, H)
    again, db_again = fused_attention_bwd_recompute_db(qkv, mask, g, H)
    torch.cuda.synchronize()
    assert fused_attention_bwd_recompute_db.launches == before + 2
    want, want_db = reference_attention_bwd(qkv, mask, None, g, H)
    assert dqkv.dtype == dtype and db.dtype == torch.float32 and db.shape == (3 * D,)
    torch.testing.assert_close(dqkv.float(), want.float(), rtol=0,
                               atol=_bwd_tol(dtype, want.float()))
    torch.testing.assert_close(db, want_db, rtol=0, atol=_tol(dtype, want_db) + 1e-4)
    assert torch.equal(db, db_again) and torch.equal(dqkv, again)
    assert torch.equal(dqkv, fused_attention_bwd_recompute(qkv, mask, g, H))


@pytest.mark.parametrize("B,fuse,launches", [
    (8, "db", (0, 1, 1, 0, 0, 0)), (12, "db", (1, 0, 0, 1, 0, 0)),
    (8, "none", (0, 1, 0, 0, 1, 0)), (12, "none", (1, 0, 0, 0, 1, 0)),
    (8, "dxdb", (0, 1, 0, 0, 0, 1)), (12, "dxdb", (1, 0, 0, 0, 0, 1)),
])
def test_qkv_attention_routes_on_card(device, B, fuse, launches, monkeypatch):
    """QKVAttention in f32 on the card against the CPU: JAX's routing by
    batch (lse saved at 8, not at 12) and BWD_FUSE, with exact launches of
    (inference fwd, fwd_lse, bwd, recompute-with-db bwd, recompute bwd, dx
    bwd); context at 1e-5, dx / dW / db at rtol/atol 1e-4."""
    from spatial_clip_tpu_torch.ops import attention_variants as av
    from spatial_clip_tpu_torch.ops import fused_attention as fa

    monkeypatch.setattr(fa, "BWD_FUSE", fuse)
    rng = np.random.default_rng(B)
    L, D, H = 50, 768, 12
    host = [torch.from_numpy(a) for a in (
        rng.normal(size=(B, L, 384)).astype(np.float32),
        (rng.normal(size=(3 * D, 384)) * 384 ** -0.5).astype(np.float32),
        (rng.normal(size=(3 * D,)) * 0.1).astype(np.float32),
        rng.normal(size=(B, L, D)).astype(np.float32))]
    counters = (fa.fused_attention, fa.fused_attention_lse, fa.fused_attention_bwd,
                fa.fused_attention_bwd_recompute_db, fa.fused_attention_bwd_recompute,
                av.fused_attention_bwd_dx)
    runs = {}
    for dev in ("cpu", device):
        x, w, b = (t.clone().to(dev).requires_grad_() for t in host[:3])
        before = [c.launches for c in counters]
        out = fa.qkv_attention(x, w, b, None, H)
        (out * host[3].to(dev)).sum().backward()
        torch.cuda.synchronize()
        runs[str(dev)] = ([t.detach().cpu() for t in (out, x.grad, w.grad, b.grad)],
                          tuple(c.launches - n for c, n in zip(counters, before)))
    (want, n_cpu), (got, n_gpu) = runs["cpu"], runs[str(device)]
    assert n_cpu == (0,) * 6 and n_gpu == launches
    torch.testing.assert_close(got[0], want[0], atol=1e-5, rtol=0)
    for a, e in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, e, atol=1e-4, rtol=1e-4)


# The dx backward: the towers at batch 256 (Din = width), f32 hd 128 and 32,
# and the longest bf16 hd 64 sequence (two row passes) with a Din that leaves
# part of a 128-column block idle.
DX_CASES = [(*BWD_CASES[i], din) for i, din in ((0, 768), (1, 512), (5, 192), (6, 96),
                                                (8, 80))]


@pytest.mark.parametrize("B,L,D,H,causal,dtype,din", DX_CASES)
def test_dx_bwd_kernel_matches_plain_version(device, B, L, D, H, causal, dtype, din):
    """The dx backward against its plain version: dqkv and db as the other
    backward entries, dx at one bf16 step (ulp) at its largest magnitude, as
    the block kernel's test (f32: 1e-4 x max(1, |ref|), the CPU tests' dx
    tolerance); dqkv the
    recompute-with-db launch's bits and db within f32 tolerance of its db;
    the same bits on a second run."""
    from spatial_clip_tpu_torch.ops.attention_variants import (
        fused_attention_bwd_dx,
        reference_attention_bwd_dx,
    )
    from spatial_clip_tpu_torch.ops.fused_attention import fused_attention_bwd_recompute_db

    gen = torch.Generator(device=device).manual_seed(B * L + D + din)
    qkv = torch.randn((B, L, 3 * D), generator=gen, device=device).to(dtype)
    g = torch.randn((B, L, D), generator=gen, device=device).to(dtype)
    w = (torch.randn((3 * D, din), generator=gen, device=device) * din ** -0.5).to(dtype)
    mask = causal_mask(L, device=device) if causal else None
    before = fused_attention_bwd_dx.launches
    got = fused_attention_bwd_dx(qkv, mask, g, w, H)
    again = fused_attention_bwd_dx(qkv, mask, g, w, H)
    torch.cuda.synchronize()
    assert fused_attention_bwd_dx.launches == before + 2
    dqkv, dx, db = got
    want_dqkv, want_dx, want_db = reference_attention_bwd_dx(qkv, mask, g, w, H)
    assert dx.dtype == dtype and dx.shape == (B, L, din) and torch.isfinite(dx).all()
    torch.testing.assert_close(dqkv.float(), want_dqkv.float(), rtol=0,
                               atol=_bwd_tol(dtype, want_dqkv.float()))
    torch.testing.assert_close(db, want_db, rtol=0, atol=_tol(dtype, want_db) + 1e-4)
    peak = want_dx.float().abs().max().item()
    dx_tol = (1e-4 * max(1.0, peak) if dtype == torch.float32
              else 2.0 ** (math.floor(math.log2(peak)) - 7))
    torch.testing.assert_close(dx.float(), want_dx.float(), rtol=0, atol=dx_tol)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    rd_dqkv, rd_db = fused_attention_bwd_recompute_db(qkv, mask, g, H)
    assert torch.equal(dqkv, rd_dqkv)
    torch.testing.assert_close(db, rd_db, rtol=0, atol=_tol(torch.float32, rd_db) + 1e-4)


DX_EDGE_LENGTHS = (1, 15, 16, 17, 50, 63, 64, 65, 77, 128, 129, 200, 256)
DX_EDGE_BATCHES = (1, 2, 3, 5, 257)
DX_EDGE_DINS = (16, 48, 80, 112, 144, 512, 768, 1024)


@pytest.mark.parametrize("L", DX_EDGE_LENGTHS)
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_dx_bwd_kernel_tile_edges(device, hd, L):
    """The bf16 dx kernel at its product's edges (the 64-row tiles and
    128-row groups, 128 / 256-column passes, 64-deep K stages, clusters of
    2 sequences with a batch not a multiple of them): causal and not, with
    B, Din and 1-3 heads cycling through their edges; dx within one bf16
    ulp at max|ref| of the plain version, dqkv the recompute-with-db
    launch's bits, db within f32 tolerance of its db, the same bits on a
    rerun."""
    from spatial_clip_tpu_torch.ops import attention_variants as av
    from spatial_clip_tpu_torch.ops.fused_attention import fused_attention_bwd_recompute_db

    i = DX_EDGE_LENGTHS.index(L) + 13 * (hd // 64)
    for causal in (False, True):
        i += 1
        B, din, H = DX_EDGE_BATCHES[i % 5], DX_EDGE_DINS[i % 8], 1 + i % 3
        if not av.dx_supported(H, H * hd, L, din, torch.bfloat16):
            continue
        D = H * hd
        gen = torch.Generator(device=device).manual_seed(i)
        qkv = torch.randn((B, L, 3 * D), generator=gen, device=device).bfloat16()
        g = torch.randn((B, L, D), generator=gen, device=device).bfloat16()
        w = (torch.randn((3 * D, din), generator=gen, device=device) * din ** -0.5).bfloat16()
        mask = causal_mask(L, device=device) if causal else None
        got = av.fused_attention_bwd_dx(qkv, mask, g, w, H)
        again = av.fused_attention_bwd_dx(qkv, mask, g, w, H)
        want = av.reference_attention_bwd_dx(qkv, mask, g, w, H)
        rd_dqkv, rd_db = fused_attention_bwd_recompute_db(qkv, mask, g, H)
        torch.cuda.synchronize()
        assert got[1].shape == (B, L, din) and torch.isfinite(got[1].float()).all()
        torch.testing.assert_close(got[1].float(), want[1].float(), rtol=0,
                                   atol=_bwd_tol(torch.bfloat16, want[1].float()))
        assert torch.equal(got[0], rd_dqkv)
        torch.testing.assert_close(got[2], rd_db, rtol=0,
                                   atol=_tol(torch.float32, rd_db) + 1e-4)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_dx_bwd_plan_covers_every_tile(device):
    """The bf16 launch's plan is the one ``dx_plan`` mirrors (which the CPU
    tests hold to cover every tile) at every edge geometry it takes."""
    from spatial_clip_tpu_torch.ops import attention_variants as av

    for hd in (32, 64, 128):
        for L in DX_EDGE_LENGTHS:
            for H, din in ((1, 16), (3, 144), (12, 768), (8, 512)):
                if av.dx_supported(H, H * hd, L, din, torch.bfloat16):
                    assert av.dx_kernel_plan(L, H, hd, din) == av.dx_plan(L, H, hd, din)


# ------------------------------------------------------------- the fused MLP

@pytest.mark.parametrize("R,W,H,dtype", [
    (256 * 50, 768, 3072, torch.bfloat16), (256 * 77, 512, 2048, torch.bfloat16),
    (64 * 50, 768, 3072, torch.bfloat16), (64 * 77, 512, 2048, torch.bfloat16),
    (1000, 768, 3072, torch.bfloat16), (77, 1024, 4096, torch.bfloat16),
    (40, 2048, 512, torch.bfloat16), (100, 640, 576, torch.bfloat16),
    (333, 256, 1024, torch.float32),
    (5, 128, 512, torch.float32), (40, 2048, 512, torch.float32),
])
def test_fused_mlp_kernel_matches_plain_version(device, R, W, H, dtype):
    """The forward against its plain version with f32 parameters cast per
    use, as a training model holds them: the image and text towers' MLP at
    batch 256 and 64, a ragged R, widths cut into column splits (1024,
    2048), and f32 on the CUDA cores; one launch each, the same bits on a
    rerun."""
    from spatial_clip_tpu_torch.ops import fused_mlp as fm

    gen = torch.Generator(device=device).manual_seed(R + W + H)
    x = torch.randn((R, W), generator=gen, device=device).to(dtype)
    fc_w = torch.randn((H, W), generator=gen, device=device) / W ** 0.5
    fc_b = 0.1 * torch.randn((H,), generator=gen, device=device)
    proj_w = torch.randn((W, H), generator=gen, device=device) / H ** 0.5
    proj_b = 0.1 * torch.randn((W,), generator=gen, device=device)
    before = fm.fused_mlp_fwd.launches
    out = fm.fused_mlp_fwd(x, fc_w, fc_b, proj_w, proj_b)
    again = fm.fused_mlp_fwd(x, fc_w, fc_b, proj_w, proj_b)
    torch.cuda.synchronize()
    assert fm.fused_mlp_fwd.launches == before + 2
    want = fm.reference_mlp_fwd(x, fc_w, fc_b, proj_w, proj_b)
    assert out.dtype == dtype and out.shape == (R, W) and torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), want.float(), rtol=0, atol=_tol(dtype, want.float()))
    assert torch.equal(out, again)


@pytest.mark.parametrize("R", TILE_EDGE_ROWS)
@pytest.mark.parametrize("W,H", [(128, 512), (256, 1024), (512, 2048), (768, 1536), (1024, 512),
                                 (2048, 1024)])
def test_fused_mlp_tile_edges(device, R, W, H):
    """The bf16 forward (wgmma, 64-row CTAs in clusters of two, 128-column
    output blocks) at every edge of the row tile and of the cluster, each
    width it takes (2048: x streamed through the ring), hidden sizes that
    are multiples of 512: within one bf16 step
    of the plain version, the same bits on a rerun, each launch counted on
    its route."""
    from spatial_clip_tpu_torch.ops import fused_mlp as fm

    gen = torch.Generator(device=device).manual_seed(R * 11 + W + H)
    x = torch.randn((R, W), generator=gen, device=device).bfloat16()
    w1 = (torch.randn((H, W), generator=gen, device=device) / W ** 0.5).bfloat16()
    b1 = (0.1 * torch.randn((H,), generator=gen, device=device)).bfloat16()
    w2 = (torch.randn((W, H), generator=gen, device=device) / H ** 0.5).bfloat16()
    b2 = (0.1 * torch.randn((W,), generator=gen, device=device)).bfloat16()
    route = "x_resident" if W <= fm.X_RESIDENT_WIDTH else "x_streamed"
    before = (fm.fused_mlp_fwd.launches, fm.fused_mlp_fwd.routes[route])
    out = fm.fused_mlp_fwd(x, w1, b1, w2, b2)
    again = fm.fused_mlp_fwd(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert (fm.fused_mlp_fwd.launches, fm.fused_mlp_fwd.routes[route]) == (before[0] + 2,
                                                                           before[1] + 2)
    assert fm.mlp_plan(R, W, H)["x_resident"] == (route == "x_resident")
    assert torch.equal(out, again)
    want = fm.reference_mlp_fwd(x, w1, b1, w2, b2)
    assert out.shape == (R, W) and torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), want.float(), rtol=0,
                               atol=_tol(torch.bfloat16, want.float()))


def test_fused_mlp_refuses_what_it_does_not_take(device):
    from spatial_clip_tpu_torch.ops import fused_mlp as fm

    def args(R, W, H, dtype=torch.bfloat16):
        return (torch.zeros(R, W, dtype=dtype, device=device),
                torch.zeros(H, W, device=device), torch.zeros(H, device=device),
                torch.zeros(W, H, device=device), torch.zeros(W, device=device))

    before = fm.fused_mlp_fwd.launches
    with pytest.raises(ValueError, match="W=2176"):
        fm.fused_mlp_fwd(*args(4, 2176, 512))
    with pytest.raises(ValueError, match="H=96"):
        fm.fused_mlp_fwd(*args(4, 128, 96))
    shifted = torch.zeros(4 * 128 + 1, dtype=torch.bfloat16, device=device)[1:].view(4, 128)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fm.fused_mlp_fwd(shifted, *args(4, 128, 512)[1:])
    assert fm.fused_mlp_fwd.launches == before


def test_mlp_pallas_on_card_matches_cpu(device):
    """Widened ViT-Test in f32 under mlp_impl='pallas': loss and gradients of
    one forward+backward on the card (the fused MLP kernel) against the CPU
    (its plain version), at rtol 1e-4 / atol 1e-5 + 1e-4 of each gradient's
    largest entry; one fused_mlp launch per block (2 + 2)."""
    from spatial_clip_tpu_torch.losses import make_loss
    from spatial_clip_tpu_torch.ops import fused_mlp as fm

    wide = dict(vision_cfg=dict(width=128, heads=2), text_cfg=dict(width=128, heads=2))
    rng = np.random.default_rng(8)
    B = 4
    u8 = torch.from_numpy(rng.integers(0, 256, (B, 32, 32, 3), np.uint8))
    ids = torch.from_numpy(rng.integers(0, 512, (B, 16)))
    spatial = dict(image_tile_ids=torch.arange(B), text_tile_ids=torch.arange(B),
                   neighbor_tile_ids=torch.from_numpy(rng.integers(-1, B, (B, 4))),
                   neighbor_alphas=torch.from_numpy(rng.uniform(0, 1, (B, 4)).astype(np.float32)))
    loss_fn = make_loss("spatial", cap_logit_scale=50.0)
    runs = {}
    for dev in ("cpu", device):
        model = create_model("ViT-Test", precision="fp32", device=dev, training=True, **wide,
                             mlp_impl="pallas")
        before = fm.fused_mlp_fwd.launches
        feats = model(normalize_batch(u8.to(dev)), ids.to(dev))
        loss = loss_fn(**feats, **{k: v.to(dev) for k, v in spatial.items()})["contrastive_loss"]
        loss.backward()
        torch.cuda.synchronize()
        runs[str(dev)] = (loss.item(), {k: p.grad.cpu() for k, p in model.named_parameters()},
                          fm.fused_mlp_fwd.launches - before)
    (loss_cpu, g_cpu, n_cpu), (loss_gpu, g_gpu, n_gpu) = runs["cpu"], runs[str(device)]
    assert n_cpu == 0 and n_gpu == 4
    assert loss_gpu == pytest.approx(loss_cpu, rel=1e-4)
    for k, w in g_cpu.items():
        torch.testing.assert_close(g_gpu[k], w, rtol=1e-4,
                                   atol=1e-5 + 1e-4 * w.abs().max().item(), msg=k)


PAIR_CASES = [  # (B, La, Da, Ha, Lb, Db, Hb, dtype): the ViT-B-32 towers, unequal head dims
    (64, 50, 768, 12, 77, 512, 8, torch.bfloat16),
    (256, 50, 768, 12, 77, 512, 8, torch.bfloat16),
    (3, 17, 256, 2, 26, 128, 4, torch.float32),  # hd 128 with hd 32
    (4, 26, 384, 12, 17, 256, 2, torch.bfloat16),  # hd 32 with hd 128
]


@pytest.mark.parametrize("B,La,Da,Ha,Lb,Db,Hb,dtype", PAIR_CASES)
def test_pair_kernels_equal_single_tower_launches(device, B, La, Da, Ha, Lb, Db, Hb, dtype):
    """The pair forward and backward give each tower exactly the bits of its
    single-tower launch (the inference forward; the recompute backward
    without db), one launch each way; and they agree with the plain
    versions."""
    from spatial_clip_tpu_torch.ops import attention_pair as ap
    from spatial_clip_tpu_torch.ops.fused_attention import fused_attention_bwd_recompute

    gen = torch.Generator(device=device).manual_seed(B + La + Lb)
    qa = torch.randn((B, La, 3 * Da), generator=gen, device=device).to(dtype)
    qb = torch.randn((B, Lb, 3 * Db), generator=gen, device=device).to(dtype)
    ga = torch.randn((B, La, Da), generator=gen, device=device).to(dtype)
    gb = torch.randn((B, Lb, Db), generator=gen, device=device).to(dtype)
    mb = causal_mask(Lb, device=device)
    before = (ap.fused_attention_pair.launches, ap.fused_attention_pair_bwd.launches)
    oa, ob = ap.fused_attention_pair(qa, None, qb, mb, Ha, Hb)
    da, db = ap.fused_attention_pair_bwd(qa, None, ga, qb, mb, gb, Ha, Hb)
    torch.cuda.synchronize()
    assert (ap.fused_attention_pair.launches, ap.fused_attention_pair_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(oa, fused_attention(qa, None, Ha))
    assert torch.equal(ob, fused_attention(qb, mb, Hb))
    assert torch.equal(da, fused_attention_bwd_recompute(qa, None, ga, Ha))
    assert torch.equal(db, fused_attention_bwd_recompute(qb, mb, gb, Hb))
    want = (*ap.reference_attention_pair(qa, None, qb, mb, Ha, Hb),
            *ap.reference_attention_pair_bwd(qa, None, ga, qb, mb, gb, Ha, Hb))
    for got, ref, tol in zip((oa, ob, da, db), want, (_tol, _tol, _bwd_tol, _bwd_tol)):
        torch.testing.assert_close(got.float(), ref.float(), rtol=0, atol=tol(dtype, ref.float()))


def test_zipped_tower_on_card_matches_cpu(device):
    """Widened ViT-Test in f32 under zip_towers='on': loss and gradients of
    one forward+backward on the card (the pair kernels) against the CPU
    (their plain versions), rtol 1e-4 / atol 1e-5 + 1e-4 of each gradient's
    largest entry; one pair launch per layer each way (2 + 2), no
    single-tower attention launch."""
    from spatial_clip_tpu_torch.losses import make_loss
    from spatial_clip_tpu_torch.ops import attention_pair as ap
    from spatial_clip_tpu_torch.ops import fused_attention as fa

    wide = dict(vision_cfg=dict(width=128, heads=2), text_cfg=dict(width=128, heads=2))
    rng = np.random.default_rng(9)
    B = 4
    u8 = torch.from_numpy(rng.integers(0, 256, (B, 32, 32, 3), np.uint8))
    ids = torch.from_numpy(rng.integers(0, 512, (B, 16)))
    spatial = dict(image_tile_ids=torch.arange(B), text_tile_ids=torch.arange(B),
                   neighbor_tile_ids=torch.from_numpy(rng.integers(-1, B, (B, 4))),
                   neighbor_alphas=torch.from_numpy(rng.uniform(0, 1, (B, 4)).astype(np.float32)))
    loss_fn = make_loss("spatial", cap_logit_scale=50.0)
    counters = (ap.fused_attention_pair, ap.fused_attention_pair_bwd, fa.fused_attention,
                fa.fused_attention_lse, fa.fused_attention_bwd, fa.fused_attention_bwd_recompute,
                fa.fused_attention_bwd_recompute_db)
    runs = {}
    for dev in ("cpu", device):
        model = create_model("ViT-Test", precision="fp32", device=dev, training=True, **wide,
                             zip_towers="on")
        before = [c.launches for c in counters]
        feats = model(normalize_batch(u8.to(dev)), ids.to(dev))
        loss = loss_fn(**feats, **{k: v.to(dev) for k, v in spatial.items()})["contrastive_loss"]
        loss.backward()
        torch.cuda.synchronize()
        runs[str(dev)] = (loss.item(), {k: p.grad.cpu() for k, p in model.named_parameters()},
                          [c.launches - n for c, n in zip(counters, before)])
    (loss_cpu, g_cpu, n_cpu), (loss_gpu, g_gpu, n_gpu) = runs["cpu"], runs[str(device)]
    assert n_cpu == [0] * 7 and n_gpu == [2, 2, 0, 0, 0, 0, 0]
    assert loss_gpu == pytest.approx(loss_cpu, rel=1e-4)
    for k, w in g_cpu.items():
        torch.testing.assert_close(g_gpu[k], w, rtol=1e-4,
                                   atol=1e-5 + 1e-4 * w.abs().max().item(), msg=k)


BLOCK_CASES = [  # B, L, D, heads, causal, dtype
    (64, 50, 768, 12, False, torch.bfloat16),
    (64, 77, 512, 8, True, torch.bfloat16),
    (3, 17, 256, 4, False, torch.float32),
    (2, 26, 384, 12, True, torch.bfloat16),  # hd 32: a half-filled qkv pass
    (2, 33, 512, 4, False, torch.float32),  # hd 128
    (3, 77, 1024, 32, True, torch.bfloat16),  # one staging tile a warpgroup, two-stage ring
]


@pytest.mark.parametrize("B,L,D,H,causal,dtype", BLOCK_CASES)
def test_block_kernel_matches_plain_version(device, B, L, D, H, causal, dtype):
    """fused_block_attn against reference_block_attn, one launch, the same
    bits on a rerun. f32: 2e-5 max(1, |ref|). bf16: one bf16 step (ulp) at
    the largest output magnitude: the kernel and the plain version round h,
    qkv, the context and the output at the same points, so an f32 sum in
    another order flips an output's last bit at most, and outputs near the
    largest (the residual stream, up to ~5) have steps of 2^-5."""
    from spatial_clip_tpu_torch.ops import fused_block as fb

    gen = torch.Generator(device=device).manual_seed(B * L + D)
    x = torch.randn((B, L, D), generator=gen, device=device).to(dtype)
    args = (x, 1 + 0.05 * torch.randn((D,), generator=gen, device=device),
            0.05 * torch.randn((D,), generator=gen, device=device),
            (torch.randn((3 * D, D), generator=gen, device=device) / D ** 0.5).to(dtype),
            0.02 * torch.randn((3 * D,), generator=gen, device=device),
            (torch.randn((D, D), generator=gen, device=device) / D ** 0.5).to(dtype),
            0.02 * torch.randn((D,), generator=gen, device=device),
            causal_mask(L, device=device) if causal else None)
    before = fb.fused_block_attn.launches
    with torch.no_grad():
        out = fb.fused_block_attn(*args, H)
        again = fb.fused_block_attn(*args, H)
    torch.cuda.synchronize()
    assert fb.fused_block_attn.launches == before + 2
    assert out.dtype == dtype and out.shape == (B, L, D) and torch.isfinite(out).all()
    assert torch.equal(out, again)
    ref = fb.reference_block_attn(*args, H).float()
    peak = ref.abs().max().item()
    tol = (2e-5 * max(1.0, peak) if dtype == torch.float32
           else 2.0 ** (math.floor(math.log2(peak)) - 7))
    torch.testing.assert_close(out.float(), ref, rtol=0, atol=tol)
    with pytest.raises(NotImplementedError, match="forward only"):
        fb.fused_block_attn(x.detach().requires_grad_(), *args[1:], H)


def test_block_smem_formula_matches_kernel(device):
    """fused_block.smem_bytes mirrors sc_block_attn_smem_bytes at the towers'
    geometries and at the limits supported() draws."""
    from spatial_clip_tpu_torch.ops import cuda_build
    from spatial_clip_tpu_torch.ops import fused_block as fb

    lib = cuda_build.library()
    for L, D, H in ((50, 768, 12), (77, 512, 8), (17, 256, 4), (26, 384, 12), (33, 512, 4),
                    (128, 256, 2), (1, 1024, 8)):
        for dtype, code in cuda_build.DTYPE_CODES.items():
            assert fb.smem_bytes(L, D, H, dtype) == lib.sc_block_attn_smem_bytes(L, D, H, code)


BLOCK_EDGE_LENGTHS = (1, 16, 17, 50, 63, 64, 65, 77, 128)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("L", BLOCK_EDGE_LENGTHS)
def test_bf16_block_kernel_over_its_tiles_edges(device, L, hd, causal):
    """The bf16 block half (wgmma products, the tensor-core attention body)
    at the 16-row boxes' and the m64 tiles' edges, a width from 128 to 1024
    and a batch of 1, 3 or 257 (past a cluster) in turn: within one bf16 ulp
    at max|ref| of the plain version, the same bits on a rerun; the
    workspace's q|k|v within one ulp of the plain version's and each head's
    context sc_attention_fwd's bits on it."""
    from spatial_clip_tpu_torch.ops import fused_block as fb

    i = BLOCK_EDGE_LENGTHS.index(L) * 6 + (hd // 32).bit_length() * 2 + causal
    D = 128 * (1 + i % 8)
    while not fb.supported(L, D, D // hd, torch.bfloat16):
        D -= 128
    B = (1, 3, 257)[i % 3] if D <= 512 else (1, 3)[i % 2]
    H = D // hd
    gen = torch.Generator(device=device).manual_seed(i)
    x = torch.randn((B, L, D), generator=gen, device=device).bfloat16()
    args = (x, 1 + 0.05 * torch.randn((D,), generator=gen, device=device),
            0.05 * torch.randn((D,), generator=gen, device=device),
            (torch.randn((3 * D, D), generator=gen, device=device) / D ** 0.5).bfloat16(),
            0.02 * torch.randn((3 * D,), generator=gen, device=device),
            (torch.randn((D, D), generator=gen, device=device) / D ** 0.5).bfloat16(),
            0.02 * torch.randn((D,), generator=gen, device=device))
    mask = causal_mask(L, device=device) if causal else None
    ws = torch.empty((fb.workspace_numel(B, L, D),), dtype=torch.bfloat16, device=device)
    with torch.no_grad():
        out = fb.fused_block_attn(*args, mask, H, workspace=ws)
        again = fb.fused_block_attn(*args, mask, H)
    torch.cuda.synchronize()
    assert torch.equal(out, again) and torch.isfinite(out).all()
    ref = fb.reference_block_attn(*args, mask, H).float()
    tol = 2.0 ** (math.floor(math.log2(ref.abs().max().item())) - 7)
    torch.testing.assert_close(out.float(), ref, rtol=0, atol=tol)
    qkv, ctx = fb.split_workspace(ws, B, L, D)
    want_qkv = fb.reference_block_qkv(*args[:5]).float()
    qkv_tol = 2.0 ** (math.floor(math.log2(want_qkv.abs().max().item())) - 7)
    torch.testing.assert_close(qkv.float(), want_qkv, rtol=0, atol=qkv_tol)
    assert torch.equal(ctx, fused_attention(qkv, mask, H))


def test_block_plan_matches_kernel(device):
    """fused_block.plan mirrors sc_block_attn_plan at every edge length,
    width and head dim the kernel takes."""
    from spatial_clip_tpu_torch.ops import fused_block as fb

    for L in BLOCK_EDGE_LENGTHS:
        for D in range(128, 1025, 128):
            for hd in (32, 64, 128):
                if fb.supported(L, D, D // hd, torch.bfloat16):
                    assert fb.plan(L, D, D // hd) == fb.kernel_plan(L, D, D // hd), (L, D, hd)


@pytest.mark.parametrize("D", list(range(128, 1025, 128)))
@pytest.mark.parametrize("R", [1, 31, 33, 5000])
def test_fused_ln_backward_over_its_grid(device, R, D):
    """The fused_ln backward's one-wave grid (bf16): one row, row counts on
    either side of 32, more rows than the wave's warps, every width whose
    lanes hold 1 to 4 vectors: dx within one bf16 step of the plain
    version's largest, dgamma / dbeta within 1e-5 of theirs, all the same
    bits on a rerun; its partial rows are fused_ln.bwd_blocks's count for
    the card's SMs and the kernel's occupancy."""
    import ctypes

    from spatial_clip_tpu_torch.ops import cuda_build
    from spatial_clip_tpu_torch.ops import fused_ln as fl

    gen = torch.Generator(device=device).manual_seed(R * D)
    x = (torch.randn((R, D), generator=gen, device=device) * 2 + 0.5).bfloat16()
    gamma = 1 + 0.1 * torch.randn((D,), generator=gen, device=device)
    dy = torch.randn((R, D), generator=gen, device=device).bfloat16()
    got = fl.fused_ln_bwd(x, gamma, dy, 1e-5)
    again = fl.fused_ln_bwd(x, gamma, dy, 1e-5)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = fl.reference_ln_bwd(x, gamma, dy, 1e-5)
    torch.testing.assert_close(got[0].float(), want[0].float(), rtol=0,
                               atol=_tol(torch.bfloat16, want[0].float()))
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5 * w.abs().max().item())
    lib = cuda_build.library()
    regs, local, per_sm = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    assert lib.sc_layer_norm_bwd_occupancy(D, 1, ctypes.byref(regs), ctypes.byref(local),
                                           ctypes.byref(per_sm)) == 0
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    assert lib.sc_layer_norm_bwd_blocks(R, D, 1) == fl.bwd_blocks(R, sms, per_sm.value)


LAYOUT_CASES = [  # B, L, D, H, causal, dtype: the ViT-B-32 towers, hd 32 / 128, long L
    (256, 50, 768, 12, False, torch.bfloat16),
    (256, 77, 512, 8, True, torch.bfloat16),
    (8, 77, 512, 8, True, torch.float32),
    (3, 17, 384, 12, False, torch.bfloat16),  # hd 32, 4 heads a group
    (2, 26, 256, 2, True, torch.float32),  # hd 128, one head a group
    (2, 166, 256, 4, True, torch.bfloat16),  # a long bf16 hd 64 backward (12 key tiles)
]


@pytest.mark.parametrize("B,L,D,H,causal,dtype", LAYOUT_CASES)
def test_layout_kernels_match_plain_and_standard(device, B, L, D, H, causal, dtype):
    """The eight layout entries against their plain versions (_tol), one
    launch each, and bit for bit against the standard launches on the same
    data: interleaved vs the standard kernels on the permuted columns, split
    vs [q|k|v], seq-major (contiguous and the transposed view) vs the
    standard kernels on qkv_nb + b rounded to the dtype, with db within f32
    tolerance of the recompute-with-db db (dq, dk, dv come as the column
    blocks of one dqkv), slab vs the group kernels; the same bits on a
    rerun."""
    from spatial_clip_tpu_torch.ops import attention_variants as av
    from spatial_clip_tpu_torch.ops.fused_attention import (
        fused_attention_bwd_recompute,
        fused_attention_bwd_recompute_db,
        reference_attention_bwd,
    )

    gen = torch.Generator(device=device).manual_seed(B * L + D + H)
    qkv = torch.randn((B, L, 3 * D), generator=gen, device=device).to(dtype)
    g = torch.randn((B, L, D), generator=gen, device=device).to(dtype)
    bias = (0.3 * torch.randn((3 * D,), generator=gen, device=device)).to(dtype)
    mask = causal_mask(L, device=device) if causal else None
    std_out = fused_attention(qkv, mask, H)
    std_d = fused_attention_bwd_recompute(qkv, mask, g, H)
    ref_out = reference_attention(qkv, mask, H).float()
    ref_d = reference_attention_bwd(qkv, mask, None, g, H)[0].float()
    entries = (av.fused_attention_inter, av.fused_attention_inter_bwd, av.fused_attention_slab,
               av.fused_attention_slab_bwd, av.fused_attention_t_fwd, av.fused_attention_t_bwd,
               av.fused_attention_split_fwd, av.fused_attention_split_bwd)
    before = [e.launches for e in entries]

    perm = torch.tensor(av.interleave_perm(H, D // H), device=device)
    qkv_i = qkv.index_select(-1, perm)
    inter = (av.fused_attention_inter(qkv_i, mask, H),
             av.fused_attention_inter_bwd(qkv_i, mask, g, H))
    slab = av.fused_attention_slab(qkv, mask, H), av.fused_attention_slab_bwd(qkv, mask, g, H)
    qkv_nb = qkv
    with_b = qkv_nb + bias
    t_out = av.fused_attention_t_fwd(qkv_nb.transpose(0, 1), bias, mask, H)
    t_d, db = av.fused_attention_t_bwd(qkv_nb.transpose(0, 1), bias, mask, g, H)
    q, k, v = (t.contiguous() for t in qkv.chunk(3, dim=-1))
    split = (av.fused_attention_split_fwd(q, k, v, mask, H),
             av.fused_attention_split_bwd(q, k, v, mask, g, H))
    torch.cuda.synchronize()
    assert [e.launches - n for e, n in zip(entries, before)] == [1] * 8
    assert torch.equal(inter[0], std_out) and torch.equal(inter[1], std_d.index_select(-1, perm))
    assert torch.equal(slab[0], std_out) and torch.equal(slab[1], std_d)
    assert torch.equal(split[0], std_out) and torch.equal(torch.cat(split[1], -1), std_d)
    assert torch.equal(t_out, fused_attention(with_b, mask, H))
    assert torch.equal(t_d, fused_attention_bwd_recompute(with_b, mask, g, H))
    db_std = fused_attention_bwd_recompute_db(with_b, mask, g, H)[1]
    torch.testing.assert_close(db, db_std, rtol=0, atol=_tol(torch.float32, db_std) + 1e-4)
    seq_major = qkv_nb.transpose(0, 1).contiguous()
    assert torch.equal(av.fused_attention_t_fwd(seq_major, bias, mask, H), t_out)
    again = av.fused_attention_t_bwd(seq_major, bias, mask, g, H)
    assert torch.equal(again[0], t_d) and torch.equal(again[1], db)
    for got, ref, tol in ((inter[0], ref_out, _tol),
                          (inter[1], ref_d.index_select(-1, perm), _bwd_tol),
                          (slab[0], ref_out, _tol), (slab[1], ref_d, _bwd_tol),
                          (split[0], ref_out, _tol), (torch.cat(split[1], -1), ref_d, _bwd_tol)):
        assert got.dtype == dtype and torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), ref, rtol=0, atol=tol(dtype, ref))
    want_t = av.reference_attention_t(qkv_nb.transpose(0, 1), bias, mask, H).float()
    want_tb = av.reference_attention_t_bwd(qkv_nb.transpose(0, 1), bias, mask, g, H)
    torch.testing.assert_close(t_out.float(), want_t, rtol=0, atol=_tol(dtype, want_t))
    torch.testing.assert_close(t_d.float(), want_tb[0].float(), rtol=0,
                               atol=_bwd_tol(dtype, want_tb[0].float()))
    torch.testing.assert_close(db, want_tb[1], rtol=0, atol=_tol(dtype, want_tb[1]) + 1e-4)


def test_layout_kernels_refuse_what_they_do_not_take(device):
    """Misaligned rows, seq-major strides other than the two layouts', f16,
    L > 256, a backward over the shared-memory limit and a geometry with no
    interleaved order raise; a CUDA tensor never falls back to a plain
    version."""
    from spatial_clip_tpu_torch.ops import attention_variants as av

    qkv = torch.randn((2, 9, 3 * 256), device=device)
    g = torch.randn((2, 9, 256), device=device)
    bias = torch.randn((3 * 256,), device=device)
    flat = torch.randn((2 * 9 * 768 + 1,), device=device)
    shifted = flat[1:].view(2, 9, 768)  # 4 bytes off a 16-byte boundary
    with pytest.raises(ValueError, match="16-byte"):
        av.fused_attention_slab(shifted, None, 4)
    with pytest.raises(ValueError, match="16-byte"):
        av.fused_attention_inter_bwd(shifted, None, g, 4)
    with pytest.raises(ValueError, match="16-byte"):
        av.fused_attention_t_fwd(shifted.transpose(0, 1), bias, None, 4)
    with pytest.raises(ValueError, match="strides"):
        av.fused_attention_t_fwd(qkv[:, :, :765].transpose(0, 1), bias[:765], None, 4)
    with pytest.raises(ValueError, match="dtype"):
        av.fused_attention_split_fwd(*(t.half().contiguous() for t in qkv.chunk(3, -1)), None, 4)
    with pytest.raises(ValueError, match="sequence length"):
        av.fused_attention_slab(torch.randn((1, 257, 768), device=device), None, 4)
    big = torch.randn((1, 200, 3 * 256), device=device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="shared memory"):  # bf16 hd 128 past L=192
        av.fused_attention_t_bwd(big.transpose(0, 1), bias, None, big[..., :256], 2)
    with pytest.raises(ValueError, match="shared memory"):
        av.fused_attention_slab_bwd(big, None, big[..., :256], 2)
    with pytest.raises(ValueError, match="interleaved"):
        av.fused_attention_inter(torch.randn((2, 9, 3 * 64), device=device), None, 2)
    before = av.fused_attention_slab.launches
    av.fused_attention_slab(qkv, None, 4)
    assert av.fused_attention_slab.launches == before + 1


@pytest.mark.parametrize("setting", [dict(attn_impl="pallas_inter"),
                                     dict(attn_impl="pallas_inter", ln_gemm_impl="pallas"),
                                     dict(attn_impl="pallas_t"), dict(attn_impl="pallas_split")],
                         ids=["inter", "inter_ln_gemm", "t", "split"])
def test_layout_settings_on_card_match_cpu(device, setting):
    """Widened ViT-Test in f32 under each layout setting: the loss and every
    gradient of one forward+backward on the card (the layout kernels) against
    the CPU (their plain versions), rtol 1e-4 / atol 1e-5 + 1e-4 of each
    gradient's largest entry; 4 launches of the setting's forward and 4 of
    its backward, none of the standard attention kernels."""
    from spatial_clip_tpu_torch.losses import make_loss
    from spatial_clip_tpu_torch.ops import attention_variants as av
    from spatial_clip_tpu_torch.ops import fused_attention as fa

    wide = dict(vision_cfg=dict(width=256, heads=4), text_cfg=dict(width=256, heads=8))
    rng = np.random.default_rng(11)
    B = 4
    u8 = torch.from_numpy(rng.integers(0, 256, (B, 32, 32, 3), np.uint8))
    ids = torch.from_numpy(rng.integers(0, 512, (B, 16)))
    spatial = dict(image_tile_ids=torch.arange(B), text_tile_ids=torch.arange(B),
                   neighbor_tile_ids=torch.from_numpy(rng.integers(-1, B, (B, 4))),
                   neighbor_alphas=torch.from_numpy(rng.uniform(0, 1, (B, 4)).astype(np.float32)))
    loss_fn = make_loss("spatial", cap_logit_scale=50.0)
    own = {"pallas_inter": (av.fused_attention_inter, av.fused_attention_inter_bwd),
           "pallas_t": (av.fused_attention_t_fwd, av.fused_attention_t_bwd),
           "pallas_split": (av.fused_attention_split_fwd, av.fused_attention_split_bwd)}
    counters = (*own[setting["attn_impl"]], fa.fused_attention, fa.fused_attention_lse,
                fa.fused_attention_bwd, fa.fused_attention_bwd_recompute,
                fa.fused_attention_bwd_recompute_db)
    runs = {}
    for dev in ("cpu", device):
        model = create_model("ViT-Test", precision="fp32", device=dev, training=True, **wide,
                             **setting)
        before = [c.launches for c in counters]
        feats = model(normalize_batch(u8.to(dev)), ids.to(dev))
        loss = loss_fn(**feats, **{k: v.to(dev) for k, v in spatial.items()})["contrastive_loss"]
        loss.backward()
        torch.cuda.synchronize()
        runs[str(dev)] = (loss.item(), {k: p.grad.cpu() for k, p in model.named_parameters()},
                          [c.launches - n for c, n in zip(counters, before)])
    (loss_cpu, g_cpu, n_cpu), (loss_gpu, g_gpu, n_gpu) = runs["cpu"], runs[str(device)]
    assert n_cpu == [0] * 7 and n_gpu == [4, 4, 0, 0, 0, 0, 0]
    assert loss_gpu == pytest.approx(loss_cpu, rel=1e-4)
    for k, w in g_cpu.items():
        torch.testing.assert_close(g_gpu[k], w, rtol=1e-4,
                                   atol=1e-5 + 1e-4 * w.abs().max().item(), msg=k)


# ------------------------------------ the key-tiled kernels (attention_long.cu)

def _long_lengths(hd, dtype):
    from spatial_clip_tpu_torch.ops.fused_attention import bwd_max_seq, fwd_max_seq

    return sorted({257, 577, fwd_max_seq(hd, dtype) + 1, bwd_max_seq(hd, dtype) + 1})


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_long_kernels_match_plain_version(device, dtype, hd, causal):
    """The key-tiled forward (with and without lse) and backward (saved lse
    with db, recompute, recompute with db) at L 257, 577 and the first
    length past each resident limit: the forward at 2e-2 (bf16) / 1e-5, lse
    at 1e-5 x max(1, |lse|), dqkv at _bwd_tol, db at _tol + 1e-4 against
    the plain version on the same lse; dqkv and db the same bits on a rerun;
    one launch of each kernel counted a call."""
    from spatial_clip_tpu_torch.ops import attention_long as al
    from spatial_clip_tpu_torch.ops.fused_attention import (
        reference_attention_bwd,
        reference_attention_lse,
    )

    B, H = 2, 2
    for L in _long_lengths(hd, dtype):
        gen = torch.Generator(device=device).manual_seed(L * hd + causal)
        qkv = torch.randn((B, L, 3 * H * hd), generator=gen, device=device).to(dtype)
        g = torch.randn((B, L, H * hd), generator=gen, device=device).to(dtype)
        mask = causal_mask(L, device=device) if causal else None
        counters = (al.fused_attention_long, al.fused_attention_long_lse, al.long_bwd_dq,
                    al.long_bwd_dkdv, al.long_db)
        before = [c.launches for c in counters]
        out = al.fused_attention_long(qkv, mask, H)
        out_lse, lse = al.fused_attention_long_lse(qkv, mask, H)
        dqkv, db = al.fused_attention_long_bwd(qkv, mask, lse, g, H)
        assert [c.launches - n for c, n in zip(counters, before)] == [1, 1, 1, 1, 1]
        again, db_again = al.fused_attention_long_bwd(qkv, mask, lse, g, H)
        re, _ = al.fused_attention_long_bwd_recompute(qkv, mask, g, H, db=False)
        re_db, re_db_db = al.fused_attention_long_bwd_recompute(qkv, mask, g, H, db=True)
        torch.cuda.synchronize()
        want, want_lse = reference_attention_lse(qkv, mask, H)
        want_d, want_db = reference_attention_bwd(qkv, mask, lse, g, H)
        want_re, want_re_db = reference_attention_bwd(qkv, mask, None, g, H)
        atol = 2e-2 if dtype == torch.bfloat16 else 1e-5
        torch.testing.assert_close(out.float(), want.float(), atol=atol, rtol=0)
        assert torch.equal(out, out_lse)
        torch.testing.assert_close(lse, want_lse, rtol=0,
                                   atol=1e-5 * max(1.0, want_lse.abs().max().item()))
        assert torch.equal(dqkv, again) and torch.equal(db, db_again)
        for got, ref in ((dqkv, want_d), (re, want_re), (re_db, want_re)):
            torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                                       atol=_bwd_tol(dtype, ref.float()))
        for got, ref in ((db, want_db), (re_db_db, want_re_db)):
            torch.testing.assert_close(got, ref, rtol=0, atol=_tol(dtype, ref) + 1e-4)


def test_long_kernel_geometry_matches_the_source(device):
    """``attention_long``'s shared-memory formulas and launch plan against
    the entries of csrc/attention_long.cu."""
    from spatial_clip_tpu_torch.ops import attention_long as al
    from spatial_clip_tpu_torch.ops import cuda_build

    lib = cuda_build.library()
    plan = (ctypes_int * 8)()
    assert lib.sc_attention_long_plan(plan) == 0
    assert list(plan) == [al.ROWS, al.TC_THREADS, al.FWD_KEYS, al.BWD_TILE, al.MAX_STAGES,
                          al.BLOCK, al.SIMT_THREADS, al.DB_ROWS]
    for hd in (32, 64, 128):
        for kind, name in enumerate(al.KINDS):
            for dtype, code in cuda_build.DTYPE_CODES.items():
                assert lib.sc_attention_long_smem_bytes(kind, hd, code) == al.smem_bytes(
                    name, hd, dtype)


LONG_TILE_EDGES = tuple(L for k in range(5, 9) for L in (128 * k - 1, 128 * k, 128 * k + 1))


def _long_mask(kind, L, device):
    """None, the causal mask, ('prefix') finfo(f32).min over the first 130
    keys of every row (past the first 128-key tile, as left padding masks),
    or ('row') that and all of row 1 (a row masked in full): chip_smoke's
    long_mask."""
    if kind == "none":
        return None
    if kind == "causal":
        return causal_mask(L, device=device)
    mask = torch.zeros((L, L), device=device)
    mask[:, :min(130, L - 1)] = torch.finfo(torch.float32).min
    if kind == "row":
        mask[1] = torch.finfo(torch.float32).min
    return mask


@pytest.mark.parametrize("mask_kind", ["none", "causal", "prefix", "row"])
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_long_bf16_kernels_at_tile_edges(device, hd, mask_kind):
    """The bf16 wgmma kernels at their 128-row items' and 64 / 128-row
    tiles' edges (L 128 k - 1, 128 k, 128 k + 1 for k 5..8, and the first
    length past each resident limit), with no mask, the causal mask, a
    finfo.min mask over a prefix of keys and that with a whole row: the
    forward with and without lse and with each row's max and log sum kept
    apart, the saved-lse backward with db and the two recompute options
    (from the max and log sum: under 'row' p is 1 / L in the row masked in
    full, as the plain version's softmax gives it), at phase 33's tolerances
    against the plain version; dqkv and db the same bits on a rerun; the dQ
    kernel's stats rows hold the lse bit for bit and are ``pack_stats`` of
    their lse and r."""
    from spatial_clip_tpu_torch.ops import attention_long as al
    from spatial_clip_tpu_torch.ops.fused_attention import (
        bwd_max_seq,
        fwd_max_seq,
        reference_attention_bwd,
        reference_attention_lse,
    )

    B, H, dtype = 2, 2, torch.bfloat16
    lengths = sorted({*LONG_TILE_EDGES, fwd_max_seq(hd, dtype) + 1, bwd_max_seq(hd, dtype) + 1})
    for L in lengths:
        gen = torch.Generator(device=device).manual_seed(L * hd + len(mask_kind))
        qkv = torch.randn((B, L, 3 * H * hd), generator=gen, device=device).to(dtype)
        g = torch.randn((B, L, H * hd), generator=gen, device=device).to(dtype)
        mask = _long_mask(mask_kind, L, device)
        out = al.fused_attention_long(qkv, mask, H)
        out_lse, lse = al.fused_attention_long_lse(qkv, mask, H)
        dqkv, db = al.fused_attention_long_bwd(qkv, mask, lse, g, H)
        again, db_again = al.fused_attention_long_bwd(qkv, mask, lse, g, H)
        stats = al.long_bwd_dq(qkv, mask, lse, g, H, torch.empty_like(qkv))
        out_parts, row_max, lsum = al.fused_attention_long_lse(qkv, mask, H, parts=True)
        re, _ = al.fused_attention_long_bwd_recompute(qkv, mask, g, H, db=False)
        re_db, re_db_db = al.fused_attention_long_bwd_recompute(qkv, mask, g, H, db=True)
        torch.cuda.synchronize()
        want, want_lse = reference_attention_lse(qkv, mask, H)
        want_d, want_db = reference_attention_bwd(qkv, mask, lse, g, H)
        _, want_max, want_lsum = al.reference_attention_parts(qkv, mask, H)
        want_re, want_re_db = reference_attention_bwd(qkv, mask, None, g, H)
        assert torch.equal(out, out_parts), L
        for got, ref in ((row_max, want_max), (lsum, want_lsum)):
            torch.testing.assert_close(got, ref, rtol=0,
                                       atol=1e-5 * max(1.0, want_lse.abs().max().item()))
        for got in (re, re_db):
            torch.testing.assert_close(got.float(), want_re.float(), rtol=0,
                                       atol=_bwd_tol(dtype, want_re.float()), msg=f"L {L}")
        torch.testing.assert_close(re_db_db, want_re_db, rtol=0,
                                   atol=_tol(dtype, want_re_db) + 1e-4)
        torch.testing.assert_close(out.float(), want.float(), atol=2e-2, rtol=0, msg=f"L {L}")
        assert torch.equal(out, out_lse), L
        torch.testing.assert_close(lse, want_lse, rtol=0,
                                   atol=1e-5 * max(1.0, want_lse.abs().max().item()))
        torch.testing.assert_close(dqkv.float(), want_d.float(), rtol=0,
                                   atol=_bwd_tol(dtype, want_d.float()), msg=f"L {L}")
        torch.testing.assert_close(db, want_db, rtol=0, atol=_tol(dtype, want_db) + 1e-4)
        assert torch.equal(dqkv, again) and torch.equal(db, db_again), L
        lse_k, r_k = stats.unpacked()
        assert torch.equal(lse_k, lse) and torch.equal(stats.rows, al.pack_stats(lse_k, r_k)), L


def test_wrappers_route_by_length(device):
    """``fused_attention`` and the saved-lse backward launch the resident
    kernels at their limit and the key-tiled ones one past it, each route
    counted on its own counter."""
    from spatial_clip_tpu_torch.ops import attention_long as al
    from spatial_clip_tpu_torch.ops import fused_attention as fa

    H, hd = 2, 64
    for L, backward in ((fa.fwd_max_seq(hd, torch.bfloat16), False),
                        (fa.bwd_max_seq(hd, torch.bfloat16), True)):
        for n, route in ((L, "resident"), (L + 1, "long")):
            qkv = torch.randn((2, n, 3 * H * hd), device=device).bfloat16()
            g = torch.randn((2, n, H * hd), device=device).bfloat16()
            resident = (fa.fused_attention_lse, fa.fused_attention_bwd)
            long = (al.fused_attention_long_lse, al.long_bwd_dq)
            before = [c.launches for c in (*resident, *long)]
            lse = fa.fused_attention_lse(qkv, None, H)[1]
            if backward:
                fa.fused_attention_bwd(qkv, None, lse, g, H)
            torch.cuda.synchronize()
            delta = [c.launches - b for c, b in zip((*resident, *long), before)]
            fwd_long = n > fa.fwd_max_seq(hd, torch.bfloat16)
            bwd_long = backward and route == "long"
            assert delta == [int(not fwd_long), int(backward and not bwd_long), int(fwd_long),
                             int(bwd_long)], (n, backward, delta)


def test_plain_route_runs_on_the_card(device):
    """ViT-Test as it is (heads of 16) on the card: 2 + 2 calls of the plain
    route a forward and no kernel launch; its features against the same
    weights on the CPU."""
    from spatial_clip_tpu_torch.ops import attention_plain
    from spatial_clip_tpu_torch.ops import fused_attention as fa

    card = create_model("ViT-Test", precision="fp32", seed=0, device=device)
    cpu = create_model("ViT-Test", precision="fp32", seed=0, device="cpu")
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.normal(size=(4, 32, 32, 3)).astype(np.float32))
    texts = torch.from_numpy(rng.integers(0, 512, (4, 16)))
    before = (attention_plain.plain_attention.launches, fa.fused_attention.launches)
    with torch.no_grad():
        got = card(images.to(device), texts.to(device))
    torch.cuda.synchronize()
    assert (attention_plain.plain_attention.launches - before[0],
            fa.fused_attention.launches - before[1]) == (4, 0)
    with torch.no_grad():
        want = cpu(images, texts)
    for k in ("image_features", "text_features"):
        torch.testing.assert_close(got[k].cpu(), want[k], atol=1e-5, rtol=0)


def test_world_one_nccl_step_keeps_the_bits(device, tmp_path):
    """Trainer(mesh=make_mesh()) on a world-1 NCCL group: two ViT-B-32 bf16
    steps at batch 16 with the fused spatial loss give the same params, mu
    and nu bits and the same fused CE launches as the steps with no group
    (the group's all-gathers and all-reduce return their inputs' bits)."""
    import torch.distributed as dist

    from spatial_clip_tpu_torch.losses import make_loss
    from spatial_clip_tpu_torch.ops import fused_contrastive as fc
    from spatial_clip_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from spatial_clip_tpu_torch.train.loop import Trainer, TrainerConfig

    rng = np.random.default_rng(19)
    B = 16
    ids = torch.arange(B, device=device)
    batches = [{
        "images": torch.from_numpy(rng.integers(0, 255, (B, 224, 224, 3), dtype=np.uint8)).to(
            device),
        "texts": torch.from_numpy(rng.integers(0, 49408, (B, 77))).to(device),
        "image_tile_ids": ids, "text_tile_ids": ids,
        "neighbor_tile_ids": torch.from_numpy(rng.integers(-1, B, (B, 6))).to(device),
        "neighbor_alphas": torch.from_numpy(rng.uniform(0, 1, (B, 6)).astype(np.float32)).to(
            device)} for _ in range(2)]
    model = create_model("ViT-B-32", precision="bf16", device=device, seed=0, training=True)
    loss = make_loss("spatial", cap_logit_scale=50.0, use_fused_kernel=True)
    config = TrainerConfig(warmup_steps=1, augment=True, color_jitter=0.2, seed=0)
    init_distributed("nccl", 0, 1, store_path=str(tmp_path / "store"), device=device)
    try:
        runs = []
        for mesh in (None, make_mesh(device=device)):
            trainer = Trainer(model, loss, config, mesh=mesh)
            state = trainer.init_state()
            before = fc.spatial_ce_fwd.launches
            for batch in batches:
                state, _ = trainer.train_step(state, batch)
            torch.cuda.synchronize()
            runs.append((state.flat, fc.spatial_ce_fwd.launches - before))
    finally:
        dist.destroy_process_group()
    (plain, n_plain), (grouped, n_grouped) = runs
    assert n_plain == n_grouped == 4
    for k in ("params", "mu", "nu"):
        assert torch.equal(plain[k], grouped[k]), k
