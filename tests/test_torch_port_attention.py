"""The port's fused attention against the JAX package's Pallas kernel.

On the CPU the port's wrapper runs its plain PyTorch version; the JAX kernel
runs in Pallas interpret mode, as tests/test_fused_attention.py runs it. The
same numpy inputs go to both. f32 parity is held at atol 1e-5: both compute
f32 scores, the row max, exp, the PV sum and the 1/sum scaling, and differ
only in summation order.
"""
from __future__ import annotations

import tests.helpers.torch_threads  # noqa: F401  (xdist workers share the cores)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatial_clip_tpu.ops.fused_attention import fused_attention as jax_fused_attention
from spatial_clip_tpu.ops.fused_attention import reference_attention as jax_reference
from spatial_clip_tpu_torch import bench_fwd
from spatial_clip_tpu_torch.ops import cuda_build
from spatial_clip_tpu_torch.ops.fused_attention import (
    HEAD_DIMS,
    MAX_SMEM_BYTES,
    fused_attention,
    fwd_max_seq,
    fwd_rows,
    fwd_smem_bytes,
    reference_attention,
)


def _inputs(seed, B, L, D, causal):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(B, L, 3 * D)).astype(np.float32)
    mask = None
    if causal:
        mask = np.triu(np.full((L, L), np.finfo(np.float32).min, np.float32), k=1)
    return qkv, mask


def _jax(fn, qkv, mask, H, *args):
    return np.asarray(fn(jnp.asarray(qkv), None if mask is None else jnp.asarray(mask), H, *args))


def _port(qkv, mask, H, dtype=torch.float32):
    m = None if mask is None else torch.from_numpy(mask)
    return fused_attention(torch.from_numpy(qkv).to(dtype), m, H)


# the geometries of tests/test_fused_attention.py (hd 64, 128, 32), then the
# serving shapes at batch 2: the image tower (L=50, 12 heads) and the causal
# text tower (L=77, 8 heads)
GEOMETRIES = [
    *[(B, L, D, H, causal) for (B, L, D, H) in [(4, 11, 128, 2), (3, 17, 384, 3), (2, 9, 256, 8)]
      for causal in (False, True)],
    (2, 50, 768, 12, False),
    (2, 77, 512, 8, True),
]


@pytest.mark.parametrize("B,L,D,H,causal", GEOMETRIES)
def test_matches_jax_kernel_f32(B, L, D, H, causal):
    qkv, mask = _inputs(B * L + D, B, L, D, causal)
    got = _port(qkv, mask, H).numpy()
    assert got.shape == (B, L, D)
    np.testing.assert_allclose(got, _jax(jax_fused_attention, qkv, mask, H, True), atol=1e-5)
    np.testing.assert_allclose(got, _jax(jax_reference, qkv, mask, H), atol=1e-5)


@pytest.mark.parametrize("B,L,D,H,causal", [(2, 50, 768, 12, False), (2, 77, 512, 8, True)])
def test_matches_jax_kernel_bf16(B, L, D, H, causal):
    """bf16 in and out, f32 statistics: one bf16 rounding step (2^-8
    relative) apart at most, since sums run in another order."""
    qkv, mask = _inputs(7, B, L, D, causal)
    qkv = np.array(jnp.asarray(qkv, jnp.bfloat16).astype(jnp.float32))  # exact in bf16
    want = np.asarray(jax_fused_attention(
        jnp.asarray(qkv, jnp.bfloat16), None if mask is None else jnp.asarray(mask), H, True
    ).astype(jnp.float32))
    got = _port(qkv, mask, H, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2, rtol=1e-2)


def test_cpu_path_is_the_plain_version_and_counts_nothing():
    qkv, mask = _inputs(0, 2, 9, 128, True)
    before = fused_attention.launches
    got = _port(qkv, mask, 2)
    assert fused_attention.launches == before
    want = reference_attention(torch.from_numpy(qkv), torch.from_numpy(mask), 2)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape,heads,dtype,why", [
    ((2, 9, 96), 2, torch.float32, "head geometry"),          # hd = 16
    ((2, 9, 3 * 192), 2, torch.float32, "head geometry"),     # hd = 96
    ((2, 0, 384), 2, torch.float32, "sequence length"),  # any L >= 1 is taken
    ((2, 9, 385), 2, torch.float32, "3\\*D"),
    ((2, 9, 384), 2, torch.float16, "dtype"),
    ((9, 384), 2, torch.float32, "3\\*D"),
])
def test_rejects_what_the_kernel_does_not_take(shape, heads, dtype, why):
    before = fused_attention.launches
    with pytest.raises(ValueError, match=why):
        fused_attention(torch.zeros(shape, dtype=dtype), None, heads)
    assert fused_attention.launches == before


def test_rejects_bad_layout_and_mask(monkeypatch):
    """Layout and mask checks raise on any device; a tensor neither on the
    CPU nor on a card reaches the kernel path and is refused there (meta (which the wrappers run as the CPU, for ops/flops.py's count) is taken off the plain devices here)."""
    monkeypatch.setattr(cuda_build, "PLAIN_DEVICES", ("cpu",))
    qkv = torch.zeros(2, 9, 384)
    with pytest.raises(ValueError, match="contiguous"):
        fused_attention(torch.zeros(2, 384, 9).transpose(1, 2), None, 2)
    with pytest.raises(ValueError, match="mask"):
        fused_attention(qkv, torch.zeros(9, 9, dtype=torch.bfloat16), 2)
    with pytest.raises(ValueError, match="mask"):
        fused_attention(qkv, torch.zeros(8, 9), 2)
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_attention(qkv.to("meta"), None, 2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_forward_fits_every_length_it_takes(hd, dtype):
    """One block's shared memory holds the resident forward at every length
    up to ``fwd_max_seq`` (``fwd_smem_bytes`` mirrors the kernel's formula),
    and grows with the length: bf16 up to 944 / 528 / 272 at hd 32 / 64 /
    128, where the next length is over the block's shared memory; f32 up to
    the CUDA-core body's 256 keys a row. Longer sequences take the key-tiled
    kernels."""
    longest = fwd_max_seq(hd, dtype)
    sizes = [fwd_smem_bytes(L, hd, dtype) for L in range(1, longest + 2)]
    assert max(sizes[:-1]) <= MAX_SMEM_BYTES
    assert sizes == sorted(sizes)
    if dtype == torch.bfloat16:
        assert longest == {32: 944, 64: 528, 128: 272}[hd]
        assert sizes[-1] > MAX_SMEM_BYTES
    else:
        assert longest == 256 and sizes[-1] <= MAX_SMEM_BYTES


@pytest.mark.parametrize("L,rows", [(1, 16), (15, 16), (16, 16), (17, 32), (50, 64), (63, 64),
                                    (65, 80), (77, 80), (128, 128), (129, 144), (200, 208),
                                    (256, 256)])
def test_forward_pads_rows_and_keys_as_the_kernel(L, rows):
    """The bf16 body stages q, k and v in whole 16-row tiles (the keys padded
    as the query rows): rows of head_dim elements plus 16 bytes of pad and
    one f32 row max each. The f32 body pads no rows."""
    assert fwd_rows(L, torch.bfloat16) == rows
    for hd in HEAD_DIMS:
        assert fwd_smem_bytes(L, hd, torch.bfloat16) == 3 * rows * (hd + 8) * 2 + rows * 4
    assert fwd_rows(L, torch.float32) == L


@pytest.mark.parametrize("variant", sorted(bench_fwd.VARIANTS))
def test_bench_fwd_variants_rewrite_the_source_and_refuse_without_a_gpu(variant):
    """Each ``bench_fwd`` variant sets its constants through nvcc ``-D``, each
    a macro with one ``#ifndef`` default in the forward body's header (a flag
    for a macro the header lacks is refused); the script parses its flags,
    then refuses: no CUDA here."""
    header = (cuda_build.CSRC_DIR / bench_fwd.HEADER).read_text()
    values = bench_fwd.VARIANTS[variant]
    assert bench_fwd.design_flags(header, bench_fwd.KNOBS, values) == [
        f"-D{bench_fwd.KNOBS[knob]}={value}" for knob, value in values.items()]
    for macro in bench_fwd.KNOBS.values():
        assert header.count(f"#ifndef {macro}\n") == 1 and header.count(macro) == 3
        with pytest.raises(RuntimeError, match=macro):
            bench_fwd.design_flags(header.replace(macro, "SC_OTHER"), bench_fwd.KNOBS, values)
    with pytest.raises(SystemExit, match="needs a CUDA GPU"):
        bench_fwd.main(["--variants", variant, "--batch", "8"])
