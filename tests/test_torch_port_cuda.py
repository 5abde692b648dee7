"""The port on the card: the CUDA kernel against its plain PyTorch version,
and a tower on the card against the same tower on the CPU.

Needs an NVIDIA GPU with nvcc; skips without one. The tests directory's
conftest imports jax, which the GPU machine may lack, so run this file as

    python -m pytest tests/test_torch_port_cuda.py --noconftest -q
"""
from __future__ import annotations

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


def test_cuda_tensor_never_falls_back(device):
    with pytest.raises(ValueError, match="head geometry"):
        fused_attention(torch.zeros(2, 9, 96, device=device), None, 2)
    with pytest.raises(ValueError, match="mask"):
        fused_attention(torch.zeros(2, 9, 384, device=device), torch.zeros(9, 9), 2)
    shifted = torch.zeros(2 * 9 * 384 + 1, dtype=torch.bfloat16, device=device)[1:]
    with pytest.raises(ValueError, match="16-byte aligned"):
        fused_attention(shifted.view(2, 9, 384), None, 2)


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
