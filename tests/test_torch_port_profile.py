"""The device-time breakdown's kernel families (``profile_serving.FAMILIES``,
read by ``bench --profile`` and ``profile_serving``) on the CPU: every
kernel the port writes by hand falls in a family of its own, never under
"other" nor a family of PyTorch's or the libraries' kernels.
"""
from __future__ import annotations

import tests.helpers.torch_threads  # noqa: F401  (xdist workers share the cores)

import re

import pytest

from spatial_clip_tpu_torch.ops import cuda_build
from spatial_clip_tpu_torch.profile_serving import FAMILIES, _family

# a kernel's name after ``__global__ void`` and an optional __launch_bounds__(...)
GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s+)?"
                    r"(\w+)\s*\(")
LIBRARY_FAMILIES = {"gemm", "reduce (LayerNorm stats, pooling)",
                    "elementwise (LayerNorm affine, GELU, residual, casts)", "copy / cat / gather"}


def _port_kernels() -> dict:
    """name -> the csrc file that defines it."""
    found = {}
    for path in sorted(cuda_build.CSRC_DIR.glob("*.cu*")):
        for name in GLOBAL.findall(path.read_text()):
            found[name] = path.name
    return found


def test_the_sources_define_the_kernels_the_families_name():
    kernels = _port_kernels()
    assert len(kernels) >= 20
    assert {"ln_fwd_kernel", "ln_dense_dx_kernel_bf16", "attn_bwd_dx_kernel",
            "mlp_fwd_kernel_bf16", "dscale_kernel"} <= set(kernels)
    assert LIBRARY_FAMILIES <= {family for family, _ in FAMILIES}


@pytest.mark.parametrize("name", sorted(_port_kernels()))
def test_every_port_kernel_has_its_own_family(name):
    """As the profiler sees it too: ``void (anonymous namespace)::..<..>(..)``."""
    family = _family(name)
    assert family != "other" and family not in LIBRARY_FAMILIES
    assert _family(f"void (anonymous namespace)::tc::{name}<2, 3, 2>(CUtensorMap_st, int)") == family


def test_library_kernels_keep_their_families():
    assert _family("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64") == "gemm"
    assert _family("void at::native::vectorized_elementwise_kernel<4, GeluCUDAKernelImpl>") == (
        "elementwise (LayerNorm affine, GELU, residual, casts)")
    assert _family("void at::native::reduce_kernel<512, 1>") == "reduce (LayerNorm stats, pooling)"
    assert _family("some_unknown_kernel") == "other"
