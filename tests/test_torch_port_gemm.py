"""The wgmma forwards' surroundings on the CPU: ``bench_gemm``'s variants
and flags, the fused MLP's and LN -> dense's wrapper checks, launch routes
and the constants the wrappers mirror from the CUDA sources.

The kernels themselves run only on the card (``tests/test_torch_port_cuda.py``,
``chip_smoke.py`` phases 12 and 15); here the wrappers take their plain
versions, which ``test_torch_port_mlp.py`` and ``test_torch_port_ln.py``
hold against JAX's interpret-mode Pallas kernels.
"""
from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from spatial_clip_tpu_torch import bench_gemm
from spatial_clip_tpu_torch.ops import cuda_build
from spatial_clip_tpu_torch.ops import fused_ln_dense as fd
from spatial_clip_tpu_torch.ops import fused_mlp as fm


@pytest.mark.parametrize("variant", list(bench_gemm.VARIANTS))
def test_bench_gemm_variants_rewrite_the_source_and_refuse_without_a_gpu(variant):
    """Each variant sets the knobs a kernel has through nvcc ``-D``, each a
    macro with one ``#ifndef`` default in that kernel's source (a flag for
    a macro the source lacks is refused), and leaves the other kernel as
    the package; the script parses its flags, then refuses: no CUDA
    here."""
    values = bench_gemm.VARIANTS[variant]
    touched = 0
    for kernel, source in bench_gemm.SOURCES.items():
        text = (cuda_build.CSRC_DIR / source).read_text()
        knobs = bench_gemm.KNOBS[kernel]
        mine = {k: v for k, v in values.items() if k in knobs}
        flags = bench_gemm.variant_flags(kernel, [variant], text)
        if variant == "package" or mine:
            touched += 1
            assert flags == {variant: [f"-D{knobs[k]}={v}" for k, v in mine.items()]}
        else:
            assert flags == {}
        for macro in knobs.values():
            assert text.count(f"#ifndef {macro}\n") == 1
            if any(knobs[k] == macro for k in mine):
                with pytest.raises(RuntimeError, match=macro):
                    bench_gemm.variant_flags(kernel, [variant], text.replace(macro, "SC_OTHER"))
    assert touched >= 1  # every variant changes at least one kernel
    with pytest.raises(SystemExit, match="needs a CUDA GPU"):
        bench_gemm.main(["--variants", variant, "--kernels", "mlp,ln_dense"])


@pytest.mark.parametrize("argv,error", [
    (["--variants", "package,nope"], ValueError),
    (["--kernels", "mlp,attention"], ValueError),
    (["--parent", "build/parent", "--kernels", "ln_dense"], SystemExit),
])
def test_bench_gemm_parses_its_flags(argv, error):
    with pytest.raises(error):
        bench_gemm.main(argv)


def test_the_mlp_route_mirrors_the_kernel_source():
    """``X_RESIDENT_WIDTH`` is the source's ``kMaxResidentWidth``; the route
    names follow it, and the f32 body has its own."""
    src = (cuda_build.CSRC_DIR / "fused_mlp.cu").read_text()
    assert int(re.search(r"kMaxResidentWidth = (\d+);", src).group(1)) == fm.X_RESIDENT_WIDTH
    assert fm._route(768, torch.bfloat16) == "x_resident"
    assert fm._route(fm.X_RESIDENT_WIDTH, torch.bfloat16) == "x_resident"
    assert fm._route(fm.X_RESIDENT_WIDTH + 128, torch.bfloat16) == "x_streamed"
    assert fm._route(2048, torch.float32) == "f32"
    assert set(fm.fused_mlp_fwd.routes) == {"x_resident", "x_streamed", "f32"}
    assert set(fd.ln_dense_fwd.routes) == {"tc", "f32"}


def _mlp_args(R, W, H, device="cpu", dtype=torch.bfloat16, seed=0):
    rng = np.random.default_rng(seed)
    t = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)
    return (t(R, W).to(dtype), t(H, W) / W ** 0.5, t(H) * 0.1, t(W, H) / H ** 0.5, t(W) * 0.1)


def test_the_wrappers_take_their_plain_versions_on_the_cpu_and_count_no_launch():
    before = (fm.fused_mlp_fwd.launches, dict(fm.fused_mlp_fwd.routes),
              fd.ln_dense_fwd.launches, dict(fd.ln_dense_fwd.routes))
    args = _mlp_args(5, 128, 512)
    torch.testing.assert_close(fm.fused_mlp_fwd(*args), fm.reference_mlp_fwd(*args),
                               rtol=0, atol=0)
    x = args[0].float().contiguous()
    w1, b1 = torch.randn(256, 128), torch.randn(256)
    y, xhat = fd.ln_dense_fwd(x, w1, b1, 1e-5)
    want_y, want_xhat = fd.reference_ln_dense_fwd(x, w1, b1, 1e-5)
    assert torch.equal(y, want_y) and torch.equal(xhat, want_xhat)
    assert before == (fm.fused_mlp_fwd.launches, fm.fused_mlp_fwd.routes,
                      fd.ln_dense_fwd.launches, fd.ln_dense_fwd.routes)


def test_the_wrappers_refuse_what_the_kernels_do_not_take():
    """Shape and dtype checks raise on any device; a tensor that is neither
    on the CPU nor on a card (meta) reaches the kernel path and is refused
    there, with no launch counted."""
    x, fc_w, fc_b, proj_w, proj_b = _mlp_args(4, 128, 512)
    before = (fm.fused_mlp_fwd.launches, fd.ln_dense_fwd.launches)
    with pytest.raises(ValueError, match="fc_w must be"):
        fm.fused_mlp_fwd(x, fc_w[:, :64], fc_b, proj_w, proj_b)
    with pytest.raises(ValueError, match="proj_b must be"):
        fm.fused_mlp_fwd(x, fc_w, fc_b, proj_w, proj_b[:64])
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fm.fused_mlp_fwd(x.double(), fc_w, fc_b, proj_w, proj_b)
    with pytest.raises(ValueError, match="R >= 1"):
        fm.fused_mlp_fwd(x[:0], fc_w, fc_b, proj_w, proj_b)
    meta = [t.to("meta") for t in (x, fc_w, fc_b, proj_w, proj_b)]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fm.fused_mlp_fwd(*meta)
    w1, b1 = torch.randn(256, 128), torch.randn(256)
    xf = x.float()
    with pytest.raises(ValueError, match="b1 must be float32"):
        fd.ln_dense_fwd(xf, w1, b1.bfloat16(), 1e-5)
    with pytest.raises(ValueError, match="share a dtype"):
        fd.ln_dense_fwd(xf, w1.bfloat16(), b1, 1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        fd.ln_dense_fwd(xf.t().contiguous().t(), w1, b1, 1e-5)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fd.ln_dense_fwd(xf.to("meta"), w1.to("meta"), b1.to("meta"), 1e-5)
    assert (fm.fused_mlp_fwd.launches, fd.ln_dense_fwd.launches) == before
