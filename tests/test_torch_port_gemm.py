"""The wgmma kernels' and the fused LayerNorm forward's surroundings on the
CPU: ``bench_gemm``'s variants and flags (its kernels: these, the
attention dx, the fused loss's dq and dK and the fused_ln backward), the
fused MLP's, LN -> dense's (forward and dx) and fused_ln's wrapper checks,
launch routes and the constants the wrappers mirror from the CUDA
sources.

The kernels themselves run only on the card (``tests/test_torch_port_cuda.py``,
``chip_smoke.py`` phases 12 and 15); here the wrappers take their plain
versions, which ``test_torch_port_mlp.py`` and ``test_torch_port_ln.py``
hold against JAX's interpret-mode Pallas kernels.
"""
from __future__ import annotations

import tests.helpers.torch_threads  # noqa: F401  (xdist workers share the cores)

import re

import numpy as np
import pytest
import torch

from spatial_clip_tpu_torch import bench_gemm
from spatial_clip_tpu_torch.ops import cuda_build
from spatial_clip_tpu_torch.ops import fused_ln as fl
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
        bench_gemm.main(["--variants", variant, "--kernels", ",".join(bench_gemm.SOURCES)])


@pytest.mark.parametrize("argv,error", [
    (["--variants", "package,nope"], ValueError),
    (["--kernels", "mlp,attention"], ValueError),
    (["--parent", "build/parent", "--kernels", "ln_dense"], SystemExit),
    (["--kernels", "ln_dense_dx,ln_nope"], ValueError),
    (["--kernels", "attn_dx,ce_dq,ce_dk,ln_bwd"], SystemExit),
    (["--parent", "build/parent", "--kernels", "attn_dx,ce_dk", "--variants",
      "package,attn_cluster4,attn_stages2"], SystemExit),
    (["--kernels", "attn_dx", "--variants", "package,attn_cluster3"], ValueError),
    (["--parent", "build/parent", "--kernels", "ln_dense_dx,ln_fwd"], SystemExit),
    (["--variants", "dx_cluster4,ln_blocks1", "--kernels", "ln_fwd"], SystemExit),
    (["--kernels", "block"], SystemExit),
    (["--parent", "build/parent", "--kernels", "block,ln_bwd", "--variants",
      "package,block_cluster1,block_cluster4,block_stages2,block_stages8,ln_bwd_depth2"],
     SystemExit),
    (["--kernels", "block", "--variants", "package,block_cluster3"], ValueError),
    (["--kernels", "block,blocks"], ValueError),
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


def test_the_wrappers_refuse_what_the_kernels_do_not_take(monkeypatch):
    """Shape and dtype checks raise on any device; a tensor that is neither
    on the CPU nor on a card (meta) reaches the kernel path and is refused
    there, with no launch counted (meta (which the wrappers run as the CPU, for ops/flops.py's count) is taken off the plain devices here)."""
    monkeypatch.setattr(cuda_build, "PLAIN_DEVICES", ("cpu",))
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


def _source_int(text: str, pattern: str) -> int:
    return int(re.search(pattern, text).group(1))


def test_the_dx_plan_mirrors_the_kernel_source():
    """``DX_ROW_TILE`` is the dx kernel's ``kRows`` and ``dx_k_parts`` its
    ``Split``: up to 3 units of 128 columns a CTA (K 384: one CTA, 768:
    two, 1024: four); the cluster's default row groups are one of the sizes
    ``bench_gemm`` times; the dx counts its launches by route."""
    src = (cuda_build.CSRC_DIR / "fused_ln_dense.cu").read_text()
    dxtc = src[src.index("namespace dxtc {"):src.index("}  // namespace dxtc")]
    assert _source_int(dxtc, r"constexpr int kRows = (\d+);") == fd.DX_ROW_TILE
    assert _source_int(dxtc, r"constexpr int kMaxParts = (\d+);") == max(
        fd.dx_k_parts(k) for k in range(128, 1025, 128))
    assert "parts = units <= 3 ? 1 : units <= 6 ? 2 : 4;" in dxtc
    assert [fd.dx_k_parts(k) for k in range(128, 1025, 128)] == [1, 1, 1, 2, 2, 2, 4, 4]
    assert _source_int(src, r"#define SC_LND_DX_CLUSTER (\d+)") in {
        v["dx_cluster"] for v in bench_gemm.VARIANTS.values() if "dx_cluster" in v}
    assert set(fd.ln_dense_bwd_dx.routes) == {"tc", "f32"}


def test_the_dx_and_ln_forward_wrappers_take_their_plain_versions_on_the_cpu():
    """On the CPU, ``ln_dense_bwd_dx`` and ``fused_ln_fwd`` return their plain
    versions' bits and count no launch and no route."""
    before = (fd.ln_dense_bwd_dx.launches, dict(fd.ln_dense_bwd_dx.routes),
              fl.fused_ln_fwd.launches)
    rng = np.random.default_rng(3)
    t = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        x, g, w1 = t(7, 256).to(dtype), t(7, 384).to(dtype), (t(384, 256) / 16).to(dtype)
        assert torch.equal(fd.ln_dense_bwd_dx(x, g, w1, 1e-5),
                           fd.reference_ln_dense_bwd_dx(x, g, w1, 1e-5))
        gamma, beta = 1 + 0.1 * t(256), 0.1 * t(256)
        assert torch.equal(fl.fused_ln_fwd(x, gamma, beta, 1e-5),
                           fl.reference_ln_fwd(x, gamma, beta, 1e-5))
    assert before == (fd.ln_dense_bwd_dx.launches, fd.ln_dense_bwd_dx.routes,
                      fl.fused_ln_fwd.launches)


def test_the_dx_and_ln_forward_wrappers_refuse_what_the_kernels_do_not_take(monkeypatch):
    """Shape and dtype checks raise on any device; a tensor on neither the
    CPU nor a card (meta) reaches the kernel path and is refused there, with
    no launch or route counted (meta (which the wrappers run as the CPU, for ops/flops.py's count) is taken off the plain devices here)."""
    monkeypatch.setattr(cuda_build, "PLAIN_DEVICES", ("cpu",))
    x, g, w1 = torch.zeros(4, 256), torch.zeros(4, 384), torch.zeros(384, 256)
    before = (fd.ln_dense_bwd_dx.launches, dict(fd.ln_dense_bwd_dx.routes),
              fl.fused_ln_fwd.launches)
    with pytest.raises(ValueError, match="g must be"):
        fd.ln_dense_bwd_dx(x, torch.zeros(4, 128), w1, 1e-5)
    with pytest.raises(ValueError, match="share a dtype"):
        fd.ln_dense_bwd_dx(x, g, w1.bfloat16(), 1e-5)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fd.ln_dense_bwd_dx(x.to("meta"), g.to("meta"), w1.to("meta"), 1e-5)
    ones = torch.ones(256)
    with pytest.raises(ValueError, match="gamma / beta"):
        fl.fused_ln_fwd(x, ones[:128], ones, 1e-5)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fl.fused_ln_fwd(x.to("meta"), ones.to("meta"), ones.to("meta"), 1e-5)
    assert before == (fd.ln_dense_bwd_dx.launches, fd.ln_dense_bwd_dx.routes,
                      fl.fused_ln_fwd.launches)


@pytest.mark.parametrize("copies_bytes,copies", [(39_321_600, 4), (40_370_176, 4),
                                                 (200_000_000, 2), (1_000_000, 150)])
def test_bench_gemm_cold_timing_rotates_past_the_l2(copies_bytes, copies):
    """The cold timing rotates over enough copies of a call's inputs and
    outputs to hold three times the 50 MB L2 (the image and text towers'
    LayerNorm at batch 256: 4 copies of 39 / 40 MB), two at least."""
    assert bench_gemm.cold_copies(copies_bytes) == copies
    assert copies * copies_bytes >= bench_gemm.COLD_BYTES or copies == 2


def test_the_ln_backward_grid_mirrors_the_kernel_source():
    """``fused_ln.bwd_blocks``'s constants are the source's: 8 warps a
    block, at most ``SC_LN_BWD_BLOCKS`` blocks an SM (another of the values
    ``bench_gemm`` times), the launch bounds sized for them, each block a
    run of rows, rows landing ``SC_LN_BWD_DEPTH`` deep."""
    src = (cuda_build.CSRC_DIR / "fused_ln.cu").read_text()
    assert "constexpr int kBwdWarps = 8;" in src and fl.BWD_WARPS == 8
    assert int(re.search(r"#define SC_LN_BWD_BLOCKS (\d+)", src).group(1)) == fl.BWD_BLOCKS
    assert "__launch_bounds__(kBwdWarps * 32, SC_LN_BWD_BLOCKS)" in src
    assert "const int end = int(long(blockIdx.x + 1) * rows / gridDim.x);" in src
    tried = {v.get("ln_bwd_blocks") for v in bench_gemm.VARIANTS.values()}
    depths = {v.get("ln_bwd_depth") for v in bench_gemm.VARIANTS.values()}
    assert 2 in tried and {2, 4} <= depths
    assert int(re.search(r"#define SC_LN_BWD_DEPTH (\d+)", src).group(1)) == 3


@pytest.mark.parametrize("per_sm", [1, 2, 3])
@pytest.mark.parametrize("rows", [1, 31, 33, 2112, 2113, 4225, 12800, 19712, 100_000])
def test_the_ln_backward_grid_is_one_even_wave(rows, per_sm):
    """The backward's grid (``sc_layer_norm_bwd_blocks``) on 132 SMs: one
    full wave, or a block for each 8 rows when there are fewer; every
    block's run of rows [b R / nb, (b + 1) R / nb) within one of every
    other's and never empty, every warp's share within one of its block's
    other warps'."""
    blocks = fl.bwd_blocks(rows, 132, per_sm)
    wave = 132 * min(per_sm, fl.BWD_BLOCKS)
    assert blocks == min(wave, -(-rows // fl.BWD_WARPS))
    runs = [(b + 1) * rows // blocks - b * rows // blocks for b in range(blocks)]
    assert sum(runs) == rows and min(runs) >= 1 and max(runs) - min(runs) <= 1
    for run in {min(runs), max(runs)}:
        shares = [len(range(w, run, fl.BWD_WARPS)) for w in range(fl.BWD_WARPS)]
        assert max(shares) - min(shares) <= 1
