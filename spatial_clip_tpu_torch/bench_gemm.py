"""The hand-written kernels' design constants timed side by side, beside their
parent's sources, on one CUDA GPU.

    python -m spatial_clip_tpu_torch.bench_gemm [--variants package,cluster1,...]
        [--kernels mlp,ln_dense,ln_dense_dx,ln_fwd,attn_dx,ce_dq,ce_dk,ln_bwd,block,
                   long_fwd,long_bwd]
        [--parent DIR]

The kernels: the fused MLP forward (``mlp``, ``csrc/fused_mlp.cu``), the
LayerNorm -> dense forward and data gradient (``ln_dense``, ``ln_dense_dx``,
``csrc/fused_ln_dense.cu``), which feed wgmma from TMA rings, the fused
LayerNorm forward and backward (``ln_fwd``, ``ln_bwd``, ``csrc/fused_ln.cu``),
the attention backward that forms dx = dqkv W in the launch (``attn_dx``,
``csrc/attention_dx.cu``, its product on wgmma) and the fused spatial
cross-entropy's dq and dK (``ce_dq``, ``ce_dk``, ``csrc/fused_spatial_ce.cu``,
f32 on the CUDA cores), the block-fused attention half (``block``,
``csrc/fused_block.cu``, wgmma products and the tensor-core attention body)
and the key-tiled attention past the resident lengths, the forward with lse
and the whole backward (``long_fwd``, ``long_bwd``, ``csrc/attention_long.cu``,
bf16 on wgmma fed by TMA; no design knobs, timed beside ``--parent``'s
kernels and SDPA's efficient-attention and flash backends at ViT-L-14-336's
image tower).
Their design constants are ``#ifndef`` macros in the sources (``KNOBS``:
each knob's macro per kernel) that nvcc ``-D`` sets: the cluster size (CTAs
that share each weight tile through a TMA multicast), the most 128-column
output blocks an MLP CTA owns (and so its column splits), the most ring
stages, the sequences a block-half CTA owns, the LayerNorm kernels'
resident blocks an SM and the rows the LayerNorm backward has in flight a
warp.
This script builds one copy of each source per variant (``VARIANTS``;
``package`` is the source as it is), all at once in parallel under
``build/bench_gemm/``. ``--parent DIR`` also builds the kernels' sources
of another checkout (the parent commit, unpacked with ``git archive``) and
times them beside.

At the main path's shapes (the MLP of the image and text towers at batch 256
and 64; ln_2 -> c_fc and ln_1 -> qkv of both towers at batch 256, forward
and dx; each tower's LayerNorm at batch 256, forward and backward; each
tower's attention with dx at batch 256; the loss at B = N = 1024 and 2048,
D 512, f32; each tower's attention half at batch 256 and 64; bf16
elsewhere, inputs from ``torch.Generator`` seed 0) it times
every copy with CUDA events beside the library calls that compute the same
function (``F.linear(F.gelu(F.linear(x)))``; ``F.linear(F.layer_norm(x))``
and its backward to x on a retained graph; ``F.layer_norm`` and its
backward on a retained graph; SDPA's backward and the cuBLAS dx GEMM; the
unfused attention half with SDPA) and, for the newer kernels, beside their
plain versions (and the dx kernel's unfused route, the recompute-with-db
kernel and ``torch.matmul``; the block half's unfused half,
``bench_block.shipped_layer``), and
prints one JSON object per kernel and shape: ms of each, the host's
microseconds to enqueue one launch of each, the package's launch plan, the
bound (the larger of the bytes at 3.35 TB/s and the products at 989
TFLOP/s bf16, or 67 TFLOP/s f32) with the share of it, and the card. The
dx kernels, the LayerNorm kernels and the loss's backward are timed on the
card's clock alone (their launches queued behind a spin, so the host's
enqueue is not in it), and so are their library calls; the LayerNorm
kernels and their library calls both warm (the same input back to back)
and cold (over copies that together exceed the 50 MB L2); so is the block
half, with its plain version, unfused half and SDPA arm. Every copy must
give the package launch's bits: the variants change the schedule, never
the sums, except the LayerNorm backward's at another wave size, whose
dgamma / dbeta sum other partial rows; those and the parent's kernels are
held to the plain version's tolerance where their sums differ (the
attention dx's dqkv, the LayerNorm backward's dgamma / dbeta and the
parent's block half; the LayerNorm backward's dx must keep the package's
bits). Needs a CUDA GPU and nvcc: there is no CPU
fallback.
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import math
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from spatial_clip_tpu_torch import bench_block
from spatial_clip_tpu_torch.bench_dx import median_ms
from spatial_clip_tpu_torch.bench_fwd import build_copies, design_flags, parse_variants
from spatial_clip_tpu_torch.models.transformer import causal_mask
from spatial_clip_tpu_torch.ops import attention_variants as av
from spatial_clip_tpu_torch.ops import cuda_build
from spatial_clip_tpu_torch.ops import fused_attention as fa
from spatial_clip_tpu_torch.ops import fused_block as fb
from spatial_clip_tpu_torch.ops import fused_contrastive as fc
from spatial_clip_tpu_torch.ops import fused_ln as fl
from spatial_clip_tpu_torch.ops import fused_ln_dense as fd
from spatial_clip_tpu_torch.ops import fused_mlp as fm

SOURCES = {"mlp": "fused_mlp.cu", "ln_dense": "fused_ln_dense.cu",
           "ln_dense_dx": "fused_ln_dense.cu", "ln_fwd": "fused_ln.cu",
           "attn_dx": "attention_dx.cu", "ce_dq": "fused_spatial_ce.cu",
           "ce_dk": "fused_spatial_ce.cu", "ln_bwd": "fused_ln.cu", "block": "fused_block.cu",
           "long_fwd": "attention_long.cu", "long_bwd": "attention_long.cu"}
FUNCTIONS = {"mlp": ("sc_mlp_fwd",), "ln_dense": ("sc_ln_dense_fwd",),
             "ln_dense_dx": ("sc_ln_dense_bwd_dx",), "ln_fwd": ("sc_layer_norm_fwd",),
             "attn_dx": ("sc_attention_bwd_dx",),
             "ce_dq": ("sc_spatial_ce_dq", "sc_spatial_ce_scratch"),
             "ce_dk": ("sc_spatial_ce_dk", "sc_spatial_ce_scratch"),
             "ln_bwd": ("sc_layer_norm_bwd", "sc_layer_norm_bwd_blocks"),
             "block": ("sc_block_attn_fwd",), "long_fwd": ("sc_attention_long_fwd",),
             "long_bwd": ("sc_attention_long_bwd_dq", "sc_attention_long_bwd_dkdv",
                          "sc_attention_long_db")}
# the parent's entries whose C signature this tree changed
PARENT_ARGTYPES = {
    "sc_layer_norm_bwd_blocks": [ctypes.c_int],  # rows
    "sc_block_attn_fwd": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5  # .., out, B, L, D, heads, dtype
    + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p],  # eps, scale, stream
}
# the key-tiled kernels' entries with the row max and log sum kept apart (the
# recompute options' route); a parent without them runs the recompute
# options from the lse
SPLIT_ENTRIES = ("sc_attention_long_fwd_split", "sc_attention_long_bwd_dq_split",
                 "sc_attention_long_bwd_dkdv_split")
KNOBS = {  # kernel: {knob: its macro in the kernel's source}
    "mlp": {"cluster": "SC_MLP_CLUSTER", "max_nb": "SC_MLP_MAX_NB",
            "stages": "SC_MLP_MAX_STAGES"},
    "ln_dense": {"cluster": "SC_LND_CLUSTER", "stages": "SC_LND_MAX_STAGES"},
    "ln_dense_dx": {"dx_cluster": "SC_LND_DX_CLUSTER", "dx_stages": "SC_LND_DX_MAX_STAGES"},
    "ln_fwd": {"ln_blocks": "SC_LN_FWD_BLOCKS"},
    "attn_dx": {"attn_cluster": "SC_DX_CLUSTER", "attn_stages": "SC_DX_MAX_STAGES"},
    "ce_dq": {},
    "ce_dk": {},
    "ln_bwd": {"ln_bwd_blocks": "SC_LN_BWD_BLOCKS", "ln_bwd_depth": "SC_LN_BWD_DEPTH"},
    "block": {"block_cluster": "SC_BLOCK_CLUSTER", "block_stages": "SC_BLOCK_MAX_STAGES"},
    "long_fwd": {},
    "long_bwd": {},
}
VARIANTS = {  # name: {knob: value}; a knob a kernel lacks leaves it as the package
    "package": {},
    "cluster1": {"cluster": 1},
    "max_nb2": {"max_nb": 2},
    "max_nb3": {"max_nb": 3},
    "stages4": {"stages": 4},
    "stages3": {"stages": 3},
    "stages2": {"stages": 2},
    "dx_cluster1": {"dx_cluster": 1},
    "dx_cluster2": {"dx_cluster": 2},
    "dx_cluster4": {"dx_cluster": 4},
    "dx_stages6": {"dx_stages": 6},
    "dx_stages4": {"dx_stages": 4},
    "ln_blocks1": {"ln_blocks": 1},
    "ln_blocks2": {"ln_blocks": 2},
    "attn_cluster1": {"attn_cluster": 1},
    "attn_cluster4": {"attn_cluster": 4},
    "attn_stages2": {"attn_stages": 2},
    "attn_stages3": {"attn_stages": 3},
    "ln_bwd_blocks2": {"ln_bwd_blocks": 2},
    "ln_bwd_b2d2": {"ln_bwd_blocks": 2, "ln_bwd_depth": 2},
    "ln_bwd_depth2": {"ln_bwd_depth": 2},
    "ln_bwd_depth4": {"ln_bwd_depth": 4},
    "block_cluster1": {"block_cluster": 1},
    "block_cluster4": {"block_cluster": 4},
    "block_stages2": {"block_stages": 2},
    "block_stages8": {"block_stages": 8},
}
SHAPES = {  # kernel: {name: (R, width, hidden or N)}; ln_fwd: (R, width, 0)
    "mlp": {"image": (256 * 50, 768, 3072), "text": (256 * 77, 512, 2048),
            "image_serve": (64 * 50, 768, 3072), "text_serve": (64 * 77, 512, 2048)},
    "ln_dense": {"image_fc": (256 * 50, 768, 3072), "image_qkv": (256 * 50, 768, 2304),
                 "text_fc": (256 * 77, 512, 2048), "text_qkv": (256 * 77, 512, 1536)},
    "ln_fwd": {"image": (256 * 50, 768, 0), "text": (256 * 77, 512, 0)},
    # attn_dx: (B, L, D, heads, causal, Din); ce: (B, N, D)
    "attn_dx": {"image": (256, 50, 768, 12, False, 768), "text": (256, 77, 512, 8, True, 512)},
    "ce_dq": {"1024": (1024, 1024, 512), "2048": (2048, 2048, 512)},
    # block: (B, L, D, heads, causal)
    "block": {"image_256": (256, 50, 768, 12, False), "text_256": (256, 77, 512, 8, True),
              "image_64": (64, 50, 768, 12, False), "text_64": (64, 77, 512, 8, True)},
}
# long_fwd / long_bwd: (B, L, heads, hd), ViT-L-14-336's image tower at batch 32
SHAPES["long_fwd"] = {"vit_l14_336": (32, 577, 16, 64)}
SHAPES["long_bwd"] = SHAPES["long_fwd"]
SHAPES["ln_dense_dx"] = SHAPES["ln_dense"]
SHAPES["ln_bwd"] = SHAPES["ln_fwd"]
SHAPES["ce_dk"] = SHAPES["ce_dq"]
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
COLD_BYTES = 150e6  # the copies a cold timing rotates over: three times the 50 MB L2
SPIN_CYCLES = 5_000_000  # ~3 ms of the card's spin ahead of a timed run of launches


def variant_flags(kernel: str, names, source_text: str) -> dict:
    """name -> nvcc -D flags of each variant that changes one of this
    kernel's knobs (``package`` always)."""
    knobs = KNOBS[kernel]
    out = {}
    for name in names:
        values = {k: v for k, v in VARIANTS[name].items() if k in knobs}
        if name == "package" or values:
            out[name] = design_flags(source_text, {k: knobs[k] for k in values}, values)
    return out


def build(kernel: str, names, parent: Path | None) -> dict:
    """name -> loaded library of each copy of the kernel's source."""
    source = SOURCES[kernel]
    flags = variant_flags(kernel, names, (cuda_build.CSRC_DIR / source).read_text())
    sources = {}
    if parent is not None:
        flags["parent"] = []
        sources["parent"] = parent / "spatial_clip_tpu_torch" / "csrc" / source
    libs = build_copies(source, flags, FUNCTIONS[kernel], f"bench_gemm/{kernel}", sources)
    if "parent" in libs:
        for fn in FUNCTIONS[kernel]:
            if fn in PARENT_ARGTYPES:
                getattr(libs["parent"], fn).argtypes = PARENT_ARGTYPES[fn]
    return libs


def host_us(launch, n: int = 200) -> float:
    """Host time to enqueue one launch, microseconds: n launches back to
    back, well under the stream's queue depth, timed on the host clock
    before the closing synchronize (so the card's time is not in it)."""
    launch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        launch()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / n * 1e6


def bound_ms(n_bytes: float, flops: float, peak_flops: float = BF16_FLOPS) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, flops / peak_flops) * 1e3


def device_ms(fn, reps: int = 7, inner: int = 20) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back calls
    on the card's clock alone: each run is queued behind a spin of the card
    (``torch.cuda._sleep``) long enough for the host to enqueue it all, so a
    kernel shorter than its host enqueue is timed, not the host."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return sorted(times)[reps // 2]


def cold_ms(fn, copies: int) -> float:
    """:func:`device_ms` of ``fn(i)`` over i = 0, 1, ..., copies - 1 in turn:
    with the copies' bytes past the L2, each call finds its inputs in device
    memory, as a step's LayerNorm does."""
    turn = itertools.cycle(range(copies))
    return device_ms(lambda: fn(next(turn)), inner=4 * copies)


def cold_copies(n_bytes: int) -> int:
    """Copies of a call's inputs and outputs (``n_bytes`` each) that together
    hold COLD_BYTES."""
    return max(2, -(-int(COLD_BYTES) // n_bytes))


def bench_mlp(libs: dict, gen) -> None:
    for shape, (R, W, H) in SHAPES["mlp"].items():
        x = torch.randn((R, W), generator=gen, device="cuda").bfloat16()
        w1 = (torch.randn((H, W), generator=gen, device="cuda") / W ** 0.5).bfloat16()
        b1 = (0.1 * torch.randn((H,), generator=gen, device="cuda")).bfloat16()
        w2 = (torch.randn((W, H), generator=gen, device="cuda") / H ** 0.5).bfloat16()
        b2 = (0.1 * torch.randn((W,), generator=gen, device="cuda")).bfloat16()
        out = torch.empty_like(x)

        def launch(lib):
            err = lib.sc_mlp_fwd(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                                 b2.data_ptr(), out.data_ptr(), R, W, H, 1,
                                 torch.cuda.current_stream().cuda_stream)
            cuda_build.check(cuda_build.library(), err, "bench_gemm launch")

        want = fm.fused_mlp_fwd(x, w1, b1, w2, b2)
        plain = fm.reference_mlp_fwd(x, w1, b1, w2, b2)
        tol = 2 ** -8 * plain.float().abs().max().item()
        report = {}
        for name, lib in libs.items():
            launch(lib)
            torch.cuda.synchronize()
            if name == "parent":
                err = (out.float() - plain.float()).abs().max().item()
                if not err <= tol:
                    raise AssertionError(f"mlp {shape}: the parent's kernel is {err} off (tol {tol})")
            elif not torch.equal(out, want):
                raise AssertionError(f"mlp {shape}: copy {name} differs from the package")
            report[name] = median_ms(lambda lib=lib: launch(lib))
        report["package_launch"] = median_ms(lambda: fm.fused_mlp_fwd(x, w1, b1, w2, b2))
        host = {name: host_us(lambda lib=lib: launch(lib)) for name, lib in libs.items()}
        library = median_ms(lambda: F.linear(F.gelu(F.linear(x, w1, b1), approximate="tanh"),
                                             w2, b2))
        n_bytes = (2 * R * W + 2 * W * H + H + W) * 2
        print(json.dumps({"kernel": "fused_mlp", "shape": shape, "R": R, "W": W, "H": H,
                          "ms": report, "library_ms": library, "host_us": host,
                          "bound_ms": bound_ms(n_bytes, 4 * R * W * H),
                          "plan": fm.mlp_plan(R, W, H),
                          "device": torch.cuda.get_device_name(0)}), flush=True)


def bench_ln_dense(libs: dict, gen) -> None:
    for shape, (R, K, N) in SHAPES["ln_dense"].items():
        x = (torch.randn((R, K), generator=gen, device="cuda") * 2 + 0.5).bfloat16()
        gamma = 1 + 0.1 * torch.randn((K,), generator=gen, device="cuda")
        beta = 0.1 * torch.randn((K,), generator=gen, device="cuda")
        weight = torch.randn((N, K), generator=gen, device="cuda") / K ** 0.5
        bias = 0.1 * torch.randn((N,), generator=gen, device="cuda")
        w1, b1 = fd._fold(gamma, beta, weight, bias, torch.bfloat16)
        y, xhat = torch.empty((R, N), dtype=x.dtype, device="cuda"), torch.empty_like(x)

        def launch(lib):
            err = lib.sc_ln_dense_fwd(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), y.data_ptr(),
                                      xhat.data_ptr(), R, K, N, 1, 1e-5,
                                      torch.cuda.current_stream().cuda_stream)
            cuda_build.check(cuda_build.library(), err, "bench_gemm launch")

        want_y, want_xhat = fd.ln_dense_fwd(x, w1, b1, 1e-5)
        plain_y, _ = fd.reference_ln_dense_fwd(x, w1, b1, 1e-5)
        tol = 2 ** -8 * plain_y.float().abs().max().item()
        report = {}
        for name, lib in libs.items():
            launch(lib)
            torch.cuda.synchronize()
            if name == "parent":
                err = (y.float() - plain_y.float()).abs().max().item()
                if not (err <= tol and torch.equal(xhat, want_xhat)):
                    raise AssertionError(f"ln_dense {shape}: the parent's kernel is {err} off "
                                         f"(tol {tol}) or its xhat has other bits")
            elif not (torch.equal(y, want_y) and torch.equal(xhat, want_xhat)):
                raise AssertionError(f"ln_dense {shape}: copy {name} differs from the package")
            report[name] = median_ms(lambda lib=lib: launch(lib))
        report["package_launch"] = median_ms(lambda: fd.ln_dense_fwd(x, w1, b1, 1e-5))
        host = {name: host_us(lambda lib=lib: launch(lib)) for name, lib in libs.items()}
        wl, bl, gl, bel = (t.bfloat16() for t in (weight, bias, gamma, beta))
        library = median_ms(lambda: F.linear(F.layer_norm(x, (K,), gl, bel, 1e-5), wl, bl))
        n_bytes = (2 * R * K + N * K + R * N) * 2 + 4 * N
        print(json.dumps({"kernel": "fused_ln_dense", "shape": shape, "R": R, "K": K, "N": N,
                          "ms": report, "library_ms": library, "host_us": host,
                          "bound_ms": bound_ms(n_bytes, 2 * R * K * N),
                          "plan": fd.ln_dense_fwd_plan(R, K, N),
                          "device": torch.cuda.get_device_name(0)}), flush=True)


def bench_ln_dense_dx(libs: dict, gen) -> None:
    for shape, (R, K, N) in SHAPES["ln_dense_dx"].items():
        x = (torch.randn((R, K), generator=gen, device="cuda") * 2 + 0.5).bfloat16()
        gamma = 1 + 0.1 * torch.randn((K,), generator=gen, device="cuda")
        beta = 0.1 * torch.randn((K,), generator=gen, device="cuda")
        weight = torch.randn((N, K), generator=gen, device="cuda") / K ** 0.5
        bias = 0.1 * torch.randn((N,), generator=gen, device="cuda")
        g = torch.randn((R, N), generator=gen, device="cuda").bfloat16()
        w1, _ = fd._fold(gamma, beta, weight, bias, torch.bfloat16)
        dx = torch.empty_like(x)

        def launch(lib):
            err = lib.sc_ln_dense_bwd_dx(x.data_ptr(), g.data_ptr(), w1.data_ptr(), dx.data_ptr(),
                                         R, K, N, 1, 1e-5, torch.cuda.current_stream().cuda_stream)
            cuda_build.check(cuda_build.library(), err, "bench_gemm launch")

        want = fd.ln_dense_bwd_dx(x, g, w1, 1e-5)
        plain = fd.reference_ln_dense_bwd_dx(x, g, w1, 1e-5)
        tol = 2 ** -8 * plain.float().abs().max().item()
        report = {}
        for name, lib in libs.items():
            launch(lib)
            torch.cuda.synchronize()
            if name == "parent":
                err = (dx.float() - plain.float()).abs().max().item()
                if not err <= tol:
                    raise AssertionError(f"ln_dense_dx {shape}: the parent's kernel is {err} off "
                                         f"(tol {tol})")
            elif not torch.equal(dx, want):
                raise AssertionError(f"ln_dense_dx {shape}: copy {name} differs from the package")
            report[name] = device_ms(lambda lib=lib: launch(lib))
        report["package_launch"] = device_ms(lambda: fd.ln_dense_bwd_dx(x, g, w1, 1e-5))
        host = {name: host_us(lambda lib=lib: launch(lib)) for name, lib in libs.items()}
        # the library route: F.linear(F.layer_norm(x)) backward to x, two calls (the
        # GEMM g W and the LayerNorm backward), on one retained graph
        xg = x.detach().requires_grad_()
        wl, bl, gl, bel = (t.bfloat16() for t in (weight, bias, gamma, beta))
        y = F.linear(F.layer_norm(xg, (K,), gl, bel, 1e-5), wl, bl)
        library = device_ms(lambda: torch.autograd.grad(y, xg, g, retain_graph=True))
        del y
        n_bytes = (2 * R * K + N * K + R * N) * 2
        print(json.dumps({"kernel": "fused_ln_dense_dx", "shape": shape, "R": R, "K": K, "N": N,
                          "ms": report, "library_ms": library, "host_us": host,
                          "bound_ms": bound_ms(n_bytes, 2 * R * K * N),
                          "plan": fd.ln_dense_bwd_dx_plan(R, K, N),
                          "device": torch.cuda.get_device_name(0)}), flush=True)


def bench_ln_fwd(libs: dict, gen) -> None:
    for shape, (R, D, _) in SHAPES["ln_fwd"].items():
        n_bytes = 2 * R * D * 2  # x in, y out
        copies = cold_copies(n_bytes)
        xs = [(torch.randn((R, D), generator=gen, device="cuda") * 2 + 0.5).bfloat16()
              for _ in range(copies)]
        ys = [torch.empty_like(xs[0]) for _ in range(copies)]
        gamma = 1 + 0.1 * torch.randn((D,), generator=gen, device="cuda")
        beta = 0.1 * torch.randn((D,), generator=gen, device="cuda")

        def launch(lib, i=0):
            err = lib.sc_layer_norm_fwd(xs[i].data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                                        ys[i].data_ptr(), R, D, 1, 1e-5,
                                        torch.cuda.current_stream().cuda_stream)
            cuda_build.check(cuda_build.library(), err, "bench_gemm launch")

        want = fl.fused_ln_fwd(xs[0], gamma, beta, 1e-5)
        report, cold = {}, {}
        for name, lib in libs.items():
            launch(lib)
            torch.cuda.synchronize()
            if not torch.equal(ys[0], want):  # the parent's too: the same lanes and sums
                raise AssertionError(f"ln_fwd {shape}: copy {name} differs from the package")
            report[name] = device_ms(lambda lib=lib: launch(lib))
            cold[name] = cold_ms(lambda i, lib=lib: launch(lib, i), copies)
        report["package_launch"] = device_ms(lambda: fl.fused_ln_fwd(xs[0], gamma, beta, 1e-5))
        host = {name: host_us(lambda lib=lib: launch(lib)) for name, lib in libs.items()}
        gl, bl = gamma.bfloat16(), beta.bfloat16()
        library = device_ms(lambda: F.layer_norm(xs[0], (D,), gl, bl, 1e-5))
        library_cold = cold_ms(lambda i: F.layer_norm(xs[i], (D,), gl, bl, 1e-5), copies)
        print(json.dumps({"kernel": "fused_ln_fwd", "shape": shape, "R": R, "D": D,
                          "ms": report, "cold_ms": cold, "cold_copies": copies,
                          "library_ms": library, "library_cold_ms": library_cold,
                          "host_us": host,
                          "bound_ms": bound_ms(n_bytes + 8 * D, 8 * R * D, F32_FLOPS),
                          "device": torch.cuda.get_device_name(0)}), flush=True)


def sdpa_bwd_device_ms(qkv, mask, heads: int) -> float:
    """PyTorch's scaled_dot_product_attention backward alone (efficient-
    attention backend, the mask additive, no bias gradient) on one retained
    graph over q, k, v cut from qkv, on the card's clock. A yardstick, used
    nowhere in the package's path."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    B, L, three_d = qkv.shape
    q, k, v = (t.contiguous().requires_grad_() for t in
               qkv.view(B, L, 3, heads, three_d // 3 // heads).permute(2, 0, 3, 1, 4))
    bias = None if mask is None else mask.to(qkv.dtype)
    g = torch.randn_like(q)
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
        return device_ms(lambda: torch.autograd.grad(out, (q, k, v), g, retain_graph=True))


def bench_attn_dx(libs: dict, gen) -> None:
    for shape, (B, L, D, H, causal, din) in SHAPES["attn_dx"].items():
        hd = D // H
        qkv = torch.randn((B, L, 3 * D), generator=gen, device="cuda").bfloat16()
        g = torch.randn((B, L, D), generator=gen, device="cuda").bfloat16()
        w = (torch.randn((3 * D, din), generator=gen, device="cuda") * din ** -0.5).bfloat16()
        mask = causal_mask(L, device="cuda") if causal else None
        outs = (torch.empty_like(qkv), qkv.new_empty((B, L, din)),
                torch.empty((B, 3 * D), device="cuda"), torch.empty((3 * D,), device="cuda"))

        def launch(lib):
            err = lib.sc_attention_bwd_dx(
                qkv.data_ptr(), None if mask is None else mask.data_ptr(), g.data_ptr(),
                w.data_ptr(), *(t.data_ptr() for t in outs), B, L, H, hd, din, 1, hd ** -0.5,
                torch.cuda.current_stream().cuda_stream)
            cuda_build.check(cuda_build.library(), err, "bench_gemm launch")

        want = av.fused_attention_bwd_dx(qkv, mask, g, w, H)
        plain = av.reference_attention_bwd_dx(qkv, mask, g, w, H)
        peak = plain[1].float().abs().max().item()
        tol = 2.0 ** (math.floor(math.log2(peak)) - 7)  # one bf16 ulp at max|ref|
        report = {}
        for name, lib in libs.items():
            launch(lib)
            torch.cuda.synchronize()
            same = torch.equal(outs[0], want[0])  # dqkv: the same body in every copy
            if name == "parent":
                err = (outs[1].float() - plain[1].float()).abs().max().item()
                if not (same and err <= tol):
                    raise AssertionError(f"attn_dx {shape}: the parent's dx is {err} off (tol "
                                         f"{tol}) or its dqkv has other bits")
            elif not (same and torch.equal(outs[1], want[1]) and torch.equal(outs[3], want[2])):
                raise AssertionError(f"attn_dx {shape}: copy {name} differs from the package")
            report[name] = device_ms(lambda lib=lib: launch(lib))
        report["package_launch"] = device_ms(lambda: av.fused_attention_bwd_dx(qkv, mask, g, w, H))
        host = {name: host_us(lambda lib=lib: launch(lib)) for name, lib in libs.items()}
        dqkv = want[0]
        gemm = device_ms(lambda: torch.matmul(dqkv, w))
        sdpa = sdpa_bwd_device_ms(qkv, mask, H)
        unfused = device_ms(
            lambda: torch.matmul(fa.fused_attention_bwd_recompute_db(qkv, mask, g, H)[0], w))
        three_d = 3 * D
        n_bytes = B * L * (2 * three_d + D + din) * 2 + three_d * din * 2 + 4 * three_d
        flops = 5 * 2 * B * H * L * L * hd + 2 * B * L * three_d * din
        bound = bound_ms(n_bytes, flops)
        print(json.dumps({"kernel": "fused_attention_bwd_dx", "shape": shape, "B": B, "L": L,
                          "D": D, "heads": H, "din": din, "ms": report,
                          "plain_ms": device_ms(
                              lambda: av.reference_attention_bwd_dx(qkv, mask, g, w, H),
                              reps=3, inner=3),
                          "unfused_ms": unfused, "library_ms": sdpa + gemm,
                          "sdpa_bwd_ms": sdpa, "gemm_ms": gemm, "host_us": host,
                          "bound_ms": bound, "share": bound / report["package_launch"],
                          "plan": av.dx_kernel_plan(L, H, hd, din),
                          "device": torch.cuda.get_device_name(0)}), flush=True)


def ce_bench_inputs(B: int, N: int, D: int, gen):
    """The loss kernels' inputs as chip_smoke's phase 9 builds them: unit
    rows, unique column ids but one duplicated, each row's own id, six
    neighbor ids from the column ids with a 20% -1 share, weights in [0, 1),
    scale 50."""
    q = F.normalize(torch.randn((B, D), generator=gen, device="cuda"), dim=1)
    kmat = F.normalize(torch.randn((N, D), generator=gen, device="cuda"), dim=1)
    col_ids = torch.randperm(10 * N, generator=gen, device="cuda")[:N]
    col_ids[N // 2] = col_ids[0]
    gt = torch.arange(B, device="cuda") % N
    picks = col_ids[torch.randint(0, N, (B, 6), generator=gen, device="cuda")]
    nbr = torch.where(torch.rand((B, 6), generator=gen, device="cuda") < 0.8, picks, -1)
    alphas = torch.rand((B, 6), generator=gen, device="cuda")
    return fc.prepare_inputs(q, kmat, col_ids, gt, nbr, alphas, torch.tensor(50.0, device="cuda"))


def bench_ce(kernel: str, libs: dict, gen) -> None:
    kind, dk = (fc.DK, True) if kernel == "ce_dk" else (fc.DQ, False)
    for shape, (B, N, D) in SHAPES[kernel].items():
        inputs = ce_bench_inputs(B, N, D, gen)
        g = torch.full((B,), 1.0 / B, device="cuda")
        _, lse, mass = fc.spatial_ce_fwd(*inputs)
        out = torch.empty_like(inputs[1] if dk else inputs[0])
        dscale = torch.empty((), device="cuda")
        scratch = {}
        for name, lib in libs.items():
            n = ctypes.c_size_t()
            cuda_build.check(cuda_build.library(),
                             lib.sc_spatial_ce_scratch(kind, B, N, D, ctypes.byref(n)),
                             "bench_gemm scratch size")
            scratch[name] = torch.empty((max(1, n.value),), device="cuda")

        def launch(name, lib):
            ptrs = [t.data_ptr() for t in (*inputs, lse, mass, g)]
            tail = [out.data_ptr()] + ([] if dk else [dscale.data_ptr()])
            fn = lib.sc_spatial_ce_dk if dk else lib.sc_spatial_ce_dq
            err = fn(*ptrs, scratch[name].data_ptr(), scratch[name].numel(), *tail, B, N, D,
                     inputs[4].shape[1], torch.cuda.current_stream().cuda_stream)
            cuda_build.check(cuda_build.library(), err, "bench_gemm launch")

        entry = fc.spatial_ce_dk if dk else fc.spatial_ce_dq
        reference = fc.reference_spatial_ce_dk if dk else fc.reference_spatial_ce_dq
        want = entry(*inputs, lse, mass, g)
        plain = reference(*inputs, lse, mass, g)
        want_out = want if dk else want[0]
        plain_out = plain if dk else plain[0]
        tol = 1e-5 * plain_out.abs().max().item() + 1e-7
        report = {}
        for name, lib in libs.items():
            launch(name, lib)
            torch.cuda.synchronize()
            if name == "parent":
                err = (out - plain_out).abs().max().item()
                if not err <= tol:
                    raise AssertionError(f"{kernel} {shape}: the parent's kernel is {err} off "
                                         f"(tol {tol})")
            elif not (torch.equal(out, want_out) and (dk or torch.equal(dscale, want[1]))):
                raise AssertionError(f"{kernel} {shape}: copy {name} differs from the package")
            report[name] = device_ms(lambda name=name, lib=lib: launch(name, lib))
        report["package_launch"] = device_ms(lambda: entry(*inputs, lse, mass, g))
        plain_ms = device_ms(lambda: reference(*inputs, lse, mass, g))
        ids = 4 * (B + N + 2 * B * inputs[4].shape[1]) + 4
        n_bytes = 4 * (B + N) * D + ids + 3 * 4 * B + 4 * (N if dk else B) * D + (0 if dk else 4)
        bound = bound_ms(n_bytes, 4 * B * N * D, F32_FLOPS)
        print(json.dumps({"kernel": f"fused_spatial_ce_{kernel[3:]}", "shape": shape, "B": B,
                          "N": N, "D": D, "ms": report, "plain_ms": plain_ms,
                          "library_ms": None, "bound_ms": bound,
                          "share": bound / report["package_launch"],
                          "plan": fc.kernel_plan(kind, B, N, D),
                          "device": torch.cuda.get_device_name(0)}), flush=True)


def bench_ln_bwd(libs: dict, gen) -> None:
    for shape, (R, D, _) in SHAPES["ln_bwd"].items():
        n_bytes = 3 * R * D * 2 + 12 * D  # x, dy in, dx out; gamma in, dgamma, dbeta out
        copies = cold_copies(3 * R * D * 2)
        xs = [(torch.randn((R, D), generator=gen, device="cuda") * 2 + 0.5).bfloat16()
              for _ in range(copies)]
        dys = [torch.randn((R, D), generator=gen, device="cuda").bfloat16()
               for _ in range(copies)]
        dxs = [torch.empty_like(xs[0]) for _ in range(copies)]
        gamma = 1 + 0.1 * torch.randn((D,), generator=gen, device="cuda")
        dgdb = torch.empty((2 * D,), device="cuda")
        parts = {name: torch.empty((lib.sc_layer_norm_bwd_blocks(R) if name == "parent" else
                                    lib.sc_layer_norm_bwd_blocks(R, D, 1), 2 * D), device="cuda")
                 for name, lib in libs.items()}

        def launch(name, lib, i=0):
            err = lib.sc_layer_norm_bwd(xs[i].data_ptr(), gamma.data_ptr(), dys[i].data_ptr(),
                                        dxs[i].data_ptr(), parts[name].data_ptr(),
                                        dgdb.data_ptr(), R, D, 1, 1e-5,
                                        torch.cuda.current_stream().cuda_stream)
            cuda_build.check(cuda_build.library(), err, "bench_gemm launch")

        want = fl.fused_ln_bwd(xs[0], gamma, dys[0], 1e-5)
        plain = fl.reference_ln_bwd(xs[0], gamma, dys[0], 1e-5)
        report, cold = {}, {}
        for name, lib in libs.items():
            launch(name, lib)
            torch.cuda.synchronize()
            if parts[name].shape[0] != parts["package"].shape[0]:
                # another grid (the parent's, or another wave size): dx the same
                # bits; dgamma / dbeta summed over other partial rows
                errs = [(dgdb[D * j:D * (j + 1)] - plain[1 + j]).abs().max().item()
                        / plain[1 + j].abs().max().item() for j in (0, 1)]
                if not (torch.equal(dxs[0], want[0]) and max(errs) <= 1e-5):
                    raise AssertionError(f"ln_bwd {shape}: copy {name}'s dx has other bits or "
                                         f"its dgamma / dbeta are {errs} off (tol 1e-5 x max)")
            elif not (torch.equal(dxs[0], want[0]) and torch.equal(dgdb[:D], want[1])
                      and torch.equal(dgdb[D:], want[2])):
                raise AssertionError(f"ln_bwd {shape}: copy {name} differs from the package")
            report[name] = device_ms(lambda name=name, lib=lib: launch(name, lib))
            cold[name] = cold_ms(lambda i, name=name, lib=lib: launch(name, lib, i), copies)
        report["package_launch"] = device_ms(lambda: fl.fused_ln_bwd(xs[0], gamma, dys[0], 1e-5))
        host = {name: host_us(lambda name=name, lib=lib: launch(name, lib))
                for name, lib in libs.items()}
        # the library: F.layer_norm's backward to x, gamma and beta on retained graphs
        gl, bl = (gamma.bfloat16().requires_grad_(), torch.zeros_like(gamma).bfloat16()
                  .requires_grad_())
        xg = [x.detach().requires_grad_() for x in xs]
        ys = [F.layer_norm(x, (D,), gl, bl, 1e-5) for x in xg]
        library = device_ms(
            lambda: torch.autograd.grad(ys[0], (xg[0], gl, bl), dys[0], retain_graph=True))
        turn = itertools.cycle(range(copies))

        def library_cold():
            i = next(turn)
            return torch.autograd.grad(ys[i], (xg[i], gl, bl), dys[i], retain_graph=True)

        library_cold_ms = device_ms(library_cold, inner=4 * copies)
        del ys
        bound = bound_ms(n_bytes, 14 * R * D, F32_FLOPS)  # chip_smoke phase 12's count
        print(json.dumps({"kernel": "fused_ln_bwd", "shape": shape, "R": R, "D": D,
                          "ms": report, "cold_ms": cold, "cold_copies": copies,
                          "library_ms": library, "library_cold_ms": library_cold_ms,
                          "host_us": host, "bound_ms": bound,
                          "share_cold": bound / cold["package"] if "package" in cold else None,
                          "partial_rows": {name: t.shape[0] for name, t in parts.items()},
                          "device": torch.cuda.get_device_name(0)}), flush=True)


def block_inputs(B: int, L: int, D: int, gen, dtype=torch.bfloat16):
    """The attention half's inputs as chip_smoke's phase 22 draws them: x,
    then bench_block's parameter dict (f32 LayerNorm parameters and biases,
    weights in dtype in the port's (out, in) layout)."""
    x = torch.randn((B, L, D), generator=gen, device="cuda").to(dtype)
    p = dict(lng=1 + 0.05 * torch.randn((D,), generator=gen, device="cuda"),
             lnb=0.05 * torch.randn((D,), generator=gen, device="cuda"),
             wqkv=(torch.randn((3 * D, D), generator=gen, device="cuda") / D ** 0.5).to(dtype),
             bqkv=0.02 * torch.randn((3 * D,), generator=gen, device="cuda"),
             wout=(torch.randn((D, D), generator=gen, device="cuda") / D ** 0.5).to(dtype),
             bout=0.02 * torch.randn((D,), generator=gen, device="cuda"))
    return x, p


def block_bound_ms(B: int, L: int, D: int, item: int = 2, peak: float = BF16_FLOPS) -> float:
    """The attention half's bound: x and out, both weights and the f32
    vectors moved once; the two products and the attention's two."""
    flops = 2 * B * L * D * 4 * D + 4 * B * L * L * D
    return bound_ms((2 * B * L * D + 4 * D * D) * item + 4 * 6 * D, flops, peak)


def bench_fused_block(libs: dict, gen) -> None:
    for shape, (B, L, D, H, causal) in SHAPES["block"].items():
        x, p = block_inputs(B, L, D, gen)
        mask = causal_mask(L, device="cuda") if causal else None
        args = (x, p["lng"], p["lnb"], p["wqkv"], p["bqkv"], p["wout"], p["bout"])
        ws = torch.empty((fb.workspace_numel(B, L, D),), dtype=x.dtype, device="cuda")
        qkv, ctx = (t.data_ptr() for t in fb.split_workspace(ws, B, L, D))
        out = torch.empty_like(x)

        def launch(name, lib, refused_ok=False):
            work = [] if name == "parent" else [qkv, ctx]
            err = lib.sc_block_attn_fwd(*(t.data_ptr() for t in args),
                                        None if mask is None else mask.data_ptr(), *work,
                                        out.data_ptr(), B, L, D, H, 1, 1e-5, (D // H) ** -0.5,
                                        torch.cuda.current_stream().cuda_stream)
            if refused_ok and err == 1:  # cudaErrorInvalidValue: the copy's plan does not fit
                return False
            cuda_build.check(cuda_build.library(), err, "bench_gemm launch")
            return True

        with torch.no_grad():
            want = fb.fused_block_attn(*args, mask, H)
            plain = fb.reference_block_attn(*args, mask, H)
            peak = plain.float().abs().max().item()
            tol = 2.0 ** (math.floor(math.log2(peak)) - 7)  # one bf16 ulp at max|ref|
            report = {}
            for name, lib in libs.items():
                if not launch(name, lib, refused_ok=name not in ("package", "parent")):
                    report[name] = None  # a variant whose shared memory does not fit here
                    continue
                torch.cuda.synchronize()
                if name == "parent":
                    err = (out.float() - plain.float()).abs().max().item()
                    if not err <= tol:
                        raise AssertionError(f"block {shape}: the parent's kernel is {err} off "
                                             f"(tol {tol})")
                elif not torch.equal(out, want):
                    raise AssertionError(f"block {shape}: copy {name} differs from the package")
                report[name] = device_ms(lambda name=name, lib=lib: launch(name, lib))
            report["package_launch"] = device_ms(
                lambda: fb.fused_block_attn(*args, mask, H, workspace=ws))
            host = {name: host_us(lambda name=name, lib=lib: launch(name, lib))
                    for name, lib in libs.items() if report[name] is not None}
            unfused = device_ms(lambda: bench_block.shipped_layer(x, p, mask, H))
            library = device_ms(
                lambda: bench_block.shipped_layer(x, p, mask, H, bench_block.sdpa_attention))
            plain_ms = device_ms(lambda: fb.reference_block_attn(*args, mask, H), reps=3, inner=3)
        bound = block_bound_ms(B, L, D)
        kplan = fb.kernel_plan(L, D, H)
        landed, from_l2 = fb.weight_bytes(kplan)
        print(json.dumps({"kernel": "fused_block_attn", "shape": shape, "B": B, "L": L, "D": D,
                          "heads": H, "ms": report, "plain_ms": plain_ms, "unfused_ms": unfused,
                          "library_ms": library, "host_us": host, "bound_ms": bound,
                          "share": bound / report["package_launch"],
                          "weight_bytes_a_cta_from_plan": {"landed": landed,
                                                           "from_l2": from_l2},
                          "plan": kplan,
                          "device": torch.cuda.get_device_name(0)}), flush=True)


def sdpa_device_ms(qkv, heads: int, backend: str, backward: bool) -> float:
    """SDPA (``backend``: 'efficient' or 'flash') on q, k, v cut from qkv,
    no mask, on the card's clock: the forward with its logsumexp kept
    (inputs that require grad), or the backward alone on one retained graph
    (``backward``). A yardstick, used nowhere in the package's path."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    B, L, three_d = qkv.shape
    q, k, v = (t.contiguous().requires_grad_() for t in
               qkv.view(B, L, 3, heads, three_d // 3 // heads).permute(2, 0, 3, 1, 4))
    g = torch.randn_like(q)
    kind = {"efficient": SDPBackend.EFFICIENT_ATTENTION, "flash": SDPBackend.FLASH_ATTENTION}
    with sdpa_kernel(kind[backend]):
        if not backward:
            return device_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        out = F.scaled_dot_product_attention(q, k, v)
        return device_ms(lambda: torch.autograd.grad(out, (q, k, v), g, retain_graph=True))


def bf16_ulp(ref) -> float:
    """One bf16 ulp at max|ref|: the tolerance of a bf16 output whose f32
    sums run in another order than the plain version's."""
    return 2.0 ** (math.floor(math.log2(ref.float().abs().max().item())) - 7)


def bench_long_fwd(libs: dict, gen) -> None:
    for shape, (B, L, H, hd) in SHAPES["long_fwd"].items():
        qkv = torch.randn((B, L, 3 * H * hd), generator=gen, device="cuda").bfloat16()
        out = qkv.new_empty((B, L, H * hd))
        lse = torch.empty((H, B, L), device="cuda")

        def launch(lib):
            err = lib.sc_attention_long_fwd(qkv.data_ptr(), None, out.data_ptr(), lse.data_ptr(),
                                            B, L, H, hd, 1, hd ** -0.5,
                                            torch.cuda.current_stream().cuda_stream)
            cuda_build.check(cuda_build.library(), err, "bench_gemm launch")

        want_out, want_lse = fa.reference_attention_lse(qkv, None, H)
        tol = 2e-2  # bf16 context: ~1 output ulp at |o| < 4 (chip_smoke's KERNEL_TOL)
        report = {}
        for name, lib in libs.items():
            launch(lib)
            torch.cuda.synchronize()
            err = (out.float() - want_out.float()).abs().max().item()
            lse_err = (lse - want_lse).abs().max().item()
            if not (err <= tol and lse_err <= 1e-5 * max(1.0, want_lse.abs().max().item())):
                raise AssertionError(f"long_fwd {shape}: copy {name} is {err} / lse {lse_err} off")
            report[name] = device_ms(lambda lib=lib: launch(lib))
        n_bytes = B * L * 4 * H * hd * 2 + 4 * H * B * L
        bound = bound_ms(n_bytes, 4 * B * H * L * L * hd)
        library = {b: sdpa_device_ms(qkv, H, b, False) for b in ("efficient", "flash")}
        print(json.dumps({"kernel": "attention_long_fwd_lse", "shape": shape, "B": B, "L": L,
                          "heads": H, "hd": hd, "ms": report,
                          "plain_ms": device_ms(lambda: fa.reference_attention_lse(qkv, None, H),
                                                reps=3, inner=3),
                          "library_ms": library, "bound_ms": bound,
                          "share": bound / report["package"],
                          "device": torch.cuda.get_device_name(0)}), flush=True)


def bench_long_bwd(libs: dict, gen) -> None:
    from spatial_clip_tpu_torch.ops import attention_long as al

    for shape, (B, L, H, hd) in SHAPES["long_bwd"].items():
        qkv = torch.randn((B, L, 3 * H * hd), generator=gen, device="cuda").bfloat16()
        g = torch.randn((B, L, H * hd), generator=gen, device="cuda").bfloat16()
        lse = al.fused_attention_long_lse(qkv, None, H)[1]
        dqkv = torch.empty_like(qkv)
        n = 3 * H * hd
        db = torch.empty((n,), device="cuda")
        part = torch.empty((al.db_parts(B, L), n), device="cuda")
        stats = torch.empty((al.stats_rows(B, L, H), 2 * al.BWD_TILE), device="cuda")
        dims = (B, L, H, hd, 1, hd ** -0.5)

        out = qkv.new_empty((B, L, H * hd))
        lse2, lsum = torch.empty_like(lse), torch.empty_like(lse)
        split_stats = torch.empty((al.stats_rows(B, L, H), al.stat_row(True)), device="cuda")
        package = cuda_build.library()

        def launch(lib, recompute=False):
            """The saved-lse backward with db (dq with its partial rows and
            stats rows, dk/dv from the stats rows, db from the partials); with
            ``recompute``, the recompute-with-db option: the forward for the
            statistics first (the row max and log sum apart where the copy
            has the split entries), then the same kernels given them."""
            stream = torch.cuda.current_stream().cuda_stream
            partials = lib.sc_attention_long_db_partials
            partials.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p]
            split = recompute and all(hasattr(lib, fn) for fn in SPLIT_ENTRIES)
            lib.sc_attention_long_fwd.argtypes = package.sc_attention_long_fwd.argtypes
            errs = []
            if split:
                for fn in SPLIT_ENTRIES:
                    getattr(lib, fn).argtypes = getattr(package, fn).argtypes
                errs.append(lib.sc_attention_long_fwd_split(
                    qkv.data_ptr(), None, out.data_ptr(), lse2.data_ptr(), lsum.data_ptr(),
                    *dims, stream))
                ptrs = (qkv.data_ptr(), None, lse2.data_ptr(), lsum.data_ptr())
                errs += [lib.sc_attention_long_bwd_dq_split(
                             *ptrs, g.data_ptr(), dqkv.data_ptr(), None, part.data_ptr(),
                             split_stats.data_ptr(), *dims, stream),
                         lib.sc_attention_long_bwd_dkdv_split(
                             qkv.data_ptr(), None, None, lsum.data_ptr(), None, g.data_ptr(),
                             dqkv.data_ptr(), part.data_ptr(), split_stats.data_ptr(), *dims,
                             stream)]
            else:
                stat = lse
                if recompute:
                    errs.append(lib.sc_attention_long_fwd(qkv.data_ptr(), None, out.data_ptr(),
                                                          lse2.data_ptr(), *dims, stream))
                    stat = lse2
                errs += [lib.sc_attention_long_bwd_dq(
                             qkv.data_ptr(), None, stat.data_ptr(), g.data_ptr(), dqkv.data_ptr(),
                             None, part.data_ptr(), stats.data_ptr(), *dims, stream),
                         lib.sc_attention_long_bwd_dkdv(
                             qkv.data_ptr(), None, None, None, g.data_ptr(), dqkv.data_ptr(),
                             part.data_ptr(), stats.data_ptr(), *dims, stream)]
            errs.append(partials(part.data_ptr(), db.data_ptr(), part.shape[0], n, stream))
            for err in errs:
                cuda_build.check(cuda_build.library(), err, "bench_gemm launch")

        want, want_db = fa.reference_attention_bwd(qkv, None, lse, g, H)
        tol, db_tol = bf16_ulp(want), 2 ** -8 * want_db.abs().max().item() + 1e-4
        report, recompute = {}, {}
        for name, lib in libs.items():
            for re_, times in ((False, report), (True, recompute)):
                launch(lib, re_)
                torch.cuda.synchronize()
                err = (dqkv.float() - want.float()).abs().max().item()
                db_err = (db - want_db).abs().max().item()
                if not (err <= tol and db_err <= db_tol):
                    raise AssertionError(f"long_bwd {shape}: copy {name}'s dqkv is {err} off "
                                         f"(tol {tol}), db {db_err} (tol {db_tol}), recompute "
                                         f"{re_}")
                times[name] = device_ms(lambda lib=lib, re_=re_: launch(lib, re_))
        three_d = 3 * H * hd
        n_bytes = B * L * (2 * three_d + H * hd) * 2 + 4 * H * B * L + 4 * three_d
        bound = bound_ms(n_bytes, 5 * 2 * B * H * L * L * hd)
        library = {b: sdpa_device_ms(qkv, H, b, True) for b in ("efficient", "flash")}
        print(json.dumps({"kernel": "attention_long_bwd", "shape": shape, "B": B, "L": L,
                          "heads": H, "hd": hd, "ms": report, "recompute_db_ms": recompute,
                          "plain_ms": device_ms(
                              lambda: fa.reference_attention_bwd(qkv, None, lse, g, H),
                              reps=3, inner=3),
                          "library_ms": library, "bound_ms": bound,
                          "share": bound / report["package"],
                          "device": torch.cuda.get_device_name(0)}), flush=True)


BENCHES = {"mlp": bench_mlp, "ln_dense": bench_ln_dense, "ln_dense_dx": bench_ln_dense_dx,
           "ln_fwd": bench_ln_fwd, "attn_dx": bench_attn_dx,
           "ce_dq": lambda libs, gen: bench_ce("ce_dq", libs, gen),
           "ce_dk": lambda libs, gen: bench_ce("ce_dk", libs, gen), "ln_bwd": bench_ln_bwd,
           "block": bench_fused_block, "long_fwd": bench_long_fwd, "long_bwd": bench_long_bwd}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--kernels", default=",".join(SOURCES))
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of another commit whose kernel sources are timed beside")
    args = ap.parse_args(argv)
    names = parse_variants(args.variants, VARIANTS)
    kernels = parse_variants(args.kernels, SOURCES)
    if not torch.cuda.is_available():
        raise SystemExit("spatial_clip_tpu_torch.bench_gemm needs a CUDA GPU")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for kernel in kernels:
        libs = build(kernel, names, args.parent)
        BENCHES[kernel](libs, gen)


if __name__ == "__main__":
    main()
