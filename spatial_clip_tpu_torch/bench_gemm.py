"""The bf16 wgmma kernels' and the fused LayerNorm forward's design constants
timed side by side, on one CUDA GPU.

    python -m spatial_clip_tpu_torch.bench_gemm [--variants package,cluster1,...]
        [--kernels mlp,ln_dense,ln_dense_dx,ln_fwd] [--parent DIR]

The kernels: the fused MLP forward (``mlp``, ``csrc/fused_mlp.cu``), the
LayerNorm -> dense forward and data gradient (``ln_dense``, ``ln_dense_dx``,
``csrc/fused_ln_dense.cu``), which feed wgmma from TMA rings, and the fused
LayerNorm forward (``ln_fwd``, ``csrc/fused_ln.cu``), a persistent row walk.
Their design constants are ``#ifndef`` macros in the sources (``KNOBS``:
each knob's macro per kernel) that nvcc ``-D`` sets: the cluster size (CTAs
along the rows that share each weight tile through a TMA multicast), the
most 128-column output blocks an MLP CTA owns (and so its column splits),
the most ring stages, and the LayerNorm forward's resident blocks an SM.
This script builds one copy of each source per variant (``VARIANTS``;
``package`` is the source as it is), all at once in parallel under
``build/bench_gemm/``. ``--parent DIR`` also builds the kernels' sources
of another checkout (the parent commit, unpacked with ``git archive``) and
times them beside.

At the main path's shapes (the MLP of the image and text towers at batch 256
and 64; ln_2 -> c_fc and ln_1 -> qkv of both towers at batch 256, forward
and dx; each tower's LayerNorm at batch 256; bf16, inputs from
``torch.Generator`` seed 0) it times every copy with CUDA events beside the
library calls that compute the same function
(``F.linear(F.gelu(F.linear(x)))``; ``F.linear(F.layer_norm(x))`` and its
backward to x on a retained graph; ``F.layer_norm``) and prints one JSON
object per kernel and shape: ms of each, the host's microseconds to enqueue
one launch of each (the tensor maps are encoded per call), the package's
launch plan, the bound (the larger of the bytes at 3.35 TB/s and the
products at 989 TFLOP/s bf16, or the LayerNorm's arithmetic at 67 TFLOP/s
f32) and the card. The dx and the LayerNorm forward are timed on the
card's clock alone (their launches queued behind a spin, so the host's
enqueue is not in it), and so are their library calls; the LayerNorm
forward and ``F.layer_norm`` both warm (the same input back to back) and
cold (over copies of x and y that together exceed the 50 MB L2). Every copy
must give the package launch's bits: the variants change the schedule,
never the sums; the parent's LN -> dense (forward and dx) and MLP kernels
are held to the plain version's tolerance, the parent's LayerNorm forward
to the package's bits. Needs a CUDA GPU and nvcc: there is no CPU fallback.
"""
from __future__ import annotations

import argparse
import itertools
import json
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from spatial_clip_tpu_torch.bench_dx import median_ms
from spatial_clip_tpu_torch.bench_fwd import build_copies, design_flags, parse_variants
from spatial_clip_tpu_torch.ops import cuda_build
from spatial_clip_tpu_torch.ops import fused_ln as fl
from spatial_clip_tpu_torch.ops import fused_ln_dense as fd
from spatial_clip_tpu_torch.ops import fused_mlp as fm

SOURCES = {"mlp": "fused_mlp.cu", "ln_dense": "fused_ln_dense.cu",
           "ln_dense_dx": "fused_ln_dense.cu", "ln_fwd": "fused_ln.cu"}
FUNCTIONS = {"mlp": ("sc_mlp_fwd",), "ln_dense": ("sc_ln_dense_fwd",),
             "ln_dense_dx": ("sc_ln_dense_bwd_dx",), "ln_fwd": ("sc_layer_norm_fwd",)}
KNOBS = {  # kernel: {knob: its macro in the kernel's source}
    "mlp": {"cluster": "SC_MLP_CLUSTER", "max_nb": "SC_MLP_MAX_NB",
            "stages": "SC_MLP_MAX_STAGES"},
    "ln_dense": {"cluster": "SC_LND_CLUSTER", "stages": "SC_LND_MAX_STAGES"},
    "ln_dense_dx": {"dx_cluster": "SC_LND_DX_CLUSTER", "dx_stages": "SC_LND_DX_MAX_STAGES"},
    "ln_fwd": {"ln_blocks": "SC_LN_FWD_BLOCKS"},
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
}
SHAPES = {  # kernel: {name: (R, width, hidden or N)}; ln_fwd: (R, width, 0)
    "mlp": {"image": (256 * 50, 768, 3072), "text": (256 * 77, 512, 2048),
            "image_serve": (64 * 50, 768, 3072), "text_serve": (64 * 77, 512, 2048)},
    "ln_dense": {"image_fc": (256 * 50, 768, 3072), "image_qkv": (256 * 50, 768, 2304),
                 "text_fc": (256 * 77, 512, 2048), "text_qkv": (256 * 77, 512, 1536)},
    "ln_fwd": {"image": (256 * 50, 768, 0), "text": (256 * 77, 512, 0)},
}
SHAPES["ln_dense_dx"] = SHAPES["ln_dense"]
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
    return build_copies(source, flags, FUNCTIONS[kernel], f"bench_gemm/{kernel}", sources)


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


BENCHES = {"mlp": bench_mlp, "ln_dense": bench_ln_dense, "ln_dense_dx": bench_ln_dense_dx,
           "ln_fwd": bench_ln_fwd}


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
