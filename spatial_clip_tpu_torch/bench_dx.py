"""Where the dx backward's time goes: its two phases timed apart, on one
CUDA GPU.

    python -m spatial_clip_tpu_torch.bench_dx [--tower image|text|both]
        [--batch 256] [--stages 3]

The kernel of ``attention_variants.fused_attention_bwd_dx``
(``csrc/attention_dx.cu``) runs, in each block, every head's backward (the
body) and then the block's dx rows (the product). This script builds three
copies of that source with the package's nvcc flags, in parallel, under
``build/bench_dx/``: ``kernel`` as it is, ``body`` without the product and
``product`` without the body (each reads what the buffers hold), with at
most ``--stages`` stages in the bf16 product's ring (nvcc
``-DSC_DX_MAX_STAGES``; the source's own when left out). For each tower's
training shape (image: (B, 50, 2304), W (2304, 768), no mask; text: (B,
77, 1536), W (1536, 512), causal; bf16, inputs from
``torch.Generator`` seed 0) it times the three with CUDA events beside the
package's launch, and prints one JSON object per tower: ms of each, the
package kernel's, and the card. It checks that the ``kernel`` copy gives the
package launch's bits. Needs a CUDA GPU and nvcc: there is no CPU fallback.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess

import torch

from spatial_clip_tpu_torch.models.transformer import causal_mask
from spatial_clip_tpu_torch.ops import attention_variants as av
from spatial_clip_tpu_torch.ops import cuda_build

TOWERS = {  # name: (L, D, heads, Din, causal)
    "image": (50, 768, 12, 768, False),
    "text": (77, 512, 8, 512, True),
}
PRODUCT = "  dxtc::dx_product_tc<HD>("
HEAD_LOOP = "  for (int h = 0; h < heads; ++h) {"
STAGES = "SC_DX_MAX_STAGES"


def build(stages):
    """name -> loaded library of each copy of csrc/attention_dx.cu."""
    text = (cuda_build.CSRC_DIR / "attention_dx.cu").read_text()
    for anchor in (PRODUCT, HEAD_LOOP):
        if text.count(anchor) != 1:
            raise RuntimeError(f"attention_dx.cu: expected one {anchor.strip()!r}")
    if text.count(f"#ifndef {STAGES}\n") != 1:
        raise RuntimeError(f"attention_dx.cu: expected one '#ifndef {STAGES}'")
    extra = [] if stages is None else [f"-D{STAGES}={int(stages)}"]
    copies = {"kernel": text,
              "body": text.replace(PRODUCT, "  if (false) dxtc::dx_product_tc<HD>("),
              "product": text.replace(HEAD_LOOP, "  for (int h = 0; h < 0; ++h) {")}
    root = cuda_build.BUILD_DIR.parent / "bench_dx"
    shutil.rmtree(root, ignore_errors=True)
    jobs = {}
    for name, source in copies.items():
        d = root / name
        d.mkdir(parents=True)
        for header in cuda_build.CSRC_DIR.glob("*.cuh"):
            shutil.copy(header, d / header.name)
        (d / "attention_dx.cu").write_text(source)
        jobs[name] = subprocess.Popen(
            [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, *extra, "-shared", "-o",
             str(d / "lib.so"), str(d / "attention_dx.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    argtypes = cuda_build.library().sc_attention_bwd_dx.argtypes
    libs = {}
    for name, proc in jobs.items():
        out, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name} failed:\n{out[-4000:]}")
        lib = ctypes.CDLL(str(root / name / "lib.so"))
        lib.sc_attention_bwd_dx.argtypes = argtypes
        lib.sc_attention_bwd_dx.restype = ctypes.c_int
        libs[name] = lib
    return libs


def median_ms(fn, reps: int = 7, inner: int = 20) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def sdpa_bwd_ms(q, k, v, bias, g) -> float:
    """PyTorch's scaled_dot_product_attention backward alone (efficient-
    attention backend, additive ``bias`` or None): ``torch.autograd.grad`` of
    one retained forward graph on q, k, v (SDPA's (B, heads, L, hd) layout)
    with the cotangent g; no bias gradient. A yardstick, used nowhere in the
    package's path."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=bias)
        return median_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), g, retain_graph=True))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tower", choices=("image", "text", "both"), default="both")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--stages", type=int, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("spatial_clip_tpu_torch.bench_dx needs a CUDA GPU")
    libs = build(args.stages)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for tower in ("image", "text") if args.tower == "both" else (args.tower,):
        L, D, H, din, causal = TOWERS[tower]
        B, hd = args.batch, D // H
        qkv = torch.randn((B, L, 3 * D), generator=gen, device="cuda").bfloat16()
        g = torch.randn((B, L, D), generator=gen, device="cuda").bfloat16()
        w = (torch.randn((3 * D, din), generator=gen, device="cuda") * din ** -0.5).bfloat16()
        mask = causal_mask(L, device="cuda") if causal else None
        outs = (torch.empty_like(qkv), qkv.new_empty((B, L, din)),
                torch.empty((B, 3 * D), device="cuda"), torch.empty((3 * D,), device="cuda"))

        def launch(lib):
            err = lib.sc_attention_bwd_dx(
                qkv.data_ptr(), None if mask is None else mask.data_ptr(), g.data_ptr(),
                w.data_ptr(), *(t.data_ptr() for t in outs), B, L, H, hd, din,
                cuda_build.DTYPE_CODES[qkv.dtype], hd ** -0.5,
                torch.cuda.current_stream().cuda_stream)
            cuda_build.check(cuda_build.library(), err, "bench_dx launch")

        launch(libs["kernel"])
        want = av.fused_attention_bwd_dx(qkv, mask, g, w, H)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(outs[:2], want[:2])):
            raise AssertionError(f"{tower}: the kernel copy's dqkv, dx differ from the package's")
        report = {f"{name}_ms": median_ms(lambda lib=lib: launch(lib))
                  for name, lib in libs.items()}
        report["package_ms"] = median_ms(lambda: av.fused_attention_bwd_dx(qkv, mask, g, w, H))
        print(json.dumps({"tower": tower, "batch": B, "stages": args.stages, **report,
                          "device": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    main()
