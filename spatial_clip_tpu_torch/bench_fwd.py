"""The bf16 attention forward's design choices timed side by side, on one
CUDA GPU.

    python -m spatial_clip_tpu_torch.bench_fwd [--variants package,two_pass,...]
        [--batch 256,1024]

The forward body (``csrc/attention_fwd.cuh``, launched by
``csrc/fused_attention_fwd.cu``) keeps a row's scores in registers from
Q K^T to P V when the row has at most ``kHold`` chunks of 16 keys, and
recomputes them otherwise; its launch bounds size registers for
``kMinBlocks`` blocks an SM. This script builds one copy of that source per
variant, with those constants at hd 32 and 64 set by nvcc ``-D`` (``KNOBS``:
the macro whose ``#ifndef`` default in the header each knob overrides;
``VARIANTS``: each knob's value; hd 128 keeps the package's), all at once in
parallel under ``build/bench_fwd/``; ``package`` is the source as it is.

For each tower's shape (image: (B, 50, 2304), no mask; text: (B, 77, 1536),
causal; bf16, inputs from ``torch.Generator`` seed 0) and each batch, it
times every copy with CUDA events, with and without the logsumexp, beside
PyTorch's ``scaled_dot_product_attention`` (efficient-attention backend) on
the same q, k, v, and prints one JSON object per tower and batch: ms of
each, its registers and resident blocks an SM, the bound (qkv read once, the context and lse
written once, at 3.35 TB/s), and the card. Every copy must give the
package launch's bits: the variants change the schedule, never the sums.
Needs a CUDA GPU and nvcc: there is no CPU fallback.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess

import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from spatial_clip_tpu_torch.bench_dx import median_ms
from spatial_clip_tpu_torch.models.transformer import causal_mask
from spatial_clip_tpu_torch.ops import cuda_build
from spatial_clip_tpu_torch.ops.fused_attention import fused_attention, fused_attention_lse

TOWERS = {"image": (50, 768, 12, False), "text": (77, 512, 8, True)}  # L, D, heads, causal
HEADER = "attention_fwd.cuh"
KNOBS = {"hold": "SC_FWD_HOLD", "min_blocks": "SC_FWD_MIN_BLOCKS"}  # knob: its macro in HEADER
VARIANTS = {  # name: {knob: its value at hd 32 and 64}; the package's otherwise
    "package": {},
    "min_blocks1": {"min_blocks": 1},
    "min_blocks3": {"min_blocks": 3},
    "hold8": {"hold": 8},
    "two_pass": {"hold": 0},
    "two_pass_min_blocks3": {"hold": 0, "min_blocks": 3},
}
HBM_BYTES_PER_S = 3.35e12


def parse_variants(text: str, variants: dict) -> list:
    """The comma-separated names of ``--variants``, each a key of
    ``variants``, in order and without repeats."""
    names = [n.strip() for n in text.split(",") if n.strip()]
    unknown = [n for n in names if n not in variants]
    if unknown or not names:
        raise ValueError(f"variants {unknown or text!r}: choose from {', '.join(variants)}")
    return list(dict.fromkeys(names))


def design_flags(header: str, knobs: dict, values: dict) -> list:
    """nvcc's ``-D`` flags that set each knob of ``values`` (knob: its value
    at hd 32 and 64); every knob's macro must have one ``#ifndef`` default in
    ``header``, or the flag would set nothing."""
    for macro in knobs.values():
        if header.count(f"#ifndef {macro}\n") != 1:
            raise RuntimeError(f"expected one '#ifndef {macro}'")
    return [f"-D{knobs[knob]}={int(value)}" for knob, value in values.items()]


def build_copies(source_name: str, flags: dict, functions, root_name: str, sources=None):
    """name -> loaded library of one build of ``csrc/<source_name>`` per entry
    of ``flags`` (name -> its extra nvcc flags), compiled with the package's
    nvcc flags, all at once in parallel, under ``build/<root_name>/``; each
    copy's ``functions`` take the package library's argtypes. ``sources``
    (name -> a path) builds that entry from another copy of the source."""
    root = cuda_build.BUILD_DIR.parent / root_name
    shutil.rmtree(root, ignore_errors=True)
    jobs = {}
    for name, extra in flags.items():
        d = root / name
        d.mkdir(parents=True)
        src = (sources or {}).get(name, cuda_build.CSRC_DIR / source_name)
        jobs[name] = subprocess.Popen(
            [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, *extra, "-shared", "-o",
             str(d / "lib.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    package = cuda_build.library()
    libs = {}
    for name, proc in jobs.items():
        out, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name} failed:\n{out[-4000:]}")
        lib = ctypes.CDLL(str(root / name / "lib.so"))
        for fn in functions:
            getattr(lib, fn).argtypes = getattr(package, fn).argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def build(names):
    """name -> loaded library of each copy of csrc/fused_attention_fwd.cu."""
    header = (cuda_build.CSRC_DIR / HEADER).read_text()
    return build_copies(
        "fused_attention_fwd.cu",
        {name: design_flags(header, KNOBS, VARIANTS[name]) for name in names},
        ("sc_attention_fwd", "sc_attention_fwd_occupancy"), "bench_fwd")


def occupancy(lib, seq: int, hd: int) -> dict:
    """The bf16 kernel's registers a thread, local bytes a thread and
    resident blocks an SM at this length."""
    regs, local, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = lib.sc_attention_fwd_occupancy(seq, hd, 1, ctypes.byref(regs), ctypes.byref(local),
                                         ctypes.byref(blocks))
    cuda_build.check(cuda_build.library(), err, "sc_attention_fwd_occupancy")
    return {"registers": regs.value, "local_bytes": local.value, "blocks_per_sm": blocks.value}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--batch", default="256,1024")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("spatial_clip_tpu_torch.bench_fwd needs a CUDA GPU")
    libs = build(parse_variants(args.variants, VARIANTS))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B in (int(b) for b in args.batch.split(",")):
        for tower, (L, D, H, causal) in TOWERS.items():
            hd = D // H
            qkv = torch.randn((B, L, 3 * D), generator=gen, device="cuda").bfloat16()
            mask = causal_mask(L, device="cuda") if causal else None
            out, lse = torch.empty((B, L, D), dtype=qkv.dtype, device="cuda"), torch.empty(
                (H, B, L), device="cuda")

            def launch(lib, with_lse):
                err = lib.sc_attention_fwd(
                    qkv.data_ptr(), None if mask is None else mask.data_ptr(), out.data_ptr(),
                    lse.data_ptr() if with_lse else None, B, L, H, hd, 1, hd ** -0.5,
                    torch.cuda.current_stream().cuda_stream)
                cuda_build.check(cuda_build.library(), err, "bench_fwd launch")

            want_out, want_lse = fused_attention_lse(qkv, mask, H)
            report = {}
            for name, lib in libs.items():
                launch(lib, True)
                torch.cuda.synchronize()
                if not (torch.equal(out, want_out) and torch.equal(lse, want_lse)):
                    raise AssertionError(f"{tower} B={B}: copy {name} differs from the package")
                report[name] = {"lse_ms": median_ms(lambda lib=lib: launch(lib, True)),
                                "fwd_ms": median_ms(lambda lib=lib: launch(lib, False)),
                                **occupancy(lib, L, hd)}
            report["package_launch"] = {
                "lse_ms": median_ms(lambda: fused_attention_lse(qkv, mask, H)),
                "fwd_ms": median_ms(lambda: fused_attention(qkv, mask, H))}
            q, k, v = (t.contiguous() for t in qkv.view(B, L, 3, H, hd).permute(2, 0, 3, 1, 4))
            bias = None if mask is None else mask.to(qkv.dtype)
            qg = q.detach().requires_grad_()
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                with torch.no_grad():
                    sdpa = median_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias))
                sdpa_lse = median_ms(lambda: F.scaled_dot_product_attention(qg, k, v,
                                                                            attn_mask=bias))
            n_bytes = (qkv.numel() + out.numel()) * qkv.element_size()
            print(json.dumps({
                "tower": tower, "batch": B, **report,
                "sdpa_ms": {"fwd": sdpa, "fwd_lse": sdpa_lse},
                "bound_ms": {"fwd": n_bytes / HBM_BYTES_PER_S * 1e3,
                             "fwd_lse": (n_bytes + lse.numel() * 4) / HBM_BYTES_PER_S * 1e3},
                "device": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    main()
