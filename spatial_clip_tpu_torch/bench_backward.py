"""The bf16 attention backward's design choices timed side by side, on one
CUDA GPU.

    python -m spatial_clip_tpu_torch.bench_backward [--variants package,two_pass,...]
        [--batch 256,1024]

The backward body (``csrc/attention_bwd.cuh`` ``tc::``, launched by
``csrc/fused_attention_bwd.cu``) keeps a query row's scores and dp in
registers through its first pass when the row has at most ``kHold`` chunks
of 16 keys, and recomputes them in each sweep otherwise; its launch bounds
size registers for ``kMinBlocks`` blocks an SM. This script builds one copy
of that source per variant, with those constants at hd 32 and 64 set by nvcc
``-D`` (``KNOBS``: the macro whose ``#ifndef`` default in the header each
knob overrides; ``VARIANTS``: each knob's value; hd 128 keeps the
package's), all at once in parallel under ``build/bench_backward/``;
``package`` is the source as it is.

For each tower's shape (image: (B, 50, 2304), no mask; text: (B, 77, 1536),
causal; bf16, inputs from ``torch.Generator`` seed 0) and each batch, it
times every copy with CUDA events in two options, the saved-lse backward
with db (``sc_attention_bwd``, the default train step's) and the recompute
backward (``sc_attention_bwd_recompute``), beside PyTorch's
``scaled_dot_product_attention`` backward (efficient-attention backend,
``torch.autograd.grad`` on one retained graph) on the same q, k, v and
cotangent, and prints one JSON object per tower and batch: ms of each, the
registers, spill bytes and resident blocks an SM of each copy's two
kernels, the bound (qkv, do and lse read once, dqkv and db written once, at
3.35 TB/s) and the card. Every copy must give the package launch's bits:
the variants change the schedule, never the sums. Needs a CUDA GPU and
nvcc: there is no CPU fallback.
"""
from __future__ import annotations

import argparse
import ctypes
import json

import torch

from spatial_clip_tpu_torch.bench_dx import median_ms, sdpa_bwd_ms
from spatial_clip_tpu_torch.bench_fwd import (
    HBM_BYTES_PER_S,
    build_copies,
    design_flags,
    parse_variants,
)
from spatial_clip_tpu_torch.models.transformer import causal_mask
from spatial_clip_tpu_torch.ops import cuda_build
from spatial_clip_tpu_torch.ops.fused_attention import (
    fused_attention_bwd,
    fused_attention_bwd_recompute,
    fused_attention_lse,
)

TOWERS = {"image": (50, 768, 12, False), "text": (77, 512, 8, True)}  # L, D, heads, causal
HEADER = "attention_bwd.cuh"
KNOBS = {"hold": "SC_BWD_HOLD", "min_blocks": "SC_BWD_MIN_BLOCKS"}  # knob: its macro in HEADER
VARIANTS = {  # name: {knob: its value at hd 32 and 64}; the package's otherwise
    "package": {},
    "hold4": {"hold": 4},
    "two_pass": {"hold": 0},
    "min_blocks1": {"min_blocks": 1},
}


def build(names):
    """name -> loaded library of each copy of csrc/fused_attention_bwd.cu."""
    header = (cuda_build.CSRC_DIR / HEADER).read_text()
    return build_copies(
        "fused_attention_bwd.cu",
        {name: design_flags(header, KNOBS, VARIANTS[name]) for name in names},
        ("sc_attention_bwd", "sc_attention_bwd_recompute", "sc_attention_bwd_occupancy"),
        "bench_backward")


def occupancy(lib, seq: int, hd: int, option: int) -> dict:
    """A bf16 kernel's registers a thread, local bytes a thread and resident
    blocks an SM at this length (option 0: saved lse with db, 1: recompute)."""
    regs, local, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = lib.sc_attention_bwd_occupancy(seq, hd, 1, option, ctypes.byref(regs),
                                         ctypes.byref(local), ctypes.byref(blocks))
    cuda_build.check(cuda_build.library(), err, "sc_attention_bwd_occupancy")
    return {"registers": regs.value, "local_bytes": local.value, "blocks_per_sm": blocks.value}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--batch", default="256,1024")
    args = ap.parse_args(argv)
    names = parse_variants(args.variants, VARIANTS)
    if not torch.cuda.is_available():
        raise SystemExit("spatial_clip_tpu_torch.bench_backward needs a CUDA GPU")
    libs = build(names)
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    for B in (int(b) for b in args.batch.split(",")):
        for tower, (L, D, H, causal) in TOWERS.items():
            hd = D // H
            qkv = torch.randn((B, L, 3 * D), generator=gen, device="cuda").bfloat16()
            g = torch.randn((B, L, D), generator=gen, device="cuda").bfloat16()
            mask = causal_mask(L, device="cuda") if causal else None
            mask_ptr = None if mask is None else mask.data_ptr()
            _, lse = fused_attention_lse(qkv, mask, H)
            dqkv = torch.empty_like(qkv)
            part = torch.empty((B, 3 * D), device="cuda")
            db = torch.empty((3 * D,), device="cuda")

            def launch(lib, saved):
                if saved:
                    err = lib.sc_attention_bwd(qkv.data_ptr(), mask_ptr, lse.data_ptr(),
                                               g.data_ptr(), dqkv.data_ptr(), part.data_ptr(),
                                               db.data_ptr(), B, L, H, hd, 1, hd ** -0.5, stream())
                else:
                    err = lib.sc_attention_bwd_recompute(qkv.data_ptr(), mask_ptr, g.data_ptr(),
                                                         dqkv.data_ptr(), B, L, H, hd, 1,
                                                         hd ** -0.5, stream())
                cuda_build.check(cuda_build.library(), err, "bench_backward launch")

            want, want_db = fused_attention_bwd(qkv, mask, lse, g, H)
            want_re = fused_attention_bwd_recompute(qkv, mask, g, H)
            report = {}
            for name, lib in libs.items():
                launch(lib, True)
                torch.cuda.synchronize()
                same = torch.equal(dqkv, want) and torch.equal(db, want_db)
                launch(lib, False)
                torch.cuda.synchronize()
                if not (same and torch.equal(dqkv, want_re)):
                    raise AssertionError(f"{tower} B={B}: copy {name} differs from the package")
                report[name] = {"lse_db_ms": median_ms(lambda lib=lib: launch(lib, True)),
                                "recompute_ms": median_ms(lambda lib=lib: launch(lib, False)),
                                "lse_db": occupancy(lib, L, hd, 0),
                                "recompute": occupancy(lib, L, hd, 1)}
            report["package_launch"] = {
                "lse_db_ms": median_ms(lambda: fused_attention_bwd(qkv, mask, lse, g, H)),
                "recompute_ms": median_ms(lambda: fused_attention_bwd_recompute(qkv, mask, g, H))}
            q, k, v = (t.contiguous() for t in qkv.view(B, L, 3, H, hd).permute(2, 0, 3, 1, 4))
            n_bytes = (2 * qkv.numel() + g.numel()) * qkv.element_size()
            print(json.dumps({
                "tower": tower, "batch": B, **report,
                "sdpa_bwd_ms": sdpa_bwd_ms(q, k, v, None if mask is None else mask.to(qkv.dtype),
                                           g.view(B, L, H, hd).transpose(1, 2).contiguous()),
                "bound_ms": {"lse_db": (n_bytes + lse.numel() * 4 + db.numel() * 4)
                             / HBM_BYTES_PER_S * 1e3,
                             "recompute": n_bytes / HBM_BYTES_PER_S * 1e3},
                "device": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    main()
