"""Where the serving path's time goes on the GPU.

    python -m spatial_clip_tpu_torch.profile_serving [--model ViT-B-32] [--batch 64]

Encodes one batch of tiles and one batch of texts under ``torch.profiler``
(after a warmup) and prints, for each tower, the wall time of the encode
(host clock, ending in a synchronize), the device's busy time (the union of
its kernel intervals), the idle share, and device time by kernel family.
Needs a CUDA GPU: there is no CPU fallback.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from spatial_clip_tpu_torch.models.factory import create_model, get_tokenizer
from spatial_clip_tpu_torch.models.transforms import normalize_batch

FAMILIES = (  # first match wins; matched against the lower-cased kernel name
    # the port's own kernels (csrc/), a family each; the attention families hold the zip
    # path's pair kernels (attention_pair.cu) and the layouts' kernels
    # (attention_layouts.cu) too
    ("attention (fused_attention_fwd)", ("attn_fwd_kernel", "attn_pair_fwd_kernel",
                                         "attn_layout_fwd_kernel")),
    ("attention backward (fused_attention_bwd)", ("attn_bwd_kernel", "attn_pair_bwd_kernel",
                                                  "attn_layout_bwd_kernel", "db_reduce_kernel")),
    ("attention backward with dx (attention_dx)", ("attn_bwd_dx_kernel",)),
    ("attention past the resident lengths (attention_long)", (
        "long_fwd_kernel", "long_dq_kernel", "long_dkdv_kernel", "long_db_kernel")),
    ("block attention (fused_block)", ("block_attn_kernel",)),
    ("fused_ln forward (fused_ln)", ("ln_fwd_kernel",)),
    ("fused_ln backward (fused_ln)", ("ln_bwd_kernel", "column_sum_kernel")),
    ("LN -> dense forward (fused_ln_dense)", ("ln_dense_fwd_kernel",)),
    ("LN -> dense dx (fused_ln_dense)", ("ln_dense_dx_kernel",)),
    ("fused MLP forward (fused_mlp)", ("mlp_fwd_kernel",)),
    ("fused spatial CE (fused_spatial_ce)", ("spatial_ce_kernel", "ce_fwd_combine_kernel",
                                             "sum_splits_kernel", "dscale_kernel")),
    # PyTorch's and the libraries' kernels
    ("gemm", ("gemm", "sm90_xmma", "cutlass", "cublas", "nvjet", "matmul")),
    ("reduce (LayerNorm stats, pooling)", ("reduce",)),
    ("elementwise (LayerNorm affine, GELU, residual, casts)", ("elementwise", "vectorized")),
    ("copy / cat / gather", ("copy", "cat", "index", "gather", "memcpy", "memset")),
)


def _family(name: str) -> str:
    low = name.lower()
    for family, keys in FAMILIES:
        if any(k in low for k in keys):
            return family
    return "other"


def _busy_ms(intervals) -> float:
    """Length of the union of [start, end) intervals (microseconds in, ms out)."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3


def profile_encode(fn, reps: int = 5) -> dict:
    """Wall time of ``fn`` unprofiled (median of 20), then device time under
    the profiler (also used for the train step, by ``bench --profile``)."""
    for _ in range(3):
        fn()
    walls = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_family = defaultdict(float)
    by_name = defaultdict(float)
    for e in kernels:
        by_family[_family(e.name)] += e.device_time / 1e3 / reps
        by_name[e.name] += e.device_time / 1e3 / reps
    busy = _busy_ms((e.time_range.start, e.time_range.end) for e in kernels) / reps
    wall = statistics.median(walls)  # the device may not overlap reps: busy is per rep
    return {
        "wall_ms": wall,
        "device_busy_ms": busy,
        "idle_share": 1.0 - busy / wall if wall else None,
        "kernels_per_encode": len(kernels) / reps,
        "device_ms_by_family": dict(sorted(by_family.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8]),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="ViT-B-32")
    ap.add_argument("--batch", type=int, default=64)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving needs a CUDA GPU")
    model = create_model(args.model, precision="bf16", seed=0, device="cuda")
    tok = get_tokenizer(args.model)
    size = int(model.cfg.vision_cfg.size)
    rng = np.random.default_rng(0)
    tiles = torch.from_numpy(rng.integers(0, 256, (args.batch, size, size, 3), np.uint8)).cuda()
    ids = torch.from_numpy(tok([f"spatial transcriptomics spot {i}" for i in range(args.batch)]))
    ids = ids.long().cuda()
    with torch.inference_mode():
        report = {
            "device": torch.cuda.get_device_name(0),
            "image": profile_encode(lambda: model.encode_image(
                normalize_batch(tiles, dtype=model.dtype))),
            "text": profile_encode(lambda: model.encode_text(ids)),
        }
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
