"""A/B of the block-fused attention half against the unfused one, on one
CUDA GPU.

    python -m spatial_clip_tpu_torch.bench_block [--tower image|text|both]
        [--batch 256] [--rounds 6] [--reps 8]

The port's ``scripts/bench_block_kernel.py``. For each tower's geometry
(image: L 50, D 768, 12 heads; text: L 77, D 512, 8 heads, causal) it builds
12 layers of parameters drawn with numpy (``default_rng(i + 1)`` for layer i,
the script's distributions: bf16 weights, f32 LayerNorm parameters and
biases) and x from ``default_rng(0)`` in bf16, and chains the 12 layers
``--reps`` times in each of two arms:

- ``shipped``: the unfused serving half: one-pass LayerNorm, ``F.linear``,
  the ``fused_attention`` kernel, ``F.linear`` and the residual;
- ``block``: ``fused_block_attn``, the whole half in one kernel.

It first checks that the two arms' outputs differ by a mean relative
difference under 0.05 (the residual stream grows over 12 layers; the same
check as the JAX script's), then times them in alternating rounds, each
timed call closed by ``torch.cuda.synchronize()``, and prints one JSON
object per tower: ms per layer (median of rounds 2.. when there are more
than 2), every round's, the relative difference and the card. It writes no
file. Needs a CUDA GPU: there is no CPU fallback.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch
import torch.nn.functional as F

from spatial_clip_tpu_torch.models.transformer import _ln_apply
from spatial_clip_tpu_torch.ops.fused_attention import fused_attention
from spatial_clip_tpu_torch.ops.fused_block import fused_block_attn

LAYERS = 12
MAX_REL_DIFF = 0.05
TOWERS = {
    "image": dict(L=50, D=768, heads=12, causal=False),
    "text": dict(L=77, D=512, heads=8, causal=True),
}


def layer_params(D: int, layers: int = LAYERS, device="cuda"):
    """Layer i's parameters from ``default_rng(i + 1)``, drawn as the JAX
    script draws them ((D, 3D) and (D, D) weights) and stored in the port's
    (out, in) layout."""
    params = []
    for i in range(layers):
        r = np.random.default_rng(i + 1)
        p = dict(
            lng=torch.from_numpy(r.normal(1, 0.05, (D,)).astype(np.float32)),
            lnb=torch.from_numpy(r.normal(0, 0.05, (D,)).astype(np.float32)),
            wqkv=torch.from_numpy(r.normal(0, D ** -0.5, (D, 3 * D)).T.astype(np.float32)),
            bqkv=torch.from_numpy(r.normal(0, 0.02, (3 * D,)).astype(np.float32)),
            wout=torch.from_numpy(r.normal(0, D ** -0.5, (D, D)).T.astype(np.float32)),
            bout=torch.from_numpy(r.normal(0, 0.02, (D,)).astype(np.float32)),
        )
        p = {k: v.to(device) for k, v in p.items()}
        p["wqkv"], p["wout"] = p["wqkv"].bfloat16().contiguous(), p["wout"].bfloat16().contiguous()
        params.append(p)
    return params


def shipped_layer(x, p, mask, heads: int, attention=fused_attention):
    """The unfused half: one-pass f32 LayerNorm, the qkv GEMM, the attention
    kernel (or ``attention``, with its signature), the output GEMM, the
    residual in f32."""
    h = _ln_apply(x, p["lng"], p["lnb"], 1e-5, x.dtype, "onepass")
    ctx = attention(F.linear(h, p["wqkv"], p["bqkv"].to(x.dtype)), mask, heads)
    o = F.linear(ctx, p["wout"], p["bout"].to(x.dtype))
    return (x.float() + o.float()).to(x.dtype)


def sdpa_attention(qkv, mask, heads: int):
    """The unfused half's attention as PyTorch's scaled_dot_product_attention
    on q, k, v cut from qkv (the additive mask in qkv's dtype): a yardstick
    for :func:`shipped_layer`'s ``attention``, used nowhere in the port's
    path."""
    B, L, three_d = qkv.shape
    q, k, v = qkv.view(B, L, 3, heads, three_d // 3 // heads).permute(2, 0, 3, 1, 4)
    ctx = F.scaled_dot_product_attention(
        q, k, v, attn_mask=None if mask is None else mask.to(qkv.dtype))
    return ctx.transpose(1, 2).reshape(B, L, three_d // 3)


def block_layer(x, p, mask, heads: int):
    return fused_block_attn(x, p["lng"], p["lnb"], p["wqkv"], p["bqkv"], p["wout"], p["bout"],
                            mask, heads)


def run_tower(name: str, batch: int = 256, rounds: int = 6, reps: int = 8) -> dict:
    """Both arms on one tower's geometry: the parity check, then ``rounds``
    alternating timed rounds of ``reps`` chained 12-layer stacks."""
    if not torch.cuda.is_available():
        raise RuntimeError("spatial_clip_tpu_torch.bench_block needs a CUDA GPU")
    t = TOWERS[name]
    L, D, heads = t["L"], t["D"], t["heads"]
    x0 = torch.from_numpy(np.random.default_rng(0).normal(0, 1, (batch, L, D)).astype(
        np.float32)).cuda().bfloat16()
    params = layer_params(D)
    mask = (torch.full((L, L), -1e9, device="cuda").triu_(1) if t["causal"] else None)
    arms = {"shipped": shipped_layer, "block": block_layer}

    def run(layer):
        x = x0
        for _ in range(reps):
            for p in params:
                x = layer(x, p, mask, heads)
        return x

    with torch.no_grad():
        ys = {a: run(layer).float() for a, layer in arms.items()}
        ref = ys["shipped"]
        rel = ((ys["block"] - ref).abs().mean() / (ref.abs().mean() + 1e-9)).item()
        if not (np.isfinite(rel) and rel < MAX_REL_DIFF):
            raise AssertionError(f"bench_block {name}: block vs shipped mean relative "
                                 f"difference {rel} (limit {MAX_REL_DIFF})")
        del ys, ref
        times = {a: [] for a in arms}
        for _ in range(rounds):
            for a, layer in arms.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run(layer)
                torch.cuda.synchronize()
                times[a].append((time.perf_counter() - t0) * 1e3 / (reps * LAYERS))
    return {
        "tower": name, "batch": batch, "L": L, "D": D, "heads": heads, "layers": LAYERS,
        "reps": reps, "rounds": rounds, "rel_diff": rel,
        "device": torch.cuda.get_device_name(0),
        **{a: {"ms_per_layer_median": statistics.median(v[1:] if len(v) > 2 else v),
               "all": v} for a, v in times.items()},
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tower", default="both", choices=["image", "text", "both"])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--reps", type=int, default=8, help="chained 12-layer stacks per timed call")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("spatial_clip_tpu_torch.bench_block needs a CUDA GPU")
    for name in (["image", "text"] if args.tower == "both" else [args.tower]):
        print(json.dumps(run_tower(name, args.batch, args.rounds, args.reps)), flush=True)


if __name__ == "__main__":
    main()
