#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA GPU, ``nvcc`` and
PyTorch built for CUDA. Each phase prints one line; any failure raises and
the exit code is not 0. No JAX is imported.

1. device  the card's name and power limit, as nvidia-smi reports them
2. build   the CUDA kernels, compiled from spatial_clip_tpu_torch/csrc; ptxas's
           registers and spills, and for the bf16 attention forward and
           backward (the tensor-core bodies) their registers, spills and
           blocks an SM; for the wgmma kernels (fused MLP, LN -> dense, the
           attention dx, the block half) their registers, spills and any
           wgmma ptxas serialized; the fused_ln backward's at D 512 / 768 /
           1024 and its blocks an SM
3. kernel  the inference attention kernel against its plain PyTorch version
           at the serving shapes (batch 64) and at phase 11's microbatch
           (1024, pass 1 and evaluate): max abs error against the stated
           tolerance, median times; then the bf16 forward with and without
           lse at the body's tile edges and two-pass lengths
           (EDGE_LENGTHS, batch 8, hd 64, causal and not)
4. serve   the ViT-B-32 embedding server (bf16, batch 64) on 127.0.0.1
           answers text and raw-image requests; every attention of the run
           went through the kernel (12 launches per encoder batch), and the
           embeddings agree with the same weights run in f32 on the CPU
5. timing  median encode time per batch of 64 tiles and of 64 texts, and the
           median latency of a 64-tile request through the server
6. kernel-train  the training attention kernels (forward with logsumexp,
           backward with the bias gradient, the backward that recomputes
           the softmax statistics, which phase 14's ln_gemm_impl setting
           runs, and the recompute backward with the bias gradient, which
           phase 18's batches take) against their plain versions at the two
           towers' shapes at batch 256 (phase 8) and at microbatch 1024
           (phase 11's pass 2), and one f32 shape; db the same bits on a
           rerun; then the bf16 backward in its three options at the
           tensor-core body's tile edges and longest length
           (BWD_EDGE_LENGTHS, batch 8, 4 heads of 32 / 64 / 128, causal
           and not) against the plain version on the same lse, with the
           share of dqkv elements on the plain version's bits and the mean
           signed error of each case
7. train-check  one ViT-B-32 train step's loss and gradients at batch 32 on
           the card (bf16, kernels) against the CPU (f32, plain path), on the
           same weights, batch and augmentation draws
8. train   the ViT-B-32 spatial train step (bf16, batch 256, full depth, the
           workload of ``python -m spatial_clip_tpu_torch.bench``): 3 warmup
           and 10 timed steps, finite losses and gradient norms, 24 forward
           and 24 backward attention launches per step; median step ms,
           pairs/s and peak device memory
9. kernel-loss  the fused spatial cross-entropy kernels (forward, dq, dK)
           against their plain versions in f32 at B = N = 1024, 2048 and a
           ragged 1000 x 1999 (D 512, k 6, scale 50, -1 neighbors, one
           duplicated column id); errors, times, bound shares and the
           backward's plan; then the backward's edges (D 1, 65, 511, 513,
           1536 x (B, N) (1, 1), (63, 2049), (2049, 63) x k 0 and 16), dq,
           dK and dscale the same bits on a rerun
10. loss-check  one ViT-B-32 step at batch 32 with grad_accum=2 (cached) and
           the fused loss, card (bf16, kernels) vs CPU (f32, plain path), on
           the same weights, batch and draws; and the fused loss against the
           dense one on the same f32 features on the card
11. train-large  Trainer.fit on ViT-B-32 bf16 at global batch 2048 = 2 x 1024
           (cached accumulation, fused loss capped at 50, k 6) from numpy
           batches: 4 steps, exact kernel launch counts per step, finite
           losses and gradient norms, then Trainer.evaluate on 2 batches of
           1024; median step ms, pairs/s, peak memory, eval R@1
12. kernel-ln  the LayerNorm kernels (fused_ln forward and backward,
           fused_ln_dense forward and dx) against their plain versions at the
           training shapes (batch 256: image (12800, 768), text (19712, 512);
           image c_fc 768 -> 3072, image qkv 768 -> 2304, text c_fc 512 ->
           2048, text qkv 512 -> 1536) and at ragged row counts (one f32);
           dgamma/dbeta the same
           bits on a rerun (and the backward's dx); F.layer_norm and
           F.linear(F.layer_norm) timed as yardsticks (the fused_ln forward
           and backward and F.layer_norm's also on the card's clock alone,
           warm and over copies past the L2: cold), with each kernel's share
           of its bound; the fused_ln backward at its one-wave grid's edges
           (LN_BWD_EDGE_*); then the bf16 fused_ln_dense forward
           and dx (wgmma) at the row tiles' and clusters' edges
           (GEMM_EDGE_ROWS), every K to 1024 and N past whole 256-column
           tiles, the same bits on a rerun, the dx plan's tiles and K-group,
           and their launches counted on the wgmma route
13. ln-check  under ln_impl='pallas' and under ln_gemm_impl='pallas' with
           attn_impl='pallas': phase 7's card-vs-CPU step at batch 32, and 64
           tiles and 64 texts encoded in bf16 against the f32 CPU plain path
           (per-row cosine, exact launches per encode)
14. train-ln  phase 8's bench workload under each of the two settings:
           exact launches per step (51 + 51 fused_ln and 24 + 24 attention
           forward-lse and backward; 48 + 48 fused_ln_dense and 24 + 24
           attention inference forward and recompute backward), finite
           losses, median step ms beside phase 8's, peak memory
15. kernel-mlp  the fused MLP kernel against its plain version at the
           training shapes (batch 256: image (12800, 768 -> 3072 -> 768),
           text (19712, 512 -> 2048 -> 512)), the serving shapes (batch 64),
           a ragged R = 1000 and one f32 shape; F.linear(F.gelu(F.linear))
           timed as its yardstick; each bf16 launch plan; then the bf16
           forward (wgmma) at the row tile's and cluster's edges
           (GEMM_EDGE_ROWS), every width it takes (2048: x streamed) and
           hidden sizes that are multiples of 512, the same bits on a rerun
           and its launches counted per route
16. mlp-check  under mlp_impl='pallas': phase 7's card-vs-CPU step at batch
           32, and the embedding server (bf16, batch 64) started with the
           setting answering 64 raw tiles and 64 texts against the f32 CPU
           plain path (per-row cosine), exactly 12 fused MLP launches per
           encoder batch
17. train-mlp  phase 8's bench workload under mlp_impl='pallas': exactly 24
           fused MLP and 24 + 24 attention launches per step, finite losses
           and gradient norms, median step ms beside phase 8's, peak memory
18. route-check  JAX's attention-backward routes: the card-vs-CPU step at
           batch 12 (no lse saved: 24 inference forward and 24 recompute
           with db launches), the same at batch 32 under BWD_FUSE='none' (24
           forward-lse and 24 recompute no-db launches), and three timed
           steps at batch 100 on the recompute-with-db route
19. kernel-pair  the zipped dual-tower kernels (both towers' inference
           forward, both towers' recompute backward without db) against their
           plain versions and, bit for bit, against the two single-tower
           launches, at the ViT-B-32 towers (image (B, 50, 2304), text (B, 77,
           1536) causal, bf16) at batch 256 and 64, and one f32 pair with
           unequal head dims (128 and 32); timed beside the two single-tower
           launches
20. zip-check  under zip_towers='on': phase 7's card-vs-CPU step at batch
           32 with exactly 12 pair forward and 12 pair backward launches and
           no single-tower attention launch; then 64 tiles and 64 texts
           through CLIP.forward(images, text) in bf16 against the f32 CPU
           plain path (per-row cosine, 12 pair forward launches)
21. train-zip  phase 8's bench workload under zip_towers='on': exactly 12 +
           12 pair launches per step and no single-tower attention launch,
           finite losses and gradient norms, median step ms beside phase 8's,
           peak memory
22. kernel-block  the block-fused attention half (fused_block_attn) against
           its plain version at the towers' shapes (image (B, 50, 768), 12
           heads; text (B, 77, 512), 8 heads, causal; B 256 and 64) and one
           f32 shape, the same bits on a rerun, each head's context in the
           bf16 workspace bit for bit sc_attention_fwd on the kernel's q|k|v;
           timed (also on the card's clock) beside the unfused half
           (one-pass LayerNorm, cuBLAS and the attention kernel) and the same
           with SDPA, with the weight bytes a CTA lands; then the bf16 kernel
           at its tiles' edges (BLOCK_EDGE_*: L 1..128, D 128..1024, hd 32 /
           64 / 128, causal and not, B 1 / 3 / 257); then
           ``spatial_clip_tpu_torch.bench_block`` for both towers (its main
           path: 12 chained layers, block vs unfused mean relative
           difference < 0.05, ms per layer of both)
23. kernel-layouts  the eight layout kernels (interleaved, slab, seq-major
           with a bias, split; forward and recompute backward) against their
           plain versions at batch 256 (image (256, 50, 2304) no mask, text
           (256, 77, 1536) causal, bf16) and one f32 shape, and bit for bit
           against the standard launches on the same data (interleaved vs
           the standard kernels after the permutation, split vs [q|k|v],
           seq-major vs the standard kernels on qkv_nb + b rounded to the
           dtype with db within f32 tolerance of the recompute-with-db db,
           slab vs the group kernels), the same bits on a rerun; timed beside
           the standard launch and SDPA. The slab kernels have no model path:
           their launches are those of this phase's timed runs
24. layouts-check  under attn_impl 'pallas_inter' (also with
           ln_gemm_impl='pallas'), 'pallas_t' and 'pallas_split': phase 7's
           card-vs-CPU step at batch 32, and CLIP.forward on 64 tiles and 64
           texts in bf16 against the f32 CPU plain path (per-row cosine),
           with exact launches per route (24 + 24 of the setting's own
           kernels a step, 24 forward an encode, none of the others)
25. train-layouts  phase 8's bench workload under each of the three
           settings: exactly 24 forward and 24 backward launches of the
           setting's own kernels per step and none of the standard attention
           kernels, finite losses and gradient norms, median step ms beside
           phase 8's, peak memory
26. kernel-dx  the attention backward that forms the qkv projection's input
           gradient dx = dqkv W in the launch (BWD_FUSE='dxdb') against its
           plain version at batch 256 (image (256, 50, 2304), W (2304, 768),
           no mask; text (256, 77, 1536), W (1536, 512), causal; bf16) and one
           f32 shape; dqkv bit for bit the recompute-with-db launch's, db
           within f32 tolerance of its db, dx and db the same bits on a
           rerun; timed beside the unfused route (the recompute-with-db
           kernel and torch.matmul(dqkv, W)) and the library route (SDPA's
           backward and the cuBLAS dx GEMM), with the bound, its share and
           the product's plan; then the bf16 product's edges (L 1..256 x hd
           32 / 64 / 128 x causal and not, B 1..257, Din 16..1024, 1-3
           heads), dqkv bit for bit and the same bits on a rerun
27. dxdb-check, train-dxdb  under BWD_FUSE='dxdb': phase 7's card-vs-CPU
           step at batch 32, then phase 8's bench workload, each with exactly
           24 forward-lse and 24 dx launches per step and no other attention
           backward; finite losses and gradient norms, median step ms beside
           phase 8's, peak memory
28. entry  the training and evaluation entry points on the repository's
           configs: ``spatial_clip_tpu_torch.train.entry.train`` (what
           ``python -m spatial_clip_tpu_torch.train`` runs) with data=synthetic
           (ViT-B-32 bf16, 224 px, batch 64, full width and depth), 4 steps,
           one epoch, a checkpoint every 2 steps (2 kept), validation and
           test; the launches per route of that run (24 forward-lse and 24
           saved-lse backward a step, 24 inference forwards a val/test batch,
           none of any other wrapper); a second run built by
           ``entry.build`` with ``resume=latest`` from step_2 takes batches 2
           and 3 of the same epoch and ends with the unbroken run's step-4
           params, mu and nu to the bit; ``spatial_clip_tpu_torch.eval`` on
           the checkpoints gives the train run's test metrics, with 24
           inference forwards a test batch; then the step ms and its device
           busy time (torch.profiler), the loader's wait per batch, fit's
           pairs/s over its train window (from its logged rates), the idle
           share that window implies beside the profiled step's busy time
           (derived, not traced), and a checkpoint's bytes, host-copy and
           write seconds

Phases 3, 6, 19, 23 and 26 also time PyTorch's scaled_dot_product_attention
(efficient-attention backend) at the kernels' shapes as a yardstick (its
backward alone, on one retained graph), phase
12 PyTorch's LayerNorm and linear layers, phase 15 its linear and GELU,
phase 22 the unfused half with SDPA, and phase 26 the cuBLAS dx GEMM; the
port never calls them.
Then one JSON line with the kernels (each with its launches on the main
path, error, time, plain time, bound and library time; the three kernels of
phase 28's path also with its launches there), the nvidia-smi line, and
last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import base64
import csv
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from http.client import HTTPConnection
from pathlib import Path

import numpy as np

KERNEL_TOL = {"bfloat16": 2e-2, "float32": 1e-5}  # bf16: ~1 output ulp at |o| < 4
MIN_COSINE = 0.99  # served bf16 embeddings vs the f32 CPU plain path
LAYERS = 12  # ViT-B-32: 12 blocks in each tower, one attention launch each
TRAIN_BATCH, CHECK_BATCH = 256, 32
WARMUP_STEPS, TIMED_STEPS = 3, 10
MAX_LOSS_REL_ERR = 2e-2  # one bf16 train step's loss vs the f32 CPU step
MIN_GRAD_COSINE = 0.99  # its flattened gradient vs the f32 CPU step's
LARGE_MICRO, LARGE_ACCUM, LARGE_STEPS = 1024, 2, 4  # spatial_v2_multi_chip's 2048 on one card
NEIGHBORS = 6
EDGE_LENGTHS = (1, 15, 16, 17, 50, 63, 64, 65, 77, 128, 129, 200, 256)  # phase 3's extra lengths
# phase 6's bf16 backward lengths, and the longest each head dim takes
BWD_EDGE_LENGTHS = (1, 15, 16, 17, 50, 63, 64, 65, 77, 128, 129)
# phases 12 and 15: rows at the wgmma forwards' row-tile (64) and cluster
# (2 x 64) edges
GEMM_EDGE_ROWS = (1, 63, 64, 65, 127, 128, 129, 255, 257, 1000)
# the least time the card could take: H100 SXM, NVIDIA's data sheet
HBM_BYTES_PER_S, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12


def bound(n_bytes: float, flops: float, peak_flops: float):
    """(bound ms, what bounds it): the larger of bytes over the memory rate
    and operations over the peak rate of their type."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_bound(qkv, heads: int, kind: str, din: int = 0):
    """Bound of an attention kernel at qkv's shape: each input read once,
    each output written once; the dots at the bf16 tensor-core peak (f32:
    the CUDA cores' peak, TF32 being other arithmetic).
    kind: 'fwd' (qkv -> out), 'fwd_lse' (+ lse), 'bwd' (qkv, do, lse ->
    dqkv, db), 'bwd_recompute' (qkv, do -> dqkv), 'bwd_recompute_db' (qkv,
    do -> dqkv, db), 'bwd_dx' (qkv, do, the (3D, din) weight -> dqkv, db and
    dx (B, L, din); the dx product's 2 B L 3D din operations added)."""
    import torch

    B, L, three_d = qkv.shape
    D, item = three_d // 3, qkv.element_size()
    hd = D // heads
    dots = 2 * B * heads * L * L * hd  # one L x L x hd product
    lse = 4 * heads * B * L
    peak = BF16_FLOPS if qkv.dtype == torch.bfloat16 else F32_FLOPS
    if kind == "fwd":
        return bound(B * L * (three_d + D) * item, 2 * dots, peak)
    if kind == "fwd_lse":
        return bound(B * L * (three_d + D) * item + lse, 2 * dots, peak)
    if kind == "bwd_recompute":
        return bound(B * L * (2 * three_d + D) * item, 5 * dots, peak)
    if kind == "bwd_recompute_db":
        return bound(B * L * (2 * three_d + D) * item + 4 * three_d, 5 * dots, peak)
    if kind == "bwd_dx":
        return bound(B * L * (2 * three_d + D + din) * item + three_d * din * item + 4 * three_d,
                     5 * dots + 2 * B * L * three_d * din, peak)
    return bound(B * L * (2 * three_d + D) * item + lse + 4 * three_d, 5 * dots, peak)


def ptxas_entries(report: str) -> dict:
    """ptxas -v's report by kernel: mangled name -> (registers, spill store
    bytes)."""
    entries = {}
    for chunk in report.split("Compiling entry function '")[1:]:
        name = chunk.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", chunk)
        spill = re.search(r"(\d+) bytes spill stores", chunk)
        entries[name] = (int(regs.group(1)) if regs else None, int(spill.group(1)) if spill else 0)
    return entries


def forward_build_report(lib, report: str) -> str:
    """The bf16 forward instantiations (the tensor-core body): for the
    standard kernel at each head dim, ptxas's registers and spill stores and
    the resident blocks an SM at L = 50, 77 and 256
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor); for the pair and layout
    forwards, their largest registers and spills."""
    import ctypes

    entries = ptxas_entries(report)
    parts = []
    for hd in (32, 64, 128):
        found = [v for k, v in entries.items() if f"15attn_fwd_kernelI13__nv_bfloat16Li{hd}E" in k]
        regs, spill = found[0] if found else (None, None)
        blocks = []
        for L in (50, 77, 256):
            r, local, n = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
            err = lib.sc_attention_fwd_occupancy(L, hd, 1, ctypes.byref(r), ctypes.byref(local),
                                                 ctypes.byref(n))
            if err:
                raise RuntimeError(f"sc_attention_fwd_occupancy L={L} hd={hd}: CUDA error {err}")
            blocks.append(f"L{L} {n.value}")
        parts.append(f"hd {hd}: {regs if regs is not None else r.value} registers, spill {spill} B, "
                     f"blocks an SM {', '.join(blocks)}")
    for kind in ("attn_pair_fwd_kernel", "attn_layout_fwd_kernel"):
        found = [v for k, v in entries.items() if kind in k and "__nv_bfloat16" in k]
        if found:
            parts.append(f"{kind} bf16 x{len(found)}: registers <= {max(v[0] for v in found)}, "
                         f"spill <= {max(v[1] for v in found)} B")
    return "; ".join(parts)


def backward_build_report(lib, report: str) -> str:
    """The bf16 backward instantiations (the tensor-core body): for the
    standard kernel at each head dim, ptxas's registers and spill stores of
    its three options (saved lse with db, recompute, recompute with db) and
    the saved-lse kernel's resident blocks an SM at L = 50, 77 and the
    longest taken (cudaOccupancyMaxActiveBlocksPerMultiprocessor); for the
    pair, layout and dx backwards, their largest registers and spills."""
    import ctypes

    import torch

    from spatial_clip_tpu_torch.ops.fused_attention import MAX_SEQ, bwd_supported

    entries = ptxas_entries(report)
    parts = []
    for hd in (32, 64, 128):
        options = []
        for label, flags in (("lse_db", "Lb0ELb1E"), ("re", "Lb1ELb0E"), ("re_db", "Lb1ELb1E")):
            found = [v for k, v in entries.items()
                     if f"15attn_bwd_kernelI13__nv_bfloat16Li{hd}E{flags}" in k]
            options.append(f"{label} {found[0][0]}/{found[0][1]} B" if found else f"{label} ?")
        longest = max(L for L in range(1, MAX_SEQ + 1) if bwd_supported(1, hd, L, torch.bfloat16))
        blocks = []
        for L in (50, 77, longest):
            r, local, n = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
            err = lib.sc_attention_bwd_occupancy(L, hd, 1, 0, ctypes.byref(r), ctypes.byref(local),
                                                 ctypes.byref(n))
            if err:
                raise RuntimeError(f"sc_attention_bwd_occupancy L={L} hd={hd}: CUDA error {err}")
            blocks.append(f"L{L} {n.value}")
        parts.append(f"hd {hd}: registers/spill {', '.join(options)}; blocks an SM "
                     f"{', '.join(blocks)}")
    for kind in ("attn_pair_bwd_kernel", "attn_layout_bwd_kernel", "attn_bwd_dx_kernel"):
        # the dx kernel's bf16 instantiations are templated on the head dim alone
        found = [v for k, v in entries.items()
                 if kind in k and ("__nv_bfloat16" in k or f"{kind}ILi" in k)]
        if found:
            parts.append(f"{kind} bf16 x{len(found)}: registers <= {max(v[0] for v in found)}, "
                         f"spill <= {max(v[1] for v in found)} B")
    return "; ".join(parts)


def gemm_build_report(report: str) -> str:
    """The bf16 wgmma kernels (fused MLP, LN -> dense forward and dx, the
    attention dx's product): ptxas's registers and spill stores of each
    instantiation (the MLP's and the LN -> dense dx's are their launch-level
    count: their consumers take 232 / 240 a thread by setmaxnreg), and how
    many ptxas said it had to serialize the wgmma of."""
    entries = ptxas_entries(report)
    parts = []
    for kind in ("mlp_fwd_kernel_bf16", "ln_dense_fwd_kernel_bf16", "ln_dense_dx_kernel_bf16",
                 "attn_bwd_dx_kernelILi", "block_attn_kernel_bf16"):
        found = {k: v for k, v in entries.items() if kind in k}
        serialized = sum(1 for line in report.splitlines()
                         if "wgmma.mma_async instructions are serialized" in line and kind in line)
        if found:
            parts.append(f"{kind} x{len(found)}: registers <= {max(v[0] for v in found.values())}, "
                         f"spill <= {max(v[1] for v in found.values())} B, wgmma serialized in "
                         f"{serialized}")
    return "; ".join(parts)


def ln_bwd_build_report(lib) -> str:
    """The bf16 fused_ln backward at D 512, 768 and 1024: its registers and
    spill (local) bytes a thread and the blocks of 8 warps an SM holds (the
    occupancy its one-wave grid is sized for)."""
    import ctypes

    parts = []
    for D in (512, 768, 1024):
        r, local, n = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        err = lib.sc_layer_norm_bwd_occupancy(D, 1, ctypes.byref(r), ctypes.byref(local),
                                              ctypes.byref(n))
        if err:
            raise RuntimeError(f"sc_layer_norm_bwd_occupancy D={D}: CUDA error {err}")
        parts.append(f"D {D}: {r.value} registers, local {local.value} B, {n.value} blocks "
                     f"({8 * n.value} warps) an SM")
    return "; ".join(parts)


def sdpa_ms(qkv, mask, heads: int) -> dict:
    """PyTorch's scaled_dot_product_attention with the efficient-attention
    backend (additive mask, logsumexp kept when grad is on) on q, k, v cut
    from qkv beforehand: forward, forward with lse (inputs that require
    grad), the backward alone (``bwd``: ``torch.autograd.grad`` of one
    retained forward graph; no bias gradient) and, beside it, the noisier
    difference forward+backward minus forward with lse (``bwd_diff``). A
    yardstick only."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from spatial_clip_tpu_torch.bench_dx import sdpa_bwd_ms

    B, L, three_d = qkv.shape
    q, k, v = (t.contiguous() for t in
               qkv.view(B, L, 3, heads, three_d // 3 // heads).permute(2, 0, 3, 1, 4))
    bias = None if mask is None else mask.to(qkv.dtype)
    g = torch.randn_like(q)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

    def fwd_bwd():
        out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=bias)
        return torch.autograd.grad(out, (qg, kg, vg), g)

    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        with torch.no_grad():
            fwd = median_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias))
        fwd_lse = median_ms(lambda: F.scaled_dot_product_attention(qg, kg, vg, attn_mask=bias))
        both = median_ms(fwd_bwd)
    return {"fwd": fwd, "fwd_lse": fwd_lse, "bwd": sdpa_bwd_ms(q, k, v, bias, g),
            "bwd_diff": both - fwd_lse}


def train_tol(dtype, ref):
    """Training and LayerNorm kernels vs their plain versions. f32:
    summation order only. bf16: both round at the same points, so they differ where an f32 sum in
    another order lands on the other side of a bf16 rounding: one bf16 step
    (2^-8) of the output's largest magnitude (dq sums L terms, so its
    magnitude, not 1, sets the step)."""
    import torch

    scale = ref.abs().max().item()
    return 2e-5 * max(1.0, scale) if dtype == torch.float32 else 2 ** -8 * scale


def bwd_tol(dtype, ref):
    """The attention backwards' dqkv vs their plain versions. f32: as
    train_tol. bf16: one bf16 ulp at the output's largest magnitude,
    2^(floor(log2 max|ref|) - 7): an f32 sum in another order (the tensor
    cores' against cuBLAS's) lands an element on the other side of a bf16
    rounding, one ulp off, and at an element near max|ref| that ulp exceeds
    2^-8 max|ref| whenever max|ref| is just above a power of two."""
    import torch

    if dtype == torch.float32:
        return train_tol(dtype, ref)
    return 2.0 ** (math.floor(math.log2(ref.abs().max().item())) - 7)


def cosine(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float((a @ b) / (a.norm() * b.norm()))


def median_ms(fn, reps: int = 7, inner: int = 20) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back calls,
    timed with CUDA events after a warmup."""
    import torch

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


def host_median_ms(fn, reps: int = 20) -> float:
    """Median wall time of ``fn`` ending in a device synchronize."""
    import torch

    times = []
    for _ in range(reps + 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[3:])


def post(port: int, path: str, body, headers=None):
    conn = HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", path, body, headers or {})
        resp = conn.getresponse()
        data = resp.read()
        if resp.status != 200:
            raise RuntimeError(f"POST {path}: HTTP {resp.status}: {data[:500]!r}")
        return json.loads(data)
    finally:
        conn.close()


def get(port: int, path: str):
    conn = HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        data = resp.read()
        if resp.status != 200:
            raise RuntimeError(f"GET {path}: HTTP {resp.status}")
        return json.loads(data)
    finally:
        conn.close()


def embeddings(reply: dict) -> np.ndarray:
    if "embeddings" in reply:
        return np.asarray(reply["embeddings"], np.float32)
    return np.frombuffer(base64.b64decode(reply["embeddings_b64"]),
                         reply["dtype"]).reshape(reply["shape"])


def check_embeddings(name: str, emb: np.ndarray, n: int, dim: int) -> None:
    if emb.shape != (n, dim) or not np.isfinite(emb).all():
        raise AssertionError(f"{name}: shape {emb.shape} (want {(n, dim)}) or non-finite values")
    norms = np.linalg.norm(emb, axis=-1)
    if not np.allclose(norms, 1.0, atol=1e-3):
        raise AssertionError(f"{name}: norms not 1: {norms.min()}..{norms.max()}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA GPU",
              file=sys.stderr)
        return 1
    from spatial_clip_tpu_torch import create_model
    from spatial_clip_tpu_torch.models.transformer import causal_mask
    from spatial_clip_tpu_torch.models.transforms import normalize_batch
    from spatial_clip_tpu_torch.ops import cuda_build
    from spatial_clip_tpu_torch.ops.fused_attention import (
        fused_attention,
        fused_attention_bwd,
        fused_attention_lse,
        reference_attention,
        reference_attention_lse,
    )
    from spatial_clip_tpu_torch.serve import EmbeddingService, make_handler

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(f"[device] {kind} x{count} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    lib_path = cuda_build.build()
    cuda_build.library()
    build_s = time.perf_counter() - t0
    ptxas = lib_path.with_suffix(".ptxas.txt")
    report = ptxas.read_text() if ptxas.is_file() else ""
    regs = sorted({int(r) for r in re.findall(r"Used (\d+) registers", report)})
    spills = sum(int(s) for s in re.findall(r"(\d+) bytes spill stores", report))
    print(f"[build] {lib_path.name} from {cuda_build.CSRC_DIR.name}/*.cu in {build_s:.2f} s "
          f"(nvcc sm_90a); ptxas: registers {regs}, spill stores {spills} B; bf16 forward "
          f"(tensor cores): {forward_build_report(cuda_build.library(), report)}; bf16 backward "
          f"(tensor cores): {backward_build_report(cuda_build.library(), report)}; wgmma "
          f"kernels: {gemm_build_report(report)}; fused_ln backward: "
          f"{ln_bwd_build_report(cuda_build.library())}", flush=True)

    # 3. kernel vs plain version on the card
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [  # name, B, L, D, heads, causal, dtype
        ("image", 64, 50, 768, 12, False, torch.bfloat16),
        ("text", 64, 77, 512, 8, True, torch.bfloat16),
        ("image_large", LARGE_MICRO, 50, 768, 12, False, torch.bfloat16),
        ("text_large", LARGE_MICRO, 77, 512, 8, True, torch.bfloat16),
        ("f32", 3, 17, 256, 4, False, torch.float32),
    ]
    kernel_rows = {}
    for name, B, L, D, H, causal, dtype in cases:
        qkv = torch.randn((B, L, 3 * D), generator=gen, device="cuda").to(dtype)
        mask = causal_mask(L, device="cuda") if causal else None
        out = fused_attention(qkv, mask, H)
        ref = reference_attention(qkv, mask, H)
        torch.cuda.synchronize()
        tol = KERNEL_TOL[str(dtype).split(".")[-1]]
        diff = out.float() - ref.float()
        err = diff.abs().max().item()
        if not err <= tol:
            raise AssertionError(f"[kernel] {name}: max abs err {err} > {tol}")
        # the tensor-core sums round differently from the plain version's in a
        # few elements: how many, and whether up and down alike
        same, signed = (diff == 0).float().mean().item(), diff.mean().item()
        ms = median_ms(lambda: fused_attention(qkv, mask, H))
        plain_ms = median_ms(lambda: reference_attention(qkv, mask, H))
        gbs = (qkv.numel() + out.numel()) * qkv.element_size() / ms / 1e6
        bound_ms, bound_by = attention_bound(qkv, H, "fwd")
        library_ms = sdpa_ms(qkv, mask, H)["fwd"]
        kernel_rows[name] = dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                 bound_by=bound_by, library_ms=library_ms)
        print(f"[kernel] fused_attention_fwd {name} qkv {tuple(qkv.shape)} {str(dtype)[6:]} "
              f"mask={'causal' if causal else 'none'}: max abs err {err:.3g} (tol {tol:g}), "
              f"{same:.6f} of elements the plain version's bits, mean signed err {signed:.3g}; "
              f"kernel {ms:.4f} ms ({gbs:.0f} GB/s of qkv+out) vs plain {plain_ms:.4f} ms, "
              f"SDPA {library_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by})", flush=True)
    # the bf16 body's tile edges (16 query rows, 16 keys) and two-pass lengths
    # (past 80 keys), with and without lse: context at KERNEL_TOL, lse at
    # phase 6's tolerance, the same context either way
    edge_errs = {}
    for L in EDGE_LENGTHS:
        for causal in (False, True):
            qkv = torch.randn((8, L, 3 * 256), generator=gen, device="cuda").bfloat16()
            mask = causal_mask(L, device="cuda") if causal else None
            out = fused_attention(qkv, mask, 4)
            out_lse, lse = fused_attention_lse(qkv, mask, 4)
            want, want_lse = reference_attention_lse(qkv, mask, 4)
            torch.cuda.synchronize()
            err = (out.float() - want.float()).abs().max().item()
            lse_err = (lse - want_lse).abs().max().item()
            lse_tol = 1e-5 * max(1.0, want_lse.abs().max().item())
            if not (err <= KERNEL_TOL["bfloat16"] and lse_err <= lse_tol
                    and torch.equal(out, out_lse)):
                raise AssertionError(
                    f"[kernel] edge L={L} causal={causal}: max abs err {err} (tol "
                    f"{KERNEL_TOL['bfloat16']}), lse {lse_err} (tol {lse_tol}), the same context "
                    f"with lse {torch.equal(out, out_lse)}")
            edge_errs[L, causal] = (err, lse_err)
    kernel_rows["edges"] = dict(err=max(e for e, _ in edge_errs.values()))
    print(f"[kernel] fused_attention_fwd / _lse bf16 batch 8, 4 heads of 64, L "
          f"{list(EDGE_LENGTHS)}, causal and not: max abs err {kernel_rows['edges']['err']:.3g} "
          f"(tol {KERNEL_TOL['bfloat16']:g}), lse {max(e for _, e in edge_errs.values()):.3g} "
          f"(tol 1e-5 x max(1, |lse|)), the same context with and without lse", flush=True)

    # 4. serve: the port's main path, through its HTTP entry points
    from http.server import ThreadingHTTPServer

    service = EmbeddingService("ViT-B-32", precision="bf16", batch_size=64, device="cuda")
    service.warmup()
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    try:
        dim = int(service.model.cfg.embed_dim)
        texts = ["a photo of a tumor tile", "lymphocytes in stroma", "EPCAM KRT8 KRT18"]
        texts70 = [f"spatial transcriptomics spot {i} with gene {i * 7 % 97} expressed"
                   for i in range(70)]
        tiles = np.random.default_rng(0).integers(0, 256, (5, 224, 224, 3), dtype=np.uint8)
        for counter in (fused_attention, fused_attention_lse, fused_attention_bwd):
            counter.launches = 0
        replies = {
            "text3": post(port, "/embed_text", json.dumps({"texts": texts})),
            "text70": post(port, "/embed_text",
                           json.dumps({"texts": texts70, "encoding": "b64_f32"})),
            "image5": post(port, "/embed_image_raw", tiles.tobytes()),
            "image5_json": post(port, "/embed_image_raw?encoding=json", tiles.tobytes()),
        }
        launches = fused_attention.launches
        health, metrics = get(port, "/healthz"), get(port, "/metrics")
        batches = 1 + 2 + 1 + 1  # 70 texts at batch 64 take two
        if launches != LAYERS * batches:
            raise AssertionError(f"[serve] {launches} kernel launches, want {LAYERS * batches}")
        if fused_attention_lse.launches or fused_attention_bwd.launches:
            raise AssertionError("[serve] serving launched a training kernel")
        emb = {k: embeddings(r) for k, r in replies.items()}
        for k, n in (("text3", 3), ("text70", 70), ("image5", 5), ("image5_json", 5)):
            check_embeddings(k, emb[k], n, dim)
        if health["embed_dim"] != dim or metrics["requests_total"] != 4:
            raise AssertionError(f"[serve] healthz {health} metrics {metrics}")

        reference = create_model("ViT-B-32", precision="fp32", seed=0, device="cpu")
        with torch.inference_mode():
            want_txt = reference.encode_text(
                torch.from_numpy(service.tokenizer(texts + texts70)).long()).numpy()
            want_img = reference.encode_image(normalize_batch(torch.from_numpy(tiles))).numpy()
        got_txt = np.concatenate([emb["text3"], emb["text70"]])
        cos = {"text": (got_txt * want_txt).sum(-1).min(),
               "image": (emb["image5"] * want_img).sum(-1).min(),
               "image_json": (emb["image5_json"] * want_img).sum(-1).min()}
        if min(cos.values()) < MIN_COSINE:
            raise AssertionError(f"[serve] cosine vs f32 CPU plain path {cos} < {MIN_COSINE}")
        print(f"[serve] ViT-B-32 bf16 batch 64 on {health['device']}: 4 requests, 200 OK, "
              f"shapes (3|70|5|5, {dim}), finite, unit norm; {launches} kernel launches = "
              f"{LAYERS} x {batches} encoder batches; min cosine vs f32 CPU plain path "
              f"text {cos['text']:.5f} image {cos['image']:.5f} "
              f"image_json {cos['image_json']:.5f}; batch_fill_mean "
              f"{metrics['batch_fill_mean']}", flush=True)

        # 5. timing
        model = service.model
        tiles64 = np.random.default_rng(1).integers(0, 256, (64, 224, 224, 3), dtype=np.uint8)
        x64 = normalize_batch(torch.from_numpy(tiles64).cuda(), dtype=model.dtype)
        ids64 = torch.from_numpy(service.tokenizer(texts70[:64])).long().cuda()
        with torch.inference_mode():
            img_ms = host_median_ms(lambda: model.encode_image(x64))
            txt_ms = host_median_ms(lambda: model.encode_text(ids64))
        body = tiles64.tobytes()
        lat = []
        for _ in range(13):
            t0 = time.perf_counter()
            post(port, "/embed_image_raw", body)
            lat.append((time.perf_counter() - t0) * 1e3)
        req_ms = statistics.median(lat[3:])
        print(f"[timing] encode_image 64 tiles {img_ms:.3f} ms ({64e3 / img_ms:.0f} tiles/s); "
              f"encode_text 64 texts {txt_ms:.3f} ms ({64e3 / txt_ms:.0f} texts/s); "
              f"POST /embed_image_raw 64 tiles {req_ms:.3f} ms median", flush=True)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        service.close()

    train_rows = kernel_train_phase()
    trainer = train_check_phase()
    train = train_phase(trainer)
    model = trainer.model  # ViT-B-32 bf16, f32 parameters from seed 0
    del trainer
    loss_rows = kernel_loss_phase()
    loss_check_phase(model)
    large = train_large_phase(model)
    del model
    ln_rows = kernel_ln_phase()
    ln_check_phase()
    ln_train = train_ln_phase(train["step_ms"])
    mlp_rows = kernel_mlp_phase()
    mlp_check_phase()
    mlp_train = train_mlp_phase(train["step_ms"])
    routes = route_check_phase()
    pair_rows = kernel_pair_phase()
    zip_check_phase()
    zip_train = train_zip_phase(train["step_ms"])
    block_rows, block_launches = kernel_block_phase()
    layout_rows, slab_launches = kernel_layouts_phase()
    layouts_check_phase()
    layout_train = train_layouts_phase(train["step_ms"])
    dx_rows = kernel_dx_phase()
    dxdb = dxdb_phase(train["step_ms"])
    entry = entry_phase()

    image = kernel_rows["image"]
    at_train = "qkv (256, 50, 2304) bf16, no mask (image tower, batch 256)"
    kernels = [{
        "name": "fused_attention_fwd",
        "route": "cuda",
        "source": "spatial_clip_tpu_torch/csrc/fused_attention_fwd.cu",
        "replaces": "spatial_clip_tpu/ops/fused_attention.py:267",
        "launches": launches,
        "max_abs_err": max(r["err"] for r in kernel_rows.values()),
        "ms": image["ms"],
        "plain_ms": image["plain_ms"],
        "bound_ms": image["bound_ms"],
        "bound_by": image["bound_by"],
        "library_ms": image["library_ms"],
        "at": "qkv (64, 50, 2304) bf16, no mask (image tower, batch 64)",
        "entry_launches": entry["fused_attention_fwd"],
    }]
    for name, part, line, launch_key in (
            ("fused_attention_fwd_lse", "fwd", 350, "lse_launches"),
            ("fused_attention_bwd", "bwd", 436, "bwd_launches")):
        row = train_rows["image"]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"spatial_clip_tpu_torch/csrc/fused_attention_{part}.cu",
            "replaces": f"spatial_clip_tpu/ops/fused_attention.py:{line}",
            "launches": train[launch_key],
            "max_abs_err": max(r[f"{part}_err"] for r in train_rows.values()
                               if f"{part}_err" in r),  # the edge sweep has no fwd_err
            "ms": row[f"{part}_ms"],
            "plain_ms": row[f"{part}_plain_ms"],
            "bound_ms": row[f"{part}_bound_ms"],
            "bound_by": row[f"{part}_bound_by"],
            "library_ms": row[f"{part}_library_ms"],
            "at": at_train,
            "entry_launches": entry[name],
        })
    row = train_rows["image"]
    kernels.append({
        "name": "fused_attention_bwd_recompute",
        "route": "cuda",
        "source": "spatial_clip_tpu_torch/csrc/fused_attention_bwd.cu",
        "replaces": "spatial_clip_tpu/ops/fused_attention.py:379",
        "launches": ln_train["ln_gemm_impl=pallas"]["counts"][7],
        "max_abs_err": max(r["bwd_re_err"] for r in train_rows.values()),
        "ms": row["bwd_re_ms"],
        "plain_ms": row["bwd_re_plain_ms"],
        "bound_ms": row["bwd_re_bound_ms"],
        "bound_by": row["bwd_re_bound_by"],
        "library_ms": row["bwd_re_library_ms"],
        "at": at_train,
    })
    for name, line, part, launches in (  # JAX's _bwd_kernel3 is the recompute entry's work
            ("fused_attention_bwd_recompute (BWD_FUSE=none)", 390, "re",
             routes["none_launches"]),
            ("fused_attention_bwd_recompute_db", 404, "rd", routes["db_launches"])):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "spatial_clip_tpu_torch/csrc/fused_attention_bwd.cu",
            "replaces": f"spatial_clip_tpu/ops/fused_attention.py:{line}",
            "launches": launches,
            "max_abs_err": max(r[f"bwd_{part}_err"] for r in train_rows.values()),
            "ms": row[f"bwd_{part}_ms"],
            "plain_ms": row[f"bwd_{part}_plain_ms"],
            "bound_ms": row[f"bwd_{part}_bound_ms"],
            "bound_by": row[f"bwd_{part}_bound_by"],
            "library_ms": row[f"bwd_{part}_library_ms"],
            "at": at_train,
        })
    main_shape = loss_rows[f"{LARGE_MICRO * LARGE_ACCUM}"]
    for part, line in (("fwd", 50), ("dq", 114), ("dk", 158)):
        kernels.append({
            "name": f"fused_spatial_ce_{part}",
            "route": "cuda",
            "source": "spatial_clip_tpu_torch/csrc/fused_spatial_ce.cu",
            "replaces": f"spatial_clip_tpu/ops/fused_contrastive.py:{line}",
            "launches": large[part],
            "max_abs_err": max(r[f"{part}_err"] for r in loss_rows.values()),
            "ms": main_shape[f"{part}_ms"],
            "plain_ms": main_shape[f"{part}_plain_ms"],
            "bound_ms": main_shape[f"{part}_bound_ms"],
            "bound_by": main_shape[f"{part}_bound_by"],
            "library_ms": None,  # no one PyTorch call computes this loss
            "at": f"q, K ({LARGE_MICRO * LARGE_ACCUM}, 512) f32, k {NEIGHBORS} (cached "
                  f"accumulation {LARGE_ACCUM} x {LARGE_MICRO})",
        })
    ln_kernels = (  # name, family, TPU kernel line, main shape, part, setting, counter, at
        ("fused_ln_fwd", "fused_ln", 48, "image", "fwd", "ln_impl=pallas", 0,
         "x (12800, 768) bf16 (image tower, batch 256)"),
        ("fused_ln_bwd", "fused_ln", 60, "image", "bwd", "ln_impl=pallas", 1,
         "x, dy (12800, 768) bf16 (image tower, batch 256)"),
        ("fused_ln_dense_fwd", "fused_ln_dense", 50, "image_fc", "fwd", "ln_gemm_impl=pallas", 2,
         "x (12800, 768) -> 3072 bf16 (image c_fc, batch 256)"),
        ("fused_ln_dense_bwd_dx", "fused_ln_dense", 65, "image_fc", "bwd", "ln_gemm_impl=pallas",
         3, "x (12800, 768), g (12800, 3072) bf16 (image c_fc, batch 256)"),
    )
    for name, family, line, shape, part, setting, index, at in ln_kernels:
        row = ln_rows[family][shape]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"spatial_clip_tpu_torch/csrc/{family}.cu",
            "replaces": f"spatial_clip_tpu/ops/{family}.py:{line}",
            "launches": ln_train[setting]["counts"][index],
            "max_abs_err": max(r[f"{part}_err"] for r in ln_rows[family].values()
                               if f"{part}_err" in r),
            "ms": row[f"{part}_ms"],
            "plain_ms": row[f"{part}_plain_ms"],
            "bound_ms": row[f"{part}_bound_ms"],
            "bound_by": row[f"{part}_bound_by"],
            "library_ms": row[f"{part}_library_ms"],
            "at": at,
        })
        if family == "fused_ln_dense":  # the wgmma kernels: every main-path shape
            kernels[-1]["ms_by_shape"] = {k: r[f"{part}_ms"] for k, r in ln_rows[family].items()
                                          if f"{part}_ms" in r}
            kernels[-1]["library_ms_by_shape"] = {k: r[f"{part}_library_ms"]
                                                  for k, r in ln_rows[family].items()
                                                  if f"{part}_library_ms" in r}
        if name == "fused_ln_fwd":  # on the card's clock, x past the L2
            kernels[-1]["cold_ms"] = row["fwd_cold_ms"]
            kernels[-1]["library_cold_ms"] = row["fwd_library_cold_ms"]
        if name == "fused_ln_bwd":  # on the card's clock alone, warm and past the L2
            kernels[-1].update(ms=row["bwd_device_ms"], library_ms=row["bwd_library_device_ms"],
                               cold_ms=row["bwd_cold_ms"],
                               library_cold_ms=row["bwd_library_cold_ms"])
    image_mlp = mlp_rows["image"]
    kernels.append({
        "name": "fused_mlp_fwd",
        "route": "cuda",
        "source": "spatial_clip_tpu_torch/csrc/fused_mlp.cu",
        "replaces": "spatial_clip_tpu/ops/fused_mlp.py:28",
        "launches": mlp_train["launches"],
        "max_abs_err": max(r["err"] for r in mlp_rows.values() if "err" in r),
        "ms": image_mlp["ms"],
        "plain_ms": image_mlp["plain_ms"],
        "bound_ms": image_mlp["bound_ms"],
        "bound_by": image_mlp["bound_by"],
        "library_ms": image_mlp["library_ms"],
        "at": "x (12800, 768) -> 3072 -> 768 bf16 (image tower MLP, batch 256)",
        "ms_by_shape": {k: r["ms"] for k, r in mlp_rows.items() if "ms" in r},
        "library_ms_by_shape": {k: r["library_ms"] for k, r in mlp_rows.items()
                                if "library_ms" in r},
    })
    pair = pair_rows["256"]
    for name, part, line, launches in (
            ("fused_attention_pair_fwd", "fwd", 106, zip_train["fwd_launches"]),
            ("fused_attention_pair_bwd", "bwd", 119, zip_train["bwd_launches"])):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "spatial_clip_tpu_torch/csrc/attention_pair.cu",
            "replaces": f"spatial_clip_tpu/ops/attention_pair.py:{line}",
            "launches": launches,
            "max_abs_err": max(r[f"{part}_err"] for r in pair_rows.values()),
            "ms": pair[f"{part}_ms"],
            "plain_ms": pair[f"{part}_plain_ms"],
            "bound_ms": pair[f"{part}_bound_ms"],
            "bound_by": pair[f"{part}_bound_by"],
            "library_ms": pair[f"{part}_library_ms"],
            "at": "qkv (256, 50, 2304) no mask with (256, 77, 1536) causal, bf16 (both towers, "
                  "batch 256)",
        })
    block = block_rows["image_256"]
    kernels.append({
        "name": "fused_block_attn",
        "route": "cuda",
        "source": "spatial_clip_tpu_torch/csrc/fused_block.cu",
        "replaces": "spatial_clip_tpu/ops/fused_block.py:45",
        "launches": block_launches,
        "max_abs_err": max(r["err"] for k, r in block_rows.items() if k != "edges"),
        "ms": block["ms"],
        "plain_ms": block["plain_ms"],
        "bound_ms": block["bound_ms"],
        "bound_by": block["bound_by"],
        "library_ms": block["library_ms"],
        "device_ms": block["device_ms"],
        "unfused_ms": block["unfused_ms"],
        "ms_by_shape": {k: r["device_ms"] for k, r in block_rows.items() if "device_ms" in r},
        "unfused_ms_by_shape": {k: r["unfused_device_ms"] for k, r in block_rows.items()
                                if "unfused_device_ms" in r},
        "edge_cases": block_rows["edges"]["cases"],
        "at": "x (256, 50, 768) bf16, 12 heads (image tower's attention half, batch 256); "
              "library: the unfused half with SDPA; unfused: with the attention kernel",
    })
    launches = {**{k: n for setting in layout_train.values() for k, n in setting.items()},
                **slab_launches}
    for name, replaces in LAYOUT_KERNELS.items():
        row = layout_rows["image"][name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "spatial_clip_tpu_torch/csrc/attention_layouts.cu",
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(r[name]["err"] for r in layout_rows.values()),
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "at": at_train,
        })
    dx = dx_rows["image"]
    kernels.append({
        "name": "fused_attention_bwd_dx",
        "route": "cuda",
        "source": "spatial_clip_tpu_torch/csrc/attention_dx.cu",
        "replaces": "spatial_clip_tpu/ops/attention_variants.py:67",
        "launches": dxdb["launches"],
        "max_abs_err": max(r["err"] for r in dx_rows.values()),
        "ms": dx["ms"],
        "plain_ms": dx["plain_ms"],
        "bound_ms": dx["bound_ms"],
        "bound_by": dx["bound_by"],
        "library_ms": dx["library_ms"],
        "unfused_ms": dx["unfused_ms"],
        "at": at_train + ", W (2304, 768); library: SDPA's backward + the cuBLAS dx GEMM; "
              "unfused: the recompute-with-db kernel + torch.matmul(dqkv, W)",
    })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


def kernel_train_phase() -> dict:
    """6. The training kernels against their plain versions on the card."""
    import torch

    from spatial_clip_tpu_torch.models.transformer import causal_mask
    from spatial_clip_tpu_torch.ops.fused_attention import (
        fused_attention_bwd,
        fused_attention_bwd_recompute,
        fused_attention_bwd_recompute_db,
        fused_attention_lse,
        reference_attention_bwd,
        reference_attention_lse,
    )

    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [  # name, B, L, D, heads, causal, dtype
        ("image", TRAIN_BATCH, 50, 768, 12, False, torch.bfloat16),
        ("text", TRAIN_BATCH, 77, 512, 8, True, torch.bfloat16),
        ("image_large", LARGE_MICRO, 50, 768, 12, False, torch.bfloat16),
        ("text_large", LARGE_MICRO, 77, 512, 8, True, torch.bfloat16),
        ("f32", 8, 77, 512, 8, True, torch.float32),
    ]
    rows = {}
    for name, B, L, D, H, causal, dtype in cases:
        qkv = torch.randn((B, L, 3 * D), generator=gen, device="cuda").to(dtype)
        g = torch.randn((B, L, D), generator=gen, device="cuda").to(dtype)
        mask = causal_mask(L, device="cuda") if causal else None
        out, lse = fused_attention_lse(qkv, mask, H)
        dqkv, db = fused_attention_bwd(qkv, mask, lse, g, H)
        dqkv_re = fused_attention_bwd_recompute(qkv, mask, g, H)
        dqkv_rd, db_rd = fused_attention_bwd_recompute_db(qkv, mask, g, H)
        db_rd_again = fused_attention_bwd_recompute_db(qkv, mask, g, H)[1]
        want_out, want_lse = reference_attention_lse(qkv, mask, H)
        want_dqkv, want_db = reference_attention_bwd(qkv, mask, want_lse, g, H)
        want_re, want_db_re = reference_attention_bwd(qkv, mask, None, g, H)
        torch.cuda.synchronize()
        checks = {  # name: (error, tolerance)
            "out": (out.float() - want_out.float(), train_tol(dtype, want_out.float())),
            "lse": (lse - want_lse, 1e-5 * max(1.0, want_lse.abs().max().item())),
            "dqkv": (dqkv.float() - want_dqkv.float(), bwd_tol(dtype, want_dqkv.float())),
            "db": (db - want_db, train_tol(dtype, want_db) + 1e-4),
            "dqkv_recompute": (dqkv_re.float() - want_re.float(),
                               bwd_tol(dtype, want_re.float())),
            "dqkv_recompute_db": (dqkv_rd.float() - want_re.float(),
                                  bwd_tol(dtype, want_re.float())),
            "db_recompute_db": (db_rd - want_db_re, train_tol(dtype, want_db_re) + 1e-4),
        }
        errs = {k: (d.abs().max().item(), tol) for k, (d, tol) in checks.items()}
        bad = {k: v for k, v in errs.items() if not v[0] <= v[1]}
        if bad or not torch.equal(db_rd, db_rd_again):
            raise AssertionError(f"[kernel-train] {name}: max abs err over tolerance {bad}; "
                                 f"recompute-with-db db the same bits on a rerun: "
                                 f"{torch.equal(db_rd, db_rd_again)}")
        row = dict(
            fwd_err=max(errs["out"][0], errs["lse"][0]),
            bwd_err=max(errs["dqkv"][0], errs["db"][0]),
            fwd_ms=median_ms(lambda: fused_attention_lse(qkv, mask, H)),
            fwd_plain_ms=median_ms(lambda: reference_attention_lse(qkv, mask, H)),
            bwd_ms=median_ms(lambda: fused_attention_bwd(qkv, mask, lse, g, H)),
            bwd_plain_ms=median_ms(lambda: reference_attention_bwd(qkv, mask, lse, g, H)),
            bwd_re_err=errs["dqkv_recompute"][0],
            bwd_re_ms=median_ms(lambda: fused_attention_bwd_recompute(qkv, mask, g, H)),
            bwd_re_plain_ms=median_ms(lambda: reference_attention_bwd(qkv, mask, None, g, H)),
            bwd_rd_err=max(errs["dqkv_recompute_db"][0], errs["db_recompute_db"][0]),
            bwd_rd_ms=median_ms(lambda: fused_attention_bwd_recompute_db(qkv, mask, g, H)),
        )
        row["bwd_rd_plain_ms"] = row["bwd_re_plain_ms"]  # one plain version returns both
        library = sdpa_ms(qkv, mask, H)
        row.update(fwd_library_ms=library["fwd_lse"], bwd_library_ms=library["bwd"],
                   bwd_re_library_ms=library["bwd"], bwd_rd_library_ms=library["bwd"],
                   bwd_library_diff_ms=library["bwd_diff"])
        (row["fwd_bound_ms"], row["fwd_bound_by"]), (row["bwd_bound_ms"], row["bwd_bound_by"]) = (
            attention_bound(qkv, H, "fwd_lse"), attention_bound(qkv, H, "bwd"))
        row["bwd_re_bound_ms"], row["bwd_re_bound_by"] = attention_bound(qkv, H, "bwd_recompute")
        row["bwd_rd_bound_ms"], row["bwd_rd_bound_by"] = attention_bound(qkv, H,
                                                                         "bwd_recompute_db")
        rows[name] = row
        print(f"[kernel-train] {name} qkv {tuple(qkv.shape)} {str(dtype)[6:]} "
              f"mask={'causal' if causal else 'none'}: max abs err (tol) " + ", ".join(
                  f"{k} {e:.3g} ({t:.3g})" for k, (e, t) in errs.items())
              + f"; fwd_lse kernel {row['fwd_ms']:.4f} ms vs plain {row['fwd_plain_ms']:.4f} ms,"
              f" SDPA {row['fwd_library_ms']:.4f} ms, bound {row['fwd_bound_ms']:.4f} ms"
              f" ({row['fwd_bound_by']}); bwd kernel {row['bwd_ms']:.4f} ms vs plain "
              f"{row['bwd_plain_ms']:.4f} ms, SDPA bwd {row['bwd_library_ms']:.4f} ms (retained "
              f"graph; fwd+bwd less fwd {row['bwd_library_diff_ms']:.4f}), bound "
              f"{row['bwd_bound_ms']:.4f} ms ({row['bwd_bound_by']}); recompute bwd kernel "
              f"{row['bwd_re_ms']:.4f} ms vs plain {row['bwd_re_plain_ms']:.4f} ms, bound "
              f"{row['bwd_re_bound_ms']:.4f} ms ({row['bwd_re_bound_by']}); recompute bwd with "
              f"db kernel {row['bwd_rd_ms']:.4f} ms, bound {row['bwd_rd_bound_ms']:.4f} ms "
              f"({row['bwd_rd_bound_by']}), db the same bits on a rerun", flush=True)
    rows["edges"] = bwd_edges_phase()
    return rows


def bwd_edges_phase() -> dict:
    """6 (continued). The bf16 backward body (tensor cores: 16-row query and
    key tiles, two passes) in its three options on each side of a tile edge
    and at the longest length each head dim takes, causal and not, batch 8,
    4 heads of 32 / 64 / 128: dqkv at bwd_tol and db at train_tol + 1e-4
    against the plain version on the same lse, db the same bits on a rerun.
    Prints each case's share of dqkv elements on the plain version's bits
    and mean signed error. Returns the largest error of each option."""
    import torch

    from spatial_clip_tpu_torch.models.transformer import causal_mask
    from spatial_clip_tpu_torch.ops.fused_attention import (
        MAX_SEQ,
        bwd_supported,
        fused_attention_bwd,
        fused_attention_bwd_recompute,
        fused_attention_bwd_recompute_db,
        fused_attention_lse,
        reference_attention_bwd,
    )

    gen = torch.Generator(device="cuda").manual_seed(6)
    B, H = 8, 4
    worst = {"bwd_err": 0.0, "bwd_re_err": 0.0, "bwd_rd_err": 0.0}
    n_cases = 0
    for hd in (32, 64, 128):
        longest = max(L for L in range(1, MAX_SEQ + 1) if bwd_supported(H, H * hd, L,
                                                                        torch.bfloat16))
        for L in (*BWD_EDGE_LENGTHS, longest):
            for causal in (False, True):
                qkv = torch.randn((B, L, 3 * H * hd), generator=gen, device="cuda").bfloat16()
                g = torch.randn((B, L, H * hd), generator=gen, device="cuda").bfloat16()
                mask = causal_mask(L, device="cuda") if causal else None
                lse = fused_attention_lse(qkv, mask, H)[1]
                want = {"bwd": reference_attention_bwd(qkv, mask, lse, g, H)}
                want["bwd_re"] = want["bwd_rd"] = reference_attention_bwd(qkv, mask, None, g, H)
                got = {"bwd": (fused_attention_bwd(qkv, mask, lse, g, H),
                               fused_attention_bwd(qkv, mask, lse, g, H)[1]),
                       "bwd_re": ((fused_attention_bwd_recompute(qkv, mask, g, H), None), None),
                       "bwd_rd": (fused_attention_bwd_recompute_db(qkv, mask, g, H),
                                  fused_attention_bwd_recompute_db(qkv, mask, g, H)[1])}
                torch.cuda.synchronize()
                parts = []
                for key, ((dqkv, db), db_again) in got.items():
                    want_dqkv, want_db = want[key]
                    diff = dqkv.float() - want_dqkv.float()
                    err, tol = diff.abs().max().item(), bwd_tol(torch.bfloat16,
                                                                want_dqkv.float())
                    ok = err <= tol and torch.isfinite(dqkv.float()).all().item()
                    if db is not None:
                        db_err = (db - want_db).abs().max().item()
                        ok = (ok and db_err <= train_tol(torch.bfloat16, want_db) + 1e-4
                              and torch.equal(db, db_again))
                        err = max(err, db_err)
                    if not ok:
                        raise AssertionError(
                            f"[kernel-train] bf16 bwd edge {key} hd={hd} L={L} causal={causal}: "
                            f"dqkv err {diff.abs().max().item()} (tol {tol}), db err "
                            f"{None if db is None else (db - want_db).abs().max().item()}, db "
                            f"the same bits on a rerun {db is None or torch.equal(db, db_again)}")
                    worst[f"{key}_err"] = max(worst[f"{key}_err"], err)
                    parts.append(f"{key} err {err:.3g} (tol {tol:.3g}) bits "
                                 f"{(diff == 0).float().mean().item():.6f} signed "
                                 f"{diff.mean().item():.3g}")
                n_cases += 1
                print(f"[kernel-train] bf16 bwd edge hd {hd} L {L} "
                      f"{'causal' if causal else 'none'}: " + "; ".join(parts), flush=True)
    print(f"[kernel-train] bf16 backward over {n_cases} edge cases (batch {B}, {H} heads of "
          f"32 / 64 / 128, L {list(BWD_EDGE_LENGTHS)} and the longest taken, causal and not), "
          f"three options: max err saved lse {worst['bwd_err']:.3g}, recompute "
          f"{worst['bwd_re_err']:.3g}, recompute with db {worst['bwd_rd_err']:.3g}, each within "
          f"tolerance; db the same bits on a rerun", flush=True)
    return worst


def train_check_phase(label: str = "train-check", batch_size: int = CHECK_BATCH, **settings):
    """7 (and 13, 16, 18 under ``settings`` or another batch). One train
    step's loss and gradients, card (bf16, kernels) vs CPU (f32, plain
    path), on the same weights, batch and augmentation draws. Returns the
    card's trainer."""
    import torch

    from spatial_clip_tpu_torch.bench import make_trainer, synthetic_batch
    from spatial_clip_tpu_torch.models.transforms import AugmentDraws

    t0 = time.perf_counter()
    card = make_trainer("ViT-B-32", device="cuda", **settings)
    cpu = make_trainer("ViT-B-32", device="cpu", precision="fp32", **settings)  # same weights
    card_state, cpu_state = card.init_state(), cpu.init_state()
    batch = synthetic_batch(cpu.model, batch_size, seed=1, device="cpu")
    rng = np.random.default_rng(2)
    draws = AugmentDraws(*(torch.from_numpy(d) for d in (
        rng.random(batch_size) < 0.5,
        (1.0 + rng.uniform(-0.2, 0.2, batch_size)).astype(np.float32),
        (1.0 + rng.uniform(-0.2, 0.2, batch_size)).astype(np.float32))))
    loss_card, _, grad_card = card.forward_backward(
        card_state, {k: v.cuda() for k, v in batch.items()},
        AugmentDraws(*(d.cuda() for d in draws)))
    loss_cpu, _, grad_cpu = cpu.forward_backward(cpu_state, batch, draws)
    grad_card = grad_card.float().cpu()
    rel = abs(loss_card.item() - loss_cpu.item()) / abs(loss_cpu.item())
    cos_all = cosine(grad_card, grad_cpu)
    # the qkv-bias gradients the backward kernel produces, by part (the key
    # part is zero in exact math: softmax ignores a per-row constant)
    by_card, by_cpu = card_state.by_name(grad_card), cpu_state.by_name(grad_cpu)
    biases = [k for k in card_state.order if k.endswith("attn.in_proj_bias")]
    cos_bias = {p: cosine(torch.cat([by_card[k].view(3, -1)[i] for k in biases]),
                          torch.cat([by_cpu[k].view(3, -1)[i] for k in biases]))
                for i, p in enumerate("qkv")}
    finite = torch.isfinite(grad_card).all().item() and np.isfinite(loss_card.item())
    if not (finite and rel <= MAX_LOSS_REL_ERR and cos_all >= MIN_GRAD_COSINE
            and min(cos_bias["q"], cos_bias["v"]) >= MIN_GRAD_COSINE):
        raise AssertionError(
            f"[{label}] loss card {loss_card.item()} cpu {loss_cpu.item()} (rel {rel}), "
            f"grad cosine {cos_all}, qkv-bias grad cosine {cos_bias}, finite {finite}")
    print(f"[{label}] ViT-B-32{settings or ''} batch {batch_size}, one step, same "
          f"weights/batch/draws: "
          f"loss card bf16 {loss_card.item():.6f} vs CPU f32 {loss_cpu.item():.6f} "
          f"(rel err {rel:.3g} <= {MAX_LOSS_REL_ERR}); flattened gradient cosine "
          f"{cos_all:.6f} (>= {MIN_GRAD_COSINE}); qkv-bias gradient cosine q "
          f"{cos_bias['q']:.6f} v {cos_bias['v']:.6f} (k {cos_bias['k']:.3f}: zero in exact "
          f"math); {time.perf_counter() - t0:.1f} s", flush=True)
    del cpu, cpu_state
    return card


def train_phase(trainer) -> dict:
    """8. The main training path: the bench workload's train step at batch 256."""
    from spatial_clip_tpu_torch.bench import synthetic_batch
    from spatial_clip_tpu_torch.ops.fused_attention import (
        fused_attention,
        fused_attention_bwd,
        fused_attention_lse,
    )

    batch = synthetic_batch(trainer.model, TRAIN_BATCH)
    steps = WARMUP_STEPS + TIMED_STEPS
    counts, step_ms, history, peak = timed_steps(
        "train", trainer, batch, steps, (fused_attention, fused_attention_lse, fused_attention_bwd))
    want = (0, 2 * LAYERS * steps, 2 * LAYERS * steps)
    if counts != want:
        raise AssertionError(f"[train] launches (fwd, fwd_lse, bwd) {counts}, want {want}")
    losses, norms = [l for l, _ in history], [n for _, n in history]
    med = statistics.median(step_ms[WARMUP_STEPS:])
    print(f"[train] ViT-B-32 bf16 batch {TRAIN_BATCH}, 12+12 layers, bench workload: "
          f"{steps} steps, launches fwd_lse {counts[1]} bwd {counts[2]} "
          f"(= 2 x {LAYERS} per step, inference fwd {counts[0]}); losses finite "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, grad norms finite {norms[0]:.4f} -> "
          f"{norms[-1]:.4f}; median step {med:.3f} ms over {TIMED_STEPS} "
          f"({TRAIN_BATCH * 1e3 / med:.1f} pairs/s); max_memory_allocated "
          f"{peak / 2 ** 30:.3f} GiB", flush=True)
    return {"lse_launches": counts[1], "bwd_launches": counts[2], "step_ms": med}


def ce_inputs(B: int, N: int, D: int = 512, seed: int = 0, k: int = NEIGHBORS):
    """The fused loss kernels' inputs as the loss builds them, on the card:
    unit rows, unique column ids but one duplicated, each row's own id (rows
    past N take random columns), k neighbor ids from the column ids with a
    20% -1 share, weights in [0, 1), scale 50."""
    import torch

    from spatial_clip_tpu_torch.ops.fused_contrastive import prepare_inputs

    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.nn.functional.normalize(torch.randn((B, D), generator=gen, device="cuda"), dim=1)
    kmat = torch.nn.functional.normalize(torch.randn((N, D), generator=gen, device="cuda"), dim=1)
    col_ids = torch.randperm(10 * N, generator=gen, device="cuda")[:N]
    col_ids[N // 2] = col_ids[0]
    gt = (torch.arange(B, device="cuda") if B <= N
          else torch.randint(0, N, (B,), generator=gen, device="cuda"))
    picks = col_ids[torch.randint(0, N, (B, k), generator=gen, device="cuda")]
    nbr = torch.where(torch.rand((B, k), generator=gen, device="cuda") < 0.8, picks, -1)
    alphas = torch.rand((B, k), generator=gen, device="cuda")
    return prepare_inputs(q, kmat, col_ids, gt, nbr, alphas, torch.tensor(50.0, device="cuda"))


def ce_check(inputs, label: str, isolated: bool = True) -> tuple:
    """The fused loss kernels on ``inputs`` against their plain versions
    (phase 9's tolerances), dq, dK and dscale the same bits on a rerun. Each
    chain runs whole: the kernels' backward takes the kernels' lse and
    mass, the plain backward the plain forward's, so both are exactly 0
    where the gradient is (a row of one column: fed the kernels' lse, the
    plain backward would return the rounding difference of its z from the
    kernels'). With ``isolated`` the backward kernels are also held against
    the plain backward on the same inputs, the kernels' lse and mass (keys
    ``dq_iso``, ``dk_iso``, ``dscale_iso``). Returns (outputs, lse, mass, g,
    errs: name -> (max abs err, the worst error over its tolerance,
    elementwise for loss, lse, mass))."""
    import torch

    from spatial_clip_tpu_torch.ops import fused_contrastive as fc

    B = inputs[0].shape[0]
    g = torch.full((B,), 1.0 / B, device="cuda")  # the cotangent of the loss's mean
    loss, lse, mass = fc.spatial_ce_fwd(*inputs)
    dq, dscale = fc.spatial_ce_dq(*inputs, lse, mass, g)
    dk = fc.spatial_ce_dk(*inputs, lse, mass, g)
    dq2, dscale2 = fc.spatial_ce_dq(*inputs, lse, mass, g)
    dk2 = fc.spatial_ce_dk(*inputs, lse, mass, g)
    want = fc.reference_spatial_ce_fwd(*inputs)
    errs = {}  # name: (max abs err, worst err / tol)
    for name, got, ref in zip(("loss", "lse", "mass"), (loss, lse, mass), want):
        d = (got - ref).abs()
        errs[name] = (d.max().item(), (d / (1e-5 * ref.abs().clamp_min(1.0))).max().item())
    feeds = {"": want[1:]} | ({"_iso": (lse, mass)} if isolated else {})
    for tag, (ref_lse, ref_mass) in feeds.items():
        want_dq, want_ds = fc.reference_spatial_ce_dq(*inputs, ref_lse, ref_mass, g)
        want_dk = fc.reference_spatial_ce_dk(*inputs, ref_lse, ref_mass, g)
        for name, got, ref in (("dq", dq, want_dq), ("dk", dk, want_dk)):
            d = (got - ref).abs().max().item()
            errs[name + tag] = (d, d / (1e-5 * ref.abs().max().item() + 1e-7))
        d = abs(dscale.item() - want_ds.item())
        errs["dscale" + tag] = (d, d / (1e-4 * abs(want_ds.item())) if want_ds.item() else
                                (float("inf") if d else 0.0))
    bad = {k: v for k, v in errs.items() if not v[1] <= 1.0}
    rerun = torch.equal(dq, dq2) and torch.equal(dscale, dscale2) and torch.equal(dk, dk2)
    finite = all(torch.isfinite(t).all().item() for t in (loss, dq, dk, dscale))
    if bad or not rerun or not finite:
        raise AssertionError(f"[kernel-loss] {label}: over tolerance {bad}; the same bits on a "
                             f"rerun {rerun}; finite {finite}")
    return (loss, dq, dk), lse, mass, g, errs


# phase 9's edges of the backward's tiles, clusters and splits: one column, an
# odd width, either side of two 256-column slices, the widest D; B != N with
# tails past every tile and split; 0 and 16 neighbors
CE_EDGE_DIMS = (1, 65, 511, 513, 1536)
CE_EDGE_SIZES = ((1, 1), (63, 2049), (2049, 63))


def ce_edges() -> dict:
    """Phase 9's sweep of the loss kernels' edges: every D of CE_EDGE_DIMS
    at every (B, N) of CE_EDGE_SIZES with 0 and 16 neighbors, each within
    phase 9's tolerances and the same bits on a rerun."""
    from spatial_clip_tpu_torch.ops import fused_contrastive as fc

    worst, plans = {}, set()
    for D in CE_EDGE_DIMS:
        for B, N in CE_EDGE_SIZES:
            for k in (0, 16):
                _, _, _, _, errs = ce_check(ce_inputs(B, N, D, seed=D + k, k=k),
                                            f"edge B={B} N={N} D={D} k={k}", isolated=False)
                for name, (e, ratio) in errs.items():
                    worst[name] = max(worst.get(name, 0.0), ratio)
                    worst[name + "_err"] = max(worst.get(name + "_err", 0.0), e)
                p = fc.kernel_plan(fc.DQ, B, N, D)
                plans.add((p["slices"], p["splits"]))
    cases = len(CE_EDGE_DIMS) * len(CE_EDGE_SIZES) * 2
    print(f"[kernel-loss] edges: D {list(CE_EDGE_DIMS)} x (B, N) {list(CE_EDGE_SIZES)} x k "
          f"(0, 16), {cases} cases: within tolerance, dq, dK and dscale the same bits on a "
          f"rerun; worst err / tol " + ", ".join(f"{k} {v:.3f}" for k, v in worst.items()
                                                  if not k.endswith("_err"))
          + f"; dq plans (slices, splits) {sorted(plans)}", flush=True)
    return {"fwd_err": max(worst[k + "_err"] for k in ("loss", "lse", "mass")),
            "dq_err": max(worst["dq_err"], worst["dscale_err"]), "dk_err": worst["dk_err"]}


def kernel_loss_phase() -> dict:
    """9. The fused spatial cross-entropy kernels against their plain
    versions on the card, f32 with TF32 off. Tolerances from f32 summation
    order: loss, lse, mass 1e-5 max(1, |ref|); dq, dK 1e-5 max|ref| + 1e-7;
    dscale 1e-4 relative; dq, dK and dscale the same bits on a rerun; each
    chain whole, and the backward kernels also against the plain backward
    on the kernels' lse and mass (ce_check). Then the kernels' edges
    (ce_edges), where a row of one column occurs, as whole chains only."""
    from spatial_clip_tpu_torch.ops import fused_contrastive as fc

    rows = {}
    for B, N in ((1024, 1024), (2048, 2048), (1000, 1999)):
        inputs = ce_inputs(B, N)
        _, lse, mass, g, errs = ce_check(inputs, f"B={B} N={N}")
        D = inputs[0].shape[1]
        ids = 4 * (B + N + 2 * B * NEIGHBORS) + 4  # ids, neighbor ids and weights, scale
        row = {
            "fwd_err": max(errs[k][0] for k in ("loss", "lse", "mass")),
            "dq_err": max(errs[k][0] for k in ("dq", "dscale", "dq_iso", "dscale_iso")),
            "dk_err": max(errs["dk"][0], errs["dk_iso"][0]),
            "fwd_ms": median_ms(lambda: fc.spatial_ce_fwd(*inputs)),
            "fwd_plain_ms": median_ms(lambda: fc.reference_spatial_ce_fwd(*inputs)),
            "dq_ms": median_ms(lambda: fc.spatial_ce_dq(*inputs, lse, mass, g)),
            "dq_plain_ms": median_ms(lambda: fc.reference_spatial_ce_dq(*inputs, lse, mass, g)),
            "dk_ms": median_ms(lambda: fc.spatial_ce_dk(*inputs, lse, mass, g)),
            "dk_plain_ms": median_ms(lambda: fc.reference_spatial_ce_dk(*inputs, lse, mass, g)),
        }
        in_bytes = 4 * (B + N) * D + ids
        for part, n_bytes, flops in (
                ("fwd", in_bytes + 3 * 4 * B, 2 * B * N * D),  # -> loss, lse, mass
                ("dq", in_bytes + 3 * 4 * B + 4 * B * D + 4, 4 * B * N * D),  # z again, dz K
                ("dk", in_bytes + 3 * 4 * B + 4 * N * D, 4 * B * N * D)):
            row[f"{part}_bound_ms"], row[f"{part}_bound_by"] = bound(n_bytes, flops, F32_FLOPS)
        rows[f"{N}" if B == N else f"{B}x{N}"] = row
        plan = fc.kernel_plan(fc.DQ, B, N, D)
        print(f"[kernel-loss] fused spatial CE B={B} N={N} D={D} k={NEIGHBORS} f32: max abs err "
              + ", ".join(f"{k} {e:.3g}" for k, (e, _) in errs.items())
              + " (within tolerance, dq, dK, dscale the same bits on a rerun); " + "; ".join(
                  f"{p} kernel {row[p + '_ms']:.4f} ms vs plain {row[p + '_plain_ms']:.4f} ms, "
                  f"bound {row[p + '_bound_ms']:.4f} ms ({row[p + '_bound_by']}, share "
                  f"{row[p + '_bound_ms'] / row[p + '_ms']:.3f})" for p in ("fwd", "dq", "dk"))
              + f"; backward plan (slices, splits) ({plan['slices']}, {plan['splits']})",
              flush=True)
    rows["edges"] = ce_edges()
    return rows


def accum_trainer(model, grad_accum: int, **cfg):
    """The large-batch configuration's trainer: the bench workload's
    augmentation and schedule, cached accumulation, the fused spatial loss
    capped at 50."""
    from spatial_clip_tpu_torch.losses import make_loss
    from spatial_clip_tpu_torch.train.loop import Trainer, TrainerConfig

    config = TrainerConfig(warmup_steps=10, total_steps=10_000, augment=True, color_jitter=0.2,
                           seed=0, grad_accum=grad_accum, grad_accum_mode="cached", **cfg)
    return Trainer(model, make_loss("spatial", cap_logit_scale=50.0, use_fused_kernel=True),
                   config)


def loss_counters():
    from spatial_clip_tpu_torch.ops import fused_contrastive as fc

    return fc.spatial_ce_fwd, fc.spatial_ce_dq, fc.spatial_ce_dk


def loss_check_phase(model) -> None:
    """10. One step with grad_accum=2 and the fused loss at batch 32, card
    (bf16, kernels) vs CPU (f32, plain path), same weights, batch and draws;
    then the fused loss against the dense one on f32 features on the card."""
    import torch

    from spatial_clip_tpu_torch import create_model
    from spatial_clip_tpu_torch.bench import synthetic_batch
    from spatial_clip_tpu_torch.losses import make_loss
    from spatial_clip_tpu_torch.models.transforms import AugmentDraws

    t0 = time.perf_counter()
    card = accum_trainer(model, 2)
    cpu = accum_trainer(create_model("ViT-B-32", precision="fp32", seed=0, device="cpu",
                                     training=True), 2)
    card_state, cpu_state = card.init_state(), cpu.init_state()
    batch = synthetic_batch(cpu.model, CHECK_BATCH, seed=3, device="cpu")
    rng = np.random.default_rng(4)
    draws = AugmentDraws(*(torch.from_numpy(d) for d in (
        rng.random(CHECK_BATCH) < 0.5,
        (1.0 + rng.uniform(-0.2, 0.2, CHECK_BATCH)).astype(np.float32),
        (1.0 + rng.uniform(-0.2, 0.2, CHECK_BATCH)).astype(np.float32))))
    for counter in loss_counters():
        counter.launches = 0
    loss_card, logits, grad_card = card.forward_backward(
        card_state, {k: v.cuda() for k, v in batch.items()},
        AugmentDraws(*(d.cuda() for d in draws)))
    counts = [c.launches for c in loss_counters()]
    loss_cpu, _, grad_cpu = cpu.forward_backward(cpu_state, batch, draws)
    rel = abs(loss_card.item() - loss_cpu.item()) / abs(loss_cpu.item())
    cos = cosine(grad_card.float().cpu(), grad_cpu)
    finite = bool(torch.isfinite(grad_card).all()) and np.isfinite(loss_card.item())
    if not (finite and rel <= MAX_LOSS_REL_ERR and cos >= MIN_GRAD_COSINE
            and counts == [4, 4, 4] and logits.shape == (CHECK_BATCH, CHECK_BATCH)):
        raise AssertionError(
            f"[loss-check] loss card {loss_card.item()} cpu {loss_cpu.item()} (rel {rel}), "
            f"grad cosine {cos}, finite {finite}, loss launches (fwd, dq, dk) {counts}")
    del cpu, cpu_state, card_state, grad_card, grad_cpu

    gen = torch.Generator(device="cuda").manual_seed(5)
    n = LARGE_MICRO
    img, txt = (torch.nn.functional.normalize(torch.randn((n, 512), generator=gen,
                                                         device="cuda"), dim=1)
                for _ in range(2))
    ids = torch.randperm(10 * n, generator=gen, device="cuda")[:n]  # unique
    spatial = dict(image_tile_ids=ids, text_tile_ids=ids,
                   neighbor_tile_ids=torch.where(
                       torch.rand((n, NEIGHBORS), generator=gen, device="cuda") < 0.8,
                       ids[torch.randint(0, n, (n, NEIGHBORS), generator=gen, device="cuda")], -1),
                   neighbor_alphas=torch.rand((n, NEIGHBORS), generator=gen, device="cuda"))
    scale = torch.tensor(100.0, device="cuda")  # above the cap
    fused, dense = (make_loss("spatial", cap_logit_scale=50.0, use_fused_kernel=f)(
        image_features=img, text_features=txt, logit_scale=scale, **spatial)["contrastive_loss"]
        .item() for f in (True, False))
    fused_rel = abs(fused - dense) / abs(dense)
    if not fused_rel <= 1e-5:
        raise AssertionError(f"[loss-check] fused loss {fused} vs dense {dense} (rel {fused_rel})")
    print(f"[loss-check] ViT-B-32 batch {CHECK_BATCH}, grad_accum 2 cached, fused loss, one step, "
          f"same weights/batch/draws: loss card bf16 {loss_card.item():.6f} vs CPU f32 "
          f"{loss_cpu.item():.6f} (rel err {rel:.3g} <= {MAX_LOSS_REL_ERR}); flattened gradient "
          f"cosine {cos:.6f} (>= {MIN_GRAD_COSINE}); loss launches fwd/dq/dK {counts}; fused vs "
          f"dense loss on f32 features ({n} x 512, unique ids) {fused:.7f} vs {dense:.7f} (rel "
          f"{fused_rel:.3g} <= 1e-5); {time.perf_counter() - t0:.1f} s", flush=True)


class StepLog:
    """A fit logger that keeps what it is given."""

    def __init__(self):
        self.records = []

    def log(self, step, metrics):
        self.records.append((step, metrics))


def train_large_phase(model) -> dict:
    """11. Trainer.fit at spatial_v2_multi_chip's global batch (2048) on one
    card as 2 x 1024 cached, from numpy batches, then Trainer.evaluate."""
    import torch

    from spatial_clip_tpu_torch.ops.fused_attention import (
        fused_attention,
        fused_attention_bwd,
        fused_attention_lse,
    )

    batch = LARGE_MICRO * LARGE_ACCUM
    trainer = accum_trainer(model, LARGE_ACCUM, log_every=1)
    rng = np.random.default_rng(6)
    size, t = int(model.cfg.vision_cfg.size), model.cfg.text_cfg
    tile_ids = np.arange(batch, dtype=np.int64)
    host = {  # made once; fit copies it to the card at every step
        "images": rng.integers(0, 255, (batch, size, size, 3), dtype=np.uint8),
        "texts": rng.integers(0, t.vocab_size, (batch, t.context_length), dtype=np.int64),
        "image_tile_ids": tile_ids,
        "text_tile_ids": tile_ids.copy(),
        "neighbor_tile_ids": rng.integers(-1, batch, (batch, NEIGHBORS)).astype(np.int64),
        "neighbor_alphas": rng.uniform(0, 1, (batch, NEIGHBORS)).astype(np.float32),
    }
    attention = (fused_attention, fused_attention_lse, fused_attention_bwd)
    counters = (*attention, *loss_counters())
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for counter in counters:
        counter.launches = 0
    steps = StepLog()
    t0 = time.perf_counter()
    state, last = trainer.fit(lambda: (host for _ in range(LARGE_STEPS)), logger=steps)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = [c.launches for c in counters]
    peak = torch.cuda.max_memory_allocated()
    per_step = [2 * LAYERS * LARGE_ACCUM] * 3 + [2 * LARGE_ACCUM] * 3  # 2 towers, 2 directions
    if counts != [n * LARGE_STEPS for n in per_step] or state.step != LARGE_STEPS:
        raise AssertionError(f"[train-large] launches (attn fwd, fwd_lse, bwd, loss fwd, dq, dK) "
                             f"{counts}, want {[n * LARGE_STEPS for n in per_step]}")
    losses = [m["train/loss"] for _, m in steps.records]
    norms = [m["train/grad_norm"] for _, m in steps.records]
    if len(losses) != LARGE_STEPS or not all(np.isfinite(losses + norms)):
        raise AssertionError(f"[train-large] losses {losses}, grad norms {norms}")
    step_ms = [batch * 1e3 / m["train/pairs_per_sec"] for _, m in steps.records]

    for counter in counters:
        counter.launches = 0
    halves = [{k: v[i * LARGE_MICRO:(i + 1) * LARGE_MICRO] for k, v in host.items()}
              for i in range(2)]
    val = trainer.evaluate(state, iter(halves))
    eval_counts = [c.launches for c in counters]
    want_eval = [2 * LAYERS * 2, 0, 0, 2 * 2, 0, 0]
    if eval_counts != want_eval or not np.isfinite(val["loss"]) or val["num_samples"] != batch:
        raise AssertionError(f"[train-large] evaluate: launches {eval_counts} (want {want_eval}),"
                             f" metrics {val}")
    med = statistics.median(step_ms[1:])
    print(f"[train-large] ViT-B-32 bf16, Trainer.fit at global batch {batch} = {LARGE_ACCUM} x "
          f"{LARGE_MICRO} cached, fused spatial loss (cap 50, k {NEIGHBORS}), numpy batches: "
          f"{LARGE_STEPS} steps in {fit_s:.1f} s; launches per step attention fwd "
          f"{counts[0] // LARGE_STEPS} fwd_lse {counts[1] // LARGE_STEPS} bwd "
          f"{counts[2] // LARGE_STEPS}, loss fwd {counts[3] // LARGE_STEPS} dq "
          f"{counts[4] // LARGE_STEPS} dK {counts[5] // LARGE_STEPS}; losses "
          f"{[round(x, 4) for x in losses]}, grad norms {[round(x, 4) for x in norms]}; median "
          f"step {med:.1f} ms over steps 2-{LARGE_STEPS} ({batch * 1e3 / med:.1f} pairs/s; all: "
          f"{[round(x, 1) for x in step_ms]}); max_memory_allocated {peak / 2 ** 30:.3f} GiB; "
          f"evaluate 2 x {LARGE_MICRO}: launches attention fwd {eval_counts[0]}, loss fwd "
          f"{eval_counts[3]}; loss {val['loss']:.4f}, R@1 {val['R@1']:.4f}, image_to_text_R@1 "
          f"{val['image_to_text_R@1']:.4f}", flush=True)
    return {"fwd": counts[3], "dq": counts[4], "dk": counts[5], "step_ms": med}


LN_SETTINGS = {  # phases 13-14: the two fused LayerNorm settings
    "ln_impl=pallas": dict(ln_impl="pallas"),
    "ln_gemm_impl=pallas": dict(ln_gemm_impl="pallas", attn_impl="pallas"),
}


def library_fwd_bwd_ms(fwd, inputs, grad_out) -> tuple:
    """(forward ms, backward ms) of a PyTorch composition: the backward is
    forward+backward minus forward, through autograd on ``inputs``."""
    import torch

    with torch.no_grad():
        fwd_ms = median_ms(fwd)
    both = median_ms(lambda: torch.autograd.grad(fwd(), inputs, grad_out))
    return fwd_ms, both - fwd_ms


def kernel_ln_phase() -> dict:
    """12. The four LayerNorm kernels against their plain versions on the
    card at the main path's shapes and one ragged shape each; dgamma/dbeta
    (f32, at 1e-5 max|ref|) the same bits on a second run. Library
    yardsticks: F.layer_norm forward and its autograd backward; for the LN
    -> GEMM kernels the two calls F.linear(F.layer_norm(x)) and their
    backward to x."""
    import torch
    import torch.nn.functional as F

    from spatial_clip_tpu_torch.bench_gemm import cold_copies, cold_ms, device_ms
    from spatial_clip_tpu_torch.ops import cuda_build
    from spatial_clip_tpu_torch.ops import fused_ln as fl
    from spatial_clip_tpu_torch.ops import fused_ln_dense as fd

    gen = torch.Generator(device="cuda").manual_seed(12)
    rows = {"fused_ln": {}, "fused_ln_dense": {}}
    for name, R, D, dtype in (("image", TRAIN_BATCH * 50, 768, torch.bfloat16),
                              ("text", TRAIN_BATCH * 77, 512, torch.bfloat16),
                              ("ragged_f32", 1001, 384, torch.float32)):
        x = (torch.randn((R, D), generator=gen, device="cuda") * 2 + 0.5).to(dtype)
        gamma = 1 + 0.1 * torch.randn((D,), generator=gen, device="cuda")
        beta = 0.1 * torch.randn((D,), generator=gen, device="cuda")
        dy = torch.randn((R, D), generator=gen, device="cuda").to(dtype)
        y = fl.fused_ln_fwd(x, gamma, beta, 1e-5)
        dx, dg, db = fl.fused_ln_bwd(x, gamma, dy, 1e-5)
        dx2, dg2, db2 = fl.fused_ln_bwd(x, gamma, dy, 1e-5)
        want_y = fl.reference_ln_fwd(x, gamma, beta, 1e-5)
        want_dx, want_dg, want_db = fl.reference_ln_bwd(x, gamma, dy, 1e-5)
        torch.cuda.synchronize()
        checks = {  # name: (error, tolerance)
            "y": ((y.float() - want_y.float()).abs().max().item(), train_tol(dtype, want_y.float())),
            "dx": ((dx.float() - want_dx.float()).abs().max().item(),
                   train_tol(dtype, want_dx.float())),
            "dgamma": ((dg - want_dg).abs().max().item(), 1e-5 * want_dg.abs().max().item()),
            "dbeta": ((db - want_db).abs().max().item(), 1e-5 * want_db.abs().max().item()),
        }
        bad = {k: v for k, v in checks.items() if not v[0] <= v[1]}
        same_bits = torch.equal(dg, dg2) and torch.equal(db, db2) and torch.equal(dx, dx2)
        if bad or not same_bits:
            raise AssertionError(f"[kernel-ln] fused_ln {name}: over tolerance {bad}, "
                                 f"dx, dgamma/dbeta same bits on a rerun: {same_bits}")
        partials = cuda_build.library().sc_layer_norm_bwd_blocks(
            R, D, cuda_build.DTYPE_CODES[dtype])
        xg = x.detach().requires_grad_()
        gl, bl = (t.to(dtype).requires_grad_() for t in (gamma, beta))
        lib_fwd, lib_bwd = library_fwd_bwd_ms(lambda: F.layer_norm(xg, (D,), gl, bl, 1e-5),
                                              (xg, gl, bl), dy)
        item = x.element_size()
        row = dict(
            fwd_err=checks["y"][0], bwd_err=max(checks[k][0] for k in ("dx", "dgamma", "dbeta")),
            fwd_ms=median_ms(lambda: fl.fused_ln_fwd(x, gamma, beta, 1e-5)),
            fwd_plain_ms=median_ms(lambda: fl.reference_ln_fwd(x, gamma, beta, 1e-5)),
            bwd_ms=median_ms(lambda: fl.fused_ln_bwd(x, gamma, dy, 1e-5)),
            bwd_plain_ms=median_ms(lambda: fl.reference_ln_bwd(x, gamma, dy, 1e-5)),
            fwd_library_ms=lib_fwd, bwd_library_ms=lib_bwd)
        # fwd: x in, y out, gamma/beta; bwd: x, dy in, dx out, gamma in, dgamma/dbeta out
        (row["fwd_bound_ms"], row["fwd_bound_by"]) = bound(2 * R * D * item + 8 * D,
                                                           8 * R * D, F32_FLOPS)
        (row["bwd_bound_ms"], row["bwd_bound_by"]) = bound(3 * R * D * item + 12 * D,
                                                           14 * R * D, F32_FLOPS)
        # cold: the card's clock alone, over copies of x (and y) past the L2
        copies = cold_copies(2 * R * D * item)
        xs = [x] + [x.clone() for _ in range(copies - 1)]
        row["fwd_cold_ms"] = cold_ms(lambda i: fl.fused_ln_fwd(xs[i], gamma, beta, 1e-5), copies)
        gd, bd = gamma.to(dtype), beta.to(dtype)
        row["fwd_library_cold_ms"] = cold_ms(lambda i: F.layer_norm(xs[i], (D,), gd, bd, 1e-5),
                                             copies)
        del xs
        # the backward on the card's clock alone: warm, and cold over copies of
        # x, dy and dx past the L2; F.layer_norm's backward on retained graphs
        copies = cold_copies(3 * R * D * item)
        xs = [x] + [x.clone() for _ in range(copies - 1)]
        dys = [dy] + [dy.clone() for _ in range(copies - 1)]
        row["bwd_device_ms"] = device_ms(lambda: fl.fused_ln_bwd(x, gamma, dy, 1e-5))
        row["bwd_cold_ms"] = cold_ms(lambda i: fl.fused_ln_bwd(xs[i], gamma, dys[i], 1e-5),
                                     copies)
        xgs = [t.detach().requires_grad_() for t in xs]
        outs = [F.layer_norm(t, (D,), gl, bl, 1e-5) for t in xgs]
        row["bwd_library_device_ms"] = device_ms(
            lambda: torch.autograd.grad(outs[0], (xgs[0], gl, bl), dy, retain_graph=True))
        row["bwd_library_cold_ms"] = cold_ms(
            lambda i: torch.autograd.grad(outs[i], (xgs[i], gl, bl), dys[i], retain_graph=True),
            copies)
        del xs, dys, xgs, outs
        rows["fused_ln"][name] = row
        print(f"[kernel-ln] fused_ln {name} x ({R}, {D}) {str(dtype)[6:]}: max abs err (tol) "
              + ", ".join(f"{k} {e:.3g} ({t:.3g})" for k, (e, t) in checks.items())
              + f", dx, dgamma/dbeta same bits on a rerun; fwd kernel {row['fwd_ms']:.4f} ms vs "
              f"plain {row['fwd_plain_ms']:.4f}, F.layer_norm {lib_fwd:.4f}, bound "
              f"{row['fwd_bound_ms']:.4f} ({row['fwd_bound_by']}, share "
              f"{row['fwd_bound_ms'] / row['fwd_ms']:.3f}); cold ({copies} copies) kernel "
              f"{row['fwd_cold_ms']:.4f} ms (share {row['fwd_bound_ms'] / row['fwd_cold_ms']:.3f})"
              f" vs F.layer_norm {row['fwd_library_cold_ms']:.4f}; bwd kernel "
              f"{row['bwd_ms']:.4f} ms vs plain {row['bwd_plain_ms']:.4f}, F.layer_norm "
              f"backward {lib_bwd:.4f} (host-fed), bound {row['bwd_bound_ms']:.4f} "
              f"({row['bwd_bound_by']}); on the card's clock kernel {row['bwd_device_ms']:.4f} ms "
              f"(share {row['bwd_bound_ms'] / row['bwd_device_ms']:.3f}) vs F.layer_norm "
              f"backward {row['bwd_library_device_ms']:.4f}, cold kernel "
              f"{row['bwd_cold_ms']:.4f} (share {row['bwd_bound_ms'] / row['bwd_cold_ms']:.3f}) "
              f"vs {row['bwd_library_cold_ms']:.4f}; backward grid {partials} blocks (one "
              f"partial row each)", flush=True)
    rows["fused_ln"]["bwd_edges"] = ln_bwd_edges()

    for name, R, K, N, dtype in (("image_fc", TRAIN_BATCH * 50, 768, 3072, torch.bfloat16),
                                 ("image_qkv", TRAIN_BATCH * 50, 768, 2304, torch.bfloat16),
                                 ("text_fc", TRAIN_BATCH * 77, 512, 2048, torch.bfloat16),
                                 ("text_qkv", TRAIN_BATCH * 77, 512, 1536, torch.bfloat16),
                                 ("ragged", 1000, 512, 1408, torch.bfloat16),
                                 ("ragged_f32", 333, 256, 384, torch.float32)):
        x = (torch.randn((R, K), generator=gen, device="cuda") * 2 + 0.5).to(dtype)
        gamma = 1 + 0.1 * torch.randn((K,), generator=gen, device="cuda")
        beta = 0.1 * torch.randn((K,), generator=gen, device="cuda")
        weight = torch.randn((N, K), generator=gen, device="cuda") / K ** 0.5
        bias = 0.1 * torch.randn((N,), generator=gen, device="cuda")
        g = torch.randn((R, N), generator=gen, device="cuda").to(dtype)
        w1, b1 = fd._fold(gamma, beta, weight, bias, dtype)
        y, xhat = fd.ln_dense_fwd(x, w1, b1, 1e-5)
        dx = fd.ln_dense_bwd_dx(x, g, w1, 1e-5)
        want_y, want_xhat = fd.reference_ln_dense_fwd(x, w1, b1, 1e-5)
        want_dx = fd.reference_ln_dense_bwd_dx(x, g, w1, 1e-5)
        torch.cuda.synchronize()
        checks = {k: ((got.float() - want.float()).abs().max().item(),
                      train_tol(dtype, want.float()))
                  for k, got, want in (("y", y, want_y), ("xhat", xhat, want_xhat),
                                       ("dx", dx, want_dx))}
        bad = {k: v for k, v in checks.items() if not v[0] <= v[1]}
        if bad:
            raise AssertionError(f"[kernel-ln] fused_ln_dense {name}: over tolerance {bad}")
        xg = x.detach().requires_grad_()
        gl, bl, wl, biasl = (t.to(dtype) for t in (gamma, beta, weight, bias))
        lib_fwd, lib_bwd = library_fwd_bwd_ms(
            lambda: F.linear(F.layer_norm(xg, (K,), gl, bl, 1e-5), wl, biasl), (xg,), g)
        item, peak = x.element_size(), BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
        row = dict(
            fwd_err=max(checks["y"][0], checks["xhat"][0]), bwd_err=checks["dx"][0],
            fwd_ms=median_ms(lambda: fd.ln_dense_fwd(x, w1, b1, 1e-5)),
            fwd_plain_ms=median_ms(lambda: fd.reference_ln_dense_fwd(x, w1, b1, 1e-5)),
            bwd_ms=median_ms(lambda: fd.ln_dense_bwd_dx(x, g, w1, 1e-5)),
            bwd_plain_ms=median_ms(lambda: fd.reference_ln_dense_bwd_dx(x, g, w1, 1e-5)),
            fwd_library_ms=lib_fwd, bwd_library_ms=lib_bwd)
        # fwd: x, W', b' in; y, xhat out. dx: x, g, W' in; dx out
        (row["fwd_bound_ms"], row["fwd_bound_by"]) = bound(
            (2 * R * K + N * K + R * N) * item + 4 * N, 2 * R * K * N, peak)
        (row["bwd_bound_ms"], row["bwd_bound_by"]) = bound(
            (2 * R * K + N * K + R * N) * item, 2 * R * K * N, peak)
        rows["fused_ln_dense"][name] = row
        print(f"[kernel-ln] fused_ln_dense {name} x ({R}, {K}) -> {N} {str(dtype)[6:]}: max abs "
              "err (tol) " + ", ".join(f"{k} {e:.3g} ({t:.3g})" for k, (e, t) in checks.items())
              + f"; fwd kernel {row['fwd_ms']:.4f} ms vs plain {row['fwd_plain_ms']:.4f}, "
              f"F.linear(F.layer_norm) {lib_fwd:.4f}, bound {row['fwd_bound_ms']:.4f} "
              f"({row['fwd_bound_by']}, share {row['fwd_bound_ms'] / row['fwd_ms']:.3f}); dx "
              f"kernel {row['bwd_ms']:.4f} ms vs plain {row['bwd_plain_ms']:.4f}, their "
              f"backward to x {lib_bwd:.4f}, bound {row['bwd_bound_ms']:.4f} "
              f"({row['bwd_bound_by']}, share {row['bwd_bound_ms'] / row['bwd_ms']:.3f})",
              flush=True)
    rows["fused_ln_dense"]["edges"] = ln_dense_edges()
    rows["fused_ln_dense"]["dx_edges"] = ln_dense_dx_edges()
    return rows


# phase 12's fused_ln backward grid edges: one row, either side of a
# warp's 32 lanes' row counts, more rows than one wave's warps; widths
# whose lanes hold 1 to 4 vectors
LN_BWD_EDGE_ROWS = (1, 31, 33, 5000)
LN_BWD_EDGE_WIDTHS = (128, 384, 640, 1024)


def ln_bwd_edges() -> dict:
    """12. The fused_ln backward (bf16) at its one-wave grid's edges
    (LN_BWD_EDGE_ROWS x LN_BWD_EDGE_WIDTHS): dx at one bf16 step of
    max|ref|, dgamma / dbeta at 1e-5 max|ref|, all three the same bits on a
    rerun. Returns the largest error."""
    import torch

    from spatial_clip_tpu_torch.ops import fused_ln as fl

    gen = torch.Generator(device="cuda").manual_seed(1212)
    worst = 0.0
    for R in LN_BWD_EDGE_ROWS:
        for D in LN_BWD_EDGE_WIDTHS:
            x = (torch.randn((R, D), generator=gen, device="cuda") * 2 + 0.5).bfloat16()
            gamma = 1 + 0.1 * torch.randn((D,), generator=gen, device="cuda")
            dy = torch.randn((R, D), generator=gen, device="cuda").bfloat16()
            got = fl.fused_ln_bwd(x, gamma, dy, 1e-5)
            again = fl.fused_ln_bwd(x, gamma, dy, 1e-5)
            want = fl.reference_ln_bwd(x, gamma, dy, 1e-5)
            torch.cuda.synchronize()
            errs = [(g.float() - w.float()).abs().max().item() for g, w in zip(got, want)]
            tols = [train_tol(torch.bfloat16, want[0].float())] + [
                1e-5 * w.abs().max().item() for w in want[1:]]
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            if not (all(e <= t for e, t in zip(errs, tols)) and same):
                raise AssertionError(f"[kernel-ln] fused_ln_bwd edge R={R} D={D}: errors {errs} "
                                     f"(tol {tols}), the same bits on a rerun {same}")
            worst = max(worst, errs[0])
    print(f"[kernel-ln] fused_ln_bwd bf16 grid edges R {list(LN_BWD_EDGE_ROWS)} x D "
          f"{list(LN_BWD_EDGE_WIDTHS)}: dx max abs err {worst:.3g} (one bf16 step of max|ref|), "
          "dgamma/dbeta within 1e-5 max|ref|, all the same bits on a rerun", flush=True)
    return dict(bwd_err=worst)


def ln_dense_edges() -> dict:
    """Phase 12's sweep of the bf16 LN -> dense forward (wgmma) at the row
    tile's and cluster's edges, every K it takes to 1024 and N past a whole
    number of 256-column tiles: y and xhat within one bf16 step of the
    plain version, the same bits on a rerun, two launches on the wgmma
    route each."""
    import torch

    from spatial_clip_tpu_torch.ops import fused_ln_dense as fd

    gen = torch.Generator(device="cuda").manual_seed(120)
    worst = 0.0
    shapes = [(R, K, N) for R in GEMM_EDGE_ROWS
              for K, N in ((128, 384), (256, 128), (512, 1408), (768, 1152), (1024, 640))]
    before = fd.ln_dense_fwd.routes["tc"]
    for R, K, N in shapes:
        x = (torch.randn((R, K), generator=gen, device="cuda") * 2 + 0.5).bfloat16()
        gamma = 1 + 0.1 * torch.randn((K,), generator=gen, device="cuda")
        beta = 0.1 * torch.randn((K,), generator=gen, device="cuda")
        weight = torch.randn((N, K), generator=gen, device="cuda") / K ** 0.5
        bias = 0.1 * torch.randn((N,), generator=gen, device="cuda")
        w1, b1 = fd._fold(gamma, beta, weight, bias, torch.bfloat16)
        y, xhat = fd.ln_dense_fwd(x, w1, b1, 1e-5)
        y2, xhat2 = fd.ln_dense_fwd(x, w1, b1, 1e-5)
        want_y, want_xhat = fd.reference_ln_dense_fwd(x, w1, b1, 1e-5)
        torch.cuda.synchronize()
        for got, want in ((y, want_y), (xhat, want_xhat)):
            err, tol = (got.float() - want.float()).abs().max().item(), train_tol(
                torch.bfloat16, want.float())
            if not err <= tol:
                raise AssertionError(f"[kernel-ln] fused_ln_dense edge R={R} K={K} N={N}: max "
                                     f"abs err {err} > {tol}")
            worst = max(worst, err / tol)
        if not (torch.equal(y, y2) and torch.equal(xhat, xhat2)):
            raise AssertionError(f"[kernel-ln] fused_ln_dense edge R={R} K={K} N={N}: other "
                                 "bits on a rerun")
    launched = fd.ln_dense_fwd.routes["tc"] - before
    if launched != 2 * len(shapes):
        raise AssertionError(f"[kernel-ln] fused_ln_dense edges: {launched} wgmma launches, "
                             f"want {2 * len(shapes)}")
    print(f"[kernel-ln] fused_ln_dense fwd bf16 edges: R {list(GEMM_EDGE_ROWS)} x (K, N) "
          f"(128, 384) (256, 128) (512, 1408) (768, 1152) (1024, 640): {len(shapes)} shapes "
          f"within tolerance (worst err / tol {worst:.3f}), the same bits on a rerun, {launched} "
          "launches on the wgmma route", flush=True)
    return {"shapes": len(shapes), "worst_err_over_tol": worst}


def ln_dense_dx_edges() -> dict:
    """Phase 12's sweep of the bf16 LN -> dense dx (wgmma, K-groups of CTAs
    owning 128 rows) at the row tile's and cluster's edges, every K it
    takes (128 ... 1024, so every K-group size and units a CTA) and N of 3
    to 5 g tiles: dx within one bf16 step of the plain version, the same
    bits on a rerun, the plan's row tiles and K-group as the wrapper's
    constants say, two launches on the wgmma route each."""
    import torch

    from spatial_clip_tpu_torch.ops import fused_ln_dense as fd

    gen = torch.Generator(device="cuda").manual_seed(121)
    worst = 0.0
    shapes = [(R, K, 384 + 128 * (K // 128 % 3)) for R in GEMM_EDGE_ROWS
              for K in range(128, 1025, 128)]
    before = fd.ln_dense_bwd_dx.routes["tc"]
    for R, K, N in shapes:
        x = (torch.randn((R, K), generator=gen, device="cuda") * 2 + 0.5).bfloat16()
        g = torch.randn((R, N), generator=gen, device="cuda").bfloat16()
        w1 = (torch.randn((N, K), generator=gen, device="cuda") / K ** 0.5).bfloat16()
        dx = fd.ln_dense_bwd_dx(x, g, w1, 1e-5)
        dx2 = fd.ln_dense_bwd_dx(x, g, w1, 1e-5)
        want = fd.reference_ln_dense_bwd_dx(x, g, w1, 1e-5)
        torch.cuda.synchronize()
        err, tol = (dx.float() - want.float()).abs().max().item(), train_tol(torch.bfloat16,
                                                                             want.float())
        if not err <= tol:
            raise AssertionError(f"[kernel-ln] fused_ln_dense dx edge R={R} K={K} N={N}: max abs "
                                 f"err {err} > {tol}")
        worst = max(worst, err / tol)
        if not torch.equal(dx, dx2):
            raise AssertionError(f"[kernel-ln] fused_ln_dense dx edge R={R} K={K} N={N}: other "
                                 "bits on a rerun")
        plan = fd.ln_dense_bwd_dx_plan(R, K, N)
        if (plan["row_tiles"], plan["k_parts"]) != (-(-R // fd.DX_ROW_TILE), fd.dx_k_parts(K)):
            raise AssertionError(f"[kernel-ln] fused_ln_dense dx edge R={R} K={K}: plan {plan}")
    launched = fd.ln_dense_bwd_dx.routes["tc"] - before
    if launched != 2 * len(shapes):
        raise AssertionError(f"[kernel-ln] fused_ln_dense dx edges: {launched} wgmma launches, "
                             f"want {2 * len(shapes)}")
    print(f"[kernel-ln] fused_ln_dense dx bf16 edges: R {list(GEMM_EDGE_ROWS)} x K 128..1024 "
          f"(N 384 / 512 / 640): {len(shapes)} shapes within tolerance (worst err / tol "
          f"{worst:.3f}), the same bits on a rerun, plans as the wrapper's constants say, "
          f"{launched} launches on the wgmma route", flush=True)
    return {"shapes": len(shapes), "worst_err_over_tol": worst}


def ln_counters():
    from spatial_clip_tpu_torch.ops import fused_ln as fl
    from spatial_clip_tpu_torch.ops import fused_ln_dense as fd
    from spatial_clip_tpu_torch.ops.fused_attention import (
        fused_attention,
        fused_attention_bwd,
        fused_attention_bwd_recompute,
        fused_attention_lse,
    )

    return (fl.fused_ln_fwd, fl.fused_ln_bwd, fd.ln_dense_fwd, fd.ln_dense_bwd_dx,
            fused_attention, fused_attention_lse, fused_attention_bwd,
            fused_attention_bwd_recompute)


def ln_check_phase() -> None:
    """13. Under each fused LayerNorm setting: one ViT-B-32 train step at
    batch 32, card (bf16, kernels) vs CPU (f32, plain path), under phase 7's
    limits; and 64 tiles and 64 texts encoded on the card (bf16 serving
    model) against the f32 CPU plain path, per-row cosine >= MIN_COSINE."""
    import torch

    from spatial_clip_tpu_torch import create_model
    from spatial_clip_tpu_torch.models.factory import get_tokenizer
    from spatial_clip_tpu_torch.models.transforms import normalize_batch

    tiles = np.random.default_rng(13).integers(0, 256, (64, 224, 224, 3), dtype=np.uint8)
    texts = [f"tile {i}: EPCAM KRT{i % 20} in stroma" for i in range(64)]
    ids = torch.from_numpy(get_tokenizer("ViT-B-32")(texts)).long()
    # per encode of 64 (image, text): fused_ln fwd, fused_ln_dense fwd, inference attention
    want = {"ln_impl=pallas": ((26, 0, 12), (25, 0, 12)),
            "ln_gemm_impl=pallas": ((0, 24, 12), (0, 24, 12))}
    for label, settings in LN_SETTINGS.items():
        train_check_phase(f"ln-check {label}", **settings)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        card = create_model("ViT-B-32", precision="bf16", seed=0, device="cuda", **settings)
        cpu = create_model("ViT-B-32", precision="fp32", seed=0, device="cpu", **settings)
        counters = ln_counters()
        got, counts = {}, []
        with torch.inference_mode():
            for kind, fn, arg in (("image", "encode_image", normalize_batch(
                    torch.from_numpy(tiles).cuda(), dtype=torch.bfloat16)),
                                  ("text", "encode_text", ids.cuda())):
                for c in counters:
                    c.launches = 0
                got[kind] = getattr(card, fn)(arg).float().cpu()
                counts.append(tuple(counters[i].launches for i in (0, 2, 4)))
            ref = {"image": cpu.encode_image(normalize_batch(torch.from_numpy(tiles))),
                   "text": cpu.encode_text(ids)}
        cos = {k: (got[k] * ref[k]).sum(-1).min().item() for k in got}
        finite = all(torch.isfinite(v).all().item() for v in got.values())
        if tuple(counts) != want[label] or min(cos.values()) < MIN_COSINE or not finite:
            raise AssertionError(f"[ln-check {label}] encode launches (ln, ln_dense, attention) "
                                 f"{counts} (want {want[label]}), min cosine {cos}, finite "
                                 f"{finite}")
        print(f"[ln-check {label}] encode 64 tiles / 64 texts, bf16 card vs f32 CPU plain path: "
              f"min cosine image {cos['image']:.5f} text {cos['text']:.5f} (>= {MIN_COSINE}); "
              f"launches (fused_ln, fused_ln_dense, attention) image {counts[0]} text "
              f"{counts[1]}; {time.perf_counter() - t0:.1f} s", flush=True)
        del card, cpu


def train_ln_phase(default_step_ms: float) -> dict:
    """14. The bench workload (ViT-B-32 bf16, batch 256) under each fused
    LayerNorm setting: 3 warmup and 10 timed steps, exact launches per
    step, finite losses and gradient norms; median step beside phase 8's."""
    import torch

    from spatial_clip_tpu_torch.bench import make_trainer, synthetic_batch

    per_step = {  # fused_ln fwd, bwd, fused_ln_dense fwd, dx, attention fwd, fwd_lse, bwd,
        # recompute bwd
        "ln_impl=pallas": (51, 51, 0, 0, 0, 2 * LAYERS, 2 * LAYERS, 0),
        "ln_gemm_impl=pallas": (0, 0, 4 * LAYERS, 4 * LAYERS, 2 * LAYERS, 0, 0, 2 * LAYERS),
    }
    steps = WARMUP_STEPS + TIMED_STEPS
    out = {}
    for label, settings in LN_SETTINGS.items():
        torch.cuda.empty_cache()
        trainer = make_trainer("ViT-B-32", device="cuda", **settings)
        batch = synthetic_batch(trainer.model, TRAIN_BATCH)
        counts, step_ms, history, peak = timed_steps(f"train-ln {label}", trainer, batch, steps,
                                                     ln_counters())
        want = tuple(n * steps for n in per_step[label])
        if counts != want:
            raise AssertionError(f"[train-ln {label}] launches (ln fwd, ln bwd, ln_dense fwd, dx, "
                                 f"attention fwd, fwd_lse, bwd, recompute bwd) {counts}, want "
                                 f"{want}")
        med = statistics.median(step_ms[WARMUP_STEPS:])
        out[label] = {"counts": counts, "step_ms": med}
        print(f"[train-ln {label}] ViT-B-32 bf16 batch {TRAIN_BATCH}: {steps} steps, launches per "
              f"step (ln fwd, ln bwd, ln_dense fwd, dx, attention fwd, fwd_lse, bwd, recompute "
              f"bwd) "
              f"{tuple(c // steps for c in counts)}; losses finite {history[0][0]:.4f} -> "
              f"{history[-1][0]:.4f}, grad norms {history[0][1]:.4f} -> {history[-1][1]:.4f}; "
              f"median step {med:.3f} ms ({TRAIN_BATCH * 1e3 / med:.1f} pairs/s) vs phase 8's "
              f"default {default_step_ms:.3f} ms ({TRAIN_BATCH * 1e3 / default_step_ms:.1f} "
              f"pairs/s); max_memory_allocated {peak / 2 ** 30:.3f} GiB", flush=True)
        del trainer, batch
    return out


def kernel_mlp_phase() -> dict:
    """15. The fused MLP kernel against its plain version on the card at the
    training shapes (batch 256), the serving shapes (batch 64), a ragged R
    and one f32 shape, with the weights in x's dtype (a serving model's; a
    training model's are cast per use before the launch). Yardstick: the
    three calls F.linear(F.gelu(F.linear(x, W1, b1), tanh), W2, b2)."""
    import torch
    import torch.nn.functional as F

    from spatial_clip_tpu_torch.ops import fused_mlp as fm

    gen = torch.Generator(device="cuda").manual_seed(15)
    rows = {}
    for name, R, W, H, dtype in (("image", TRAIN_BATCH * 50, 768, 3072, torch.bfloat16),
                                 ("text", TRAIN_BATCH * 77, 512, 2048, torch.bfloat16),
                                 ("image_serve", 64 * 50, 768, 3072, torch.bfloat16),
                                 ("text_serve", 64 * 77, 512, 2048, torch.bfloat16),
                                 ("ragged", 1000, 768, 3072, torch.bfloat16),
                                 ("f32", 333, 256, 1024, torch.float32)):
        x = torch.randn((R, W), generator=gen, device="cuda").to(dtype)
        w1 = (torch.randn((H, W), generator=gen, device="cuda") / W ** 0.5).to(dtype)
        b1 = (0.1 * torch.randn((H,), generator=gen, device="cuda")).to(dtype)
        w2 = (torch.randn((W, H), generator=gen, device="cuda") / H ** 0.5).to(dtype)
        b2 = (0.1 * torch.randn((W,), generator=gen, device="cuda")).to(dtype)
        out = fm.fused_mlp_fwd(x, w1, b1, w2, b2)
        want = fm.reference_mlp_fwd(x, w1, b1, w2, b2)
        torch.cuda.synchronize()
        err, tol = (out.float() - want.float()).abs().max().item(), train_tol(dtype, want.float())
        if not (err <= tol and torch.isfinite(out).all().item()):
            raise AssertionError(f"[kernel-mlp] {name}: max abs err {err} > {tol} or non-finite")
        peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
        row = dict(
            err=err,
            ms=median_ms(lambda: fm.fused_mlp_fwd(x, w1, b1, w2, b2)),
            plain_ms=median_ms(lambda: fm.reference_mlp_fwd(x, w1, b1, w2, b2)),
            library_ms=median_ms(lambda: F.linear(F.gelu(F.linear(x, w1, b1), approximate="tanh"),
                                                  w2, b2)))
        # x, W1, b1, W2, b2 in; out; two products of 2 R W H operations each
        row["bound_ms"], row["bound_by"] = bound(
            (2 * R * W + 2 * W * H + H + W) * x.element_size(), 4 * R * W * H, peak)
        if dtype == torch.bfloat16:
            row["plan"] = fm.mlp_plan(R, W, H)
        rows[name] = row
        print(f"[kernel-mlp] fused_mlp {name} x ({R}, {W}) -> {H} -> {W} {str(dtype)[6:]}: max abs "
              f"err {err:.3g} (tol {tol:.3g}); kernel {row['ms']:.4f} ms vs plain "
              f"{row['plain_ms']:.4f}, F.linear(F.gelu(F.linear)) {row['library_ms']:.4f}, bound "
              f"{row['bound_ms']:.4f} ({row['bound_by']}, share "
              f"{row['bound_ms'] / row['ms']:.3f}); plan {row.get('plan')}", flush=True)
    rows["edges"] = mlp_edges()
    return rows


def mlp_edges() -> dict:
    """Phase 15's sweep of the bf16 fused MLP forward (wgmma) at the row
    tile's and cluster's edges, every width it takes (2048: x streamed
    through the ring) and hidden sizes that are multiples of 512: within
    one bf16 step of the plain version, the same bits on a rerun, two
    launches on each shape's route."""
    import torch

    from spatial_clip_tpu_torch.ops import fused_mlp as fm

    gen = torch.Generator(device="cuda").manual_seed(150)
    worst = 0.0
    shapes = [(R, W, H) for R in GEMM_EDGE_ROWS
              for W, H in ((128, 512), (256, 1024), (512, 2048), (768, 1536), (1024, 512),
                           (2048, 1024))]
    before = dict(fm.fused_mlp_fwd.routes)
    want_routes = {"x_resident": 0, "x_streamed": 0}
    for R, W, H in shapes:
        x = torch.randn((R, W), generator=gen, device="cuda").bfloat16()
        w1 = (torch.randn((H, W), generator=gen, device="cuda") / W ** 0.5).bfloat16()
        b1 = (0.1 * torch.randn((H,), generator=gen, device="cuda")).bfloat16()
        w2 = (torch.randn((W, H), generator=gen, device="cuda") / H ** 0.5).bfloat16()
        b2 = (0.1 * torch.randn((W,), generator=gen, device="cuda")).bfloat16()
        out = fm.fused_mlp_fwd(x, w1, b1, w2, b2)
        again = fm.fused_mlp_fwd(x, w1, b1, w2, b2)
        want = fm.reference_mlp_fwd(x, w1, b1, w2, b2)
        torch.cuda.synchronize()
        err, tol = (out.float() - want.float()).abs().max().item(), train_tol(torch.bfloat16,
                                                                              want.float())
        if not (err <= tol and torch.equal(out, again)):
            raise AssertionError(f"[kernel-mlp] edge R={R} W={W} H={H}: max abs err {err} (tol "
                                 f"{tol}), the same bits on a rerun {torch.equal(out, again)}")
        worst = max(worst, err / tol)
        want_routes["x_resident" if W <= fm.X_RESIDENT_WIDTH else "x_streamed"] += 2
    got_routes = {k: fm.fused_mlp_fwd.routes[k] - before[k] for k in want_routes}
    if got_routes != want_routes:
        raise AssertionError(f"[kernel-mlp] edges: launches by route {got_routes}, want "
                             f"{want_routes}")
    print(f"[kernel-mlp] fused_mlp bf16 edges: R {list(GEMM_EDGE_ROWS)} x (W, H) (128, 512) "
          f"(256, 1024) (512, 2048) (768, 1536) (1024, 512) (2048, 1024): {len(shapes)} shapes "
          f"within tolerance (worst err / tol {worst:.3f}), the same bits on a rerun, launches "
          f"by route {got_routes}", flush=True)
    return {"shapes": len(shapes), "worst_err_over_tol": worst, "routes": got_routes}


def mlp_check_phase() -> None:
    """16. Under mlp_impl='pallas': phase 7's card-vs-CPU step at batch 32;
    then the embedding server (bf16, batch 64) started with the setting
    answers 64 raw tiles and 64 texts, each one encoder batch of exactly 12
    fused MLP (and 12 attention) launches, against the same weights in f32
    on the CPU (plain path), per-row cosine >= MIN_COSINE; and phase 5's
    encode timings under the setting."""
    import torch
    from http.server import ThreadingHTTPServer

    from spatial_clip_tpu_torch import create_model
    from spatial_clip_tpu_torch.models.transforms import normalize_batch
    from spatial_clip_tpu_torch.ops import fused_mlp as fm
    from spatial_clip_tpu_torch.ops.fused_attention import fused_attention
    from spatial_clip_tpu_torch.serve import EmbeddingService, make_handler

    train_check_phase("mlp-check", mlp_impl="pallas")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    service = EmbeddingService("ViT-B-32", precision="bf16", batch_size=64, device="cuda",
                               mlp_impl="pallas")
    service.warmup()
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    tiles = np.random.default_rng(16).integers(0, 256, (64, 224, 224, 3), dtype=np.uint8)
    texts = [f"spot {i}: EPCAM KRT{i % 20} in tumor stroma" for i in range(64)]
    try:
        got, counts = {}, {}
        for kind, path, body in (
                ("image", "/embed_image_raw", tiles.tobytes()),
                ("text", "/embed_text", json.dumps({"texts": texts, "encoding": "b64_f32"}))):
            fm.fused_mlp_fwd.launches = fused_attention.launches = 0
            got[kind] = embeddings(post(port, path, body))
            counts[kind] = (fm.fused_mlp_fwd.launches, fused_attention.launches)
        model = service.model  # phase 5's timings under the setting
        x64 = normalize_batch(torch.from_numpy(tiles).cuda(), dtype=model.dtype)
        ids64 = torch.from_numpy(get_tokenizer_ids(texts)).cuda()
        with torch.inference_mode():
            img_ms = host_median_ms(lambda: model.encode_image(x64))
            txt_ms = host_median_ms(lambda: model.encode_text(ids64))
        del model, x64, ids64
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        service.close()
    dim = int(service.model.cfg.embed_dim)
    del service
    reference = create_model("ViT-B-32", precision="fp32", seed=0, device="cpu", mlp_impl="pallas")
    with torch.inference_mode():
        want = {"image": reference.encode_image(normalize_batch(torch.from_numpy(tiles))).numpy(),
                "text": reference.encode_text(
                    torch.from_numpy(get_tokenizer_ids(texts))).numpy()}
    for kind in got:
        check_embeddings(f"mlp-check {kind}", got[kind], 64, dim)
    cos = {k: float((got[k] * want[k]).sum(-1).min()) for k in got}
    if counts != {"image": (LAYERS, LAYERS), "text": (LAYERS, LAYERS)} or \
            min(cos.values()) < MIN_COSINE:
        raise AssertionError(f"[mlp-check] launches (fused_mlp, attention) per encoder batch "
                             f"{counts}, min cosine vs f32 CPU {cos}")
    print(f"[mlp-check] server with mlp_impl='pallas' (ViT-B-32 bf16, batch 64): POST "
          f"/embed_image_raw 64 tiles and /embed_text 64 texts, 200 OK, finite, unit norm; "
          f"launches (fused_mlp, attention) per encoder batch image {counts['image']} text "
          f"{counts['text']}; min cosine vs f32 CPU plain path image {cos['image']:.5f} text "
          f"{cos['text']:.5f} (>= {MIN_COSINE}); encode_image 64 tiles {img_ms:.3f} ms, "
          f"encode_text 64 texts {txt_ms:.3f} ms (phase 5's timing); "
          f"{time.perf_counter() - t0:.1f} s",
          flush=True)


def get_tokenizer_ids(texts):
    from spatial_clip_tpu_torch.models.factory import get_tokenizer

    return np.asarray(get_tokenizer("ViT-B-32")(texts), dtype=np.int64)


def timed_steps(label: str, trainer, batch, steps: int, counters):
    """``steps`` train steps from a fresh state, each ending in a
    synchronize, with every counter set to 0 first; fails on a non-finite
    loss or gradient norm. Returns (launch counts, step ms, (loss, grad
    norm) per step, peak memory)."""
    import torch

    state = trainer.init_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    step_ms, history = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        history.append((float(metrics["loss"]), float(metrics["grad_norm"])))
    if not all(np.isfinite([v for pair in history for v in pair])):
        raise AssertionError(f"[{label}] non-finite loss or grad norm: {history}")
    return (tuple(c.launches for c in counters), step_ms, history,
            torch.cuda.max_memory_allocated())


def attention_counters():
    from spatial_clip_tpu_torch.ops import fused_attention as fa

    return (fa.fused_attention, fa.fused_attention_lse, fa.fused_attention_bwd,
            fa.fused_attention_bwd_recompute_db, fa.fused_attention_bwd_recompute)


def train_mlp_phase(default_step_ms: float) -> dict:
    """17. The bench workload (ViT-B-32 bf16, batch 256) under
    mlp_impl='pallas': 3 warmup and 10 timed steps, exactly 24 fused MLP
    and 24 + 24 attention (forward-lse, backward) launches per step, finite
    losses and gradient norms; median step beside phase 8's."""
    import torch

    from spatial_clip_tpu_torch.bench import make_trainer, synthetic_batch
    from spatial_clip_tpu_torch.ops import fused_mlp as fm

    torch.cuda.empty_cache()
    trainer = make_trainer("ViT-B-32", device="cuda", mlp_impl="pallas")
    batch = synthetic_batch(trainer.model, TRAIN_BATCH)
    steps = WARMUP_STEPS + TIMED_STEPS
    counters = (fm.fused_mlp_fwd, *attention_counters())
    counts, step_ms, history, peak = timed_steps("train-mlp", trainer, batch, steps, counters)
    want = tuple(n * steps for n in (2 * LAYERS, 0, 2 * LAYERS, 2 * LAYERS, 0, 0))
    if counts != want:
        raise AssertionError(f"[train-mlp] launches (fused_mlp, attention fwd, fwd_lse, bwd, "
                             f"recompute-with-db bwd, recompute bwd) {counts}, want {want}")
    med = statistics.median(step_ms[WARMUP_STEPS:])
    print(f"[train-mlp mlp_impl=pallas] ViT-B-32 bf16 batch {TRAIN_BATCH}: {steps} steps, launches "
          f"per step (fused_mlp, attention fwd, fwd_lse, bwd, recompute-with-db bwd, recompute "
          f"bwd) {tuple(c // steps for c in counts)}; losses finite {history[0][0]:.4f} -> "
          f"{history[-1][0]:.4f}, grad norms {history[0][1]:.4f} -> {history[-1][1]:.4f}; median "
          f"step {med:.3f} ms ({TRAIN_BATCH * 1e3 / med:.1f} pairs/s) vs phase 8's default "
          f"{default_step_ms:.3f} ms ({TRAIN_BATCH * 1e3 / default_step_ms:.1f} pairs/s); "
          f"max_memory_allocated {peak / 2 ** 30:.3f} GiB", flush=True)
    del trainer, batch
    return {"launches": counts[0], "step_ms": med}


ROUTE_BATCH = 100  # not a multiple of 8: JAX's _lse_ok fails, no lse is saved


def route_check_phase() -> dict:
    """18. JAX's attention-backward routes on the card: the card-vs-CPU step
    at batch 12 (``_lse_ok`` fails: the inference forward and the recompute
    backward with db, 24 each, no forward-lse), the step at batch 32 under
    BWD_FUSE='none' (24 forward-lse and 24 recompute no-db), with exact
    launch counts; then 1 warmup and 3 timed steps of the bench workload at
    batch 100 on the recompute-with-db route."""
    import torch

    from spatial_clip_tpu_torch.bench import make_trainer, synthetic_batch
    from spatial_clip_tpu_torch.ops import fused_attention as fa

    counters = attention_counters()
    counts = {}
    for label, batch_size, fuse, want in (
            ("recompute-with-db", 12, "db", (2 * LAYERS, 0, 0, 2 * LAYERS, 0)),
            ("BWD_FUSE=none", CHECK_BATCH, "none", (0, 2 * LAYERS, 0, 0, 2 * LAYERS))):
        torch.cuda.empty_cache()
        previous, fa.BWD_FUSE = fa.BWD_FUSE, fuse
        for c in counters:
            c.launches = 0
        try:
            train_check_phase(f"route-check {label}", batch_size)
        finally:
            fa.BWD_FUSE = previous
        counts[label] = tuple(c.launches for c in counters)
        if counts[label] != want:
            raise AssertionError(f"[route-check {label}] launches (attention fwd, fwd_lse, bwd, "
                                 f"recompute-with-db bwd, recompute bwd) {counts[label]}, want "
                                 f"{want}")
    torch.cuda.empty_cache()
    trainer = make_trainer("ViT-B-32", device="cuda")
    batch = synthetic_batch(trainer.model, ROUTE_BATCH)
    launches, step_ms, history, peak = timed_steps(f"route-check batch {ROUTE_BATCH}", trainer,
                                                   batch, 4, counters)
    want = tuple(4 * n for n in (2 * LAYERS, 0, 0, 2 * LAYERS, 0))
    if launches != want:
        raise AssertionError(f"[route-check batch {ROUTE_BATCH}] launches {launches}, want {want}")
    med = statistics.median(step_ms[1:])
    print(f"[route-check] launches (attention fwd, fwd_lse, bwd, recompute-with-db bwd, recompute "
          f"bwd): batch 12 {counts['recompute-with-db']}, batch {CHECK_BATCH} BWD_FUSE=none "
          f"{counts['BWD_FUSE=none']}; batch {ROUTE_BATCH} (no lse saved), 4 steps {launches}: "
          f"losses {[round(l, 4) for l, _ in history]}, median of steps 2-4 {med:.3f} ms "
          f"({ROUTE_BATCH * 1e3 / med:.1f} pairs/s; all {[round(t, 1) for t in step_ms]}); "
          f"max_memory_allocated {peak / 2 ** 30:.3f} GiB", flush=True)
    del trainer, batch
    return {"db_launches": launches[3], "none_launches": counts["BWD_FUSE=none"][4],
            "step_ms": med}


def zip_counters():
    from spatial_clip_tpu_torch.ops import attention_pair as ap

    return (ap.fused_attention_pair, ap.fused_attention_pair_bwd, *attention_counters())


def sum_bounds(*bounds):
    """The bound of two kernels' work done in one launch: their bounds added,
    bound by what bounds the larger."""
    return sum(ms for ms, _ in bounds), max(bounds)[1]


def kernel_pair_phase() -> dict:
    """19. The pair kernels against their plain versions (forward at
    KERNEL_TOL as phase 3; backward at bwd_tol as phase 6) and bit for bit
    against the single-tower launches (the inference forward with no lse,
    the recompute backward without db); timed beside those two launches and
    beside SDPA on each tower."""
    import torch

    from spatial_clip_tpu_torch.models.transformer import causal_mask
    from spatial_clip_tpu_torch.ops import attention_pair as ap
    from spatial_clip_tpu_torch.ops.fused_attention import (
        fused_attention,
        fused_attention_bwd_recompute,
    )

    gen = torch.Generator(device="cuda").manual_seed(19)
    cases = [  # name, B, (La, Da, Ha, causal), (Lb, Db, Hb, causal), dtype
        ("256", TRAIN_BATCH, (50, 768, 12, False), (77, 512, 8, True), torch.bfloat16),
        ("64", 64, (50, 768, 12, False), (77, 512, 8, True), torch.bfloat16),
        ("f32", 3, (17, 256, 2, False), (26, 128, 4, True), torch.float32),
    ]
    rows = {}
    for name, B, (La, Da, Ha, ca), (Lb, Db, Hb, cb), dtype in cases:
        qa = torch.randn((B, La, 3 * Da), generator=gen, device="cuda").to(dtype)
        qb = torch.randn((B, Lb, 3 * Db), generator=gen, device="cuda").to(dtype)
        ga = torch.randn((B, La, Da), generator=gen, device="cuda").to(dtype)
        gb = torch.randn((B, Lb, Db), generator=gen, device="cuda").to(dtype)
        ma = causal_mask(La, device="cuda") if ca else None
        mb = causal_mask(Lb, device="cuda") if cb else None
        oa, ob = ap.fused_attention_pair(qa, ma, qb, mb, Ha, Hb)
        da, db = ap.fused_attention_pair_bwd(qa, ma, ga, qb, mb, gb, Ha, Hb)
        singles = (fused_attention(qa, ma, Ha), fused_attention(qb, mb, Hb),
                   fused_attention_bwd_recompute(qa, ma, ga, Ha),
                   fused_attention_bwd_recompute(qb, mb, gb, Hb))
        want = (*ap.reference_attention_pair(qa, ma, qb, mb, Ha, Hb),
                *ap.reference_attention_pair_bwd(qa, ma, ga, qb, mb, gb, Ha, Hb))
        torch.cuda.synchronize()
        same_bits = [torch.equal(got, single) for got, single in zip((oa, ob, da, db), singles)]
        errs = {}
        for k, got, ref in zip(("ctx_a", "ctx_b", "dqkv_a", "dqkv_b"), (oa, ob, da, db), want):
            tol = (KERNEL_TOL[str(dtype).split(".")[-1]] if k.startswith("ctx")
                   else bwd_tol(dtype, ref.float()))
            errs[k] = ((got.float() - ref.float()).abs().max().item(), tol)
        bad = {k: v for k, v in errs.items() if not v[0] <= v[1]}
        if bad or not all(same_bits):
            raise AssertionError(f"[kernel-pair] {name}: over tolerance {bad}; equal to the single-"
                                 f"tower launches (ctx_a, ctx_b, dqkv_a, dqkv_b) {same_bits}")
        lib_a, lib_b = sdpa_ms(qa, ma, Ha), sdpa_ms(qb, mb, Hb)
        row = dict(
            fwd_err=max(errs["ctx_a"][0], errs["ctx_b"][0]),
            bwd_err=max(errs["dqkv_a"][0], errs["dqkv_b"][0]),
            fwd_ms=median_ms(lambda: ap.fused_attention_pair(qa, ma, qb, mb, Ha, Hb)),
            fwd_single_ms=median_ms(lambda: (fused_attention(qa, ma, Ha),
                                             fused_attention(qb, mb, Hb))),
            fwd_plain_ms=median_ms(lambda: ap.reference_attention_pair(qa, ma, qb, mb, Ha, Hb)),
            bwd_ms=median_ms(lambda: ap.fused_attention_pair_bwd(qa, ma, ga, qb, mb, gb, Ha, Hb)),
            bwd_single_ms=median_ms(lambda: (fused_attention_bwd_recompute(qa, ma, ga, Ha),
                                             fused_attention_bwd_recompute(qb, mb, gb, Hb))),
            bwd_plain_ms=median_ms(lambda: ap.reference_attention_pair_bwd(
                qa, ma, ga, qb, mb, gb, Ha, Hb)),
            fwd_library_ms=lib_a["fwd"] + lib_b["fwd"], bwd_library_ms=lib_a["bwd"] + lib_b["bwd"])
        row["fwd_bound_ms"], row["fwd_bound_by"] = sum_bounds(attention_bound(qa, Ha, "fwd"),
                                                              attention_bound(qb, Hb, "fwd"))
        row["bwd_bound_ms"], row["bwd_bound_by"] = sum_bounds(
            attention_bound(qa, Ha, "bwd_recompute"), attention_bound(qb, Hb, "bwd_recompute"))
        rows[name] = row
        print(f"[kernel-pair] {name}: qkv {tuple(qa.shape)} + {tuple(qb.shape)} {str(dtype)[6:]}: "
              "max abs err (tol) "
              + ", ".join(f"{k} {e:.3g} ({t:.3g})" for k, (e, t) in errs.items())
              + "; each tower bit for bit its single-tower launch's; "
              + "; ".join(f"{p} pair {row[p + '_ms']:.4f} ms vs two single launches "
                          f"{row[p + '_single_ms']:.4f}, plain {row[p + '_plain_ms']:.4f}, SDPA "
                          f"{row[p + '_library_ms']:.4f}, bound {row[p + '_bound_ms']:.4f} "
                          f"({row[p + '_bound_by']})" for p in ("fwd", "bwd")), flush=True)
    return rows


def zip_check_phase() -> None:
    """20. Under zip_towers='on': phase 7's card-vs-CPU step at batch 32
    with exact launches (12 pair forward, 12 pair backward, no single-tower
    attention); then 64 tiles and 64 texts through CLIP.forward(images,
    text), the bf16 card against the f32 CPU plain path (per-row cosine), 12
    pair forward launches."""
    import torch

    from spatial_clip_tpu_torch import create_model
    from spatial_clip_tpu_torch.models.transforms import normalize_batch

    counters = zip_counters()
    for c in counters:
        c.launches = 0
    torch.cuda.empty_cache()
    train_check_phase("zip-check", zip_towers="on")
    step = tuple(c.launches for c in counters)
    if step != (LAYERS, LAYERS, 0, 0, 0, 0, 0):
        raise AssertionError(f"[zip-check] step launches (pair fwd, pair bwd, attention fwd, "
                             f"fwd_lse, bwd, recompute-with-db bwd, recompute bwd) {step}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tiles = np.random.default_rng(20).integers(0, 256, (64, 224, 224, 3), dtype=np.uint8)
    ids = torch.from_numpy(get_tokenizer_ids(
        [f"spot {i}: EPCAM KRT{i % 20} near stroma" for i in range(64)]))
    card = create_model("ViT-B-32", precision="bf16", seed=0, device="cuda", zip_towers="on")
    cpu = create_model("ViT-B-32", precision="fp32", seed=0, device="cpu", zip_towers="on")
    for c in counters:
        c.launches = 0
    with torch.inference_mode():
        got = card(normalize_batch(torch.from_numpy(tiles).cuda(), dtype=torch.bfloat16),
                   ids.cuda())
        got = {k: got[k].float().cpu() for k in ("image_features", "text_features")}
        encode = tuple(c.launches for c in counters)
        ref = cpu(normalize_batch(torch.from_numpy(tiles)), ids)
    cos = {k: (got[k] * ref[k]).sum(-1).min().item() for k in got}
    finite = all(torch.isfinite(v).all().item() for v in got.values())
    if encode != (LAYERS, 0, 0, 0, 0, 0, 0) or min(cos.values()) < MIN_COSINE or not finite:
        raise AssertionError(f"[zip-check] forward launches {encode}, min cosine {cos}, finite "
                             f"{finite}")
    print(f"[zip-check] zip_towers='on': step launches (pair fwd, pair bwd, single-tower "
          f"attention x5) {step}; CLIP.forward(64 tiles, 64 texts) bf16 card vs f32 CPU plain "
          f"path: min cosine image {cos['image_features']:.5f} text {cos['text_features']:.5f} "
          f"(>= {MIN_COSINE}), launches {encode}; {time.perf_counter() - t0:.1f} s", flush=True)
    del card, cpu


def train_zip_phase(default_step_ms: float) -> dict:
    """21. The bench workload (ViT-B-32 bf16, batch 256) under
    zip_towers='on': 3 warmup and 10 timed steps, exactly 12 pair forward
    and 12 pair backward launches per step and no single-tower attention
    launch, finite losses and gradient norms; median step beside phase 8's."""
    import torch

    from spatial_clip_tpu_torch.bench import make_trainer, synthetic_batch

    torch.cuda.empty_cache()
    trainer = make_trainer("ViT-B-32", device="cuda", zip_towers="on")
    batch = synthetic_batch(trainer.model, TRAIN_BATCH)
    steps = WARMUP_STEPS + TIMED_STEPS
    counts, step_ms, history, peak = timed_steps("train-zip", trainer, batch, steps,
                                                 zip_counters())
    want = tuple(n * steps for n in (LAYERS, LAYERS, 0, 0, 0, 0, 0))
    if counts != want:
        raise AssertionError(f"[train-zip] launches (pair fwd, pair bwd, attention fwd, fwd_lse, "
                             f"bwd, recompute-with-db bwd, recompute bwd) {counts}, want {want}")
    med = statistics.median(step_ms[WARMUP_STEPS:])
    print(f"[train-zip zip_towers=on] ViT-B-32 bf16 batch {TRAIN_BATCH}: {steps} steps, launches "
          f"per step (pair fwd, pair bwd, single-tower attention x5) "
          f"{tuple(c // steps for c in counts)}; losses finite {history[0][0]:.4f} -> "
          f"{history[-1][0]:.4f}, grad norms {history[0][1]:.4f} -> {history[-1][1]:.4f}; median "
          f"step {med:.3f} ms ({TRAIN_BATCH * 1e3 / med:.1f} pairs/s) vs phase 8's default "
          f"{default_step_ms:.3f} ms ({TRAIN_BATCH * 1e3 / default_step_ms:.1f} pairs/s); "
          f"max_memory_allocated {peak / 2 ** 30:.3f} GiB", flush=True)
    del trainer, batch
    return {"fwd_launches": counts[0], "bwd_launches": counts[1], "step_ms": med}


# phase 22's edges of the bf16 block half: lengths at the 16-row boxes, the
# one- and two-tile row splits and the longest; every width 128..1024 in
# steps of 128 at each head dim; batches of 1, 3 and past a cluster (257)
BLOCK_EDGE_LENGTHS = (1, 16, 17, 50, 63, 64, 65, 77, 128)
BLOCK_EDGE_WIDTHS = tuple(range(128, 1025, 128))
BLOCK_EDGE_BATCHES = (1, 3, 257)


def block_check(fb, fused_attention, args, mask, H, label: str) -> tuple:
    """fused_block_attn (with its workspace) against reference_block_attn:
    bf16 one bf16 ulp at max|ref| (2^(floor(log2 max) - 7)), f32 2e-5
    max(1, |ref|), finite, the same bits on a rerun; in bf16 each head's
    context in the workspace bit for bit sc_attention_fwd on the kernel's
    q|k|v, and that q|k|v within one bf16 ulp of the plain version's.
    Returns (error, tolerance)."""
    import torch

    x = args[0]
    B, L, D = x.shape
    ws = (torch.empty((fb.workspace_numel(B, L, D),), dtype=x.dtype, device="cuda")
          if x.dtype == torch.bfloat16 else None)
    out = fb.fused_block_attn(*args, mask, H, workspace=ws)
    again = fb.fused_block_attn(*args, mask, H)
    ref = fb.reference_block_attn(*args, mask, H).float()
    torch.cuda.synchronize()
    peak = ref.abs().max().item()
    tol = (2e-5 * max(1.0, peak) if x.dtype == torch.float32
           else 2.0 ** (math.floor(math.log2(peak)) - 7))
    err = (out.float() - ref).abs().max().item()
    ok = err <= tol and torch.equal(out, again) and torch.isfinite(out).all().item()
    extra = ""
    if ws is not None:
        qkv, ctx = fb.split_workspace(ws, B, L, D)
        want_qkv = fb.reference_block_qkv(*args[:5]).float()
        qkv_tol = 2.0 ** (math.floor(math.log2(want_qkv.abs().max().item())) - 7)
        qkv_err = (qkv.float() - want_qkv).abs().max().item()
        same_ctx = torch.equal(ctx, fused_attention(qkv, mask, H))
        ok = ok and same_ctx and qkv_err <= qkv_tol
        extra = (f", q|k|v {qkv_err:.3g} (tol {qkv_tol:.3g}), each head's context "
                 f"sc_attention_fwd's bits: {same_ctx}")
    if not ok:
        raise AssertionError(f"[kernel-block] {label}: max abs err {err} (tol {tol}), the same "
                             f"bits on a rerun {torch.equal(out, again)}{extra}")
    return err, tol


def kernel_block_phase():
    """22. fused_block_attn against reference_block_attn (block_check) at the
    towers' shapes; timed (median_ms and on the card's clock) beside the
    plain version, the unfused half (bench_block's shipped arm: one-pass
    LayerNorm, cuBLAS, the attention kernel, cuBLAS, the residual) and that
    arm with SDPA in place of the kernel (the library yardstick), with the
    weight bytes each CTA lands and its plan; then the bf16 kernel at its
    tiles' edges (BLOCK_EDGE_*, causal and not); then bench_block for both
    towers, the kernel's main path, with its launches counted. Returns
    (rows, launches)."""

    import torch

    from spatial_clip_tpu_torch import bench_block
    from spatial_clip_tpu_torch.bench_gemm import block_bound_ms, block_inputs, device_ms
    from spatial_clip_tpu_torch.models.transformer import causal_mask
    from spatial_clip_tpu_torch.ops import fused_block as fb
    from spatial_clip_tpu_torch.ops.fused_attention import fused_attention

    gen = torch.Generator(device="cuda").manual_seed(22)
    rows = {}
    for name, B, L, D, H, causal, dtype in (
            ("image_256", TRAIN_BATCH, 50, 768, 12, False, torch.bfloat16),
            ("text_256", TRAIN_BATCH, 77, 512, 8, True, torch.bfloat16),
            ("image_64", 64, 50, 768, 12, False, torch.bfloat16),
            ("text_64", 64, 77, 512, 8, True, torch.bfloat16),
            ("f32", 8, 26, 256, 4, True, torch.float32)):
        x, p = block_inputs(B, L, D, gen, dtype)
        args = (x, p["lng"], p["lnb"], p["wqkv"], p["bqkv"], p["wout"], p["bout"])
        mask = causal_mask(L, device="cuda") if causal else None
        with torch.no_grad():
            err, tol = block_check(fb, fused_attention, args, mask, H, name)
            ws = (torch.empty((fb.workspace_numel(B, L, D),), dtype=dtype, device="cuda")
                  if dtype == torch.bfloat16 else None)
            row = dict(
                err=err,
                ms=median_ms(lambda: fb.fused_block_attn(*args, mask, H, workspace=ws)),
                plain_ms=median_ms(lambda: fb.reference_block_attn(*args, mask, H)),
                unfused_ms=median_ms(lambda: bench_block.shipped_layer(x, p, mask, H)),
                library_ms=median_ms(
                    lambda: bench_block.shipped_layer(x, p, mask, H, bench_block.sdpa_attention)),
                device_ms=device_ms(lambda: fb.fused_block_attn(*args, mask, H, workspace=ws)),
                unfused_device_ms=device_ms(lambda: bench_block.shipped_layer(x, p, mask, H)))
        item = x.element_size()
        row["bound_ms"] = block_bound_ms(B, L, D, item,
                                         BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS)
        flops = 2 * B * L * D * 4 * D + 4 * B * L * L * D
        n_bytes = (2 * B * L * D + 4 * D * D) * item + 4 * 6 * D
        row["bound_by"] = bound(n_bytes, flops, BF16_FLOPS if dtype == torch.bfloat16
                                else F32_FLOPS)[1]
        plan = ""
        if dtype == torch.bfloat16:
            row["plan"] = fb.kernel_plan(L, D, H)
            landed, from_l2 = fb.weight_bytes(row["plan"])
            row["weight_bytes_from_plan"] = dict(landed=landed, from_l2=from_l2, ctas=B)
            plan = (f"; plan {row['plan']}; from that plan (not measured): W landed "
                    f"{landed / 1e6:.3f} MB a CTA ({from_l2 / 1e6:.3f} MB of it from L2), "
                    f"{B * from_l2 / 1e9:.3f} GB from L2 a launch")
        rows[name] = row
        print(f"[kernel-block] fused_block_attn {name} x ({B}, {L}, {D}) {H} heads "
              f"{'causal' if causal else 'no mask'} {str(dtype)[6:]}: max abs err {err:.3g} (tol "
              f"{tol:.3g}), the same bits on a rerun; kernel {row['ms']:.4f} ms (card's clock "
              f"{row['device_ms']:.4f}) vs plain {row['plain_ms']:.4f}, unfused (LN, cuBLAS, "
              f"attention kernel) {row['unfused_ms']:.4f} (card's clock "
              f"{row['unfused_device_ms']:.4f}), unfused with SDPA {row['library_ms']:.4f}; bound "
              f"{row['bound_ms']:.4f} ({row['bound_by']}, share "
              f"{row['bound_ms'] / row['device_ms']:.3f} on the card's clock){plan}", flush=True)
    rows["edges"] = block_edges()
    fb.fused_block_attn.launches = 0
    for tower in ("image", "text"):
        r = bench_block.run_tower(tower, TRAIN_BATCH, rounds=2, reps=2)
        print(f"[kernel-block] bench_block --tower {tower} --batch {TRAIN_BATCH} --rounds 2 --reps "
              f"2: block vs shipped mean rel diff {r['rel_diff']:.3g} (< "
              f"{bench_block.MAX_REL_DIFF}); ms per layer block {r['block']['all']} shipped "
              f"{r['shipped']['all']}", flush=True)
    launches = fb.fused_block_attn.launches
    want = 2 * 3 * bench_block.LAYERS * 2  # towers x (parity run + 2 rounds) x layers x reps
    if launches != want:
        raise AssertionError(f"[kernel-block] bench_block launched the kernel {launches} times, "
                             f"want {want}")
    return rows, launches


def block_edges() -> dict:
    """22. The bf16 kernel at its tiles' edges: every BLOCK_EDGE_LENGTHS x
    BLOCK_EDGE_WIDTHS x head dim 32 / 64 / 128 x causal and not that
    supported() takes, the batch cycling through BLOCK_EDGE_BATCHES, each
    held to block_check. Returns the largest error relative to its
    tolerance."""
    import torch

    from spatial_clip_tpu_torch.bench_gemm import block_inputs
    from spatial_clip_tpu_torch.models.transformer import causal_mask
    from spatial_clip_tpu_torch.ops import fused_block as fb
    from spatial_clip_tpu_torch.ops.fused_attention import fused_attention

    gen = torch.Generator(device="cuda").manual_seed(2222)
    n, skipped, worst = 0, [], 0.0
    for L in BLOCK_EDGE_LENGTHS:
        for D in BLOCK_EDGE_WIDTHS:
            for hd in (32, 64, 128):
                H = D // hd
                if not fb.supported(L, D, H, torch.bfloat16):
                    skipped.append((L, D, hd))
                    continue
                for causal in (False, True):
                    B = BLOCK_EDGE_BATCHES[n % len(BLOCK_EDGE_BATCHES)]
                    x, p = block_inputs(B, L, D, gen)
                    args = (x, p["lng"], p["lnb"], p["wqkv"], p["bqkv"], p["wout"], p["bout"])
                    mask = causal_mask(L, device="cuda") if causal else None
                    with torch.no_grad():
                        err, tol = block_check(fb, fused_attention, args, mask, H,
                                               f"edge B={B} L={L} D={D} hd={hd} causal={causal}")
                    worst = max(worst, err / tol)
                    n += 1
    print(f"[kernel-block] bf16 edges: {n} cases (L {list(BLOCK_EDGE_LENGTHS)} x D "
          f"{BLOCK_EDGE_WIDTHS[0]}..{BLOCK_EDGE_WIDTHS[-1]} x hd 32/64/128 x causal and not, B "
          f"{list(BLOCK_EDGE_BATCHES)} in turn), each within one bf16 ulp at max|ref| (worst "
          f"{worst:.3g} of it), the same bits on a rerun, each head's context sc_attention_fwd's "
          f"bits; not taken (L, D, hd): {skipped}", flush=True)
    return dict(err=worst, cases=n)


LAYOUT_KERNELS = {  # phase 23's entries: the TPU kernel each replaces
    "fused_attention_inter": "spatial_clip_tpu/ops/fused_attention.py:671",
    "fused_attention_inter_bwd": "spatial_clip_tpu/ops/attention_variants.py:185",
    "fused_attention_slab": "spatial_clip_tpu/ops/attention_variants.py:131",
    "fused_attention_slab_bwd": "spatial_clip_tpu/ops/attention_variants.py:144",
    "fused_attention_t_fwd": "spatial_clip_tpu/ops/attention_variants.py:485",
    "fused_attention_t_bwd": "spatial_clip_tpu/ops/attention_variants.py:502",
    "fused_attention_split_fwd": "spatial_clip_tpu/ops/attention_variants.py:826",
    "fused_attention_split_bwd": "spatial_clip_tpu/ops/attention_variants.py:855",
}


def kernel_layouts_phase():
    """23. Each layout entry against its plain version (train_tol; dqkv
    bwd_tol) and bit for bit against the standard launch on the same data,
    the same bits on a rerun; timed beside that standard launch, its plain version and SDPA.
    The slab kernels' counters are set to 0 before the timed runs and read
    after them: those runs are their main path. Returns (rows by case and
    entry, slab launches)."""
    import torch

    from spatial_clip_tpu_torch.models.transformer import causal_mask
    from spatial_clip_tpu_torch.ops import attention_variants as av
    from spatial_clip_tpu_torch.ops import fused_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(23)
    rows = {}
    timed = {}
    for name, B, L, D, H, causal, dtype in (
            ("image", TRAIN_BATCH, 50, 768, 12, False, torch.bfloat16),
            ("text", TRAIN_BATCH, 77, 512, 8, True, torch.bfloat16),
            ("f32", 8, 77, 512, 8, True, torch.float32)):
        qkv = torch.randn((B, L, 3 * D), generator=gen, device="cuda").to(dtype)
        g = torch.randn((B, L, D), generator=gen, device="cuda").to(dtype)
        bias = (0.3 * torch.randn((3 * D,), generator=gen, device="cuda")).to(dtype)
        mask = causal_mask(L, device="cuda") if causal else None
        perm = torch.tensor(av.interleave_perm(H, D // H), device="cuda")
        qkv_i = qkv.index_select(-1, perm)
        qkv_t = qkv.transpose(0, 1)  # the no-bias GEMM output's view, as the model passes it
        with_b = qkv + bias
        q, k, v = (t.contiguous() for t in qkv.chunk(3, dim=-1))  # [q|k|v] is qkv
        # entry: (its call, its plain version, the standard launch it must equal, how the
        # entry's output maps onto that launch's)
        entries = {
            "fused_attention_inter": (
                lambda: av.fused_attention_inter(qkv_i, mask, H),
                lambda: av.reference_attention_inter(qkv_i, mask, H),
                lambda: fa.fused_attention(qkv, mask, H), lambda out: out),
            "fused_attention_inter_bwd": (
                lambda: av.fused_attention_inter_bwd(qkv_i, mask, g, H),
                lambda: av.reference_attention_inter_bwd(qkv_i, mask, g, H),
                lambda: fa.fused_attention_bwd_recompute(qkv, mask, g, H),
                lambda out: out.index_select(-1, torch.argsort(perm))),
            "fused_attention_slab": (
                lambda: av.fused_attention_slab(qkv, mask, H),
                lambda: fa.reference_attention(qkv, mask, H),
                lambda: fa.fused_attention(qkv, mask, H), lambda out: out),
            "fused_attention_slab_bwd": (
                lambda: av.fused_attention_slab_bwd(qkv, mask, g, H),
                lambda: fa.reference_attention_bwd(qkv, mask, None, g, H)[0],
                lambda: fa.fused_attention_bwd_recompute(qkv, mask, g, H), lambda out: out),
            "fused_attention_t_fwd": (
                lambda: av.fused_attention_t_fwd(qkv_t, bias, mask, H),
                lambda: av.reference_attention_t(qkv_t, bias, mask, H),
                lambda: fa.fused_attention(with_b, mask, H), lambda out: out),
            "fused_attention_t_bwd": (
                lambda: av.fused_attention_t_bwd(qkv_t, bias, mask, g, H),
                lambda: av.reference_attention_t_bwd(qkv_t, bias, mask, g, H),
                lambda: fa.fused_attention_bwd_recompute_db(with_b, mask, g, H), lambda out: out),
            "fused_attention_split_fwd": (
                lambda: av.fused_attention_split_fwd(q, k, v, mask, H),
                lambda: av.reference_attention_split(q, k, v, mask, H),
                lambda: fa.fused_attention(qkv, mask, H), lambda out: out),
            "fused_attention_split_bwd": (
                lambda: av.fused_attention_split_bwd(q, k, v, mask, g, H),
                lambda: av.reference_attention_split_bwd(q, k, v, mask, g, H),
                lambda: fa.fused_attention_bwd_recompute(qkv, mask, g, H),
                lambda out: torch.cat(out, dim=-1)),
        }
        library = sdpa_ms(qkv, mask, H)
        case = {}
        for entry, (run, plain, standard, as_standard) in entries.items():
            got, again, want, std = run(), run(), plain(), standard()
            torch.cuda.synchronize()
            got_t = got if isinstance(got, tuple) else (got,)
            want_t = want if isinstance(want, tuple) else (want,)
            # each output at phase 6's tolerance (dqkv bwd_tol, t_bwd's f32 db
            # train_tol + 1e-4), the contexts at train_tol
            errs = [((a.float() - b.float()).abs().max().item(),
                     train_tol(dtype, b.float()) + 1e-4 if b.dim() == 1
                     else bwd_tol(dtype, b.float()) if entry.endswith("_bwd")
                     else train_tol(dtype, b.float()))
                    for a, b in zip(got_t, want_t)]
            err, tol = max(errs)  # the largest error, beside its output's tolerance
            within = all(e <= t for e, t in errs)
            same_rerun = all(torch.equal(a, b) for a, b in
                             zip(got_t, again if isinstance(again, tuple) else (again,)))
            mapped = as_standard(got)
            if entry == "fused_attention_t_bwd":  # dqkv bit for bit, db within f32 tolerance
                db_tol = train_tol(torch.float32, std[1]) + 1e-4
                equal = (torch.equal(mapped[0], std[0])
                         and (mapped[1] - std[1]).abs().max().item() <= db_tol)
            else:
                equal = torch.equal(mapped, std)
            finite = all(torch.isfinite(a).all().item() for a in got_t)
            if not (within and same_rerun and equal and finite):
                raise AssertionError(
                    f"[kernel-layouts] {entry} {name}: max abs err, tol {errs}, the same "
                    f"bits on a rerun {same_rerun}, equal to the standard launch {equal}, finite "
                    f"{finite}")
            bwd = entry.endswith("_bwd")
            item, three_d = qkv.element_size(), 3 * D
            n_bytes = B * L * ((2 * three_d + D) if bwd else (three_d + D)) * item
            if entry.startswith("fused_attention_t"):
                n_bytes += three_d * item + (4 * three_d if bwd else 0)  # the bias, db
            dots = 2 * B * H * L * L * (D // H)
            bound_ms, bound_by = bound(n_bytes, (5 if bwd else 2) * dots,
                                       BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS)
            case[entry] = dict(err=err, tol=tol, bound_ms=bound_ms, bound_by=bound_by,
                               library_ms=library["bwd" if bwd else "fwd"],
                               plain_ms=median_ms(plain), standard_ms=median_ms(standard))
            timed[entry] = run
        slab = (av.fused_attention_slab, av.fused_attention_slab_bwd)
        for c in slab:
            c.launches = 0
        for entry, run in timed.items():
            case[entry]["ms"] = median_ms(run)
        for c, entry in zip(slab, ("fused_attention_slab", "fused_attention_slab_bwd")):
            case[entry]["timed_launches"] = c.launches
        rows[name] = case
        print(f"[kernel-layouts] {name} qkv {tuple(qkv.shape)} {str(dtype)[6:]} "
              f"mask={'causal' if causal else 'none'}: every entry equal to its standard launch "
              f"(t_bwd db within f32 tolerance), the same bits on a rerun; " + "; ".join(
                  f"{e[len('fused_attention_'):]} err {r['err']:.3g} (tol {r['tol']:.3g}) "
                  f"{r['ms']:.4f} ms vs standard {r['standard_ms']:.4f}, plain "
                  f"{r['plain_ms']:.4f}, SDPA {r['library_ms']:.4f}, bound {r['bound_ms']:.4f} "
                  f"({r['bound_by']})" for e, r in case.items()), flush=True)
    slab_launches = {e: sum(r[e]["timed_launches"] for r in rows.values())
                     for e in ("fused_attention_slab", "fused_attention_slab_bwd")}
    return rows, slab_launches


LAYOUT_SETTINGS = {  # phases 24-25: label -> (create_model overrides, its kernels)
    "pallas_inter": (dict(attn_impl="pallas_inter"),
                     ("fused_attention_inter", "fused_attention_inter_bwd")),
    "pallas_inter+ln_gemm": (dict(attn_impl="pallas_inter", ln_gemm_impl="pallas"),
                             ("fused_attention_inter", "fused_attention_inter_bwd")),
    "pallas_t": (dict(attn_impl="pallas_t"), ("fused_attention_t_fwd", "fused_attention_t_bwd")),
    "pallas_split": (dict(attn_impl="pallas_split"),
                     ("fused_attention_split_fwd", "fused_attention_split_bwd")),
}


def layout_counters():
    """The six model-path layout wrappers, then the standard attention
    wrappers and the pair wrappers: name -> wrapper."""
    from spatial_clip_tpu_torch.ops import attention_pair as ap
    from spatial_clip_tpu_torch.ops import attention_variants as av

    names = [n for n in LAYOUT_KERNELS if "slab" not in n]
    out = {n: getattr(av, n) for n in names}
    for c in (*attention_counters(), ap.fused_attention_pair, ap.fused_attention_pair_bwd):
        out[c.__name__] = c
    return out


def layouts_check_phase() -> None:
    """24. Under each layout setting: phase 7's card-vs-CPU step at batch 32
    (24 forward and 24 backward launches of the setting's own kernels, none
    of any other attention kernel), and CLIP.forward on 64 tiles and 64
    texts in bf16 against the f32 CPU plain path, per-row cosine >=
    MIN_COSINE, 24 forward launches."""
    import torch

    from spatial_clip_tpu_torch import create_model
    from spatial_clip_tpu_torch.models.transforms import normalize_batch

    tiles = np.random.default_rng(24).integers(0, 256, (64, 224, 224, 3), dtype=np.uint8)
    ids = torch.from_numpy(get_tokenizer_ids(
        [f"spot {i}: EPCAM KRT{i % 20} beside stroma" for i in range(64)]))
    counters = layout_counters()
    for label, (settings, own) in LAYOUT_SETTINGS.items():
        torch.cuda.empty_cache()
        for c in counters.values():
            c.launches = 0
        train_check_phase(f"layouts-check {label}", **settings)
        step = {n: c.launches for n, c in counters.items() if c.launches}
        t0 = time.perf_counter()
        card = create_model("ViT-B-32", precision="bf16", seed=0, device="cuda", **settings)
        cpu = create_model("ViT-B-32", precision="fp32", seed=0, device="cpu", **settings)
        for c in counters.values():
            c.launches = 0
        with torch.inference_mode():
            got = card(normalize_batch(torch.from_numpy(tiles).cuda(), dtype=torch.bfloat16),
                       ids.cuda())
            got = {k: got[k].float().cpu() for k in ("image_features", "text_features")}
            encode = {n: c.launches for n, c in counters.items() if c.launches}
            ref = cpu(normalize_batch(torch.from_numpy(tiles)), ids)
        cos = {k: (got[k] * ref[k]).sum(-1).min().item() for k in got}
        finite = all(torch.isfinite(v).all().item() for v in got.values())
        want_step = {own[0]: 2 * LAYERS, own[1]: 2 * LAYERS}
        if (step != want_step or encode != {own[0]: 2 * LAYERS} or min(cos.values()) < MIN_COSINE
                or not finite):
            raise AssertionError(f"[layouts-check {label}] step launches {step} (want "
                                 f"{want_step}), encode launches {encode}, min cosine {cos}, "
                                 f"finite {finite}")
        print(f"[layouts-check {label}] step launches {step}, nothing else; CLIP.forward(64 "
              f"tiles, 64 texts) bf16 card vs f32 CPU plain path: min cosine image "
              f"{cos['image_features']:.5f} text {cos['text_features']:.5f} (>= {MIN_COSINE}), "
              f"launches {encode}; {time.perf_counter() - t0:.1f} s", flush=True)
        del card, cpu


def train_layouts_phase(default_step_ms: float) -> dict:
    """25. The bench workload (ViT-B-32 bf16, batch 256) under each of the
    three layout settings: 3 warmup and 10 timed steps, exactly 24 forward
    and 24 backward launches of the setting's own kernels per step and none
    of any other attention kernel, finite losses and gradient norms; median
    step beside phase 8's. Returns label -> {kernel name: launches}."""
    import torch

    from spatial_clip_tpu_torch.bench import make_trainer, synthetic_batch

    counters = layout_counters()
    steps = WARMUP_STEPS + TIMED_STEPS
    out = {}
    for label in ("pallas_inter", "pallas_t", "pallas_split"):
        settings, own = LAYOUT_SETTINGS[label]
        torch.cuda.empty_cache()
        trainer = make_trainer("ViT-B-32", device="cuda", **settings)
        batch = synthetic_batch(trainer.model, TRAIN_BATCH)
        counts, step_ms, history, peak = timed_steps(f"train-layouts {label}", trainer, batch,
                                                     steps, tuple(counters.values()))
        got = {n: c for n, c in zip(counters, counts) if c}
        want = {own[0]: 2 * LAYERS * steps, own[1]: 2 * LAYERS * steps}
        if got != want:
            raise AssertionError(f"[train-layouts {label}] launches {got}, want {want}")
        med = statistics.median(step_ms[WARMUP_STEPS:])
        out[label] = got
        print(f"[train-layouts {label}] ViT-B-32 bf16 batch {TRAIN_BATCH}: {steps} steps, "
              f"launches per step {({n: c // steps for n, c in got.items()})}, no other "
              f"attention kernel; losses finite {history[0][0]:.4f} -> {history[-1][0]:.4f}, "
              f"grad norms {history[0][1]:.4f} -> {history[-1][1]:.4f}; median step "
              f"{med:.3f} ms ({TRAIN_BATCH * 1e3 / med:.1f} pairs/s) vs phase 8's default "
              f"{default_step_ms:.3f} ms ({TRAIN_BATCH * 1e3 / default_step_ms:.1f} pairs/s); "
              f"max_memory_allocated {peak / 2 ** 30:.3f} GiB", flush=True)
        del trainer, batch
    return out


def kernel_dx_phase() -> dict:
    """26. The dx backward against its plain version (dqkv and db at phase
    6's tolerances; dx at one bf16 step (ulp) at its largest magnitude, as
    phase 22: both round dx once from f32 sums in other orders; f32 at 1e-4
    x max(1, |ref|), the CPU tests' dx tolerance: it sums 3D products in
    another order, from dqkv entries that differ by their own summation
    order), dqkv bit for bit and db within f32 tolerance of the
    recompute-with-db launch on the same data, dx and db the same bits on a
    rerun; timed beside its plain version, the unfused route, the library
    route (SDPA's backward and the cuBLAS dx GEMM) and SDPA's backward."""

    import torch

    from spatial_clip_tpu_torch.models.transformer import causal_mask
    from spatial_clip_tpu_torch.ops import attention_variants as av
    from spatial_clip_tpu_torch.ops import fused_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(26)
    rows = {}
    for name, B, L, D, H, causal, dtype, din in (
            ("image", TRAIN_BATCH, 50, 768, 12, False, torch.bfloat16, 768),
            ("text", TRAIN_BATCH, 77, 512, 8, True, torch.bfloat16, 512),
            ("f32", 3, 17, 256, 4, False, torch.float32, 128)):
        qkv = torch.randn((B, L, 3 * D), generator=gen, device="cuda").to(dtype)
        g = torch.randn((B, L, D), generator=gen, device="cuda").to(dtype)
        w = (torch.randn((3 * D, din), generator=gen, device="cuda") * din ** -0.5).to(dtype)
        mask = causal_mask(L, device="cuda") if causal else None
        got = av.fused_attention_bwd_dx(qkv, mask, g, w, H)
        again = av.fused_attention_bwd_dx(qkv, mask, g, w, H)
        want = av.reference_attention_bwd_dx(qkv, mask, g, w, H)
        std_dqkv, std_db = fa.fused_attention_bwd_recompute_db(qkv, mask, g, H)
        torch.cuda.synchronize()
        dx_ref = want[1].float()
        peak = dx_ref.abs().max().item()
        dx_tol = 1e-4 * max(1.0, peak) if dtype == torch.float32 else bwd_tol(dtype, dx_ref)
        checks = {  # output: (error, tolerance)
            "dqkv": ((got[0].float() - want[0].float()).abs().max().item(),
                     bwd_tol(dtype, want[0].float())),
            "dx": ((got[1].float() - dx_ref).abs().max().item(), dx_tol),
            "db": ((got[2] - want[2]).abs().max().item(), train_tol(dtype, want[2]) + 1e-4),
        }
        db_std_err = (got[2] - std_db).abs().max().item()
        db_std_tol = train_tol(torch.float32, std_db) + 1e-4
        same_rerun = all(torch.equal(a, b) for a, b in zip(got, again))
        dqkv_equal = torch.equal(got[0], std_dqkv)
        finite = all(torch.isfinite(t).all().item() for t in got)
        if not (all(e <= t for e, t in checks.values()) and db_std_err <= db_std_tol
                and same_rerun and dqkv_equal and finite):
            raise AssertionError(
                f"[kernel-dx] {name}: max abs err, tol {checks}; db vs the recompute-with-db "
                f"launch's {db_std_err} (tol {db_std_tol}); the same bits on a rerun "
                f"{same_rerun}; dqkv equal to the recompute-with-db launch's {dqkv_equal}; "
                f"finite {finite}")
        library = sdpa_ms(qkv, mask, H)
        gemm_ms = median_ms(lambda: torch.matmul(std_dqkv, w))
        bound_ms, bound_by = attention_bound(qkv, H, "bwd_dx", din)
        row = dict(
            err=max(e for e, _ in checks.values()),
            ms=median_ms(lambda: av.fused_attention_bwd_dx(qkv, mask, g, w, H)),
            plain_ms=median_ms(lambda: av.reference_attention_bwd_dx(qkv, mask, g, w, H)),
            unfused_ms=median_ms(
                lambda: torch.matmul(fa.fused_attention_bwd_recompute_db(qkv, mask, g, H)[0], w)),
            library_ms=library["bwd"] + gemm_ms, sdpa_bwd_ms=library["bwd"], gemm_ms=gemm_ms,
            bound_ms=bound_ms, bound_by=bound_by)
        rows[name] = row
        print(f"[kernel-dx] {name} qkv {tuple(qkv.shape)} W {tuple(w.shape)} {str(dtype)[6:]} "
              f"mask={'causal' if causal else 'none'}: max abs err (tol) " + ", ".join(
                  f"{k} {e:.3g} ({t:.3g})" for k, (e, t) in checks.items())
              + f"; dqkv bit for bit the recompute-with-db launch's, db within {db_std_err:.3g} "
              f"of its db (tol {db_std_tol:.3g}; equal {torch.equal(got[2], std_db)}), dx and db "
              f"the same bits on a rerun; kernel {row['ms']:.4f} ms vs plain "
              f"{row['plain_ms']:.4f} ms, unfused route (recompute-with-db kernel + matmul) "
              f"{row['unfused_ms']:.4f} ms, library route (SDPA backward "
              f"{row['sdpa_bwd_ms']:.4f} + cuBLAS dx GEMM {gemm_ms:.4f}) "
              f"{row['library_ms']:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}, share "
              f"{bound_ms / row['ms']:.3f})" + (
                  "" if dtype == torch.float32 else
                  f"; plan {av.dx_kernel_plan(L, H, D // H, din)}"), flush=True)
    rows["edges"] = dx_edges()
    return rows


# phase 26's edges of the bf16 product's row tiles (64), row groups (128),
# column passes (128 / 256), 64-deep K stages and cluster (2 sequences)
DX_EDGE_BATCHES = (1, 2, 3, 5, 257)
DX_EDGE_DINS = (16, 48, 80, 112, 144, 512, 768, 1024)


def dx_edges() -> dict:
    """Phase 26's sweep of the dx kernel's edges in bf16: every L of
    EDGE_LENGTHS at hd 32 / 64 / 128 (as far as the backward's shared
    memory takes it), causal and not, with B, Din and 1-3 heads cycling
    through DX_EDGE_BATCHES, DX_EDGE_DINS: dx within one bf16 ulp at
    max|ref| of the plain version, dqkv bit for bit the recompute-with-db
    launch's, db within f32 tolerance of its db and of the plain version's,
    dqkv, dx and db the same bits on a rerun, all finite."""
    import torch

    from spatial_clip_tpu_torch.models.transformer import causal_mask
    from spatial_clip_tpu_torch.ops import attention_variants as av
    from spatial_clip_tpu_torch.ops import fused_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(260)
    worst, cases, plans = {"dx": 0.0, "db": 0.0}, 0, set()
    worst_err = 0.0
    for hd in (32, 64, 128):
        for L in EDGE_LENGTHS:
            for causal in (False, True):
                B = DX_EDGE_BATCHES[cases % len(DX_EDGE_BATCHES)]
                din = DX_EDGE_DINS[cases % len(DX_EDGE_DINS)]
                H = 1 + cases % 3
                if not av.dx_supported(H, H * hd, L, din, torch.bfloat16):
                    continue
                cases += 1
                D = H * hd
                qkv = torch.randn((B, L, 3 * D), generator=gen, device="cuda").bfloat16()
                g = torch.randn((B, L, D), generator=gen, device="cuda").bfloat16()
                w = (torch.randn((3 * D, din), generator=gen, device="cuda")
                     * din ** -0.5).bfloat16()
                mask = causal_mask(L, device="cuda") if causal else None
                got = av.fused_attention_bwd_dx(qkv, mask, g, w, H)
                again = av.fused_attention_bwd_dx(qkv, mask, g, w, H)
                want = av.reference_attention_bwd_dx(qkv, mask, g, w, H)
                std_dqkv, std_db = fa.fused_attention_bwd_recompute_db(qkv, mask, g, H)
                torch.cuda.synchronize()
                dx_err = (got[1].float() - want[1].float()).abs().max().item()
                dx_tol = bwd_tol(torch.bfloat16, want[1].float())
                db_err = max((got[2] - std_db).abs().max().item() /
                             (train_tol(torch.float32, std_db) + 1e-4),
                             (got[2] - want[2]).abs().max().item() /
                             (train_tol(torch.bfloat16, want[2]) + 1e-4))
                ok = (dx_err <= dx_tol and db_err <= 1.0 and torch.equal(got[0], std_dqkv)
                      and all(torch.equal(a, b) for a, b in zip(got, again))
                      and all(torch.isfinite(t.float()).all().item() for t in got))
                if not ok:
                    raise AssertionError(
                        f"[kernel-dx] edge B={B} L={L} hd={hd} heads={H} Din={din} "
                        f"causal={causal}: dx err {dx_err} (tol {dx_tol}), db err / tol "
                        f"{db_err}, dqkv equal to the recompute-with-db launch's "
                        f"{torch.equal(got[0], std_dqkv)}, the same bits on a rerun "
                        f"{all(torch.equal(a, b) for a, b in zip(got, again))}")
                worst["dx"] = max(worst["dx"], dx_err / dx_tol if dx_tol else 0.0)
                worst["db"] = max(worst["db"], db_err)
                worst_err = max(worst_err, dx_err)
                p = av.dx_kernel_plan(L, H, hd, din)
                plans.add((p["mt"], p["groups"], p["stages"]))
    print(f"[kernel-dx] edges: bf16 L {list(EDGE_LENGTHS)} x hd (32, 64, 128) x causal and not "
          f"({cases} cases the backward takes), B {list(DX_EDGE_BATCHES)}, Din "
          f"{list(DX_EDGE_DINS)}, 1-3 heads: dx within one bf16 ulp at max|ref| (worst err / "
          f"tol {worst['dx']:.3f}), db within f32 tolerance (worst {worst['db']:.3f}), dqkv bit "
          f"for bit the recompute-with-db launch's, the same bits on a rerun; plans (m64 tiles, "
          f"row groups, stages) {sorted(plans)}", flush=True)
    return {"err": worst_err}


def dxdb_phase(default_step_ms: float) -> dict:
    """27. Under BWD_FUSE='dxdb' (restored after): phase 7's card-vs-CPU step
    at batch 32 and phase 8's bench workload (3 warmup and 10 timed steps),
    each with exactly 24 forward-lse and 24 dx launches per step and no
    other attention kernel; finite losses and gradient norms, median step
    beside phase 8's. Returns the dx launches of the bench workload."""
    import torch

    from spatial_clip_tpu_torch.bench import make_trainer, synthetic_batch
    from spatial_clip_tpu_torch.ops import attention_variants as av
    from spatial_clip_tpu_torch.ops import fused_attention as fa

    counters = (*attention_counters(), av.fused_attention_bwd_dx)
    per_step = (0, 2 * LAYERS, 0, 0, 0, 2 * LAYERS)
    names = "(attention fwd, fwd_lse, bwd, recompute-with-db bwd, recompute bwd, dx bwd)"
    previous, fa.BWD_FUSE = fa.BWD_FUSE, "dxdb"
    try:
        torch.cuda.empty_cache()
        for c in counters:
            c.launches = 0
        train_check_phase("dxdb-check")
        counts = tuple(c.launches for c in counters)
        if counts != per_step:
            raise AssertionError(f"[dxdb-check] launches {names} {counts}, want {per_step}")
        torch.cuda.empty_cache()
        trainer = make_trainer("ViT-B-32", device="cuda")
        batch = synthetic_batch(trainer.model, TRAIN_BATCH)
        steps = WARMUP_STEPS + TIMED_STEPS
        counts, step_ms, history, peak = timed_steps("train-dxdb", trainer, batch, steps,
                                                     counters)
    finally:
        fa.BWD_FUSE = previous
    want = tuple(n * steps for n in per_step)
    if counts != want:
        raise AssertionError(f"[train-dxdb] launches {names} {counts}, want {want}")
    med = statistics.median(step_ms[WARMUP_STEPS:])
    print(f"[train-dxdb BWD_FUSE=dxdb] ViT-B-32 bf16 batch {TRAIN_BATCH}: {steps} steps, launches "
          f"per step {names} {tuple(c // steps for c in counts)}; losses finite "
          f"{history[0][0]:.4f} -> {history[-1][0]:.4f}, grad norms {history[0][1]:.4f} -> "
          f"{history[-1][1]:.4f}; median step {med:.3f} ms ({TRAIN_BATCH * 1e3 / med:.1f} "
          f"pairs/s) vs phase 8's default {default_step_ms:.3f} ms "
          f"({TRAIN_BATCH * 1e3 / default_step_ms:.1f} pairs/s); max_memory_allocated "
          f"{peak / 2 ** 30:.3f} GiB", flush=True)
    del trainer, batch
    return {"launches": counts[-1], "step_ms": med}


def every_counter() -> dict:
    """Every kernel wrapper of the package that counts its launches: name ->
    wrapper."""
    import importlib

    out = {}
    for name in ("fused_attention", "attention_variants", "attention_pair", "fused_block",
                 "fused_contrastive", "fused_ln", "fused_ln_dense", "fused_mlp"):
        module = importlib.import_module(f"spatial_clip_tpu_torch.ops.{name}")
        for attr, fn in vars(module).items():
            if (callable(fn) and isinstance(getattr(fn, "launches", None), int)
                    and fn.__module__ == module.__name__):  # each wrapper once, where defined
                out[f"{name}.{attr}"] = fn
    return out


def read_launches(counters: dict) -> dict:
    return {k: c.launches for k, c in counters.items() if c.launches}


ENTRY_STEPS, ENTRY_BATCH = 4, 64  # configs/data/synthetic.yaml: batch 64, 512 + 128 samples


def entry_phase(extra=()) -> dict:
    """28. The training and evaluation entry points over the repository's
    configs, on ViT-B-32 (configs/model/spatial_clip.yaml) with
    data=synthetic, in a temporary root under build/ deleted after;
    ``extra`` overrides go to every run. Returns the entry run's launches
    by package kernel name."""
    import itertools

    import torch

    from spatial_clip_tpu_torch import eval as port_eval
    from spatial_clip_tpu_torch.profile_serving import profile_encode
    from spatial_clip_tpu_torch.train import entry
    from spatial_clip_tpu_torch.train.checkpoints import CheckpointManager

    counters = every_counter()
    build = Path(__file__).resolve().parent / "build"  # ignored by git, like the kernels' build
    build.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="entry_", dir=build))
    try:
        overrides = ["data=synthetic", "save_ckpt=true", f"trainer.max_steps={ENTRY_STEPS}",
                     "trainer.epochs=1", "trainer.save_every_steps=2", "trainer.keep_ckpts=2",
                     "trainer.log_every=1", "test=true", *extra]
        cfg = entry.compose_train([*overrides, f"paths.root_dir={root / 'run'}"])
        torch.cuda.empty_cache()
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        value, objects = entry.train(cfg)
        run_s = time.perf_counter() - t0
        launches = read_launches(counters)
        val_batches = 2 * (128 // ENTRY_BATCH)  # the val split, then the same split as test
        want = {"fused_attention.fused_attention_lse": 2 * LAYERS * ENTRY_STEPS,
                "fused_attention.fused_attention_bwd": 2 * LAYERS * ENTRY_STEPS,
                "fused_attention.fused_attention": 2 * LAYERS * val_batches}
        if launches != want:
            raise AssertionError(f"[entry] train launches {launches}, want {want}")
        state, metrics = objects["state"], objects["metrics"]
        ckpt_dir = Path(cfg["paths"]["output_dir"]) / "checkpoints"
        steps = sorted(p.name for p in ckpt_dir.iterdir())
        finite = all(np.isfinite(v) for v in metrics.values() if isinstance(v, float))
        if not (state.step == ENTRY_STEPS and steps == ["step_2", "step_4"] and finite
                and np.isfinite(value) and metrics["test/num_samples"] == 128.0):
            raise AssertionError(f"[entry] step {state.step}, checkpoints {steps}, value "
                                 f"{value}, metrics {metrics}")
        model = objects["model"]
        print(f"[entry] python -m spatial_clip_tpu_torch.train {' '.join(overrides)}: "
              f"{model.model_name} {str(model.dtype)[6:]} batch {ENTRY_BATCH}, "
              f"{state.step} steps in {run_s:.1f} s (model build, loader, validation, test and "
              f"checkpoints included); launches {launches}; loss {metrics['loss']:.4f}, val/loss "
              f"{metrics['val/loss']:.4f}, test/R@1 {metrics['test/R@1']:.4f}; checkpoints "
              f"{steps}", flush=True)

        # resume=latest from step_2 in a new run: batches 2 and 3 of epoch 0
        resume_root = root / "resume"
        rcfg = entry.compose_train([*overrides, "resume=latest",
                                    f"paths.root_dir={resume_root}"])
        rdir = Path(rcfg["paths"]["output_dir"]) / "checkpoints"
        rdir.mkdir(parents=True)
        shutil.copytree(ckpt_dir / "step_2", rdir / "step_2")
        run = entry.build(rcfg)

        def rest_of_epoch():
            loader = run.datamodule.train_dataloader()
            loader.set_epoch(0)
            return itertools.islice(loader, 2, None)

        resumed, _ = run.fit(rest_of_epoch, steps_per_epoch=2)
        diffs = {k: (resumed.flat[k].float() - state.flat[k].float()).abs().max().item()
                 for k in ("params", "mu", "nu")}
        same = {k: torch.equal(resumed.flat[k], state.flat[k]) for k in diffs}
        if not ((resumed.step, resumed.count) == (state.step, state.count)
                and all(same.values())):
            raise AssertionError(f"[entry] resumed step {resumed.step} count {resumed.count}, "
                                 f"the same bits {same}, max abs differences {diffs}")
        del run, resumed
        print(f"[entry] resume=latest from step_2 in a new run, batches 2-3 of epoch 0: step "
              f"{state.step} state the same bits as the unbroken run: {same}", flush=True)

        # eval on the checkpoints: the newest (step_4, written at the epoch's end)
        torch.cuda.empty_cache()
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        got = port_eval.main(["data=synthetic", f"paths.root_dir={root / 'eval'}",
                              f"ckpt_path={ckpt_dir}", *extra])
        eval_s = time.perf_counter() - t0
        eval_launches = read_launches(counters)
        want_eval = {"fused_attention.fused_attention": LAYERS * 128 // ENTRY_BATCH * 2}
        test = {k: float(v) for k, v in metrics.items() if k.startswith("test/")}
        if eval_launches != want_eval or got != test:
            raise AssertionError(f"[entry] eval launches {eval_launches} (want {want_eval}), "
                                 f"metrics {got} vs the train run's {test}")
        print(f"[entry] python -m spatial_clip_tpu_torch.eval data=synthetic "
              f"ckpt_path=<run>/checkpoints: {len(got)} test metrics equal to the train run's "
              f"in-memory evaluation (test/loss {got['test/loss']:.6f}); launches "
              f"{eval_launches}; {eval_s:.1f} s", flush=True)

        # times: the step alone, the loader's wait, a checkpoint's write
        trainer, dm = objects["trainer"], objects["datamodule"]
        loader = dm.train_dataloader()
        loader.set_epoch(1)
        waits, batches = [], []
        t0 = time.perf_counter()
        for batch in itertools.islice(loader, ENTRY_STEPS):
            waits.append((time.perf_counter() - t0) * 1e3)
            batches.append(batch)
            t0 = time.perf_counter()
        dbatch = trainer._device_batch(batches[0])
        holder = {"state": state}

        def step():
            holder["state"], _ = trainer.train_step(holder["state"], dbatch)

        prof = profile_encode(step, reps=3)
        state = holder["state"]
        med, busy = prof["wall_ms"], prof["device_busy_ms"]
        wait = statistics.mean(waits)
        # fit's train window from its logged rates (log_every=1: one per step,
        # the loader's wait included)
        with open(Path(cfg["paths"]["output_dir"]) / "metrics.csv") as f:
            rates = [float(r["train/pairs_per_sec"]) for r in csv.DictReader(f)
                     if r.get("train/pairs_per_sec")]
        fit_s = sum(ENTRY_BATCH / r for r in rates)
        fit_pps = ENTRY_BATCH * len(rates) / fit_s
        fit_ms = fit_s * 1e3 / len(rates)
        mgr = CheckpointManager(root / "bench", keep=1)
        t0 = time.perf_counter()
        mgr.save(state, state.step)
        copy_s = time.perf_counter() - t0
        mgr.wait()
        write_s = time.perf_counter() - t0 - copy_s
        n_bytes = sum(p.stat().st_size for p in (root / "bench").rglob("*") if p.is_file())
        n_params = sum(p.numel() for p in state.params.values())
        print(f"[entry-timing] ViT-B-32 bf16 batch {ENTRY_BATCH}, data=synthetic "
              f"(num_workers 0): train step {med:.3f} ms median of 20 "
              f"({ENTRY_BATCH * 1e3 / med:.1f} pairs/s the step alone), device busy {busy:.3f} ms "
              f"a step (idle share of the step {prof['idle_share']:.3f}, "
              f"{prof['kernels_per_encode']:.0f} kernels; by family "
              f"{ {k: round(v, 3) for k, v in prof['device_ms_by_family'].items()} }); loader "
              f"wait {wait:.1f} ms a batch (mean of {len(waits)}: "
              f"{[round(w, 1) for w in waits]}); fit's train window {len(rates)} steps at "
              f"{fit_pps:.1f} pairs/s ({fit_ms:.1f} ms a step, the loader included; per step "
              f"{[round(r, 1) for r in rates]} pairs/s); device idle share of that window "
              f"derived from the profiled step's busy time, not traced: "
              f"{1 - busy / fit_ms:.3f}; checkpoint {n_bytes} B (a flat f32 buffer of "
              f"{state.flat['params'].numel()} elements for {n_params} parameters, + "
              f"{str(state.flat['mu'].dtype)[6:]} mu and nu): host copy "
              f"{copy_s:.3f} s, write {write_s:.3f} s ({n_bytes / max(write_s, 1e-9) / 1e9:.2f} "
              f"GB/s)", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"fused_attention_fwd": launches["fused_attention.fused_attention"],
            "fused_attention_fwd_lse": launches["fused_attention.fused_attention_lse"],
            "fused_attention_bwd": launches["fused_attention.fused_attention_bwd"]}


if __name__ == "__main__":
    sys.exit(main())
