#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, gene and CLI paths on one NVIDIA GPU and check them.

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
29. gene-check  path B, the Gene-MLP tower (ViT-B-32-GeneMLP: 5,000 genes
           -> 1024, 3 blocks, head 512): phase 7's card-vs-CPU step at batch
           32 under the default LayerNorm and under ln_impl='pallas', with
           exact launches (12 forward-lse and 12 saved-lse backward; under
           'pallas' also 27 fused_ln forwards and backwards: the image
           tower's 26 and the gene tower's ln_final)
30. gene-train  path B's step at batch 256 (phase 8's workload on
           ViT-B-32-GeneMLP): exactly 12 + 12 attention launches a step,
           median step ms beside phase 8's, one step's device busy time
31. gene-entry  paths A (data=synthetic with model.global_hvg_path: the
           gene-vocabulary text tower, 5,120 ids) and B (experiment=gene_mlp
           on the synthetic dataset, batch 256) through phase 28's entry
           runs, with a generated list of 5,000 genes: exact launches, the
           resume to the same bits, .eval's test/zero_shot_pcc within 1e-5
           of a numpy recomputation from the run's gene bank and test image
           features, the first 256 bank rows against the f32 CPU bank
           (per-row cosine), the bank's encode ms, the step and a
           checkpoint's bytes
32. gene-study  one short arm of each tower of the gene scaling study
           (gene, linear, text; 1,024 spots, batch 256), and the
           ImageNet-style zero-shot classifier (ViT-B-32, random weights,
           1,000 classes x the 80 OpenAI templates) with its first columns
           held to the f32 CPU classifier and its launches counted
33. long-kernels  the key-tiled attention kernels (csrc/attention_long.cu:
           forward with and without lse, dQ, dK/dV, db) against their plain
           versions at L 257, 401, 577, 1025 and the first length past each
           resident limit, hd 32 / 64 / 128, bf16 and f32, causal and not, in
           the three backward options, at phases 3 and 6's tolerances, dqkv
           and db the same bits on a rerun; ptxas's registers and spills; each
           kernel timed at ViT-L-14-336's image tower (batch 32, 16 heads of
           64, L 577) beside its plain version, its bound and SDPA
34. vitl-serve  ViT-L-14 (bf16, batch 64) through the server: 64 texts and 64
           raw tiles, exactly 36 resident forwards, every embedding vs f32 on
           the CPU by cosine, encode times
35. vitl14  ViT-L-14: phase 7's card-vs-CPU step at batch 4, then 13 steps at
           batch 64 with exactly 36 forward-lse and 36 saved-lse backward
           launches a step (all resident: L 257 and 77), step ms, peak memory
36. vitl14-336  ViT-L-14-336: the same at batch 2, then 13 steps at batch 32
           with exactly 24 key-tiled forwards with lse, dQ, dK/dV and db
           launches a step (L 577) and 12 + 12 resident ones (the text tower)
37. so400m  ViT-SO400M-14-SigLIP: one forward of 8 tiles and 8 id rows vs f32
           on the CPU; 27 resident forwards (image, L 257) and 27 calls of the
           plain route (text, 16 heads of 72: JAX's gate takes einsum)
38. smoke-synthetic  experiment=smoke_synthetic (ViT-Test, fp32, heads of 16)
           through .train and .eval on the card: no attention kernel launch,
           the plain route 2 x 2 a forward
39. main-train, embed  ``python -m spatial_clip_tpu_torch.cli.main_train``
           (ViT-B-32 bf16, 224 px synthetic, batch 64, spatial loss capped at
           50, 4 steps, the run mirrored with --remote-sync, protocol local):
           exact launches, results.json, step_4 and the mirror; then
           ``cli.embed`` on that checkpoint over 512 samples at batch 256
           (exact launches, the first 32 rows vs the f32 CPU model by cosine,
           pairs/s)
40. siglip  a ViT-B-32 JSON with SigLIP's initial scale and bias through
           ``main_train --siglip`` (4 steps, exact launches), then one step
           card vs CPU at batch 32
41. distill  ``main_train --distill-model ViT-L-14`` (student ViT-B-32,
           batch 64, 4 steps): the student's 24 + 24 training launches and the
           teacher's 36 inference forwards a step, exactly; one step card vs
           CPU at batch 4
42. lit, sgd-check, lion-check  ``main_train --lock-image-tower
           --lock-image-unlocked-groups 1`` for 3 steps: the frozen parameters
           the same bits as at init, resblocks_11 moved, a step's grad_norm
           the whole gradient's (the frozen range counts in the clipping);
           ``--opt sgd`` and ``--opt lion``: one step card vs CPU (loss,
           gradient, moment, update)
43. remat  ViT-L-14-336 at batch 32 with and without ``remat``: the same
           bits after 2 steps, exact launches (forward-lse doubled), step ms
           and peak memory; ViT-B-32 at batch 256 under remat
44. debug  ``.train experiment=smoke_synthetic debug=default`` (a NaN tile
           then raises FloatingPointError, and without the preset does not),
           ``debug=profiler`` on data=synthetic (the trace holds the attention
           kernels), ``cli.sweep --mode grid`` (2 trials, none failed)
Phases 3, 6, 19, 23 and 26 also time PyTorch's scaled_dot_product_attention
(efficient-attention backend) at the kernels' shapes as a yardstick (its
backward alone, on one retained graph), phase
12 PyTorch's LayerNorm and linear layers, phase 15 its linear and GELU,
phase 22 the unfused half with SDPA, and phase 26 the cuBLAS dx GEMM; the
port never calls them.
Then one JSON line with the kernels (each with its launches on the main
path, error, time, plain time, bound and library time; the key-tiled
kernels with their launches in phase 36's steps; the three kernels of
phase 28's path also with its launches there, and they and the fused_ln
kernels with their launches on the gene paths, phases 29-32; the
attention forward, forward-lse and backward and the key-tiled forward also
with their launches in phases 39-43), the nvidia-smi line, and
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

    from spatial_clip_tpu_torch.ops.fused_attention import bwd_max_seq

    entries = ptxas_entries(report)
    parts = []
    for hd in (32, 64, 128):
        options = []
        for label, flags in (("lse_db", "Lb0ELb1E"), ("re", "Lb1ELb0E"), ("re_db", "Lb1ELb1E")):
            found = [v for k, v in entries.items()
                     if f"15attn_bwd_kernelI13__nv_bfloat16Li{hd}E{flags}" in k]
            options.append(f"{label} {found[0][0]}/{found[0][1]} B" if found else f"{label} ?")
        longest = min(256, bwd_max_seq(hd, torch.bfloat16))  # the lengths it was held to
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
    gene_check = gene_check_phase()
    gene_train = gene_train_phase(train["step_ms"])
    gene_entry = gene_entry_phase()
    gene_study = gene_study_phase()
    long_rows = long_kernel_phase()
    vitl_serve_phase()
    long_train_phase("vitl14", "ViT-L-14", VITL_CHECK, VITL_BATCH,
                     {"fused_attention.fused_attention_lse": 36,
                      "fused_attention.fused_attention_bwd": 36})
    vitl336 = long_train_phase("vitl14-336", "ViT-L-14-336", VITL336_CHECK, VITL336_BATCH, {
        **{f"attention_long.{k}": 24 for k in ("fused_attention_long_lse", "long_bwd_dq",
                                                "long_bwd_dkdv", "long_db")},
        "fused_attention.fused_attention_lse": 12, "fused_attention.fused_attention_bwd": 12})
    so400m_phase()
    smoke_synthetic_phase()
    cli = main_train_phase()
    siglip = siglip_phase()
    distill = distill_phase()
    lit = lit_phase()
    remat = remat_phase()
    debug_phase()

    def gene_launches(key: str) -> dict:
        """A kernel's launches on the gene paths: phase 29's step (path B),
        phase 30's 13 steps, phase 31's entry runs and evals, by path."""
        out = {f"path B check {k}": n.get(key, 0) for k, n in gene_check.items()}
        out["path B 13 steps"] = dict(zip(
            ("fused_attention.fused_attention", "fused_attention.fused_attention_lse",
             "fused_attention.fused_attention_bwd"), gene_train["launches"])).get(key, 0)
        for path in ("A", "B"):
            for part in ("train", "eval"):
                out[f"path {path} entry {part}"] = gene_entry[path][f"{part}_launches"].get(key, 0)
        return out

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
        "gene_launches": {**gene_launches("fused_attention.fused_attention"),
                          "zero-shot classifier": gene_study["classifier_launches"]},
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
            "gene_launches": gene_launches(
                f"fused_attention.{name.replace('_fwd_lse', '_lse')}"),
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
        if family == "fused_ln":  # the gene tower's ln_final joins the image tower's 26
            kernels[-1]["gene_launches"] = gene_launches(f"fused_ln.{name}")
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
    Bt, Lt, Ht, hdt = LONG_TIMED
    for name, part, line, key in (
            ("fused_attention_long_fwd", "fwd", 350, "fused_attention_long_lse"),
            ("attention_long_bwd_dq", "dq", 436, "long_bwd_dq"),
            ("attention_long_bwd_dkdv", "dkdv", 436, "long_bwd_dkdv"),
            ("attention_long_db", "db", 436, "long_db")):
        row = long_rows[part]
        worst = long_rows["worst"]["fwd" if part == "fwd" else "db" if part == "db" else "dq"]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "spatial_clip_tpu_torch/csrc/attention_long.cu",
            "replaces": f"spatial_clip_tpu/ops/fused_attention.py:{line}",
            "launches": vitl336["launches"][f"attention_long.{key}"],
            "max_abs_err": max(worst, row["err"]),
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "at": f"qkv ({Bt}, {Lt}, {3 * Ht * hdt}) bf16, no mask (ViT-L-14-336's image tower, "
                  f"batch {Bt}); launches: phase 36's {VITL_STEPS} steps",
            **({"bwd_ms": row["bwd_ms"], "bwd_library_ms": row["bwd_library_ms"],
                "bwd_bound_ms": row["bwd_bound_ms"]} if part == "dq" else {}),
        })
    phase_launches = {  # phases 39-43: the CLI and option paths
        "39 main_train": cli["train_launches"], "39 embed": cli["embed_launches"],
        "40 siglip": siglip["launches"], "41 distill": distill["launches"],
        "42 lit": lit["launches"], "43 remat ViT-L-14-336": remat["vitl336"][True]["launches"],
        "43 remat ViT-B-32": remat["vitb32"]["launches"]}
    rows = {"fused_attention_fwd": FWD, "fused_attention_fwd_lse": LSE,
            "fused_attention_bwd": BWD,
            "fused_attention_long_fwd": "attention_long.fused_attention_long_lse"}
    for row in kernels:
        if row["name"] in rows:
            row["cli_launches"] = {k: n.get(rows[row["name"]], 0)
                                   for k, n in phase_launches.items()}
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
        bwd_max_seq,
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
        longest = min(256, bwd_max_seq(hd, torch.bfloat16))  # phase 33 holds longer ones
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


def train_check_phase(label: str = "train-check", batch_size: int = CHECK_BATCH,
                      model_name: str = "ViT-B-32", want_launches=None, **settings):
    """7 (and 13, 16, 18 under ``settings`` or another batch, 29 on another
    model). One train step's loss and gradients, card (bf16, kernels) vs
    CPU (f32, plain path), on the same weights, batch and augmentation
    draws; with ``want_launches`` (package kernel name -> count), the card
    step's launches of every counted wrapper must be exactly those. Returns
    the card's trainer."""
    import torch

    from spatial_clip_tpu_torch.bench import make_trainer, synthetic_batch
    from spatial_clip_tpu_torch.models.transforms import AugmentDraws

    t0 = time.perf_counter()
    card = make_trainer(model_name, device="cuda", **settings)
    cpu = make_trainer(model_name, device="cpu", precision="fp32", **settings)  # same weights
    card_state, cpu_state = card.init_state(), cpu.init_state()
    batch = synthetic_batch(cpu.model, batch_size, seed=1, device="cpu")
    rng = np.random.default_rng(2)
    draws = AugmentDraws(*(torch.from_numpy(d) for d in (
        rng.random(batch_size) < 0.5,
        (1.0 + rng.uniform(-0.2, 0.2, batch_size)).astype(np.float32),
        (1.0 + rng.uniform(-0.2, 0.2, batch_size)).astype(np.float32))))
    counters = every_counter() if want_launches is not None else {}
    for c in counters.values():
        c.launches = 0
    loss_card, _, grad_card = card.forward_backward(
        card_state, {k: v.cuda() for k, v in batch.items()},
        AugmentDraws(*(d.cuda() for d in draws)))
    launches = read_launches(counters)
    if want_launches is not None and launches != want_launches:
        raise AssertionError(f"[{label}] launches {launches}, want {want_launches}")
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
    print(f"[{label}] {model_name}{settings or ''} batch {batch_size}, one step, same "
          f"weights/batch/draws{'' if want_launches is None else f', launches {launches}'}: "
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
    for name in ("fused_attention", "attention_long", "attention_plain", "attention_variants",
                 "attention_pair", "fused_block", "fused_contrastive", "fused_ln", "fused_ln_dense",
                 "fused_mlp"):
        module = importlib.import_module(f"spatial_clip_tpu_torch.ops.{name}")
        for attr, fn in vars(module).items():
            if (callable(fn) and isinstance(getattr(fn, "launches", None), int)
                    and fn.__module__ == module.__name__):  # each wrapper once, where defined
                out[f"{name}.{attr}"] = fn
    return out


def read_launches(counters: dict) -> dict:
    return {k: c.launches for k, c in counters.items() if c.launches}


ENTRY_STEPS, ENTRY_BATCH = 4, 64  # configs/data/synthetic.yaml: batch 64, 512 + 128 samples


def entry_phase(label: str = "entry", base=("data=synthetic",), batch: int = ENTRY_BATCH,
                test_samples: int = 128, want_train=None, want_eval=None,
                gene_list=None) -> dict:
    """28 (and 31 on the gene paths). The training and evaluation entry
    points over the repository's configs with the ``base`` overrides
    (phase 28: ViT-B-32 of configs/model/spatial_clip.yaml with
    data=synthetic), in a temporary root under build/ deleted after. The
    train run's and the eval's launches must be ``want_train`` and
    ``want_eval`` (package kernel name -> count; by default phase 28's).
    With ``gene_list`` (an HVG file the base names), ``.eval`` must report
    test/zero_shot_pcc, equal within PCC_TOL to a numpy recomputation from
    the run's gene bank and test image features; the bank's first
    BANK_CHECK rows must hold to the f32 CPU bank by per-row cosine; the
    bank's encode is timed. Returns the launches and the measurements."""
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
    out = {}
    try:
        overrides = [*base, "save_ckpt=true", f"trainer.max_steps={ENTRY_STEPS}",
                     "trainer.epochs=1", "trainer.save_every_steps=2", "trainer.keep_ckpts=2",
                     "trainer.log_every=1", "test=true"]
        cfg = entry.compose_train([*overrides, f"paths.root_dir={root / 'run'}"])
        torch.cuda.empty_cache()
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        value, objects = entry.train(cfg)
        run_s = time.perf_counter() - t0
        launches = read_launches(counters)
        val_batches = 2 * (test_samples // batch)  # the val split, then the same split as test
        want = want_train or {
            "fused_attention.fused_attention_lse": 2 * LAYERS * ENTRY_STEPS,
            "fused_attention.fused_attention_bwd": 2 * LAYERS * ENTRY_STEPS,
            "fused_attention.fused_attention": 2 * LAYERS * val_batches}
        if launches != want:
            raise AssertionError(f"[{label}] train launches {launches}, want {want}")
        state, metrics = objects["state"], objects["metrics"]
        ckpt_dir = Path(cfg["paths"]["output_dir"]) / "checkpoints"
        steps = sorted(p.name for p in ckpt_dir.iterdir())
        finite = all(np.isfinite(v) for v in metrics.values() if isinstance(v, float))
        if not (state.step == ENTRY_STEPS and steps == ["step_2", "step_4"] and finite
                and np.isfinite(value) and metrics["test/num_samples"] == float(test_samples)):
            raise AssertionError(f"[{label}] step {state.step}, checkpoints {steps}, value "
                                 f"{value}, metrics {metrics}")
        model = objects["model"]
        print(f"[{label}] python -m spatial_clip_tpu_torch.train {' '.join(overrides)}: "
              f"{model.model_name} {str(model.dtype)[6:]} batch {batch}, "
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
            raise AssertionError(f"[{label}] resumed step {resumed.step} count {resumed.count}, "
                                 f"the same bits {same}, max abs differences {diffs}")
        del run, resumed
        print(f"[{label}] resume=latest from step_2 in a new run, batches 2-3 of epoch 0: step "
              f"{state.step} state the same bits as the unbroken run: {same}", flush=True)

        # eval on the checkpoints: the newest (step_4, written at the epoch's end)
        torch.cuda.empty_cache()
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        got = port_eval.main([*base, f"paths.root_dir={root / 'eval'}", f"ckpt_path={ckpt_dir}"])
        eval_s = time.perf_counter() - t0
        eval_launches = read_launches(counters)
        want_eval = want_eval or {
            "fused_attention.fused_attention": LAYERS * test_samples // batch * 2}
        test = {k: float(v) for k, v in metrics.items() if k.startswith("test/")}
        pcc = got.pop("test/zero_shot_pcc", None)
        if (eval_launches != want_eval or got != test
                or (pcc is None) != (gene_list is None)):
            raise AssertionError(f"[{label}] eval launches {eval_launches} (want {want_eval}), "
                                 f"metrics {got} vs the train run's {test}, zero_shot_pcc {pcc}")
        print(f"[{label}] python -m spatial_clip_tpu_torch.eval {' '.join(base)} "
              f"ckpt_path=<run>/checkpoints: {len(got)} test metrics equal to the train run's "
              f"in-memory evaluation (test/loss {got['test/loss']:.6f})"
              f"{'' if pcc is None else f', test/zero_shot_pcc {pcc!r}'}; launches "
              f"{eval_launches}; {eval_s:.1f} s", flush=True)
        out.update(train_launches=launches, eval_launches=eval_launches, pcc=pcc)
        if gene_list is not None:
            out.update(gene_bank_check(label, objects, gene_list, pcc))

        # times: the step alone, the loader's wait, a checkpoint's write
        trainer, dm = objects["trainer"], objects["datamodule"]
        loader = dm.train_dataloader()
        loader.set_epoch(1)
        waits, batches = [], []
        t0 = time.perf_counter()
        for b in itertools.islice(loader, ENTRY_STEPS):
            waits.append((time.perf_counter() - t0) * 1e3)
            batches.append(b)
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
        fit_s = sum(batch / r for r in rates)
        fit_pps = batch * len(rates) / fit_s
        fit_ms = fit_s * 1e3 / len(rates)
        mgr = CheckpointManager(root / "bench", keep=1)
        t0 = time.perf_counter()
        mgr.save(state, state.step)
        copy_s = time.perf_counter() - t0
        mgr.wait()
        write_s = time.perf_counter() - t0 - copy_s
        n_bytes = sum(p.stat().st_size for p in (root / "bench").rglob("*") if p.is_file())
        n_params = sum(p.numel() for p in state.params.values())
        print(f"[{label}-timing] {model.model_name} bf16 batch {batch}, {' '.join(base)} "
              f"(num_workers 0): train step {med:.3f} ms median of 20 "
              f"({batch * 1e3 / med:.1f} pairs/s the step alone), device busy {busy:.3f} ms "
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
        out.update(step_ms=med, busy_ms=busy, ckpt_bytes=n_bytes)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out.update({"fused_attention_fwd": launches.get("fused_attention.fused_attention", 0),
                "fused_attention_fwd_lse": launches.get("fused_attention.fused_attention_lse", 0),
                "fused_attention_bwd": launches.get("fused_attention.fused_attention_bwd", 0)})
    return out


PCC_TOL, BANK_CHECK = 1e-5, 256  # phase 31: numpy recomputation; bank rows held to the CPU


def numpy_pcc(features: np.ndarray, bank: np.ndarray, captions, genes) -> float:
    """The zero-shot gene-expression PCC recomputed in numpy (float64): each
    row's similarities to the bank against its caption's rank-weighted
    target (1 - 0.8 r / n, symbols matched exactly), Pearson per row (0
    where the centred norms' product is at most 1e-6), averaged."""
    index = {g: i for i, g in enumerate(genes)}
    target = np.zeros((len(captions), len(genes)))
    for i, caption in enumerate(captions):
        words = caption.split()
        for rank, word in enumerate(words):
            if word in index:
                target[i, index[word]] = 1.0 - 0.8 * rank / max(len(words), 1)
    logits = features.astype(np.float64) @ bank.astype(np.float64).T
    p = logits - logits.mean(axis=1, keepdims=True)
    t = target - target.mean(axis=1, keepdims=True)
    den = np.sqrt((p * p).sum(axis=1)) * np.sqrt((t * t).sum(axis=1))
    r = np.where(den > 1e-6, (p * t).sum(axis=1) / np.maximum(den, 1e-6), 0.0)
    return float(r.mean())


def gene_bank_check(label: str, objects: dict, gene_list, pcc: float) -> dict:
    """31. The gene bank of the entry run's final state (step_4, what
    ``.eval`` restored) and its test images' features on the card: the PCC
    recomputed in numpy within PCC_TOL of ``.eval``'s, the first BANK_CHECK
    rows by per-row cosine against the same weights' f32 bank on the CPU,
    and the bank's encode time (median of 3, host clock ending in a
    synchronize)."""
    import torch

    from spatial_clip_tpu_torch.models.clip import CLIP
    from spatial_clip_tpu_torch.models.transforms import normalize_batch
    from spatial_clip_tpu_torch.train.evaluate import encode_gene_bank, read_gene_list, run_model

    model, state = objects["model"], objects["state"]
    tokenizer = objects["datamodule"].tokenizer
    genes = read_gene_list(gene_list)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bank = encode_gene_bank(model, state.params, tokenizer, genes)
        times.append((time.perf_counter() - t0) * 1e3)
    feats, captions = [], []
    for b in objects["datamodule"].test_dataloader():
        images = torch.from_numpy(b["images"]).cuda()
        images = (normalize_batch(images, dtype=model.dtype) if images.dtype == torch.uint8
                  else images.to(model.dtype))
        feats.append(run_model(model, state.params, images=images)["image_features"]
                     .float().cpu().numpy())
        captions += b["raw_text"]
    again = numpy_pcc(np.concatenate(feats), bank, captions, genes)
    cpu = CLIP(model.cfg, dtype=torch.float32, device="cpu")
    cpu.load_state_dict({k: v.detach().float().cpu() for k, v in state.params.items()})
    want = encode_gene_bank(cpu, None, tokenizer, genes[:BANK_CHECK])
    cos = (bank[:BANK_CHECK] * want).sum(-1)
    if not (abs(again - pcc) <= PCC_TOL and cos.min() >= MIN_COSINE and np.isfinite(bank).all()
            and bank.shape == (len(genes), model.cfg.embed_dim)):
        raise AssertionError(f"[{label}] zero_shot_pcc {pcc} vs numpy {again} (tol {PCC_TOL}), "
                             f"bank {bank.shape} min cosine vs f32 CPU {cos.min()}")
    print(f"[{label}-pcc] gene bank {bank.shape} ({type(tokenizer).__name__}), encoded in "
          f"{statistics.median(times):.1f} ms (median of 3: {[round(t, 1) for t in times]}); "
          f"test/zero_shot_pcc {pcc!r} vs numpy recomputation from the bank and "
          f"{len(captions)} test image features {again!r} (|diff| {abs(again - pcc):.3g} <= "
          f"{PCC_TOL}); first {BANK_CHECK} bank rows vs f32 CPU: min cosine {cos.min():.6f} "
          f"(>= {MIN_COSINE})", flush=True)
    return {"bank_ms": statistics.median(times), "pcc_numpy": again, "bank_min_cos": cos.min()}


GENE_MODEL, NUM_GENES = "ViT-B-32-GeneMLP", 5000  # configs/experiment/gene_mlp.yaml


def gene_check_phase() -> dict:
    """29. Path B, the Gene-MLP tower: phase 7's card-vs-CPU step at batch
    32 on ViT-B-32-GeneMLP (5,000 genes, 50-gene vectors), under the
    default LayerNorm and under ln_impl='pallas', with exact launches: the
    image tower's 12 forward-lse and 12 saved-lse backward, and under
    'pallas' also 27 fused_ln forwards and backwards (the image tower's 26
    and the gene tower's ln_final; its block LayerNorms stay two-pass)."""
    attention = {"fused_attention.fused_attention_lse": LAYERS,
                 "fused_attention.fused_attention_bwd": LAYERS}
    ln = {"fused_ln.fused_ln_fwd": 2 * LAYERS + 3, "fused_ln.fused_ln_bwd": 2 * LAYERS + 3}
    out = {}
    for setting, want in (("default", attention), ("ln_impl=pallas", {**attention, **ln})):
        settings = {} if setting == "default" else {"ln_impl": "pallas"}
        train_check_phase(f"gene-check {setting}", model_name=GENE_MODEL, want_launches=want,
                          **settings)
        out[setting] = want
    return out


def gene_train_phase(default_step_ms: float) -> dict:
    """30. Path B's step at batch 256: phase 8's bench workload on
    ViT-B-32-GeneMLP (python -m spatial_clip_tpu_torch.bench --model
    ViT-B-32-GeneMLP): 3 warmup and 10 timed steps with exactly 12 + 12
    attention launches a step, then one step's device busy time
    (torch.profiler), beside phase 8's step."""
    import torch

    from spatial_clip_tpu_torch.bench import make_trainer, synthetic_batch
    from spatial_clip_tpu_torch.profile_serving import profile_encode

    trainer = make_trainer(GENE_MODEL)
    batch = synthetic_batch(trainer.model, TRAIN_BATCH)
    steps = WARMUP_STEPS + TIMED_STEPS
    counters = attention_counters()
    counts, step_ms, history, peak = timed_steps("gene-train", trainer, batch, steps, counters)
    want = (0, LAYERS * steps, LAYERS * steps, 0, 0)
    if counts != want:
        raise AssertionError(f"[gene-train] launches (attention fwd, fwd_lse, bwd, recompute-db, "
                             f"recompute) {counts}, want {want}")
    med = statistics.median(step_ms[WARMUP_STEPS:])
    holder = {"state": trainer.init_state()}

    def step():
        holder["state"], _ = trainer.train_step(holder["state"], batch)

    prof = profile_encode(step, reps=3)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    print(f"[gene-train] {GENE_MODEL} bf16 batch {TRAIN_BATCH} (gene tower 5000 -> 1024, 3 "
          f"blocks, head 512; {n_params} parameters): {steps} steps, launches fwd_lse "
          f"{counts[1]} bwd {counts[2]} (= {LAYERS} per step); losses finite {history[0][0]:.4f} "
          f"-> {history[-1][0]:.4f}; median step {med:.3f} ms over {TIMED_STEPS} "
          f"({TRAIN_BATCH * 1e3 / med:.1f} pairs/s) against phase 8's ViT-B-32 "
          f"{default_step_ms:.3f} ms; profiled: wall {prof['wall_ms']:.3f} ms, device busy "
          f"{prof['device_busy_ms']:.3f} ms, idle share {prof['idle_share']:.3f}, "
          f"{prof['kernels_per_encode']:.0f} kernels; by family "
          f"{ {k: round(v, 3) for k, v in prof['device_ms_by_family'].items()} }; "
          f"max_memory_allocated {peak / 2 ** 30:.3f} GiB", flush=True)
    del trainer, batch, holder
    torch.cuda.empty_cache()
    return {"step_ms": med, "busy_ms": prof["device_busy_ms"], "launches": counts}


GENE_BANK_BATCHES = -(-NUM_GENES // 256)  # evaluate.encode_gene_bank's batch of 256


def gene_entry_phase() -> dict:
    """31. Paths A and B through the entry points, as phase 28 runs
    data=synthetic, with a generated list of 5,000 genes (GENE0 ...
    GENE4999; the synthetic dataset's genes are the first 500) as
    model.global_hvg_path:
    - path A, the gene-vocabulary text tower: data=synthetic (ViT-B-32,
      batch 64) with the GeneTokenizer's 5,004 ids padded to 5,120;
    - path B, experiment=gene_mlp (ViT-B-32-GeneMLP, batch 256) on the
      synthetic dataset (1,280 samples: 4 steps, one val and one test
      batch), one loader worker so that the host crops are drawn in order.
    Each: exact launches, resume to the same bits, .eval with
    test/zero_shot_pcc checked by gene_bank_check, the step's time and the
    checkpoint's bytes."""
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    hvg = Path(tempfile.mkdtemp(prefix="hvg_", dir=build)) / "global_hvgs.txt"
    hvg.write_text("\n".join(f"GENE{i}" for i in range(NUM_GENES)) + "\n")
    try:
        a_test = 128  # data=synthetic's 512 samples: 128 val, the test split the same
        path_a = entry_phase(
            "gene-entry A", base=("data=synthetic", f"model.global_hvg_path={hvg}"),
            want_train={
                "fused_attention.fused_attention_lse": 2 * LAYERS * ENTRY_STEPS,
                "fused_attention.fused_attention_bwd": 2 * LAYERS * ENTRY_STEPS,
                "fused_attention.fused_attention": 2 * LAYERS * 2 * (a_test // ENTRY_BATCH)},
            want_eval={"fused_attention.fused_attention": (
                2 * LAYERS * a_test // ENTRY_BATCH        # trainer.evaluate on the test split
                + LAYERS * GENE_BANK_BATCHES              # the bank through the text tower
                + LAYERS * a_test // ENTRY_BATCH)},       # the PCC's test images
            gene_list=hvg)
        b_samples, b_batch = 1280, TRAIN_BATCH
        b_test = b_samples // 4 // b_batch * b_batch
        path_b = entry_phase(
            "gene-entry B", base=("experiment=gene_mlp", "data=synthetic",
                                  "data.dataset_format=synthetic",
                                  f"data.dataset_format_kwargs.num_samples={b_samples}",
                                  f"model.global_hvg_path={hvg}"),
            batch=b_batch, test_samples=b_test,
            want_train={
                "fused_attention.fused_attention_lse": LAYERS * ENTRY_STEPS,
                "fused_attention.fused_attention_bwd": LAYERS * ENTRY_STEPS,
                "fused_attention.fused_attention": LAYERS * 2 * (b_test // b_batch)},
            want_eval={"fused_attention.fused_attention": 2 * LAYERS * b_test // b_batch},
            gene_list=hvg)
    finally:
        shutil.rmtree(hvg.parent, ignore_errors=True)
    return {"A": path_a, "B": path_b}


STUDY_SPOTS, STUDY_CLASSES_CPU = 1024, 4


def gene_study_phase() -> dict:
    """32. One short arm of each tower of the gene scaling study
    (spatial_clip_tpu_torch.gene_scaling_study: gene, linear and text, 1,024
    spots at 64 px, one epoch at batch 256, 512 held-out spots), finite
    losses and metrics; then the ImageNet-style zero-shot classifier on
    ViT-B-32 (random weights from seed 0, bf16): 1,000 classes x the 80
    OpenAI templates through the text tower, its first STUDY_CLASSES_CPU
    columns held to the f32 CPU classifier by cosine, and zero_shot_eval
    (imagenet_zero_shot_eval's second half) on 2 batches of 64 random
    tiles with random labels (chance-level top-1 / top-5, no ImageNet
    data)."""
    import torch

    from spatial_clip_tpu_torch import create_model, get_tokenizer
    from spatial_clip_tpu_torch.gene_scaling_study import run_arm
    from spatial_clip_tpu_torch.ops.fused_attention import fused_attention
    from spatial_clip_tpu_torch.train.zero_shot import (
        build_zero_shot_classifier,
        load_imagenet_metadata,
        zero_shot_eval,
    )

    arms = {}
    for tower in ("gene", "linear", "text"):
        t0 = time.perf_counter()
        arm = run_arm(tower, STUDY_SPOTS, 1, TRAIN_BATCH, device="cuda")
        vals = [v for v in arm["val"].values()] + arm["train_loss_curve"]
        if not (arm["steps"] == STUDY_SPOTS // TRAIN_BATCH and all(np.isfinite(vals))):
            raise AssertionError(f"[gene-study] arm {arm}")
        arms[tower] = arm
        print(f"[gene-study] arm {tower}: {arm['steps']} steps at batch {TRAIN_BATCH}, loss "
              f"{arm['train_loss_curve']}, val R@1 {arm['val']['R@1']} loss "
              f"{arm['val']['loss']} on {arm['val']['num_samples']:.0f} spots; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()
    names, templates = load_imagenet_metadata("openai")
    model = create_model("ViT-B-32", precision="bf16", seed=0, device="cuda")
    tok = get_tokenizer("ViT-B-32")
    fused_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clf = build_zero_shot_classifier(model, None, tok, names, templates)
    clf_s = time.perf_counter() - t0
    launches = fused_attention.launches
    want_launches = LAYERS * -(-len(names) // 10)
    cpu = create_model("ViT-B-32", precision="fp32", seed=0, device="cpu")
    want = build_zero_shot_classifier(cpu, None, tok, names[:STUDY_CLASSES_CPU], templates)
    cos = (clf[:, :STUDY_CLASSES_CPU] * want).sum(0)
    rng = np.random.default_rng(32)
    loader = [{"images": rng.integers(0, 256, (64, 224, 224, 3), dtype=np.uint8),
               "label": rng.integers(0, len(names), 64)} for _ in range(2)]
    res = zero_shot_eval(model, None, clf, loader)
    if not (clf.shape == (model.cfg.embed_dim, len(names)) and np.isfinite(clf).all()
            and cos.min() >= MIN_COSINE and launches == want_launches
            and all(0 <= v <= 1 for v in res.values())):
        raise AssertionError(f"[gene-study] classifier {clf.shape}, cosine vs CPU {cos}, "
                             f"launches {launches} (want {want_launches}), eval {res}")
    print(f"[gene-study] zero-shot classifier ViT-B-32 bf16: {len(names)} classes x "
          f"{len(templates)} templates in {clf_s:.2f} s, {launches} attention launches "
          f"(12 a batch of 10 classes), first {STUDY_CLASSES_CPU} columns vs f32 CPU: min cosine "
          f"{cos.min():.6f} (>= {MIN_COSINE}); zero_shot_eval on 128 random tiles: "
          f"{res}", flush=True)
    return {"arms": arms, "classifier_launches": launches, "classifier_s": clf_s}



# phase 33: the key-tiled kernels' lengths (with the first past each resident
# limit) and the shape they are timed at, ViT-L-14-336's image tower
LONG_LENGTHS = (257, 401, 577, 1025)
LONG_TIMED = (32, 577, 16, 64)  # batch, L, heads, head dim
VITL_BATCH, VITL336_BATCH = 64, 32  # phases 35-36: timed steps
VITL_CHECK, VITL336_CHECK = 4, 2  # phases 35-36: card vs CPU
VITL_STEPS = WARMUP_STEPS + TIMED_STEPS


def long_bound(qkv, heads: int, kind: str):
    """Bound of a key-tiled backward kernel at qkv's shape: 'dq' reads q, k,
    v, do and lse and writes dq and r, three L x L x hd products (s, dp, dq);
    'dkdv' reads q, k, v, do, lse and r and writes dk and dv, four (s, dp,
    dv, dk); 'db' reads dqkv and writes db."""
    import torch

    B, L, three_d = qkv.shape
    D, item = three_d // 3, qkv.element_size()
    dots = 2 * B * heads * L * L * (D // heads)
    stat = 4 * heads * B * L
    peak = BF16_FLOPS if qkv.dtype == torch.bfloat16 else F32_FLOPS
    if kind == "dq":
        return bound(B * L * (three_d + D + D) * item + 2 * stat, 3 * dots, peak)
    if kind == "dkdv":
        return bound(B * L * (three_d + D + 2 * D) * item + 2 * stat, 4 * dots, peak)
    return bound(B * L * three_d * item + 4 * three_d, B * L * three_d, F32_FLOPS)


def long_kernel_phase() -> dict:
    """33. The key-tiled kernels (csrc/attention_long.cu) against their plain
    versions on the card: the forward with and without lse, the backward
    from the saved lse with db and the two recompute options, at L 257, 401,
    577, 1025 and the first length past each resident limit (forward and
    backward), hd 32 / 64 / 128, bf16 and f32, causal and not (batch 2, 2
    heads), at phases 3 and 6's tolerances, dqkv and db the same bits on a
    rerun; ptxas's registers and spills; then each kernel timed at
    ViT-L-14-336's image tower (LONG_TIMED) beside its plain version, its
    bound and SDPA."""
    import torch

    from spatial_clip_tpu_torch.models.transformer import causal_mask
    from spatial_clip_tpu_torch.ops import attention_long as al
    from spatial_clip_tpu_torch.ops import cuda_build
    from spatial_clip_tpu_torch.ops import fused_attention as fa

    lib_path = cuda_build.build()
    ptxas = ptxas_entries(lib_path.with_suffix(".ptxas.txt").read_text())
    regs = {k: [v for n, v in ptxas.items() if f"{k}_kernel" in n and "attention_long" in n]
            for k in ("long_fwd", "long_dq", "long_dkdv", "long_db")}
    print("[long-kernels] ptxas registers / spill B over the instantiations: " + "; ".join(
        f"{k} {max(r for r, _ in v)}/{max(s for _, s in v)}" for k, v in regs.items() if v),
        flush=True)
    gen = torch.Generator(device="cuda").manual_seed(33)
    B, H = 2, 2
    worst = {"fwd": 0.0, "dq": 0.0, "db": 0.0}
    n_cases = 0
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for hd in (32, 64, 128):
            lengths = sorted({*LONG_LENGTHS, fa.fwd_max_seq(hd, dtype) + 1,
                              fa.bwd_max_seq(hd, dtype) + 1})
            group = {"fwd": 0.0, "bwd": 0.0, "db": 0.0}
            for L in lengths:
                for causal in (False, True):
                    qkv = torch.randn((B, L, 3 * H * hd), generator=gen, device="cuda").to(dtype)
                    g = torch.randn((B, L, H * hd), generator=gen, device="cuda").to(dtype)
                    mask = causal_mask(L, device="cuda") if causal else None
                    out = al.fused_attention_long(qkv, mask, H)
                    out_lse, lse = al.fused_attention_long_lse(qkv, mask, H)
                    got = {"lse": al.fused_attention_long_bwd(qkv, mask, lse, g, H),
                           "re": al.fused_attention_long_bwd_recompute(qkv, mask, g, H, db=False),
                           "re_db": al.fused_attention_long_bwd_recompute(qkv, mask, g, H,
                                                                          db=True)}
                    again = {"lse": al.fused_attention_long_bwd(qkv, mask, lse, g, H),
                             "re_db": al.fused_attention_long_bwd_recompute(qkv, mask, g, H,
                                                                            db=True)}
                    want_out, want_lse = fa.reference_attention_lse(qkv, mask, H)
                    want = {"lse": fa.reference_attention_bwd(qkv, mask, lse, g, H)}
                    want["re"] = want["re_db"] = fa.reference_attention_bwd(qkv, mask, None, g, H)
                    torch.cuda.synchronize()
                    tol = KERNEL_TOL[name]
                    err = (out.float() - want_out.float()).abs().max().item()
                    lse_err = (lse - want_lse).abs().max().item()
                    lse_tol = 1e-5 * max(1.0, want_lse.abs().max().item())
                    bad = []
                    if not (err <= tol and lse_err <= lse_tol and torch.equal(out, out_lse)):
                        bad.append(f"fwd err {err} (tol {tol}) lse {lse_err} (tol {lse_tol}) "
                                   f"the same context with lse {torch.equal(out, out_lse)}")
                    for key, (dqkv, db) in got.items():
                        want_dqkv, want_db = want[key]
                        d_err = (dqkv.float() - want_dqkv.float()).abs().max().item()
                        d_tol = bwd_tol(dtype, want_dqkv.float())
                        group["bwd"] = max(group["bwd"], d_err)
                        if not (d_err <= d_tol and torch.isfinite(dqkv.float()).all().item()):
                            bad.append(f"{key} dqkv err {d_err} (tol {d_tol})")
                        if db is not None:
                            db_err = (db - want_db).abs().max().item()
                            db_tol = train_tol(dtype, want_db) + 1e-4
                            group["db"] = max(group["db"], db_err)
                            same = torch.equal(db, again[key][1]) and torch.equal(
                                dqkv, again[key][0])
                            if not (db_err <= db_tol and same):
                                bad.append(f"{key} db err {db_err} (tol {db_tol}), dqkv and db "
                                           f"the same bits on a rerun {same}")
                    if bad:
                        raise AssertionError(f"[long-kernels] {name} hd {hd} L {L} causal "
                                             f"{causal}: " + "; ".join(bad))
                    group["fwd"] = max(group["fwd"], err)
                    n_cases += 1
            worst = {"fwd": max(worst["fwd"], group["fwd"]), "dq": max(worst["dq"], group["bwd"]),
                     "db": max(worst["db"], group["db"])}
            dq_tol = ("one bf16 ulp at max|ref|" if dtype == torch.bfloat16
                      else "2e-5 x max(1, |ref|)")
            print(f"[long-kernels] {name} hd {hd}, batch {B}, {H} heads, L {lengths}, causal "
                  f"and not: forward max abs err {group['fwd']:.3g} (tol {KERNEL_TOL[name]:g}), "
                  f"lse within 1e-5 x max(1, |lse|), the same context with and without lse; "
                  f"backward (saved lse with db, recompute, recompute with db) dqkv max abs err "
                  f"{group['bwd']:.3g} within {dq_tol}, db {group['db']:.3g}; dqkv and db the "
                  f"same bits on a rerun", flush=True)

    # times at ViT-L-14-336's image tower, bf16, no mask
    Bt, L, Ht, hd = LONG_TIMED
    qkv = torch.randn((Bt, L, 3 * Ht * hd), generator=gen, device="cuda").bfloat16()
    g = torch.randn((Bt, L, Ht * hd), generator=gen, device="cuda").bfloat16()
    out, lse = al.fused_attention_long_lse(qkv, None, Ht)
    dqkv, db = al.fused_attention_long_bwd(qkv, None, lse, g, Ht)
    r = al.long_bwd_dq(qkv, None, lse, g, Ht, torch.empty_like(qkv))
    want_out, want_lse = fa.reference_attention_lse(qkv, None, Ht)
    want_dqkv, want_db = fa.reference_attention_bwd(qkv, None, lse, g, Ht)
    torch.cuda.synchronize()
    errs = {"fwd": (out.float() - want_out.float()).abs().max().item(),
            "dqkv": (dqkv.float() - want_dqkv.float()).abs().max().item(),
            "r": (r - al.reference_long_r(qkv, None, lse, g, Ht)).abs().max().item(),
            "db": (db - want_db).abs().max().item()}
    if not (errs["fwd"] <= KERNEL_TOL["bfloat16"]
            and errs["dqkv"] <= bwd_tol(torch.bfloat16, want_dqkv.float())
            and errs["db"] <= train_tol(torch.bfloat16, want_db) + 1e-4):
        raise AssertionError(f"[long-kernels] timed shape {tuple(qkv.shape)}: errors {errs}")
    dbuf = torch.empty_like(qkv)
    D = Ht * hd

    def plain_dq():
        d = fa.reference_attention_bwd(qkv, None, lse, g, Ht)[0]
        return d[..., :D], al.reference_long_r(qkv, None, lse, g, Ht)

    library = sdpa_ms(qkv, None, Ht)
    rows = {
        "fwd": dict(ms=median_ms(lambda: al.fused_attention_long_lse(qkv, None, Ht)),
                    plain_ms=median_ms(lambda: fa.reference_attention_lse(qkv, None, Ht), 3, 3),
                    library_ms=library["fwd_lse"], err=errs["fwd"]),
        "dq": dict(ms=median_ms(lambda: al.long_bwd_dq(qkv, None, lse, g, Ht, dbuf)),
                   plain_ms=median_ms(plain_dq, 3, 3), library_ms=None, err=errs["dqkv"]),
        "dkdv": dict(ms=median_ms(lambda: al.long_bwd_dkdv(qkv, None, lse, r, g, Ht, dbuf)),
                     plain_ms=median_ms(lambda: fa.reference_attention_bwd(qkv, None, lse, g,
                                                                           Ht)[0][..., D:], 3, 3),
                     library_ms=None, err=errs["dqkv"]),
        "db": dict(ms=median_ms(lambda: al.long_db(dqkv)),
                   plain_ms=median_ms(lambda: dqkv.float().sum(dim=(0, 1))),
                   library_ms=median_ms(lambda: torch.sum(dqkv, dim=(0, 1), dtype=torch.float32)),
                   err=errs["db"]),
    }
    rows["fwd"]["bound_ms"], rows["fwd"]["bound_by"] = attention_bound(qkv, Ht, "fwd_lse")
    for k in ("dq", "dkdv", "db"):
        rows[k]["bound_ms"], rows[k]["bound_by"] = long_bound(qkv, Ht, k)
    bwd_ms = median_ms(lambda: al.fused_attention_long_bwd(qkv, None, lse, g, Ht))
    bwd_bound = attention_bound(qkv, Ht, "bwd")[0]
    rows["dq"].update(bwd_ms=bwd_ms, bwd_library_ms=library["bwd"], bwd_bound_ms=bwd_bound)
    print(f"[long-kernels] timed at qkv {tuple(qkv.shape)} bf16, no mask (ViT-L-14-336's image "
          f"tower, batch {Bt}): " + "; ".join(
              f"{k} {v['ms']:.4f} ms vs plain {v['plain_ms']:.4f} ms, bound {v['bound_ms']:.4f} "
              f"ms ({v['bound_by']}), library "
              f"{'none' if v['library_ms'] is None else format(v['library_ms'], '.4f') + ' ms'}"
              for k, v in rows.items())
          + f"; the whole backward (dQ, dK/dV, db) {bwd_ms:.4f} ms vs SDPA's backward "
          f"{library['bwd']:.4f} ms (retained graph), bound {bwd_bound:.4f} ms; errors {errs}; "
          f"{n_cases} cases checked", flush=True)
    rows["worst"] = worst
    return rows


def vitl_serve_phase() -> dict:
    """34. ViT-L-14 (bf16, batch 64) through the embedding server on
    127.0.0.1: 64 texts and 64 raw tiles, exactly 36 resident inference
    forwards (24 image + 12 text layers; L 257 is within the resident
    forward's 528 at hd 64) and no other attention; every embedding against
    the same weights in f32 on the CPU by cosine; encode times."""
    from http.server import ThreadingHTTPServer

    import torch

    from spatial_clip_tpu_torch import create_model
    from spatial_clip_tpu_torch.models.transforms import normalize_batch
    from spatial_clip_tpu_torch.serve import EmbeddingService, make_handler

    t0 = time.perf_counter()
    service = EmbeddingService("ViT-L-14", precision="bf16", batch_size=VITL_BATCH,
                               device="cuda")
    service.warmup()
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    counters = every_counter()
    try:
        dim = int(service.model.cfg.embed_dim)
        texts = [f"spatial spot {i}: gene {i * 13 % 101} high in tumor stroma" for i in range(64)]
        tiles = np.random.default_rng(34).integers(0, 256, (64, 224, 224, 3), dtype=np.uint8)
        for c in counters.values():
            c.launches = 0
        txt = embeddings(post(port, "/embed_text", json.dumps({"texts": texts})))
        img = embeddings(post(port, "/embed_image_raw", tiles.tobytes()))
        launches = read_launches(counters)
        want_launches = {"fused_attention.fused_attention": 24 + 12}
        check_embeddings("vitl text", txt, 64, dim)
        check_embeddings("vitl image", img, 64, dim)
        model, tokenizer = service.model, service.tokenizer
        x64 = normalize_batch(torch.from_numpy(tiles).cuda(), dtype=model.dtype)
        ids64 = torch.from_numpy(tokenizer(texts)).long().cuda()
        with torch.inference_mode():
            img_ms = host_median_ms(lambda: model.encode_image(x64), reps=5)
            txt_ms = host_median_ms(lambda: model.encode_text(ids64), reps=5)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        service.close()
    del service, model
    torch.cuda.empty_cache()
    reference = create_model("ViT-L-14", precision="fp32", seed=0, device="cpu")
    with torch.inference_mode():
        want_txt = reference.encode_text(torch.from_numpy(tokenizer(texts)).long()).numpy()
        want_img = reference.encode_image(normalize_batch(torch.from_numpy(tiles))).numpy()
    cos = {"text": float((txt * want_txt).sum(-1).min()),
           "image": float((img * want_img).sum(-1).min())}
    if launches != want_launches or min(cos.values()) < MIN_COSINE:
        raise AssertionError(f"[vitl-serve] launches {launches} (want {want_launches}), min "
                             f"cosine vs f32 CPU {cos}")
    print(f"[vitl-serve] ViT-L-14 bf16 batch {VITL_BATCH} through the server: 64 texts and 64 "
          f"raw tiles, 200 OK, unit norm, launches {launches} (24 image + 12 text layers, "
          f"resident at L 257 and 77); min cosine vs f32 CPU text {cos['text']:.5f} image "
          f"{cos['image']:.5f} (>= {MIN_COSINE}); encode_image 64 tiles {img_ms:.3f} ms, "
          f"encode_text 64 texts {txt_ms:.3f} ms; {time.perf_counter() - t0:.1f} s", flush=True)
    return {"launches": launches, "img_ms": img_ms, "txt_ms": txt_ms, "cos": cos}


def long_train_phase(label: str, model_name: str, check_batch: int, batch: int,
                     per_step: dict) -> dict:
    """35 (ViT-L-14) and 36 (ViT-L-14-336). Phase 7's card-vs-CPU step at
    ``check_batch`` with exactly ``per_step`` launches, then WARMUP_STEPS +
    TIMED_STEPS steps at ``batch`` with exactly ``per_step`` launches a step
    and none of any other wrapper: finite losses and gradient norms, median
    step ms, pairs/s, peak memory."""
    import torch

    from spatial_clip_tpu_torch.bench import synthetic_batch

    trainer = train_check_phase(f"{label}-check", batch_size=check_batch, model_name=model_name,
                                want_launches=per_step)
    data = synthetic_batch(trainer.model, batch)
    counters = every_counter()
    names = list(counters)
    counts, step_ms, history, peak = timed_steps(label, trainer, data, VITL_STEPS,
                                                 [counters[k] for k in names])
    launches = {k: n for k, n in zip(names, counts) if n}
    want = {k: n * VITL_STEPS for k, n in per_step.items()}
    if launches != want:
        raise AssertionError(f"[{label}] launches {launches}, want {want}")
    med = statistics.median(step_ms[WARMUP_STEPS:])
    print(f"[{label}] {model_name} bf16 batch {batch}: {VITL_STEPS} steps, launches {launches} "
          f"(= {VITL_STEPS} x {per_step}); losses finite {history[0][0]:.4f} -> "
          f"{history[-1][0]:.4f}, grad norms finite; median step {med:.3f} ms over "
          f"{TIMED_STEPS} ({batch * 1e3 / med:.1f} pairs/s); max_memory_allocated "
          f"{peak / 2 ** 30:.3f} GiB", flush=True)
    del trainer, data
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": med, "peak_gib": peak / 2 ** 30}


def so400m_phase() -> dict:
    """37. ViT-SO400M-14-SigLIP (bf16): one forward of 8 tiles and 8 rows of
    token ids, against the same weights in f32 on the CPU by per-row cosine.
    The image tower (27 layers, L 257, 18 heads of 64) takes the resident
    inference kernel, the text tower (27 layers, 16 heads of 72, which JAX's
    gate groups no heads of) the plain einsum route: exactly 27 and 27."""
    import torch

    from spatial_clip_tpu_torch import create_model
    from spatial_clip_tpu_torch.models.transforms import normalize_batch

    t0 = time.perf_counter()
    name = "ViT-SO400M-14-SigLIP"
    card = create_model(name, precision="bf16", seed=0, device="cuda")
    cfg = card.cfg
    rng = np.random.default_rng(37)
    tiles = rng.integers(0, 256, (8, cfg.vision_cfg.size, cfg.vision_cfg.size, 3), dtype=np.uint8)
    ids = torch.from_numpy(rng.integers(0, cfg.text_cfg.vocab_size,
                                        (8, cfg.text_cfg.context_length)))
    counters = every_counter()
    for c in counters.values():
        c.launches = 0
    with torch.inference_mode():
        got = card(normalize_batch(torch.from_numpy(tiles).cuda(), dtype=card.dtype), ids.cuda())
        torch.cuda.synchronize()
    launches = read_launches(counters)
    got = {k: got[k].float().cpu().numpy() for k in ("image_features", "text_features")}
    del card
    torch.cuda.empty_cache()
    cpu = create_model(name, precision="fp32", seed=0, device="cpu")
    with torch.inference_mode():
        want = cpu(normalize_batch(torch.from_numpy(tiles)), ids)
    cos = {k: float((got[k] * want[k].numpy()).sum(-1).min()) for k in got}
    layers = cfg.vision_cfg.layers
    want_launches = {"fused_attention.fused_attention": layers,
                     "attention_plain.plain_attention": cfg.text_cfg.layers}
    finite = all(np.isfinite(v).all() for v in got.values())
    if launches != want_launches or min(cos.values()) < MIN_COSINE or not finite:
        raise AssertionError(f"[so400m] launches {launches} (want {want_launches}), cosine {cos}, "
                             f"finite {finite}")
    print(f"[so400m] {name} bf16, 8 tiles and 8 id rows, one forward: launches {launches} "
          f"(image tower resident at L 257, {cfg.vision_cfg.heads} heads of "
          f"{cfg.vision_cfg.width // cfg.vision_cfg.heads}; text tower {cfg.text_cfg.heads} heads "
          f"of {cfg.text_cfg.width // cfg.text_cfg.heads} on the plain route); min cosine vs f32 "
          f"CPU image {cos['image_features']:.5f} text {cos['text_features']:.5f} (>= "
          f"{MIN_COSINE}); {time.perf_counter() - t0:.1f} s", flush=True)
    return {"launches": launches, "cos": cos}


def smoke_synthetic_phase() -> dict:
    """38. ``experiment=smoke_synthetic`` (ViT-Test as it is, fp32, heads of
    16) through ``spatial_clip_tpu_torch.train`` and ``.eval`` on the card:
    no attention kernel launches, and the plain route 2 layers x 2 towers a
    forward, for each train step and each val and test batch."""
    import torch

    from spatial_clip_tpu_torch import eval as port_eval
    from spatial_clip_tpu_torch.train import entry

    counters = every_counter()
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="smoke_", dir=build))
    try:
        base = ["experiment=smoke_synthetic"]
        cfg = entry.compose_train([*base, "save_ckpt=true", "test=true",
                                   f"paths.root_dir={root / 'run'}"])
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        value, objects = entry.train(cfg)
        run_s = time.perf_counter() - t0
        launches = read_launches(counters)
        metrics, state = objects["metrics"], objects["state"]
        per_forward = 2 * 2  # ViT-Test: 2 layers in each tower
        batch = int(cfg["data"]["batch_size"])
        eval_batches = -(-int(metrics["test/num_samples"]) // batch)
        want = {"attention_plain.plain_attention":
                per_forward * (state.step + 2 * eval_batches)}  # val, then the same split as test
        if (launches != want or not np.isfinite(value)
                or str(objects["model"].dtype) != "torch.float32"):
            raise AssertionError(f"[smoke-synthetic] train launches {launches} (want {want}), "
                                 f"value {value}, dtype {objects['model'].dtype}")
        for c in counters.values():
            c.launches = 0
        got = port_eval.main([*base, f"paths.root_dir={root / 'eval'}",
                              f"ckpt_path={Path(cfg['paths']['output_dir']) / 'checkpoints'}"])
        eval_launches = read_launches(counters)
        want_eval = {"attention_plain.plain_attention": per_forward * eval_batches}
        test = {k: float(v) for k, v in metrics.items() if k.startswith("test/")}
        if eval_launches != want_eval or got != test:
            raise AssertionError(f"[smoke-synthetic] eval launches {eval_launches} (want "
                                 f"{want_eval}), metrics {got} vs {test}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    print(f"[smoke-synthetic] python -m spatial_clip_tpu_torch.train experiment=smoke_synthetic "
          f"on {torch.cuda.get_device_name(0)}: ViT-Test fp32 (2 heads of 16), {state.step} "
          f"steps in {run_s:.1f} s, val/loss {metrics['val/loss']:.4f}; launches {launches} (no "
          f"attention kernel; {per_forward} plain calls a forward); .eval on the checkpoints: "
          f"launches {eval_launches}, the train run's {len(got)} test metrics", flush=True)
    return {"train_launches": launches, "eval_launches": eval_launches}


# ---------------------------------------------------------------------------
# phases 39-44: the open_clip-style trainer and its options, the other CLIs,
# activation checkpointing and the debug presets

CLI_BATCH, CLI_STEPS = 64, 4  # phases 39-42: main_train at batch 64
EMBED_SAMPLES, EMBED_BATCH, EMBED_CHECK = 512, 256, 32  # phase 39's embed; rows held to the CPU
FWD, LSE, BWD = ("fused_attention.fused_attention", "fused_attention.fused_attention_lse",
                 "fused_attention.fused_attention_bwd")
REMAT_STEPS = 4  # phase 43: steps with and without remat (2 for the bits, then timed)
MIN_SIGN_AGREEMENT = 0.95  # phase 42: Lion's first update, card vs CPU


def scratch_root(prefix: str) -> Path:
    build = Path(__file__).resolve().parent / "build"  # ignored by git
    build.mkdir(exist_ok=True)
    return Path(tempfile.mkdtemp(prefix=prefix, dir=build))


def cli_argv(root: Path, steps: int = CLI_STEPS, model="ViT-B-32"):
    """main_train's argv for ``steps`` steps of ViT-B-32 bf16 at 224 px and
    batch 64 on the synthetic split of 256 samples (its val split: one
    batch of 64), logs under ``root``."""
    return ["--model", str(model), "--precision", "bf16", "--dataset-type", "synthetic",
            "--synthetic-image-size", "224", "--train-num-samples", str(CLI_BATCH * CLI_STEPS),
            "--steps-per-epoch", str(steps), "--batch-size", str(CLI_BATCH), "--epochs", "1",
            "--workers", "4", "--seed", "0", "--log-every-n-steps", "1",
            "--logs", str(root / "logs"), "--name", "run"]


def run_main_train(label: str, argv, want: dict):
    """``cli.main_train.main(argv)`` with every counter at 0 first; the run's
    launches must be ``want``. Returns (metrics, seconds, launches)."""
    import torch

    from spatial_clip_tpu_torch.cli import main_train

    counters = every_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    metrics = main_train.main(argv)
    seconds = time.perf_counter() - t0
    launches = read_launches(counters)
    finite = all(np.isfinite(v) for v in metrics.values() if isinstance(v, float))
    if launches != want or not finite:
        raise AssertionError(f"[{label}] launches {launches} (want {want}), metrics {metrics}")
    return metrics, seconds, launches


def main_train_phase() -> dict:
    """39. ``python -m spatial_clip_tpu_torch.cli.main_train`` (ViT-B-32 bf16,
    batch 64, spatial loss capped at 50, 4 steps, the local mirror): exact
    launches (24 forward-lse and 24 saved-lse backward a step, 24 inference
    forwards for the val batch), results.json, step_4 and the mirrored run
    directory; then ``cli.embed`` on that checkpoint over 512 synthetic
    samples at batch 256 (24 inference forwards a batch), its first 32 rows
    of each tower against the f32 CPU model on the same weights and tiles,
    per-row cosine; pairs/s."""
    import torch

    from spatial_clip_tpu_torch.cli import embed
    from spatial_clip_tpu_torch.data.datamodule import collate_spatial
    from spatial_clip_tpu_torch.data.datasets import create_spatial_dataset
    from spatial_clip_tpu_torch.models.factory import create_model_and_transforms, get_tokenizer
    from spatial_clip_tpu_torch.models.transforms import normalize_batch

    root = scratch_root("cli_")
    try:
        argv = [*cli_argv(root), "--use-spatial-loss", "--cap-logit-scale", "50",
                "--remote-sync", str(root / "mirror"), "--remote-sync-protocol", "local"]
        want = {LSE: 2 * LAYERS * CLI_STEPS, BWD: 2 * LAYERS * CLI_STEPS, FWD: 2 * LAYERS}
        metrics, run_s, launches = run_main_train("main-train", argv, want)
        peak = torch.cuda.max_memory_allocated()
        run = root / "logs" / "run"
        results = json.loads((run / "results.json").read_text())
        steps = sorted(p.name for p in (run / "checkpoints").iterdir())
        mirror = root / "mirror" / "run"
        mirrored = {str(p.relative_to(mirror)) for p in mirror.rglob("*") if p.is_file()}
        local = {str(p.relative_to(run)) for p in run.rglob("*") if p.is_file()}
        if not (steps == [f"step_{CLI_STEPS}"] and set(results) == set(metrics)
                and f"checkpoints/step_{CLI_STEPS}/state.pt" in mirrored and mirrored == local):
            raise AssertionError(f"[main-train] checkpoints {steps}, results {sorted(results)}, "
                                 f"mirror {sorted(mirrored)} vs run {sorted(local)}")
        print(f"[main-train] python -m spatial_clip_tpu_torch.cli.main_train --model ViT-B-32 "
              f"--precision bf16 --batch-size {CLI_BATCH} --use-spatial-loss --cap-logit-scale "
              f"50 --remote-sync <dir> ({CLI_STEPS} steps, synthetic 224 px): launches "
              f"{launches}; {run_s:.1f} s (model build, loader, validation, checkpoint, sync "
              f"process included); loss {metrics['loss']:.4f}, val/loss "
              f"{metrics['val/loss']:.4f}, train pairs/s {metrics['pairs_per_sec']:.1f} (the last "
              f"step, loader included); max_memory_allocated {peak / 2 ** 30:.3f} GiB; "
              f"results.json {len(results)} keys, checkpoints {steps}, the mirror holds the "
              f"run's {len(local)} files", flush=True)

        counters = every_counter()
        for c in counters.values():
            c.launches = 0
        out = root / "emb.npz"
        t0 = time.perf_counter()
        stats = embed.main(["--model", "ViT-B-32", "--ckpt", str(run / "checkpoints"),
                            "--data", str(root), "--dataset-type", "synthetic",
                            "--synthetic-num-samples", str(EMBED_SAMPLES), "--batch-size",
                            str(EMBED_BATCH), "--workers", "4", "--out", str(out)])
        embed_s = time.perf_counter() - t0
        embed_launches = read_launches(counters)
        want = {FWD: 2 * LAYERS * EMBED_SAMPLES // EMBED_BATCH}
        got = np.load(out)
        if embed_launches != want or got["image_embeddings"].shape != (EMBED_SAMPLES, 512):
            raise AssertionError(f"[embed] launches {embed_launches} (want {want}), shapes "
                                 f"{ {k: got[k].shape for k in got.files} }")
        cpu, _, pp_val = create_model_and_transforms("ViT-B-32", precision="fp32", device="cpu")
        embed.load_weights(cpu, run / "checkpoints")
        ds = create_spatial_dataset("synthetic", root, "train", "train", 1, pp_val,
                                    get_tokenizer("ViT-B-32"), {"num_samples": EMBED_SAMPLES})
        batch = collate_spatial([ds[i] for i in range(EMBED_CHECK)])
        with torch.inference_mode():
            want_img = cpu.encode_image(normalize_batch(torch.from_numpy(batch["images"])))
            want_txt = cpu.encode_text(torch.from_numpy(batch["texts"]))
        cos = {"image": float((got["image_embeddings"][:EMBED_CHECK] * want_img.numpy())
                              .sum(-1).min()),
               "text": float((got["text_embeddings"][:EMBED_CHECK] * want_txt.numpy())
                             .sum(-1).min())}
        if min(cos.values()) < MIN_COSINE or not np.array_equal(got["tile_ids"][:EMBED_CHECK],
                                                                batch["image_tile_ids"]):
            raise AssertionError(f"[embed] cosine vs f32 CPU {cos}")
        print(f"[embed] python -m spatial_clip_tpu_torch.cli.embed --ckpt <run>/checkpoints "
              f"(step_{CLI_STEPS}, bf16) over {EMBED_SAMPLES} synthetic samples at batch "
              f"{EMBED_BATCH}: launches {embed_launches}; {stats['pairs_per_sec']} pairs/s as "
              f"the CLI reports it (host decode and loader included), {embed_s:.1f} s with the "
              f"model build; first {EMBED_CHECK} rows vs the f32 CPU model on the same "
              f"weights: min cosine image {cos['image']:.5f} text {cos['text']:.5f} (>= "
              f"{MIN_COSINE})", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"train_launches": launches, "embed_launches": embed_launches, "cos": cos,
            "pairs_per_sec": stats["pairs_per_sec"], "run_s": run_s}


def option_check(label: str, model_name: str, loss_kind: str, batch_size: int,
                 loss_kw=None, opts=(None,), teacher_name=None, want_launches=None) -> dict:
    """One train step of ``model_name`` under an option of the open_clip-style
    trainer, card (bf16, kernels) vs CPU (f32, plain path), on the same
    weights, batch and augmentation draws: the loss (rel err <=
    MAX_LOSS_REL_ERR) and the flattened gradient (cosine >= MIN_GRAD_COSINE);
    with ``want_launches`` the card step's launches. For each optimizer in
    ``opts`` (``label`` formatted with its name; the models built once)
    the whole step runs on both sides (constant lr from step 0) and the
    optimizer's moment and update are held too: the moment by cosine, SGD's
    update by cosine, Lion's by the share of entries whose sign agrees (>=
    MIN_SIGN_AGREEMENT). ``teacher_name``: a frozen teacher, the same seeded
    weights on both sides. Returns the measurements by optimizer."""
    import torch

    from spatial_clip_tpu_torch import create_model
    from spatial_clip_tpu_torch.bench import synthetic_batch
    from spatial_clip_tpu_torch.losses import make_loss
    from spatial_clip_tpu_torch.models.transforms import AugmentDraws
    from spatial_clip_tpu_torch.train.loop import Trainer, TrainerConfig

    t0 = time.perf_counter()
    models = {device: (create_model(model_name, precision=precision, seed=0, device=device,
                                    training=True),
                       None if teacher_name is None else
                       create_model(teacher_name, precision=precision, seed=1, device=device))
              for device, precision in (("cuda", "bf16"), ("cpu", "fp32"))}
    batch = synthetic_batch(models["cpu"][0], batch_size, seed=1, device="cpu")
    rng = np.random.default_rng(2)
    draws = AugmentDraws(*(torch.from_numpy(d) for d in (
        rng.random(batch_size) < 0.5,
        (1.0 + rng.uniform(-0.2, 0.2, batch_size)).astype(np.float32),
        (1.0 + rng.uniform(-0.2, 0.2, batch_size)).astype(np.float32))))
    card_batch = {k: v.cuda() for k, v in batch.items()}
    card_draws = AugmentDraws(*(d.cuda() for d in draws))
    results = {}
    for opt in opts:
        cfg = TrainerConfig(schedule="const", warmup_steps=0, learning_rate=1e-4, seed=0,
                            **({"opt": opt} if opt else {}))
        card, cpu = (Trainer(models[d][0], make_loss(loss_kind, **(loss_kw or {})), cfg,
                             teacher=models[d][1]) for d in ("cuda", "cpu"))
        card_state, cpu_state = card.init_state(), cpu.init_state()
        counters = every_counter()
        for c in counters.values():
            c.launches = 0
        loss_card, _, grad_card = card.forward_backward(card_state, card_batch, card_draws)
        launches = read_launches(counters)
        loss_cpu, _, grad_cpu = cpu.forward_backward(cpu_state, batch, draws)
        rel = abs(loss_card.item() - loss_cpu.item()) / abs(loss_cpu.item())
        cos = cosine(grad_card.float().cpu(), grad_cpu)
        out = {"loss_rel_err": rel, "grad_cosine": cos, "launches": launches}
        ok = (rel <= MAX_LOSS_REL_ERR and cos >= MIN_GRAD_COSINE
              and (want_launches is None or launches == want_launches))
        if opt:
            before = (card_state.flat["params"].to("cpu", torch.float32, copy=True),
                      cpu_state.flat["params"].clone())
            card.train_step(card_state, card_batch, card_draws)
            cpu.train_step(cpu_state, batch, draws)
            delta_card = card_state.flat["params"].float().cpu() - before[0]
            delta_cpu = cpu_state.flat["params"] - before[1]
            out["moment_cosine"] = cosine(card_state.flat["mu"].float().cpu(),
                                          cpu_state.flat["mu"])
            if opt == "lion":
                moved = delta_cpu != 0
                out["sign_agreement"] = float((torch.sign(delta_card[moved])
                                               == torch.sign(delta_cpu[moved])).double().mean())
                ok = ok and out["sign_agreement"] >= MIN_SIGN_AGREEMENT
            else:
                out["update_cosine"] = cosine(delta_card, delta_cpu)
                ok = ok and out["update_cosine"] >= MIN_GRAD_COSINE
            ok = ok and out["moment_cosine"] >= MIN_GRAD_COSINE
        name = label.format(opt)
        if not ok:
            raise AssertionError(f"[{name}] {out} (want launches {want_launches})")
        print(f"[{name}] {Path(model_name).name} batch {batch_size}, loss {loss_kind}"
              f"{'' if not opt else f', opt {opt}'}"
              f"{'' if teacher_name is None else f', teacher {teacher_name}'}: loss card bf16 "
              f"{loss_card.item():.6f} vs CPU f32 {loss_cpu.item():.6f} (rel err {rel:.3g} <= "
              f"{MAX_LOSS_REL_ERR}); gradient cosine {cos:.6f} (>= {MIN_GRAD_COSINE}); launches "
              f"{launches}"
              + "".join(f"; {k} {v:.6f}" for k, v in out.items()
                        if k in ("moment_cosine", "update_cosine", "sign_agreement"))
              + f"; {time.perf_counter() - t0:.1f} s", flush=True)
        results[opt] = out
        del card, cpu, card_state, cpu_state
        t0 = time.perf_counter()
    del models
    torch.cuda.empty_cache()
    return results


def siglip_phase() -> dict:
    """40. SigLIP: a ViT-B-32 JSON with SigLIP's initial scale and bias
    (log 10, -10, as ViT-B-16-SigLIP.json) passed to ``--model`` by path;
    ``main_train --siglip`` for 4 steps (exact launches), then one step card
    vs CPU at batch 32."""
    from spatial_clip_tpu_torch.models.config import load_model_config

    root = scratch_root("siglip_")
    try:
        config = {**load_model_config("ViT-B-32"), "init_logit_scale": 2.302585,
                  "init_logit_bias": -10.0}
        path = root / "ViT-B-32-sigmoid.json"
        path.write_text(json.dumps(config))
        want = {LSE: 2 * LAYERS * CLI_STEPS, BWD: 2 * LAYERS * CLI_STEPS, FWD: 2 * LAYERS}
        metrics, run_s, launches = run_main_train(
            "siglip", [*cli_argv(root, model=path), "--siglip"], want)
        print(f"[siglip] main_train --model <ViT-B-32 JSON with init_logit_scale 2.302585, "
              f"init_logit_bias -10> --siglip, batch {CLI_BATCH}, {CLI_STEPS} steps: launches "
              f"{launches}; loss {metrics['loss']:.4f}, logit_scale "
              f"{metrics['logit_scale']:.4f}; {run_s:.1f} s", flush=True)
        check = option_check("siglip-check", str(path), "siglip", CHECK_BATCH,
                             want_launches={LSE: 2 * LAYERS, BWD: 2 * LAYERS})[None]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"launches": launches, "check": check}


def distill_phase() -> dict:
    """41. Distillation: student ViT-B-32, teacher ViT-L-14 (seeded
    weights), ``main_train --distill-model ViT-L-14`` at batch 64 for 4
    steps: the student's 24 forward-lse and 24 backward a step beside the
    teacher's 36 inference forwards (24 image + 12 text), and on the val
    batch 24 + 36 inference forwards; then one step card vs CPU at batch 4."""
    root = scratch_root("distill_")
    teacher_fwd = 24 + 12
    try:
        want = {LSE: 2 * LAYERS * CLI_STEPS, BWD: 2 * LAYERS * CLI_STEPS,
                FWD: teacher_fwd * CLI_STEPS + 2 * LAYERS + teacher_fwd}
        metrics, run_s, launches = run_main_train(
            "distill", [*cli_argv(root), "--distill-model", "ViT-L-14"], want)
        print(f"[distill] main_train --distill-model ViT-L-14 (student ViT-B-32), batch "
              f"{CLI_BATCH}, {CLI_STEPS} steps: launches {launches} (the teacher's "
              f"{teacher_fwd} inference forwards a step and a val batch); loss "
              f"{metrics['loss']:.4f}, distill_loss {metrics['distill_loss']:.4f}; "
              f"{run_s:.1f} s", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check = option_check("distill-check", "ViT-B-32", "distill", 4, teacher_name="ViT-L-14",
                         want_launches={LSE: 2 * LAYERS, BWD: 2 * LAYERS, FWD: teacher_fwd})[None]
    return {"launches": launches, "check": check}


def lit_phase() -> dict:
    """42. LiT: ``main_train --lock-image-tower --lock-image-unlocked-groups
    1`` for 3 steps: every frozen parameter of the checkpoint the same bits
    as at init (seed 0), ``resblocks_11`` moved; the clipping norm counts
    the frozen gradients (a step's ``grad_norm`` is the norm of the whole
    gradient, the frozen range included); then ``--opt sgd`` and ``--opt
    lion``: one step each card vs CPU."""
    import torch

    from spatial_clip_tpu_torch import create_model
    from spatial_clip_tpu_torch.bench import synthetic_batch
    from spatial_clip_tpu_torch.cli.main_train import _lock_prefixes, parse_args
    from spatial_clip_tpu_torch.losses import make_loss
    from spatial_clip_tpu_torch.train.checkpoints import state_file_params
    from spatial_clip_tpu_torch.train.loop import Trainer, TrainerConfig

    steps = 3
    root = scratch_root("lit_")
    lock = ["--lock-image-tower", "--lock-image-unlocked-groups", "1"]
    try:
        want = {LSE: 2 * LAYERS * steps, BWD: 2 * LAYERS * steps, FWD: 2 * LAYERS}
        metrics, run_s, launches = run_main_train(
            "lit", [*cli_argv(root, steps=steps), *lock], want)
        trained = state_file_params(root / "logs" / "run" / "checkpoints" / f"step_{steps}")
        init = create_model("ViT-B-32", precision="bf16", seed=0, device="cuda", training=True)
        prefixes = _lock_prefixes(init, parse_args(lock))
        from spatial_clip_tpu_torch.train.optim import freeze_mask

        frozen = {k for k, f in freeze_mask(trained, prefixes).items() if f}
        start = {k: p.detach().cpu() for k, p in init.named_parameters()}
        same = {k: torch.equal(trained[k], start[k]) for k in trained}
        last = [k for k in trained if k.startswith("visual.transformer.resblocks.11.")]
        if not (all(same[k] for k in frozen) and last and not any(same[k] for k in last)
                and any(k.startswith("visual.transformer.resblocks.10.") for k in frozen)):
            raise AssertionError(f"[lit] frozen moved: {[k for k in frozen if not same[k]]}; "
                                 f"resblocks_11 unmoved: {[k for k in last if same[k]]}")
        # the clipping norm: the whole gradient's, frozen range included
        trainer = Trainer(init, make_loss("spatial", cap_logit_scale=50.0),
                          TrainerConfig(frozen_prefixes=prefixes, seed=0))
        state = trainer.init_state()
        batch = synthetic_batch(init, CLI_BATCH)
        gen = state.generator.get_state()
        _, _, grads = trainer.forward_backward(state, batch)
        a, b = state.frozen
        whole = float(grads.float().norm())
        unfrozen = float(torch.cat([grads[:a], grads[b:]]).float().norm())
        state.generator.set_state(gen)
        _, m = trainer.train_step(state, batch)
        rel = abs(float(m["grad_norm"]) - whole) / whole
        if not (rel <= 1e-5 and whole > 1.01 * unfrozen):
            raise AssertionError(f"[lit] grad_norm {float(m['grad_norm'])}, whole {whole}, "
                                 f"without the frozen range {unfrozen}")
        print(f"[lit] main_train {' '.join(lock)}, batch {CLI_BATCH}, {steps} steps: launches "
              f"{launches}; {len(frozen)} frozen parameters the same bits as at init, the "
              f"{len(last)} of resblocks_11 moved (JAX's freeze_mask would freeze them too); a "
              f"step's grad_norm {float(m['grad_norm']):.6f} = the whole gradient's norm "
              f"{whole:.6f} (rel {rel:.2g}; without the frozen range {unfrozen:.6f}); "
              f"{run_s:.1f} s", flush=True)
        del trainer, state, init, grads
    finally:
        shutil.rmtree(root, ignore_errors=True)
    checks = option_check("{}-check", "ViT-B-32", "spatial", CHECK_BATCH,
                          loss_kw={"cap_logit_scale": 50.0}, opts=("sgd", "lion"),
                          want_launches={LSE: 2 * LAYERS, BWD: 2 * LAYERS})
    return {"launches": launches, "frozen": len(frozen), "checks": checks}


def remat_steps(label: str, model_name: str, batch_size: int, remat: bool, steps: int):
    """``steps`` bench-workload steps of ``model_name`` with or without
    remat from the seeded state, each ending in a synchronize: the flat
    buffers after step 2 (copied to the host), the launches of all steps,
    the median step ms of steps 3 on, the peak memory and (loss, grad norm)
    per step."""
    import torch

    from spatial_clip_tpu_torch.bench import make_trainer, synthetic_batch

    torch.cuda.empty_cache()
    trainer = make_trainer(model_name, remat=remat)
    data = synthetic_batch(trainer.model, batch_size)
    state = trainer.init_state()
    counters = every_counter()
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, history, flat = [], [], None
    for i in range(steps):
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, data)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        history.append((float(metrics["loss"]), float(metrics["grad_norm"])))
        if i == 1:
            flat = {k: v.cpu() for k, v in state.flat.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = read_launches(counters)
    if not all(np.isfinite([v for pair in history for v in pair])):
        raise AssertionError(f"[{label}] non-finite loss or grad norm: {history}")
    del trainer, data, state
    torch.cuda.empty_cache()
    return flat, launches, statistics.median(step_ms[2:]), peak, history


def remat_phase() -> dict:
    """43. Activation checkpointing: ViT-L-14-336 at batch 32 (phase 36's
    step) with and without ``remat``: params, mu and nu after 2 steps the
    same bits, exact launches (the forward-lse ones doubled by the
    recompute), step ms and peak memory of both; then ViT-B-32 at batch 256
    under remat: 48 forward-lse and 24 backward launches a step, step ms
    and peak memory."""
    import torch

    out = {}
    per_step = {"attention_long.fused_attention_long_lse": 24, "attention_long.long_bwd_dq": 24,
                "attention_long.long_bwd_dkdv": 24, "attention_long.long_db": 24, LSE: 12,
                BWD: 12}
    runs = {}
    for remat in (False, True):
        want = {k: n * (2 if remat and "lse" in k else 1) * REMAT_STEPS
                for k, n in per_step.items()}
        flat, launches, ms, peak, history = remat_steps(
            "remat", "ViT-L-14-336", VITL336_BATCH, remat, REMAT_STEPS)
        if launches != want:
            raise AssertionError(f"[remat] ViT-L-14-336 remat={remat} launches {launches}, "
                                 f"want {want}")
        runs[remat] = dict(flat=flat, launches=launches, ms=ms, peak=peak)
    same = {k: torch.equal(runs[False]["flat"][k], runs[True]["flat"][k])
            for k in ("params", "mu", "nu")}
    diffs = {k: (runs[False]["flat"][k].float() - runs[True]["flat"][k].float()).abs().max()
             .item() for k in same}
    ratio = runs[True]["ms"] / runs[False]["ms"]
    print(f"[remat] ViT-L-14-336 bf16 batch {VITL336_BATCH}, {REMAT_STEPS} steps each: "
          f"without remat {runs[False]['ms']:.3f} ms a step (median of steps 3-"
          f"{REMAT_STEPS}), {runs[False]['peak']:.3f} GiB; with remat {runs[True]['ms']:.3f} ms "
          f"({ratio:.3f}x), {runs[True]['peak']:.3f} GiB "
          f"({runs[True]['peak'] / runs[False]['peak']:.3f}x); "
          f"launches with remat {runs[True]['launches']}; after 2 steps the same bits "
          f"{same} (max abs differences {diffs})", flush=True)
    if not all(same.values()):
        raise AssertionError(f"[remat] remat and plain differ after 2 steps: {diffs}")
    out["vitl336"] = {k: {kk: vv for kk, vv in v.items() if kk != "flat"}
                      for k, v in runs.items()}
    del runs
    want = {LSE: 2 * 2 * LAYERS * REMAT_STEPS, BWD: 2 * LAYERS * REMAT_STEPS}
    _, launches, ms, peak, history = remat_steps("remat-b32", "ViT-B-32", TRAIN_BATCH, True,
                                                 REMAT_STEPS)
    if launches != want:
        raise AssertionError(f"[remat] ViT-B-32 launches {launches}, want {want}")
    print(f"[remat] ViT-B-32 bf16 batch {TRAIN_BATCH} under remat, {REMAT_STEPS} steps: launches "
          f"{launches} (forward-lse doubled by the recompute); {ms:.3f} ms a step, "
          f"{peak:.3f} GiB; losses finite {history[0][0]:.4f} -> {history[-1][0]:.4f}",
          flush=True)
    out["vitb32"] = {"launches": launches, "ms": ms, "peak": peak}
    return out


def debug_phase() -> dict:
    """44. The debug presets and the sweep on the card: ``.train
    experiment=smoke_synthetic debug=default`` runs, and with its trainer a
    batch holding a NaN tile raises FloatingPointError (a trainer without
    the preset takes the same batch to a NaN loss); ``debug=profiler`` on
    ``data=synthetic`` (ViT-B-32, 2 steps) writes a trace under
    ``<output_dir>/profile`` whose kernels include the attention forward
    and backward; ``cli.sweep --mode grid`` runs 2 trials of
    ``experiment=smoke_synthetic`` and none fails."""
    import torch

    from spatial_clip_tpu_torch.cli import sweep
    from spatial_clip_tpu_torch.train import entry
    from spatial_clip_tpu_torch.train.loop import Trainer

    root = scratch_root("debug_")
    try:
        t0 = time.perf_counter()
        cfg = entry.compose_train(["experiment=smoke_synthetic", "debug=default",
                                   f"paths.root_dir={root / 'default'}"])
        _, objects = entry.train(cfg)
        trainer, state = objects["trainer"], objects["state"]
        batch = trainer._device_batch(next(iter(objects["datamodule"].train_dataloader())))
        images = batch["images"].float() / 255.0
        images[0, 0, 0, 0] = float("nan")
        nan_batch = {**batch, "images": images}
        try:
            trainer.train_step(state, nan_batch)
            raised = None
        except FloatingPointError as e:
            raised = str(e)
        plain = Trainer(trainer.model, trainer.loss, type(trainer.cfg)(augment=False))
        _, m = plain.train_step(plain.init_state(), nan_batch)
        if raised is None or not np.isnan(float(m["loss"])):
            raise AssertionError(f"[debug] NaN tile under debug=default: {raised}; without: "
                                 f"loss {float(m['loss'])}")
        print(f"[debug] .train experiment=smoke_synthetic debug=default on the card: "
              f"{state.step} steps; a NaN tile then raises FloatingPointError ({raised!r}), "
              f"without the preset the step runs to loss {float(m['loss'])}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

        t0 = time.perf_counter()
        cfg = entry.compose_train(["data=synthetic", "debug=profiler",
                                   f"paths.root_dir={root / 'profiler'}"])
        entry.train(cfg)
        traces = list((Path(cfg["paths"]["output_dir"]) / "profile").glob("*.pt.trace.json"))
        events = json.loads(traces[0].read_text())["traceEvents"] if len(traces) == 1 else []
        kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
        attention = sorted({m.group(0) for k in kernels
                            for m in [re.search(r"attn_(fwd|bwd)_kernel", k)] if m})
        if attention != ["attn_bwd_kernel", "attn_fwd_kernel"]:
            raise AssertionError(f"[debug] profiler traces {traces}: {len(kernels)} kernel "
                                 f"names, attention {attention}")
        print(f"[debug] .train data=synthetic debug=profiler: trace "
              f"{traces[0].name} ({traces[0].stat().st_size} B, {len(kernels)} distinct kernel "
              f"names, the port's attention kernels {attention}); "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

        t0 = time.perf_counter()
        summary = sweep.main(["--mode", "grid", "--param",
                              "optimizer.learning_rate=choice:0.001,0.0001", "--out",
                              str(root / "sweep.json"), "--", "experiment=smoke_synthetic",
                              f"paths.root_dir={root / 'sweep'}"])
        results = summary["results"]
        if len(results) != 2 or any("error" in r for r in results):
            raise AssertionError(f"[debug] sweep {summary}")
        print(f"[debug] cli.sweep --mode grid, 2 trials of experiment=smoke_synthetic on the "
              f"card: values {[round(r['value'], 4) for r in results]}, none failed; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    return {"trace_kernels": len(kernels), "attention": attention}


if __name__ == "__main__":
    sys.exit(main())
