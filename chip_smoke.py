#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA GPU, ``nvcc`` and
PyTorch built for CUDA. Each phase prints one line; any failure raises and
the exit code is not 0. No JAX is imported.

1. device  the card's name and power limit, as nvidia-smi reports them
2. build   the CUDA kernels, compiled from spatial_clip_tpu_torch/csrc
3. kernel  each kernel against its plain PyTorch version at the serving
           shapes: max abs error against the stated tolerance, median times
4. serve   the ViT-B-32 embedding server (bf16, batch 64) on 127.0.0.1
           answers text and raw-image requests; every attention of the run
           went through the kernel (12 launches per encoder batch), and the
           embeddings agree with the same weights run in f32 on the CPU
5. timing  median encode time per batch of 64 tiles and of 64 texts, and the
           median latency of a 64-tile request through the server
6. kernel-train  the training attention kernels (forward with logsumexp,
           backward with the bias gradient) against their plain versions at
           the two batch-256 training shapes and one f32 shape
7. train-check  one ViT-B-32 train step's loss and gradients at batch 32 on
           the card (bf16, kernels) against the CPU (f32, plain path), on the
           same weights, batch and augmentation draws
8. train   the ViT-B-32 spatial train step (bf16, batch 256, full depth, the
           workload of ``python -m spatial_clip_tpu_torch.bench``): 3 warmup
           and 10 timed steps, finite losses and gradient norms, 24 forward
           and 24 backward attention launches per step; median step ms,
           pairs/s and peak device memory

Then one JSON line with the kernels, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import base64
import json
import re
import statistics
import subprocess
import sys
import threading
import time
from http.client import HTTPConnection

import numpy as np

KERNEL_TOL = {"bfloat16": 2e-2, "float32": 1e-5}  # bf16: ~1 output ulp at |o| < 4
MIN_COSINE = 0.99  # served bf16 embeddings vs the f32 CPU plain path
LAYERS = 12  # ViT-B-32: 12 blocks in each tower, one attention launch each
TRAIN_BATCH, CHECK_BATCH = 256, 32
WARMUP_STEPS, TIMED_STEPS = 3, 10
MAX_LOSS_REL_ERR = 2e-2  # one bf16 train step's loss vs the f32 CPU step
MIN_GRAD_COSINE = 0.99  # its flattened gradient vs the f32 CPU step's


def train_tol(dtype, ref):
    """Training kernels vs their plain versions. f32: summation order only.
    bf16: both round at the same points, so they differ where an f32 sum in
    another order lands on the other side of a bf16 rounding: one bf16 step
    (2^-8) of the output's largest magnitude (dq sums L terms, so its
    magnitude, not 1, sets the step)."""
    import torch

    scale = ref.abs().max().item()
    return 2e-5 * max(1.0, scale) if dtype == torch.float32 else 2 ** -8 * scale


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
          f"(nvcc sm_90a); ptxas: registers {regs}, spill stores {spills} B", flush=True)

    # 3. kernel vs plain version on the card
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [  # name, B, L, D, heads, causal, dtype
        ("image", 64, 50, 768, 12, False, torch.bfloat16),
        ("text", 64, 77, 512, 8, True, torch.bfloat16),
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
        err = (out.float() - ref.float()).abs().max().item()
        if not err <= tol:
            raise AssertionError(f"[kernel] {name}: max abs err {err} > {tol}")
        ms = median_ms(lambda: fused_attention(qkv, mask, H))
        plain_ms = median_ms(lambda: reference_attention(qkv, mask, H))
        gbs = (qkv.numel() + out.numel()) * qkv.element_size() / ms / 1e6
        kernel_rows[name] = dict(err=err, ms=ms, plain_ms=plain_ms)
        print(f"[kernel] fused_attention_fwd {name} qkv {tuple(qkv.shape)} {str(dtype)[6:]} "
              f"mask={'causal' if causal else 'none'}: max abs err {err:.3g} (tol {tol:g}); "
              f"kernel {ms:.4f} ms ({gbs:.0f} GB/s of qkv+out) vs plain {plain_ms:.4f} ms",
              flush=True)

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

    image = kernel_rows["image"]
    at_train = "qkv (256, 50, 2304) bf16, no mask (image tower, batch 256)"
    print(json.dumps({"kernels": [{
        "name": "fused_attention_fwd",
        "route": "cuda",
        "source": "spatial_clip_tpu_torch/csrc/fused_attention_fwd.cu",
        "replaces": "spatial_clip_tpu/ops/fused_attention.py:267",
        "launches": launches,
        "max_abs_err": max(r["err"] for r in kernel_rows.values()),
        "ms": image["ms"],
        "plain_ms": image["plain_ms"],
        "at": "qkv (64, 50, 2304) bf16, no mask (image tower, batch 64)",
    }, {
        "name": "fused_attention_fwd_lse",
        "route": "cuda",
        "source": "spatial_clip_tpu_torch/csrc/fused_attention_fwd.cu",
        "replaces": "spatial_clip_tpu/ops/fused_attention.py:350",
        "launches": train["lse_launches"],
        "max_abs_err": max(r["fwd_err"] for r in train_rows.values()),
        "ms": train_rows["image"]["fwd_ms"],
        "plain_ms": train_rows["image"]["fwd_plain_ms"],
        "at": at_train,
    }, {
        "name": "fused_attention_bwd",
        "route": "cuda",
        "source": "spatial_clip_tpu_torch/csrc/fused_attention_bwd.cu",
        "replaces": "spatial_clip_tpu/ops/fused_attention.py:436",
        "launches": train["bwd_launches"],
        "max_abs_err": max(r["bwd_err"] for r in train_rows.values()),
        "ms": train_rows["image"]["bwd_ms"],
        "plain_ms": train_rows["image"]["bwd_plain_ms"],
        "at": at_train,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


def kernel_train_phase() -> dict:
    """6. The training kernels against their plain versions on the card."""
    import torch

    from spatial_clip_tpu_torch.models.transformer import causal_mask
    from spatial_clip_tpu_torch.ops.fused_attention import (
        fused_attention_bwd,
        fused_attention_lse,
        reference_attention_bwd,
        reference_attention_lse,
    )

    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [  # name, B, L, D, heads, causal, dtype
        ("image", TRAIN_BATCH, 50, 768, 12, False, torch.bfloat16),
        ("text", TRAIN_BATCH, 77, 512, 8, True, torch.bfloat16),
        ("f32", 8, 77, 512, 8, True, torch.float32),
    ]
    rows = {}
    for name, B, L, D, H, causal, dtype in cases:
        qkv = torch.randn((B, L, 3 * D), generator=gen, device="cuda").to(dtype)
        g = torch.randn((B, L, D), generator=gen, device="cuda").to(dtype)
        mask = causal_mask(L, device="cuda") if causal else None
        out, lse = fused_attention_lse(qkv, mask, H)
        dqkv, db = fused_attention_bwd(qkv, mask, lse, g, H)
        want_out, want_lse = reference_attention_lse(qkv, mask, H)
        want_dqkv, want_db = reference_attention_bwd(qkv, mask, want_lse, g, H)
        torch.cuda.synchronize()
        checks = {  # name: (error, tolerance)
            "out": (out.float() - want_out.float(), train_tol(dtype, want_out.float())),
            "lse": (lse - want_lse, 1e-5 * max(1.0, want_lse.abs().max().item())),
            "dqkv": (dqkv.float() - want_dqkv.float(), train_tol(dtype, want_dqkv.float())),
            "db": (db - want_db, train_tol(dtype, want_db) + 1e-4),
        }
        errs = {k: (d.abs().max().item(), tol) for k, (d, tol) in checks.items()}
        bad = {k: v for k, v in errs.items() if not v[0] <= v[1]}
        if bad:
            raise AssertionError(f"[kernel-train] {name}: max abs err over tolerance {bad}")
        row = dict(
            fwd_err=max(errs["out"][0], errs["lse"][0]),
            bwd_err=max(errs["dqkv"][0], errs["db"][0]),
            fwd_ms=median_ms(lambda: fused_attention_lse(qkv, mask, H)),
            fwd_plain_ms=median_ms(lambda: reference_attention_lse(qkv, mask, H)),
            bwd_ms=median_ms(lambda: fused_attention_bwd(qkv, mask, lse, g, H)),
            bwd_plain_ms=median_ms(lambda: reference_attention_bwd(qkv, mask, lse, g, H)),
        )
        rows[name] = row
        print(f"[kernel-train] {name} qkv {tuple(qkv.shape)} {str(dtype)[6:]} "
              f"mask={'causal' if causal else 'none'}: max abs err (tol) " + ", ".join(
                  f"{k} {e:.3g} ({t:.3g})" for k, (e, t) in errs.items())
              + f"; fwd_lse kernel {row['fwd_ms']:.4f} ms vs plain {row['fwd_plain_ms']:.4f} ms"
              f"; bwd kernel {row['bwd_ms']:.4f} ms vs plain {row['bwd_plain_ms']:.4f} ms",
              flush=True)
    return rows


def train_check_phase():
    """7. One train step's loss and gradients, card (bf16, kernels) vs CPU
    (f32, plain path), on the same weights, batch and augmentation draws.
    Returns the card's trainer for phase 8."""
    import torch

    from spatial_clip_tpu_torch.bench import make_trainer, synthetic_batch
    from spatial_clip_tpu_torch.models.transforms import AugmentDraws

    t0 = time.perf_counter()
    card = make_trainer("ViT-B-32", device="cuda")
    cpu = make_trainer("ViT-B-32", device="cpu", precision="fp32")  # same f32 weights
    card_state, cpu_state = card.init_state(), cpu.init_state()
    batch = synthetic_batch(cpu.model, CHECK_BATCH, seed=1, device="cpu")
    rng = np.random.default_rng(2)
    draws = AugmentDraws(*(torch.from_numpy(d) for d in (
        rng.random(CHECK_BATCH) < 0.5,
        (1.0 + rng.uniform(-0.2, 0.2, CHECK_BATCH)).astype(np.float32),
        (1.0 + rng.uniform(-0.2, 0.2, CHECK_BATCH)).astype(np.float32))))
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
            f"[train-check] loss card {loss_card.item()} cpu {loss_cpu.item()} (rel {rel}), "
            f"grad cosine {cos_all}, qkv-bias grad cosine {cos_bias}, finite {finite}")
    print(f"[train-check] ViT-B-32 batch {CHECK_BATCH}, one step, same weights/batch/draws: "
          f"loss card bf16 {loss_card.item():.6f} vs CPU f32 {loss_cpu.item():.6f} "
          f"(rel err {rel:.3g} <= {MAX_LOSS_REL_ERR}); flattened gradient cosine "
          f"{cos_all:.6f} (>= {MIN_GRAD_COSINE}); qkv-bias gradient cosine q "
          f"{cos_bias['q']:.6f} v {cos_bias['v']:.6f} (k {cos_bias['k']:.3f}: zero in exact "
          f"math); {time.perf_counter() - t0:.1f} s", flush=True)
    del cpu, cpu_state
    return card


def train_phase(trainer) -> dict:
    """8. The main training path: the bench workload's train step at batch 256."""
    import torch

    from spatial_clip_tpu_torch.bench import synthetic_batch
    from spatial_clip_tpu_torch.ops.fused_attention import (
        fused_attention,
        fused_attention_bwd,
        fused_attention_lse,
    )

    state = trainer.init_state()
    batch = synthetic_batch(trainer.model, TRAIN_BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for counter in (fused_attention, fused_attention_lse, fused_attention_bwd):
        counter.launches = 0
    step_ms, history = [], []
    for _ in range(WARMUP_STEPS + TIMED_STEPS):
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        history.append((metrics["loss"], metrics["grad_norm"]))
    counts = (fused_attention.launches, fused_attention_lse.launches,
              fused_attention_bwd.launches)
    peak = torch.cuda.max_memory_allocated()
    steps = WARMUP_STEPS + TIMED_STEPS
    want = (0, 2 * LAYERS * steps, 2 * LAYERS * steps)
    if counts != want:
        raise AssertionError(f"[train] launches (fwd, fwd_lse, bwd) {counts}, want {want}")
    losses = [float(l) for l, _ in history]
    norms = [float(n) for _, n in history]
    if not all(np.isfinite(losses + norms)):
        raise AssertionError(f"[train] non-finite loss or grad norm: {losses} {norms}")
    med = statistics.median(step_ms[WARMUP_STEPS:])
    print(f"[train] ViT-B-32 bf16 batch {TRAIN_BATCH}, 12+12 layers, bench workload: "
          f"{steps} steps, launches fwd_lse {counts[1]} bwd {counts[2]} "
          f"(= 2 x {LAYERS} per step, inference fwd {counts[0]}); losses finite "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, grad norms finite {norms[0]:.4f} -> "
          f"{norms[-1]:.4f}; median step {med:.3f} ms over {TIMED_STEPS} "
          f"({TRAIN_BATCH * 1e3 / med:.1f} pairs/s); max_memory_allocated "
          f"{peak / 2 ** 30:.3f} GiB", flush=True)
    return {"lse_launches": counts[1], "bwd_launches": counts[2], "step_ms": med}


if __name__ == "__main__":
    sys.exit(main())
