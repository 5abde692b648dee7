"""Train-step throughput of the spatial CLIP trainer on one CUDA GPU.

    python -m spatial_clip_tpu_torch.bench [--model ViT-B-32] [--batch 256]
        [--steps 20] [--windows 3] [--warmup 3] [--profile]
        [--zip-towers off|auto|on]
        [--attn-impl auto|pallas|pallas3|pallas_inter|pallas_t|pallas_split]
        [--ln-impl onepass|fp32|pallas] [--ln-gemm-impl dense|pallas]
        [--mlp-impl dense|pallas] [--bwd-fuse db|none|dxdb]

The workload of the repository's ``bench.py``, run by the port (``--model
ViT-B-32-GeneMLP``: with the Gene-MLP tower over 50-gene vectors): ViT-B-32 in
bf16 with f32 parameters, batch 256, on-device flip + color jitter 0.2 and
normalization of uint8 tiles, the spatial loss with the logit scale capped
at 50 and k=6 neighbors drawn from [-1, B), AdamW with warmup 10 and 10,000
total steps, seed 0. The synthetic batch is made once and stays on the
device. After ``--warmup`` steps it times ``--windows`` windows of
``--steps`` steps, each closed by ``torch.cuda.synchronize()``, and prints
one JSON line: pairs/sec/chip from the median window, with ``global_batch``,
``n_chips``, ``step_ms``, ``window_ms`` and the last ``loss``. ``--profile``
adds the device time of one step by kernel family (torch.profiler). The
model settings (``--zip-towers`` and the four ``--*-impl``) go to
``create_model``; left out, each keeps the model config's value.
``--bwd-fuse`` sets ``fused_attention.BWD_FUSE``, the attention backward's
option (JAX's A/B arms ``^db``, ``^nodx``, ``^dx`` of
``scripts/ab_step_time.py``): 'db' (the default) the kernel with the bias
gradient, 'none' the no-db kernel, 'dxdb' the kernel that also forms the
projection's input gradient. Needs a CUDA GPU: there is no CPU fallback.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from spatial_clip_tpu_torch.losses import make_loss
from spatial_clip_tpu_torch.models.config import ATTN_IMPLS
from spatial_clip_tpu_torch.models.factory import create_model
from spatial_clip_tpu_torch.ops import fused_attention
from spatial_clip_tpu_torch.train.loop import Trainer, TrainerConfig

NEIGHBORS = 6
# the model settings the command line passes to create_model, with their values
MODEL_SETTINGS = {
    "zip_towers": ("off", "auto", "on"),
    "attn_impl": ATTN_IMPLS,
    "ln_impl": ("onepass", "fp32", "pallas"),
    "ln_gemm_impl": ("dense", "pallas"),
    "mlp_impl": ("dense", "pallas"),
}


def gene_vectors(rng, batch: int, num_genes: int, length: int = 50) -> np.ndarray:
    """Rank-weighted gene vectors (batch, num_genes) f32 as the
    GeneVectorizer makes them: ``length`` distinct genes a row, the one at
    rank r weighing 1 - 0.8 r / length."""
    out = np.zeros((batch, num_genes), dtype=np.float32)
    weights = 1.0 - 0.8 * np.arange(length) / length
    for row in out:
        row[rng.permutation(num_genes)[:length]] = weights
    return out


def hf_ids(rng, batch: int, length: int, vocab: int, pad: int) -> np.ndarray:
    """Ids for a Hugging Face text tower: drawn in [3, vocab) (inside the
    tower's vocab, past its special ids), each row but the first ending in
    a pad tail of a length of its own."""
    ids = rng.integers(3, vocab, (batch, length), dtype=np.int64)
    for row, start in enumerate(rng.integers(1, length, batch)):
        if row:
            ids[row, start:] = pad
    return ids


def synthetic_batch(model, batch: int, seed: int = 0, device="cuda"):
    """The benchmark's batch, made with numpy from ``seed`` and moved to the
    device once: uint8 tiles, token ids (for a Gene-MLP tower, 50-gene
    rank-weighted vectors; for a Hugging Face tower, :func:`hf_ids` in its
    vocab with pad tails), tile ids 0..B-1, k neighbor ids in [-1, B) and
    their weights in [0, 1)."""
    rng = np.random.default_rng(seed)
    size = int(model.cfg.vision_cfg.size)
    t, g = model.cfg.text_cfg, model.cfg.gene_cfg
    tile_ids = np.arange(batch, dtype=np.int64)
    images = rng.integers(0, 255, (batch, size, size, 3), dtype=np.uint8)
    if g is not None:
        texts = gene_vectors(rng, batch, g.num_genes)
    elif model.hf_text:
        texts = hf_ids(rng, batch, t.context_length, model.text.vocab_size, t.pad_id)
    else:
        texts = rng.integers(0, t.vocab_size, (batch, t.context_length), dtype=np.int64)
    host = {
        "images": images,
        "texts": texts,
        "image_tile_ids": tile_ids,
        "text_tile_ids": tile_ids.copy(),
        "neighbor_tile_ids": rng.integers(-1, batch, (batch, NEIGHBORS)).astype(np.int64),
        "neighbor_alphas": rng.uniform(0, 1, (batch, NEIGHBORS)).astype(np.float32),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in host.items()}


def make_trainer(model_name: str = "ViT-B-32", seed: int = 0, device="cuda",
                 precision: str = "bf16", **cfg_overrides):
    """The benchmark's model (bf16 compute, f32 parameters) and trainer;
    ``cfg_overrides`` (e.g. ``ln_impl='pallas'``) go to ``create_model``."""
    model = create_model(model_name, precision=precision, seed=seed, device=device,
                         training=True, **cfg_overrides)
    cfg = TrainerConfig(warmup_steps=10, total_steps=10_000, augment=True, color_jitter=0.2,
                        log_every=10_000, seed=seed)
    return Trainer(model, loss=make_loss("spatial", cap_logit_scale=50.0), config=cfg)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="ViT-B-32")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--steps", type=int, default=20, help="steps per timed window")
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--profile", action="store_true",
                    help="also print the device time of one step by kernel family")
    for flag, choices in MODEL_SETTINGS.items():
        ap.add_argument(f"--{flag.replace('_', '-')}", choices=choices, default=None)
    ap.add_argument("--bwd-fuse", choices=("db", "none", "dxdb"), default=None,
                    help="the attention backward's option (fused_attention.BWD_FUSE)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("spatial_clip_tpu_torch.bench needs a CUDA GPU")
    settings = {k: getattr(args, k) for k in MODEL_SETTINGS if getattr(args, k) is not None}
    if args.bwd_fuse is not None:
        fused_attention.BWD_FUSE = args.bwd_fuse
    trainer = make_trainer(args.model, **settings)
    state = trainer.init_state()
    batch = synthetic_batch(trainer.model, args.batch)
    for _ in range(args.warmup):
        state, metrics = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    window_ms = []
    for _ in range(args.windows):
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, metrics = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        window_ms.append((time.perf_counter() - t0) * 1e3 / args.steps)
    step_ms = statistics.median(window_ms)
    pairs_per_sec = args.batch * 1e3 / step_ms
    report = {
        "metric": f"HEST tile-spot pairs/sec/chip ({args.model} spatial train step)",
        "value": pairs_per_sec,
        "unit": "pairs/sec/chip",
        "detail": {
            "model": args.model,
            "settings": {**settings, "bwd_fuse": fused_attention.BWD_FUSE},
            "device": torch.cuda.get_device_name(0),
            "global_batch": args.batch,
            "n_chips": 1,
            "step_ms": step_ms,
            "window_ms": window_ms,
            "loss": float(metrics["loss"]),
        },
    }
    if args.profile:
        from spatial_clip_tpu_torch.profile_serving import profile_encode

        def step():
            nonlocal state
            state, _ = trainer.train_step(state, batch)

        report["detail"]["profile"] = profile_encode(step, reps=3)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
