"""Gene-MLP tower against the gene-vocabulary text tower, retrieval by data scale.

    python -m spatial_clip_tpu_torch.gene_scaling_study [--arms gene:8192,text:8192]
        [--epochs 6] [--batch 256] [--generator identity|expression]
        [--device cuda|cpu] [--out reports/gene_scaling.json]

The port's ``scripts/gene_scaling_study.py``. Each arm trains a small CLIP on
a synthetic dataset of ``spots`` spots (64 px tiles, 50-gene sentences over
the 500 synthetic genes) and evaluates retrieval on 512 held-out spots:

- ``gene``: the Gene-MLP tower (``gene_width``, ``gene_layers`` blocks) over
  the :class:`GeneVectorizer`;
- ``linear``: the same tower with no blocks (a bag-of-genes control);
- ``text``: a 4-layer text transformer (width 128, 4 heads) over the
  :class:`GeneTokenizer` (context 56).

The image tower is ViT-Test widened to the script's 64 px, 6 layers, width
128 and 4 heads of 32 (a head width the attention kernels take). bf16
compute, the CLIP loss, AdamW at 1e-3 with a tenth of the steps as warmup,
flip and jitter 0.2 on the device, seed 0. ``--generator expression`` draws
the data from :class:`SyntheticExpressionDataset`. Each arm prints one JSON
line (its loss curve every 200 steps, the val metrics, seconds); the list is
written to ``--out`` after each arm. It runs on the card unless ``--device
cpu`` asks for the CPU.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

VISION = {"image_size": 64, "layers": 6, "width": 128, "patch_size": 16, "heads": 4}
DEFAULT_ARMS = [
    ("gene", 8192, {}),
    ("gene", 32768, {}),
    ("gene", 65536, {}),
    ("gene", 65536, {"gene_width": 512, "gene_layers": 3}),
    ("text", 8192, {}),
    ("text", 65536, {}),
]


def run_arm(tower: str, spots: int, epochs: int, batch: int, gene_width: int = 256,
            gene_layers: int = 2, seed: int = 0, generator: str = "identity",
            device: str = "cuda") -> dict:
    """Train one arm and return its record (also printed as a JSON line)."""
    from spatial_clip_tpu_torch.data.datamodule import DataLoader
    from spatial_clip_tpu_torch.data.datasets.synthetic import (
        SyntheticExpressionDataset,
        SyntheticSpatialDataset,
        synthetic_gene_list,
    )
    from spatial_clip_tpu_torch.losses import make_loss
    from spatial_clip_tpu_torch.models.factory import create_model
    from spatial_clip_tpu_torch.models.tokenizer import GeneTokenizer, GeneVectorizer
    from spatial_clip_tpu_torch.train.loop import Trainer, TrainerConfig

    gene_tower = tower in ("gene", "linear")
    if gene_tower:
        tok = GeneVectorizer(synthetic_gene_list())
    else:
        tok = GeneTokenizer(synthetic_gene_list(), context_length=56)
    ds_cls = SyntheticExpressionDataset if generator == "expression" else SyntheticSpatialDataset
    train_ds = ds_cls(num_samples=spots, image_size=64, k_neighbors=6, sentence_len=50,
                      tokenizer=tok, seed=seed)
    val_ds = ds_cls(num_samples=512, image_size=64, k_neighbors=6, sentence_len=50,
                    tokenizer=tok, seed=seed + 1)
    layers = 0 if tower == "linear" else gene_layers
    if gene_tower:
        towers = {"gene_cfg": {"num_genes": tok.num_genes, "width": gene_width,
                               "layers": layers}}
    else:
        towers = {"text_cfg": {"context_length": 56, "vocab_size": tok.vocab_size,
                               "width": 128, "heads": 4, "layers": 4}}
    model = create_model("ViT-Test", precision="bf16", seed=seed, device=device,
                         training=True, embed_dim=128, vision_cfg=VISION, **towers)
    steps = max(1, spots * epochs // batch)
    trainer = Trainer(model, loss=make_loss("clip"), config=TrainerConfig(
        learning_rate=1e-3, warmup_steps=max(steps // 10, 1), total_steps=steps,
        augment=True, color_jitter=0.2, log_every=10 ** 9, seed=seed))
    loader = DataLoader(train_ds, batch_size=batch, shuffle=True, seed=seed, drop_last=True)
    state = trainer.init_state()
    t0 = time.time()
    it = iter(loader)
    epoch = 0
    losses = []
    for s in range(steps):
        try:
            b = next(it)
        except StopIteration:
            epoch += 1
            loader.set_epoch(epoch)
            it = iter(loader)
            b = next(it)
        state, m = trainer.train_step(state, trainer._device_batch(b))
        if s % 200 == 0 or s == steps - 1:
            losses.append(round(float(m["loss"]), 4))
    elapsed = time.time() - t0
    val = trainer.evaluate(state, DataLoader(val_ds, batch_size=256, shuffle=False))
    out = {
        "tower": tower, "spots": spots, "steps": steps, "epochs": epochs,
        "generator": generator,
        "gene_width": gene_width if gene_tower else None,
        "gene_layers": layers if gene_tower else None,
        "train_loss_curve": losses,
        "val": {k: round(float(v), 4) for k, v in val.items()},
        "elapsed_sec": round(elapsed, 1),
        "device": device,
    }
    print(json.dumps(out), flush=True)
    return out


def parse_arms(spec: str):
    """``tower:spots[:width:layers],...`` -> [(tower, spots, kwargs)]."""
    arms = []
    for part in spec.split(","):
        fields = part.strip().split(":")
        kw = {}
        if len(fields) >= 4:
            kw = {"gene_width": int(fields[2]), "gene_layers": int(fields[3])}
        arms.append((fields[0], int(fields[1]), kw))
    return arms


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--generator", default="identity", choices=("identity", "expression"))
    ap.add_argument("--arms", default=None,
                    help="comma list tower:spots[:width:layers], e.g. 'gene:65536,text:65536'")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", type=Path, default=Path("reports/gene_scaling.json"))
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("no CUDA GPU: pass --device cpu to run on the CPU")
    arms = parse_arms(args.arms) if args.arms else DEFAULT_ARMS
    results = []
    for tower, spots, kw in arms:
        results.append(run_arm(tower, spots, args.epochs, args.batch,
                               generator=args.generator, device=args.device, **kw))
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
