"""Embed a whole dataset split with a trained model (counterpart of
``spatial_clip_tpu.cli.embed``): every tile and gene sentence to an
L2-normalized vector, saved as ``.npz`` (``tile_ids``,
``image_embeddings``, ``text_embeddings``), and with ``--parquet`` also as
a parquet table, for retrieval indexes or downstream probing.

    python -m spatial_clip_tpu_torch.cli.embed --model ViT-B-32 \
        --ckpt logs/run/checkpoints --data /data/processed/hest_v1 \
        --dataset-type shards --split train --out embeddings.npz

``--ckpt`` takes a checkpoint directory (its newest ``step_N``), one
``step_N`` directory (its ``state.pt``), a JAX-layout ``params.npz`` or a
weights file. The towers run eagerly, so the last partial batch is encoded
as it is (the JAX package pads it to the batch size for its jitted shapes).
``--synthetic-num-samples`` sizes the synthetic split (the JAX package's
CLI leaves it at the dataset's default, 256, as it does when unset). The run goes on the GPU unless
``--device cpu``; with no GPU it raises.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


def load_weights(model, ckpt) -> None:
    """Load ``ckpt`` (see the module docstring) into ``model``."""
    from spatial_clip_tpu_torch.models.factory import load_checkpoint
    from spatial_clip_tpu_torch.train.checkpoints import (
        STATE_FILE,
        CheckpointManager,
        state_file_params,
    )

    p = Path(ckpt)
    if p.is_dir() and any(p.glob("step_*")):
        p = p / f"step_{CheckpointManager(p).latest_step()}"
    if p.is_dir() and (p / STATE_FILE).is_file():
        model.load_state_dict(state_file_params(p))
    else:
        load_checkpoint(model, p)


def main(argv=None):
    import torch

    from spatial_clip_tpu_torch.cli.main_train import resolve_device
    from spatial_clip_tpu_torch.data.datamodule import DataLoader
    from spatial_clip_tpu_torch.data.datasets import create_spatial_dataset
    from spatial_clip_tpu_torch.models.factory import (
        create_model_and_transforms,
        get_tokenizer,
    )
    from spatial_clip_tpu_torch.models.transforms import normalize_batch

    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="ViT-B-32")
    ap.add_argument("--precision", default="bf16")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--data", required=True)
    ap.add_argument("--dataset-type", default="shards",
                    choices=["shards", "parquet", "synthetic", "csv"])
    ap.add_argument("--split", default="train")
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--k-neighbors", type=int, default=1)
    ap.add_argument("--gene-vocab", default=None)
    ap.add_argument("--out", default="embeddings.npz")
    ap.add_argument("--parquet", action="store_true", help="also write .parquet")
    ap.add_argument("--synthetic-num-samples", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the towers run; cuda raises without a GPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    model, _, pp_val = create_model_and_transforms(args.model, precision=args.precision,
                                                   device=device)
    if args.ckpt:
        load_weights(model, args.ckpt)
    tokenizer = get_tokenizer(model.model_name, gene_vocab=args.gene_vocab)
    fmt = {"shards": "shards_v1", "parquet": "parquet_v1"}.get(args.dataset_type,
                                                                args.dataset_type)
    format_kwargs = ({"num_samples": args.synthetic_num_samples}
                     if args.synthetic_num_samples and fmt == "synthetic" else {})
    ds = create_spatial_dataset(
        format_name=fmt, data_dir=Path(args.data), split_name=args.split, split_spec=args.split,
        k_neighbors=args.k_neighbors, preprocess_fn=pp_val, tokenizer=tokenizer,
        format_kwargs=format_kwargs)
    loader = DataLoader(ds, batch_size=args.batch_size, shuffle=False, drop_last=False,
                        num_workers=args.workers)

    tile_ids, img_out, txt_out = [], [], []
    t0 = time.time()
    n = 0
    with torch.inference_mode():
        for batch in loader:
            images = torch.from_numpy(batch["images"]).to(device)
            images = (normalize_batch(images, dtype=model.dtype) if images.dtype == torch.uint8
                      else images.to(model.dtype))
            texts = torch.from_numpy(np.asarray(batch["texts"])).to(device)
            img_out.append(model.encode_image(images).float().cpu().numpy())
            txt_out.append(model.encode_text(texts).float().cpu().numpy())
            tile_ids.append(np.asarray(batch["image_tile_ids"]))
            n += len(batch["image_tile_ids"])
    elapsed = time.time() - t0
    tile_ids = np.concatenate(tile_ids)
    img_emb = np.concatenate(img_out)
    txt_emb = np.concatenate(txt_out)
    np.savez(args.out, tile_ids=tile_ids, image_embeddings=img_emb, text_embeddings=txt_emb)
    if args.parquet:
        import pandas as pd

        df = pd.DataFrame({
            "tile_id": tile_ids,
            "image_embedding": list(img_emb.astype(np.float32)),
            "text_embedding": list(txt_emb.astype(np.float32)),
        })
        df.to_parquet(Path(args.out).with_suffix(".parquet"))
    stats = {"n": int(n), "dim": int(img_emb.shape[1]),
             "pairs_per_sec": round(n / max(elapsed, 1e-9), 1), "out": args.out}
    print(json.dumps(stats))
    return stats


if __name__ == "__main__":
    main(sys.argv[1:])
