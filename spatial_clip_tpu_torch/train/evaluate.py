"""Standalone evaluation helpers (counterpart of
``spatial_clip_tpu.train.evaluate``).

- :func:`encode_gene_bank`: every gene symbol of the HVG list through the
  text tower (the gene-vocab text transformer, or the Gene-MLP tower through
  its vectorizer), batched, L2-normalized.
- :func:`zero_shot_gene_expression`: the zero-shot gene-expression PCC over
  a loader: each image's similarities to the bank against its caption's
  rank-weighted target (``ZeroShotGeneExpressionMetric``).

``params`` is a trainer state's parameters by name (``TrainState.params``),
run through the model with ``torch.func.functional_call``, or None for the
model's own. Nothing here takes a gradient.
"""
from __future__ import annotations

import logging
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Union

import numpy as np
import torch
from torch.func import functional_call

from spatial_clip_tpu_torch.models.transforms import normalize_batch
from spatial_clip_tpu_torch.train.metrics import ZeroShotGeneExpressionMetric

log = logging.getLogger(__name__)


def read_gene_list(path: Union[str, Path]) -> List[str]:
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def run_model(model, params: Optional[Dict[str, torch.Tensor]], images=None,
              text=None) -> Dict[str, torch.Tensor]:
    """``model(images, text)`` without grad, at ``params`` when given."""
    with torch.no_grad():
        if params is None:
            return model(images, text)
        return functional_call(model, params, (images, text))


def encode_gene_bank(model, params, tokenizer: Callable, genes: List[str],
                     batch_size: int = 256) -> np.ndarray:
    """(len(genes), embed_dim) f32 L2-normalized text embeddings, one per
    symbol. The list is padded with ``"PAD"`` to a multiple of
    ``batch_size`` (the gene tokenizer's UNK, the vectorizer's zero row);
    only the first ``len(genes)`` rows are kept."""
    device = model.logit_scale.device
    out = []
    padded = genes + ["PAD"] * ((-len(genes)) % batch_size)
    for i in range(0, len(padded), batch_size):
        tokens = torch.from_numpy(tokenizer(padded[i:i + batch_size])).to(device)
        out.append(run_model(model, params, text=tokens)["text_features"].float().cpu().numpy())
    return np.concatenate(out)[:len(genes)]


def zero_shot_gene_expression(model, params, tokenizer: Callable,
                              hvg_path: Union[str, Path], loader: Iterable,
                              batch_size: int = 256) -> float:
    """The mean over the loader's rows of the Pearson correlation between
    the image's similarities to the gene bank (f32) and its caption's
    rank-weighted target. Batches without ``raw_text`` are skipped; uint8
    images are normalized (OpenAI mean and std) to the model's dtype."""
    genes = read_gene_list(hvg_path)
    if not genes:
        return 0.0
    device = model.logit_scale.device
    bank = torch.from_numpy(encode_gene_bank(model, params, tokenizer, genes,
                                             batch_size)).to(device)
    metric = ZeroShotGeneExpressionMetric(genes=genes)
    state = metric.init(device)
    for batch in loader:
        if "raw_text" not in batch:
            continue
        images = torch.from_numpy(np.asarray(batch["images"])).to(device)
        if images.dtype == torch.uint8:
            images = normalize_batch(images, dtype=model.dtype)
        feats = run_model(model, params, images=images.to(model.dtype))["image_features"]
        state = metric.update(state, feats.float() @ bank.T, batch["raw_text"])
    return metric.compute(state)
