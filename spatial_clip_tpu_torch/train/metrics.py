"""Metrics (counterpart of ``spatial_clip_tpu.train.metrics``): in-batch
``recall_at_k``, the ``ContrastiveMetrics`` accumulator, the full-split
``clip_retrieval_metrics``, and the zero-shot gene-expression Pearson
correlation (``rank_weighted_vectors``, ``pearson_rows``,
``ZeroShotGeneExpressionMetric``)."""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def recall_at_k(logits: torch.Tensor, targets: torch.Tensor, k: int) -> torch.Tensor:
    """Fraction of rows whose target column ranks in the top k: the number
    of columns scoring strictly higher is below ``min(k, n_cols)``."""
    k_eff = min(k, logits.shape[1])
    target_scores = logits.gather(1, targets[:, None])
    rank = (logits > target_scores).sum(dim=1)
    return (rank < k_eff).float().mean()


class ContrastiveMetrics:
    """R@1/5/10 accumulator whose state is device sums (``correct@k``,
    ``total``); read back only in :meth:`compute`."""

    KS = (1, 5, 10)

    def init(self, device=None) -> Dict[str, torch.Tensor]:
        state = {f"correct@{k}": torch.zeros((), device=device) for k in self.KS}
        state["total"] = torch.zeros((), device=device)
        return state

    def update(self, state: Dict[str, torch.Tensor], logits: torch.Tensor,
               targets: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Counts rows whose target has fewer than ``min(k, n_cols)`` columns
        scoring strictly higher."""
        new = dict(state)
        rank = (logits > logits.gather(1, targets[:, None])).sum(dim=1)
        for k in self.KS:
            k_eff = min(k, logits.shape[1])
            new[f"correct@{k}"] = state[f"correct@{k}"] + (rank < k_eff).sum()
        new["total"] = state["total"] + logits.shape[0]
        return new

    def compute(self, state: Dict[str, torch.Tensor]) -> Dict[str, float]:
        total = max(float(state["total"]), 1.0)
        return {f"R@{k}": float(state[f"correct@{k}"]) / total for k in self.KS}


def clip_retrieval_metrics(image_features: np.ndarray,
                           text_features: np.ndarray) -> Dict[str, float]:
    """Full-split retrieval in both directions: the 0-based rank of each
    row's own column is the number of columns scoring strictly higher; mean
    and median rank (1-based) and R@1/5/10 as ``rank < k`` (no clamp to the
    number of columns)."""
    logits_i = np.asarray(image_features) @ np.asarray(text_features).T
    out: Dict[str, float] = {}
    gt = np.arange(logits_i.shape[0])
    for name, logits in (("image_to_text", logits_i), ("text_to_image", logits_i.T)):
        ranking = (logits > logits[gt, gt][:, None]).sum(axis=1)
        out[f"{name}_mean_rank"] = float(ranking.mean() + 1)
        out[f"{name}_median_rank"] = float(np.floor(np.median(ranking)) + 1)
        for k in (1, 5, 10):
            out[f"{name}_R@{k}"] = float((ranking < k).mean())
    return out


def rank_weighted_vectors(captions: Sequence[str], gene_to_idx: Dict[str, int],
                          num_genes: int) -> np.ndarray:
    """Caption -> rank-weighted expression target (B, num_genes) f32: the
    gene at rank r of an n-gene caption weighs ``1 - 0.8 r / n``. Symbols
    are matched exactly (not upper-cased, unlike the GeneVectorizer), split
    on whitespace."""
    out = np.zeros((len(captions), num_genes), dtype=np.float32)
    for i, caption in enumerate(captions):
        genes = caption.split()
        n = len(genes)
        for rank, gene in enumerate(genes):
            idx = gene_to_idx.get(gene)
            if idx is not None:
                out[i, idx] = 1.0 - (0.8 * rank / max(n, 1))
    return out


def pearson_rows(preds: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-row Pearson correlation; 0 where the product of the rows'
    centred norms is at most 1e-6 (a constant row)."""
    p = preds - preds.mean(dim=1, keepdim=True)
    t = targets - targets.mean(dim=1, keepdim=True)
    num = (p * t).sum(dim=1)
    den = p.square().sum(dim=1).sqrt() * t.square().sum(dim=1).sqrt()
    return torch.where(den > 1e-6, num / den.clamp_min(1e-6), torch.zeros_like(num))


class ZeroShotGeneExpressionMetric:
    """Zero-shot gene-expression PCC through a gene bank of text embeddings:
    ``update(state, image_features @ bank.T, raw_texts)`` adds each row's
    Pearson correlation between its logits over the genes and its caption's
    rank-weighted target; the state is device sums (``sum_pcc``,
    ``total``), read back only in :meth:`compute`."""

    def __init__(self, global_hvg_path: Optional[str] = None,
                 genes: Optional[List[str]] = None):
        if genes is None and global_hvg_path:
            with open(global_hvg_path) as f:
                genes = [line.strip() for line in f if line.strip()]
        self.genes = genes or []
        self.gene_to_idx = {g: i for i, g in enumerate(self.genes)}
        self.num_global_genes = len(self.genes)

    def init(self, device=None) -> Dict[str, torch.Tensor]:
        return {"sum_pcc": torch.zeros((), device=device), "total": torch.zeros((), device=device)}

    def update(self, state: Dict[str, torch.Tensor], preds_logits: torch.Tensor,
               captions: Sequence[str]) -> Dict[str, torch.Tensor]:
        if self.num_global_genes == 0:
            return state
        targets = torch.from_numpy(
            rank_weighted_vectors(captions, self.gene_to_idx, self.num_global_genes)
        ).to(preds_logits.device)
        pcc = pearson_rows(preds_logits.float(), targets)
        return {"sum_pcc": state["sum_pcc"] + pcc.sum(), "total": state["total"] + pcc.shape[0]}

    def compute(self, state: Dict[str, torch.Tensor]) -> float:
        total = float(state["total"])
        return float(state["sum_pcc"]) / total if total > 0 else 0.0
