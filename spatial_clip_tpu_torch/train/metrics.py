"""Retrieval metrics (counterpart of ``spatial_clip_tpu.train.metrics``):
in-batch ``recall_at_k``, the ``ContrastiveMetrics`` accumulator and the
full-split ``clip_retrieval_metrics``."""
from __future__ import annotations

from typing import Dict

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
