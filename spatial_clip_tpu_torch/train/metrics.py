"""In-batch retrieval metrics (counterpart of ``spatial_clip_tpu.train.metrics``,
its ``recall_at_k``)."""
from __future__ import annotations

import torch


def recall_at_k(logits: torch.Tensor, targets: torch.Tensor, k: int) -> torch.Tensor:
    """Fraction of rows whose target column ranks in the top k: the number
    of columns scoring strictly higher is below ``min(k, n_cols)``."""
    k_eff = min(k, logits.shape[1])
    target_scores = logits.gather(1, targets[:, None])
    rank = (logits > target_scores).sum(dim=1)
    return (rank < k_eff).float().mean()
