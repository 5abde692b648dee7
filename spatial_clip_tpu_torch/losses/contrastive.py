"""Contrastive losses (counterpart of ``spatial_clip_tpu.losses.contrastive``).

- :func:`clip_loss`: symmetric InfoNCE.
- :func:`spatial_loss`: multi-positive spatial CLIP loss with soft neighbor
  labels: the dense path (the (B, N) label matrices are built from tile ids
  on the device) and the fused path (``use_fused_kernel``, the kernels of
  ``ops/fused_contrastive.py``, O(B) memory).

Only the single-process case (the JAX package's ``axis_name=None``) is
ported: the inputs are the whole batch.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from spatial_clip_tpu_torch.ops.fused_contrastive import fused_spatial_ce


def _apply_logit_scale(z: torch.Tensor, logit_scale: torch.Tensor,
                       logit_bias: Optional[torch.Tensor], cap_logit_scale: Optional[float],
                       float32_logits: bool) -> torch.Tensor:
    s_eff = logit_scale
    if cap_logit_scale is not None:
        # straight-through cap: the forward uses the clipped scale, the
        # backward sees the raw one
        s_eff = logit_scale + (torch.clamp(logit_scale, max=cap_logit_scale)
                               - logit_scale).detach()
    logits = s_eff * z
    if logit_bias is not None:
        logits = logits + logit_bias
    if float32_logits:
        logits = logits.float()
    return logits


def clip_loss(image_features: torch.Tensor, text_features: torch.Tensor,
              logit_scale: torch.Tensor, logit_bias: Optional[torch.Tensor] = None,
              float32_logits: bool = True) -> Dict[str, torch.Tensor]:
    """Symmetric InfoNCE over the batch."""
    logits_i = _apply_logit_scale(image_features @ text_features.T, logit_scale, logit_bias,
                                  None, float32_logits)
    logits_t = _apply_logit_scale(text_features @ image_features.T, logit_scale, logit_bias,
                                  None, float32_logits)
    labels = torch.arange(image_features.shape[0], device=image_features.device)
    loss_i = -F.log_softmax(logits_i, dim=-1).gather(1, labels[:, None]).mean()
    loss_t = -F.log_softmax(logits_t, dim=-1).gather(1, labels[:, None]).mean()
    return {"contrastive_loss": 0.5 * (loss_i + loss_t)}


def build_spatial_soft_labels(all_tile_ids: torch.Tensor, ground_truth_cols: torch.Tensor,
                              neighbor_tile_ids: torch.Tensor, neighbor_alphas: torch.Tensor,
                              neighbor_alpha_scale: float = 1.0) -> torch.Tensor:
    """Soft-label matrix (B, N): 1 on each row's own column plus
    ``max(alpha_k * scale, 0)`` on every column whose tile id matches
    neighbor k (ids < 0 are padding and weigh nothing; a duplicated id gets
    the weight on every match), rows L1-normalized."""
    N = all_tile_ids.shape[0]
    labels = F.one_hot(ground_truth_cols.long(), N).float()
    alphas = torch.clamp(neighbor_alphas.float() * neighbor_alpha_scale, min=0.0)
    alphas = torch.where(neighbor_tile_ids >= 0, alphas, torch.zeros_like(alphas))
    match = (neighbor_tile_ids[:, :, None].long() == all_tile_ids.long()[None, None, :]).float()
    labels = labels + (match * alphas[:, :, None]).sum(dim=1)
    return labels / labels.sum(dim=1, keepdim=True).clamp_min(1e-12)


def spatial_loss(image_features: torch.Tensor, text_features: torch.Tensor,
                 logit_scale: torch.Tensor, image_tile_ids: torch.Tensor,
                 text_tile_ids: torch.Tensor, neighbor_tile_ids: torch.Tensor,
                 neighbor_alphas: torch.Tensor, logit_bias: Optional[torch.Tensor] = None,
                 cap_logit_scale: Optional[float] = None, temp_reg_weight: float = 0.0,
                 float32_logits: bool = True, neighbor_alpha_scale: float = 1.0,
                 use_fused_kernel: bool = False) -> Dict[str, torch.Tensor]:
    """Multi-positive spatial contrastive loss: soft cross-entropy against
    the L1-normalized neighbor labels in both directions, plus the optional
    temperature regularizer ``temp_reg_weight * gap^2`` with
    ``gap = E_p[z] - E_q[z]`` averaged over the two directions.

    ``use_fused_kernel`` (taken only without ``temp_reg_weight`` and
    ``logit_bias``, as in the JAX package) runs :func:`fused_spatial_ce`,
    which builds the labels from tile ids inside the kernels: the diagonal
    is matched by tile id, so a duplicated id weighs 1 on every column that
    carries it, and neighbor ids < 0 are not masked (they match no column).
    It equals the dense path when the tile ids are unique."""
    B = image_features.shape[0]
    ground_truth = torch.arange(B, device=image_features.device)
    if use_fused_kernel and temp_reg_weight == 0.0 and logit_bias is None:
        s_eff = logit_scale
        if cap_logit_scale is not None:
            s_eff = logit_scale + (torch.clamp(logit_scale, max=cap_logit_scale)
                                   - logit_scale).detach()
        alphas = neighbor_alphas.float() * neighbor_alpha_scale
        nbr = neighbor_tile_ids.to(torch.int32)
        loss_i = fused_spatial_ce(image_features, text_features, text_tile_ids.to(torch.int32),
                                  ground_truth, nbr, alphas, s_eff).mean()
        loss_t = fused_spatial_ce(text_features, image_features, image_tile_ids.to(torch.int32),
                                  ground_truth, nbr, alphas, s_eff).mean()
        return {"contrastive_loss": 0.5 * (loss_i + loss_t)}
    labels_i = build_spatial_soft_labels(text_tile_ids, ground_truth, neighbor_tile_ids,
                                         neighbor_alphas, neighbor_alpha_scale)
    labels_t = build_spatial_soft_labels(image_tile_ids, ground_truth, neighbor_tile_ids,
                                         neighbor_alphas, neighbor_alpha_scale)
    z_i = image_features @ text_features.T
    z_t = text_features @ image_features.T
    logits_i = _apply_logit_scale(z_i, logit_scale, logit_bias, cap_logit_scale, float32_logits)
    logits_t = _apply_logit_scale(z_t, logit_scale, logit_bias, cap_logit_scale, float32_logits)
    loss_i = -(F.log_softmax(logits_i, dim=-1) * labels_i).sum(dim=1).mean()
    loss_t = -(F.log_softmax(logits_t, dim=-1) * labels_t).sum(dim=1).mean()
    total = 0.5 * (loss_i + loss_t)
    if temp_reg_weight > 0:
        p_i, p_t = F.softmax(logits_i, dim=1), F.softmax(logits_t, dim=1)
        z_i32, z_t32 = z_i.float(), z_t.float()
        gap = 0.5 * (((p_i * z_i32).sum(dim=1).mean() - (labels_i * z_i32).sum(dim=1).mean())
                     + ((p_t * z_t32).sum(dim=1).mean() - (labels_t * z_t32).sum(dim=1).mean()))
        total = total + temp_reg_weight * gap ** 2
    return {"contrastive_loss": total}
