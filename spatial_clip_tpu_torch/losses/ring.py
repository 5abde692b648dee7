"""The ring spatial loss: O(local B) memory at any global batch (counterpart
of ``spatial_clip_tpu.losses.ring``).

Each rank keeps its feature shard; the other tower's shards pass around the
ring of ranks (:func:`~spatial_clip_tpu_torch.parallel.collectives.shift`,
point to point), while each rank keeps an online log-sum-exp and the
label-weighted sums of its local rows. No (B, N) logit matrix exists: a step
scores one (B, B) block. The soft labels are rebuilt per block from tile ids
(the fused kernels' semantics: the diagonal is matched by tile id). The
gradients flow back through the chain of exchanges, as through JAX's
``ppermute``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from spatial_clip_tpu_torch.parallel.collectives import Group, mean_over_ranks, rank_size, shift


def _block_labels(row_gt_ids, blk_ids, nbr, alphas):
    """(B, Bblk) unnormalized labels: 1 where a column's id is the row's own,
    plus ``alphas`` where it is a neighbor's."""
    labels = (blk_ids[None, :] == row_gt_ids[:, None]).float()
    return labels + ((blk_ids[None, None, :] == nbr[:, :, None]).float()
                     * alphas[:, :, None]).sum(dim=1)


def _ring_direction(rows, blk, blk_ids, row_gt_ids, nbr, alphas, s_eff, group: Group):
    """Each local row's soft cross-entropy against every rank's block of
    columns, the blocks arriving one ring step at a time."""
    n = rank_size(group)[1]
    m = torch.full((rows.shape[0], 1), -1e30, dtype=torch.float32, device=rows.device)
    s = torch.zeros_like(m)
    t = torch.zeros_like(m)
    mass = torch.zeros_like(m)
    for step in range(n):
        if step:
            blk, blk_ids = shift(blk, group), shift(blk_ids, group)
        z = (rows @ blk.T).float() * s_eff
        labels = _block_labels(row_gt_ids, blk_ids, nbr, alphas)
        m_new = torch.maximum(m, z.max(dim=1, keepdim=True).values)
        s = s * torch.exp(m - m_new) + torch.exp(z - m_new).sum(dim=1, keepdim=True)
        m = m_new
        t = t + (z * labels).sum(dim=1, keepdim=True)
        mass = mass + labels.sum(dim=1, keepdim=True)
    lse = m + torch.log(s.clamp_min(1e-30))
    return (lse - t / mass.clamp_min(1e-12))[:, 0]


def _single_block(z, col_ids, row_ids, nbr, alphas):
    labels = _block_labels(row_ids, col_ids, nbr, alphas)
    labels = labels / labels.sum(dim=1, keepdim=True).clamp_min(1e-12)
    return -(F.log_softmax(z, dim=1) * labels).sum(dim=1)


def ring_spatial_loss(image_features: torch.Tensor, text_features: torch.Tensor,
                      logit_scale: torch.Tensor, image_tile_ids: torch.Tensor,
                      text_tile_ids: torch.Tensor, neighbor_tile_ids: torch.Tensor,
                      neighbor_alphas: torch.Tensor, logit_bias: Optional[torch.Tensor] = None,
                      group: Group = None, cap_logit_scale: Optional[float] = None,
                      neighbor_alpha_scale: float = 1.0, **_unused) -> Dict[str, torch.Tensor]:
    """The spatial multi-positive loss by ring rotation: alphas below 0, and
    those of padding ids (< 0), weigh nothing; each row's positive is the
    column with its own tile id (unique ids in the global batch assumed, as
    in the fused kernel). Without a group, one block: the in-batch loss.
    ``logit_bias`` is accepted and unused, as in the JAX package."""
    s_eff = logit_scale
    if cap_logit_scale is not None:
        s_eff = logit_scale + (torch.clamp(logit_scale, max=cap_logit_scale)
                               - logit_scale).detach()
    alphas = torch.clamp(neighbor_alphas.float() * neighbor_alpha_scale, min=0.0)
    alphas = torch.where(neighbor_tile_ids >= 0, alphas, torch.zeros_like(alphas))
    nbr = neighbor_tile_ids.long()
    img_ids, txt_ids = image_tile_ids.long(), text_tile_ids.long()
    if group is None:
        z_i = (image_features @ text_features.T).float() * s_eff
        z_t = (text_features @ image_features.T).float() * s_eff
        loss_i = _single_block(z_i, txt_ids, img_ids, nbr, alphas)
        loss_t = _single_block(z_t, img_ids, txt_ids, nbr, alphas)
        return {"contrastive_loss": 0.5 * (loss_i.mean() + loss_t.mean())}
    loss_i = _ring_direction(image_features, text_features, txt_ids, img_ids, nbr, alphas,
                             s_eff, group)
    loss_t = _ring_direction(text_features, image_features, img_ids, txt_ids, nbr, alphas,
                             s_eff, group)
    return {"contrastive_loss": mean_over_ranks(0.5 * (loss_i.mean() + loss_t.mean()), group)}
