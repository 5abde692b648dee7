"""Contrastive losses (counterpart of ``spatial_clip_tpu.losses.contrastive``).

- :func:`clip_loss`: symmetric InfoNCE.
- :func:`spatial_loss`: multi-positive spatial CLIP loss with soft neighbor
  labels: the dense path (the (B, N) label matrices are built from tile ids
  on the device) and the fused path (``use_fused_kernel``, the kernels of
  ``ops/fused_contrastive.py``, O(B) memory).
- :func:`distill_clip_loss`: InfoNCE plus the soft cross-entropy of the
  student's logits against a frozen teacher's, both ways.
- :func:`siglip_loss`: the pairwise sigmoid loss.

Every loss takes ``group``, the JAX package's ``axis_name``: None means the
inputs are the whole batch; a ``torch.distributed`` process group means they
are this rank's rows of a global batch sharded over the group in rank
order. Then the local rows are scored against every rank's columns
(:func:`gather_features`), the ground truth is shifted by ``B * rank``, and
the returned loss is the mean over the ranks (the global loss, the same
bits on every rank), whose gradient is this rank's local term's: the ranks
average their gradients afterwards (``parallel/collectives.py``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from spatial_clip_tpu_torch.ops.fused_contrastive import fused_spatial_ce
from spatial_clip_tpu_torch.parallel.collectives import (
    Group,
    all_gather,
    all_reduce_sum,
    mean_over_ranks,
    rank_size,
    shift,
)


def gather_features(image_features: torch.Tensor, text_features: torch.Tensor,
                    group: Group) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both towers' features of every rank, in rank order; gradients flow
    back to each rank's rows (summed over the ranks' losses)."""
    return all_gather(image_features, group), all_gather(text_features, group)


def _columns(image_features, text_features, group: Group):
    """The gathered features and the ground-truth shift of this rank's rows."""
    all_img, all_txt = gather_features(image_features, text_features, group)
    return all_img, all_txt, image_features.shape[0] * rank_size(group)[0]


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
              group: Group = None, float32_logits: bool = True) -> Dict[str, torch.Tensor]:
    """Symmetric InfoNCE: local rows against the gathered columns."""
    all_img, all_txt, shift_ = _columns(image_features, text_features, group)
    logits_i = _apply_logit_scale(image_features @ all_txt.T, logit_scale, logit_bias,
                                  None, float32_logits)
    logits_t = _apply_logit_scale(text_features @ all_img.T, logit_scale, logit_bias,
                                  None, float32_logits)
    labels = torch.arange(image_features.shape[0], device=image_features.device) + shift_
    loss_i = -F.log_softmax(logits_i, dim=-1).gather(1, labels[:, None]).mean()
    loss_t = -F.log_softmax(logits_t, dim=-1).gather(1, labels[:, None]).mean()
    return {"contrastive_loss": mean_over_ranks(0.5 * (loss_i + loss_t), group)}


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
                 group: Group = None, cap_logit_scale: Optional[float] = None,
                 temp_reg_weight: float = 0.0, float32_logits: bool = True,
                 neighbor_alpha_scale: float = 1.0,
                 use_fused_kernel: bool = False) -> Dict[str, torch.Tensor]:
    """Multi-positive spatial contrastive loss: soft cross-entropy against
    the L1-normalized neighbor labels in both directions, plus the optional
    temperature regularizer ``temp_reg_weight * gap^2`` with
    ``gap = E_p[z] - E_q[z]`` averaged over the two directions (and over
    the ranks). Neighbor ids index the gathered tile ids.

    ``use_fused_kernel`` (taken only without ``temp_reg_weight`` and
    ``logit_bias``, as in the JAX package) runs :func:`fused_spatial_ce`
    on the local rows against the gathered columns, which builds the labels
    from tile ids inside the kernels: the diagonal is matched by tile id, so
    a duplicated id weighs 1 on every column that carries it, and neighbor
    ids < 0 are not masked (they match no column). It equals the dense path
    when the tile ids are unique."""
    B = image_features.shape[0]
    all_img, all_txt, shift_ = _columns(image_features, text_features, group)
    all_img_ids, all_txt_ids = all_gather(image_tile_ids, group), all_gather(text_tile_ids, group)
    ground_truth = torch.arange(B, device=image_features.device) + shift_
    if use_fused_kernel and temp_reg_weight == 0.0 and logit_bias is None:
        s_eff = logit_scale
        if cap_logit_scale is not None:
            s_eff = logit_scale + (torch.clamp(logit_scale, max=cap_logit_scale)
                                   - logit_scale).detach()
        alphas = neighbor_alphas.float() * neighbor_alpha_scale
        nbr = neighbor_tile_ids.to(torch.int32)
        loss_i = fused_spatial_ce(image_features, all_txt, all_txt_ids.to(torch.int32),
                                  ground_truth, nbr, alphas, s_eff).mean()
        loss_t = fused_spatial_ce(text_features, all_img, all_img_ids.to(torch.int32),
                                  ground_truth, nbr, alphas, s_eff).mean()
        return {"contrastive_loss": mean_over_ranks(0.5 * (loss_i + loss_t), group)}
    labels_i = build_spatial_soft_labels(all_txt_ids, ground_truth, neighbor_tile_ids,
                                         neighbor_alphas, neighbor_alpha_scale)
    labels_t = build_spatial_soft_labels(all_img_ids, ground_truth, neighbor_tile_ids,
                                         neighbor_alphas, neighbor_alpha_scale)
    z_i = image_features @ all_txt.T
    z_t = text_features @ all_img.T
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
        total = total + temp_reg_weight * mean_over_ranks(gap, group) ** 2
    return {"contrastive_loss": mean_over_ranks(total, group)}


def distill_clip_loss(image_features: torch.Tensor, text_features: torch.Tensor,
                      logit_scale: torch.Tensor, dist_image_features: torch.Tensor,
                      dist_text_features: torch.Tensor, dist_logit_scale: torch.Tensor,
                      logit_bias: Optional[torch.Tensor] = None, group: Group = None,
                      float32_logits: bool = True) -> Dict[str, torch.Tensor]:
    """Teacher-student distillation: :func:`clip_loss` plus the mean over
    rows of the cross-entropy between the teacher's softmax and the
    student's log-softmax, image -> text and text -> image averaged
    (``distill_loss``). The teacher's logits carry no gradient."""
    all_img, all_txt = gather_features(image_features, text_features, group)
    with torch.no_grad():
        d_all_img, d_all_txt = gather_features(dist_image_features, dist_text_features, group)
    base = clip_loss(image_features, text_features, logit_scale, logit_bias=logit_bias,
                     group=group, float32_logits=float32_logits)["contrastive_loss"]
    logits_i = (image_features @ all_txt.T * logit_scale).float()
    logits_t = (text_features @ all_img.T * logit_scale).float()
    with torch.no_grad():
        t_logits_i = (dist_image_features @ d_all_txt.T * dist_logit_scale).float()
        t_logits_t = (dist_text_features @ d_all_img.T * dist_logit_scale).float()

    def soft_ce(student, teacher):
        return -(F.softmax(teacher, dim=1) * F.log_softmax(student, dim=1)).sum(1).mean()

    distill = 0.5 * (soft_ce(logits_i, t_logits_i) + soft_ce(logits_t, t_logits_t))
    distill = mean_over_ranks(distill, group)
    return {"contrastive_loss": base + distill, "distill_loss": distill}


def _siglip_pair_loss(img: torch.Tensor, txt: torch.Tensor, logit_scale: torch.Tensor,
                      logit_bias: torch.Tensor, negative_only: bool) -> torch.Tensor:
    """Sum of the pairwise sigmoid losses of one image block against one
    text block: label +1 on the diagonal, -1 elsewhere (every pair -1 with
    ``negative_only``)."""
    logits = (logit_scale * (img @ txt.T) + logit_bias).float()
    if negative_only:
        labels = -torch.ones_like(logits)
    else:
        labels = 2.0 * torch.eye(logits.shape[0], logits.shape[1], device=logits.device) - 1.0
    return -F.logsigmoid(labels * logits).sum()


def siglip_loss(image_features: torch.Tensor, text_features: torch.Tensor,
                logit_scale: torch.Tensor, logit_bias: Optional[torch.Tensor] = None,
                group: Group = None, dist_impl: str = "shift") -> Dict[str, torch.Tensor]:
    """SigLIP's pairwise sigmoid loss, divided by the local batch size. The
    model must carry a learned bias (a config with ``init_logit_bias``).

    ``dist_impl`` says how the ranks' text blocks reach this rank's images
    (each scored as negatives; without a group it has no effect):
    ``gather`` (one all-gather, every block at once), ``reduce`` (each rank
    writes its block into a zero buffer that a sum assembles), ``shift``
    (the blocks passed around a ring, P - 1 point-to-point steps) and
    ``bidir`` (two rings turning opposite ways, half the steps each). The
    two rings exchange point to point, so on CUDA tensors they take an
    ``nccl`` group."""
    if logit_bias is None:
        raise TypeError("the siglip loss needs the model's logit_bias: build the model from a "
                        "config that sets init_logit_bias")
    if dist_impl not in ("gather", "reduce", "shift", "bidir"):
        raise ValueError(f"unknown siglip dist_impl: {dist_impl}")
    B = image_features.shape[0]
    loss = _siglip_pair_loss(image_features, text_features, logit_scale, logit_bias,
                             negative_only=False)
    rank, n = rank_size(group)

    def negatives(txt):
        return _siglip_pair_loss(image_features, txt, logit_scale, logit_bias, negative_only=True)

    if group is not None and n > 1:
        if dist_impl in ("gather", "reduce"):
            if dist_impl == "gather":
                blocks = all_gather(text_features, group).reshape(n, B, -1)
            else:
                buf = text_features.new_zeros((n,) + text_features.shape)
                blocks = all_reduce_sum(buf.index_copy(0, torch.tensor([rank], device=buf.device),
                                                       text_features[None]), group)
            for i in range(n):
                if i != rank:
                    loss = loss + negatives(blocks[i])
        elif dist_impl == "shift":
            txt = text_features
            for _ in range(n - 1):
                txt = shift(txt, group, 1)
                loss = loss + negatives(txt)
        else:  # bidir: two halves rotating in opposite directions
            txt_r = txt_l = text_features
            for _ in range((n - 1) // 2):
                txt_r, txt_l = shift(txt_r, group, 1), shift(txt_l, group, -1)
                loss = loss + negatives(txt_r) + negatives(txt_l)
            if (n - 1) % 2:
                loss = loss + negatives(shift(txt_r, group, 1))
    return {"contrastive_loss": mean_over_ranks(loss / B, group)}
