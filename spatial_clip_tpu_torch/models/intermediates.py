"""``forward_intermediates`` (counterpart of ``spatial_clip_tpu.models.intermediates``).

The image and text features of :class:`~spatial_clip_tpu_torch.models.clip.CLIP`
or :class:`~spatial_clip_tpu_torch.models.coca.CoCa` with the outputs of the
blocks a caller selects, as JAX's ``forward_intermediates`` returns them
from the blocks' sown tokens: each tower runs its embedding, then its blocks
one by one (each with the kernel or plain route the tower takes), keeping
each block's output, then its head. ``stop_early`` with
``intermediates_only`` runs the blocks only as deep as the deepest one
selected, JAX's depth-pruned model. ``normalize_intermediates`` passes each
selected output through the tower's final LayerNorm (``ln_post`` /
``ln_final``) with two-pass f32 statistics and an f32 output, as JAX applies
a default ``LayerNorm`` with those parameters. Only the ViT image tower and
the CLIP text transformer have blocks to select; the other towers raise
ValueError, as in JAX. A method of the model here (JAX has it on the
bundle); it runs without grad.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import torch

from spatial_clip_tpu_torch.models.clip import l2_normalize
from spatial_clip_tpu_torch.models.transformer import _ln_apply
from spatial_clip_tpu_torch.ops.flops import feature_take_indices

Indices = Optional[Union[int, Sequence[int]]]


def _run_blocks(blocks, x: torch.Tensor, mask, depth: int) -> List[torch.Tensor]:
    """The outputs of the first ``depth`` blocks."""
    out = []
    for block in list(blocks)[:depth]:
        x = block(x, mask)
        out.append(x)
    return out


def _final_ln(ln, x: torch.Tensor) -> torch.Tensor:
    return _ln_apply(x, ln.weight, ln.bias, ln.eps, torch.float32, "fp32")


def _image_stages(model):
    """(embed, blocks, head -> pooled feature, final LayerNorm) of the ViT."""
    visual = model.visual

    def head(x):
        out = visual.head(x)
        return out[0] if isinstance(out, tuple) else out  # CoCa's tower also gives its tokens

    return visual.embed, visual.transformer.resblocks, head, visual.ln_post


def _text_stages(model):
    """(embed, blocks, mask, head(x, text) -> feature, final LayerNorm) of
    the CLIP text transformer: CoCa's ``text`` tower, or CLIP's modules on
    the model itself."""
    if model.text is not None:  # CoCa
        t = model.text
        return t.embed, t.transformer.resblocks, t.attn_mask, t.head, t.ln_final
    return (model._text_embed, model.transformer.resblocks, model.attn_mask, model._text_head,
            model.ln_final)


@torch.no_grad()
def forward_intermediates(
        model, image: Optional[torch.Tensor] = None, text: Optional[torch.Tensor] = None, *,
        image_indices: Indices = None, text_indices: Indices = None, stop_early: bool = False,
        normalize: bool = True, normalize_intermediates: bool = False,
        intermediates_only: bool = False, image_output_fmt: str = "NCHW",
        image_output_extra_tokens: bool = False, text_output_fmt: str = "NLC",
        text_output_extra_tokens: bool = False, output_logits: bool = False,
        output_logit_scale_bias: bool = False
) -> Dict[str, Union[torch.Tensor, List[torch.Tensor]]]:
    """JAX's arguments: ``*_indices`` None for every block, an int n for
    the last n, or a list of ids (negatives wrap); ``intermediates_only``
    drops the features, their normalization and the logits;
    ``image_output_fmt`` 'NCHW' (the patch grid, the class token split
    off; ``image_output_extra_tokens`` returns it as
    ``image_intermediates_prefix``) or 'NLC'. ``image`` is NHWC,
    normalized, in the compute dtype; ``text`` (B, L) token ids."""
    assert image_output_fmt in ("NCHW", "NLC"), "Output format must be one of NCHW or NLC."
    assert text_output_fmt == "NLC", "text tower emits NLC intermediates"
    cfg = model.cfg
    output: Dict[str, Union[torch.Tensor, List[torch.Tensor]]] = {}
    if intermediates_only:
        normalize = False
        output_logits = False
    if output_logits and (image is None or text is None):
        raise ValueError("output_logits requires both image and text inputs")
    v, t = cfg.vision_cfg, cfg.text_cfg
    if image is not None and (v.timm_model_name or not isinstance(v.layers, int)):
        raise ValueError("forward_intermediates supports the ViT vision tower; "
                         f"got timm/resnet trunk for {getattr(model, 'model_name', '')!r}")
    if text is not None and (cfg.gene_cfg is not None or t.hf_config or t.hf_model_name):
        raise ValueError("forward_intermediates supports the CLIP text transformer; "
                         "gene-MLP/HF towers have no block-token contract")
    img_take = feature_take_indices(v.layers, image_indices) if image is not None else []
    txt_take = feature_take_indices(t.layers, text_indices) if text is not None else []
    prune = stop_early and intermediates_only

    if image is not None:
        embed, blocks, head, ln = _image_stages(model)
        depth = max(img_take) + 1 if prune and img_take else v.layers
        outs = _run_blocks(blocks, embed(image), None, min(depth, v.layers))
        sel = [outs[i] for i in img_take]
        if normalize_intermediates:
            sel = [_final_ln(ln, y) for y in sel]
        prefix = [y[:, :1] for y in sel]
        sel = [y[:, 1:] for y in sel]
        if image_output_fmt == "NCHW":
            B = image.shape[0]
            g = int(sel[0].shape[1] ** 0.5)
            sel = [y.reshape(B, g, g, -1).permute(0, 3, 1, 2) for y in sel]
        output["image_intermediates"] = sel
        if image_output_extra_tokens:
            output["image_intermediates_prefix"] = prefix
        if not intermediates_only:
            feats = head(outs[-1])
            output["image_features"] = l2_normalize(feats) if normalize else feats

    if text is not None:
        embed, blocks, mask, head, ln = _text_stages(model)
        depth = max(txt_take) + 1 if prune and txt_take else t.layers
        outs = _run_blocks(blocks, embed(text), mask, min(depth, t.layers))
        sel = [outs[i] for i in txt_take]
        if normalize_intermediates:
            sel = [_final_ln(ln, y) for y in sel]
        # no prefix tokens: a cls token is appended at the end, part of the stream
        output["text_intermediates"] = sel
        if not intermediates_only:
            feats = head(outs[-1], text)
            output["text_features"] = l2_normalize(feats) if normalize else feats

    scale = model.logit_scale.exp()
    if output_logits:
        logits = scale * output["image_features"] @ output["text_features"].T
        if model.logit_bias is not None:
            logits = logits + model.logit_bias
        output["image_logits"] = logits
        output["text_logits"] = logits.T
    if output_logit_scale_bias:
        output["logit_scale"] = scale
        if model.logit_bias is not None:
            output["logit_bias"] = model.logit_bias
    return output
