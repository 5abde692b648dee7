"""Two-tower CLIP model (counterpart of ``spatial_clip_tpu.models.clip``).

Laid out as open_clip's ``CLIP``: the image tower under ``visual.*`` and the
text tower's modules at the top level (``transformer.*``,
``token_embedding.weight``, ``text_projection``, ...), so its state dict has
the keys ``spatial_clip_tpu.models.convert.jax_to_torch_state_dict`` exports.
With ``gene_cfg`` set, the Gene-MLP tower (:class:`GeneMLPTower`) replaces
the text tower under ``text.*`` (``text.embed``, ``text.ln_0``, ...,
``text.head``), and ``text`` is a rank-weighted gene vector (B, num_genes).

Under ``zip_towers='on'`` (where :func:`zip_ready` holds), a forward given
both images and text runs the two towers in lockstep (:meth:`CLIP.encode_pair`):
each layer's image and text attention is one launch of the pair kernel
(``ops.attention_pair``), forward and backward.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from spatial_clip_tpu_torch.models.config import CLIPCfg, check_ported
from spatial_clip_tpu_torch.models.transformer import (
    GeneMLPTower,
    TextTransformer,
    VisionTransformer,
    gelu_tanh,
    quick_gelu,
    text_head,
)
from spatial_clip_tpu_torch.ops.attention_pair import PairAttention, pair_supported


def zip_ready(cfg: CLIPCfg, remat: bool = False) -> bool:
    """Whether a forward given images and text zips the towers: JAX's
    ``CLIP._zip_ready``, clause by clause, from the configuration and the
    model's ``remat``. 'off' or ``remat`` never zips; any block feature the
    zip stages do not run (qk-norm, scaled-cosine, a LayerNorm fused into a
    projection, attention other than the fused kernel) or unequal depths
    run the towers apart."""
    z = cfg.zip_towers
    if z == "off" or remat:
        return False
    v, t = cfg.vision_cfg, cfg.text_cfg
    if (v.timm_model_name or isinstance(v.layers, (list, tuple)) or cfg.gene_cfg is not None
            or t.hf_config is not None or t.hf_model_name):
        return False
    if v.layers != t.layers:
        return False
    if v.qk_norm or v.scaled_cosine or t.qk_norm:
        return False
    if cfg.ln_gemm_impl != "dense":
        return False
    if cfg.attn_impl not in ("auto", "pallas"):
        return False
    if not pair_supported(v.heads, v.width, t.heads, t.width):
        return False
    # JAX zips under 'auto' only on a TPU backend, where each kernel call is
    # a synchronous boundary the pair halves; on the card 'auto' runs the
    # towers apart and 'on' asks for the pair
    return z != "auto"


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """Unit vectors, computed in f32 whatever the compute dtype."""
    x32 = x.float()
    return x32 / torch.linalg.vector_norm(x32, dim=dim, keepdim=True).clamp_min(eps)


class CLIP(nn.Module):
    """``dtype`` is the compute dtype. ``param_dtype`` (default: ``dtype``)
    stores the matrices and embeddings; a model built ``training`` checks
    that the attention backward kernel takes both towers' geometry;
    ``remat`` recomputes each transformer block in the backward."""

    def __init__(self, cfg: CLIPCfg, dtype=torch.float32, device=None, param_dtype=None,
                 training: bool = False, remat: bool = False):
        super().__init__()
        check_ported(cfg)
        self.cfg, self.dtype, self.remat = cfg, dtype, remat
        v, t = cfg.vision_cfg, cfg.text_cfg
        act = quick_gelu if cfg.quick_gelu else gelu_tanh
        common = dict(ln_stats=cfg.ln_impl, act=act, dtype=dtype,
                      param_dtype=param_dtype or dtype, device=device, training=training,
                      attn_impl=cfg.attn_impl, ln_gemm_impl=cfg.ln_gemm_impl,
                      mlp_impl=cfg.mlp_impl, remat=remat)
        self.visual = VisionTransformer(
            v.size, v.patch_size, v.width, v.layers, v.heads, v.mlp_ratio,
            cfg.embed_dim, ls_init_value=v.ls_init_value, no_ln_pre=v.no_ln_pre,
            final_ln_after_pool=v.final_ln_after_pool, pool_type=v.pool_type,
            norm_eps=v.norm_eps, **common)
        if cfg.gene_cfg is not None:
            g = cfg.gene_cfg
            self.text = GeneMLPTower(
                g.num_genes, g.width, g.layers, cfg.embed_dim, gene_dropout=g.gene_dropout,
                norm_eps=g.norm_eps, ln_stats=cfg.ln_impl, dtype=dtype,
                param_dtype=param_dtype or dtype, device=device)
        else:
            self.text = None
            text = TextTransformer(
                t.context_length, t.vocab_size, t.width, t.heads, t.layers, t.mlp_ratio,
                cfg.embed_dim, ls_init_value=t.ls_init_value, no_causal_mask=t.no_causal_mask,
                pool_type=t.pool_type, final_ln_after_pool=t.final_ln_after_pool,
                proj_bias=t.proj_bias, norm_eps=t.norm_eps, **common)
            # open_clip's layout: the text tower's modules sit on the model itself
            self.transformer = text.transformer
            self.token_embedding = text.token_embedding
            self.positional_embedding = text.positional_embedding
            self.ln_final = text.ln_final
            self.text_projection = text.text_projection
            self.register_buffer("attn_mask", text.attn_mask, persistent=False)
            self.text_pool_type = t.pool_type
            self.text_final_ln_after_pool = t.final_ln_after_pool
        self.logit_scale = nn.Parameter(torch.empty((), device=device))
        self.logit_bias = (nn.Parameter(torch.empty((), device=device))
                           if cfg.init_logit_bias is not None else None)

    def encode_image(self, images: torch.Tensor, normalize: bool = True) -> torch.Tensor:
        """images: (B, H, W, 3) normalized, in the compute dtype."""
        feats = self.visual(images)
        return l2_normalize(feats) if normalize else feats

    def _text_embed(self, text: torch.Tensor) -> torch.Tensor:
        """Token + positional embedding, as TextTransformer.embed."""
        return (self.token_embedding(text).to(self.dtype)
                + self.positional_embedding.to(self.dtype))

    def _text_head(self, x: torch.Tensor, text: torch.Tensor) -> torch.Tensor:
        return text_head(x, text, self.ln_final, self.text_projection, self.text_pool_type,
                         self.text_final_ln_after_pool)

    def encode_text(self, text: torch.Tensor, normalize: bool = True,
                    gene_keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """text: (B, context_length) token ids, or with a gene tower the
        (B, num_genes) gene vectors, whose genes outside ``gene_keep`` (the
        trainer's gene-dropout mask) are zeroed."""
        if self.text is not None:
            feats = self.text(text, gene_keep)
        else:
            feats = self._text_head(self.transformer(self._text_embed(text), self.attn_mask),
                                    text)
        return l2_normalize(feats) if normalize else feats

    def _zip_ready(self) -> bool:
        return zip_ready(self.cfg, self.remat)

    def encode_pair(self, images: torch.Tensor, text: torch.Tensor, normalize: bool = True):
        """Both towers with each layer's image and text attention as one
        launch (JAX's ``encode_pair``): the same math as
        :meth:`encode_image` and :meth:`encode_text`. Returns (image
        features, text features)."""
        xa, xb = self.visual.embed(images), self._text_embed(text)
        for ba, bb in zip(self.visual.transformer.resblocks, self.transformer.resblocks):
            ca, cb = PairAttention.apply(ba.attn_qkv(xa), None, bb.attn_qkv(xb), self.attn_mask,
                                         ba.attn.heads, bb.attn.heads)
            xa, xb = ba.attn_finish(xa, ca), bb.attn_finish(xb, cb)
        img, txt = self.visual.head(xa), self._text_head(xb, text)
        if normalize:
            img, txt = l2_normalize(img), l2_normalize(txt)
        return img, txt

    def forward(self, images: Optional[torch.Tensor] = None,
                text: Optional[torch.Tensor] = None,
                gene_keep: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        if images is not None and text is not None and self._zip_ready():
            out["image_features"], out["text_features"] = self.encode_pair(images, text)
        else:
            if images is not None:
                out["image_features"] = self.encode_image(images)
            if text is not None:
                out["text_features"] = self.encode_text(text, gene_keep=gene_keep)
        out["logit_scale"] = self.logit_scale.exp()
        if self.logit_bias is not None:
            out["logit_bias"] = self.logit_bias
        return out
