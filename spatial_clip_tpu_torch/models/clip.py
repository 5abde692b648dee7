"""Two-tower CLIP model (counterpart of ``spatial_clip_tpu.models.clip``).

Laid out as open_clip's ``CLIP``: the image tower under ``visual.*`` and the
text tower's modules at the top level (``transformer.*``,
``token_embedding.weight``, ``text_projection``, ...), so its state dict has
the keys ``spatial_clip_tpu.models.convert.jax_to_torch_state_dict`` exports.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from spatial_clip_tpu_torch.models.config import CLIPCfg, check_ported
from spatial_clip_tpu_torch.models.transformer import (
    TextTransformer,
    VisionTransformer,
    gelu_tanh,
    quick_gelu,
    text_head,
)


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """Unit vectors, computed in f32 whatever the compute dtype."""
    x32 = x.float()
    return x32 / torch.linalg.vector_norm(x32, dim=dim, keepdim=True).clamp_min(eps)


class CLIP(nn.Module):
    def __init__(self, cfg: CLIPCfg, dtype=torch.float32, device=None):
        super().__init__()
        check_ported(cfg)
        self.cfg, self.dtype = cfg, dtype
        v, t = cfg.vision_cfg, cfg.text_cfg
        act = quick_gelu if cfg.quick_gelu else gelu_tanh
        common = dict(ln_stats=cfg.ln_impl, act=act, dtype=dtype, device=device)
        self.visual = VisionTransformer(
            v.size, v.patch_size, v.width, v.layers, v.heads, v.mlp_ratio,
            cfg.embed_dim, ls_init_value=v.ls_init_value, no_ln_pre=v.no_ln_pre,
            final_ln_after_pool=v.final_ln_after_pool, pool_type=v.pool_type,
            norm_eps=v.norm_eps, **common)
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

    def encode_text(self, text: torch.Tensor, normalize: bool = True) -> torch.Tensor:
        """text: (B, context_length) token ids."""
        x = self.token_embedding(text) + self.positional_embedding
        x = self.transformer(x, self.attn_mask)
        feats = text_head(x, text, self.ln_final, self.text_projection,
                          self.text_pool_type, self.text_final_ln_after_pool)
        return l2_normalize(feats) if normalize else feats

    def forward(self, images: Optional[torch.Tensor] = None,
                text: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        if images is not None:
            out["image_features"] = self.encode_image(images)
        if text is not None:
            out["text_features"] = self.encode_text(text)
        out["logit_scale"] = self.logit_scale.exp()
        if self.logit_bias is not None:
            out["logit_bias"] = self.logit_bias
        return out
