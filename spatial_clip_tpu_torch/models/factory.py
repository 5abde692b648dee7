"""Model and tokenizer factory (counterpart of ``spatial_clip_tpu.models.factory``).

``create_model`` returns the CLIP ``nn.Module`` on ``device``, its weights
drawn from ``seed`` with the distributions the JAX package's flax
initializers use (the values differ: the two frameworks' generators differ).
For serving (the default) the model is in eval mode with its weights stored
in the compute dtype and no grad; with ``training=True`` it is in train mode
with float32 parameters that require grad, cast to the compute dtype at
each use, as the JAX package trains. The repository holds no pretrained checkpoint, so ``pretrained`` is
not ported; weights from the JAX package load with
``model.load_state_dict(convert.from_jax_params(params))``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from spatial_clip_tpu_torch.models.clip import CLIP
from spatial_clip_tpu_torch.models.config import CLIPCfg, resolve_clip_cfg
from spatial_clip_tpu_torch.models.constants import OPENAI_DATASET_MEAN, OPENAI_DATASET_STD
from spatial_clip_tpu_torch.models.tokenizer import (
    DEFAULT_CONTEXT_LENGTH,
    HashTokenizer,
    SimpleTokenizer,
)
from spatial_clip_tpu_torch.models.transformer import (
    Dense,
    LayerNorm,
    LayerScale,
    MultiHeadAttention,
    PatchEmbed,
)
from spatial_clip_tpu_torch.models.transforms import PreprocessCfg

PRECISION_DTYPES = {
    "fp32": torch.float32,
    "float32": torch.float32,
    "bf16": torch.bfloat16,
    "bfloat16": torch.bfloat16,
    "amp_bf16": torch.bfloat16,
    "pure_bf16": torch.bfloat16,
}


@torch.no_grad()
def init_weights(model: CLIP, seed: int = 0) -> None:
    """Fill every parameter from a CPU generator seeded with ``seed``:
    flax's lecun_normal (truncated normal, std sqrt(1/fan_in)/.8796) for
    dense and patch kernels, normal(width^-1/2) for embeddings and
    projections, normal(0.01) for the text positions, ones/zeros for
    LayerNorm, constants for layer-scale and the logit scale/bias."""
    g = torch.Generator().manual_seed(seed)
    cfg = model.cfg

    def lecun(p: torch.Tensor, fan_in: int) -> None:
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        p.copy_(nn.init.trunc_normal_(torch.empty(p.shape), 0.0, std, -2 * std, 2 * std,
                                      generator=g))

    def normal(p: torch.Tensor, std: float) -> None:
        p.copy_(torch.randn(p.shape, generator=g) * std)

    for name, mod in model.named_modules():
        if isinstance(mod, Dense):
            lecun(mod.weight, mod.in_features)
            mod.bias.zero_()
        elif isinstance(mod, MultiHeadAttention):
            lecun(mod.in_proj_weight, mod.in_proj_weight.shape[1])
            mod.in_proj_bias.zero_()
        elif isinstance(mod, LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, LayerScale):
            tower = cfg.vision_cfg if name.startswith("visual.") else cfg.text_cfg
            mod.gamma.fill_(tower.ls_init_value)
        elif isinstance(mod, PatchEmbed):
            lecun(mod.weight, mod.weight[0].numel())
    v_width = cfg.vision_cfg.width
    normal(model.visual.class_embedding, v_width ** -0.5)
    normal(model.visual.positional_embedding, v_width ** -0.5)
    normal(model.visual.proj, v_width ** -0.5)
    normal(model.token_embedding.weight, cfg.text_cfg.width ** -0.5)
    normal(model.positional_embedding, 0.01)
    if not isinstance(model.text_projection, Dense):
        normal(model.text_projection, cfg.text_cfg.width ** -0.5)
    model.logit_scale.fill_(cfg.init_logit_scale)
    if model.logit_bias is not None:
        model.logit_bias.fill_(cfg.init_logit_bias)


def create_model(model_name: str, pretrained: Optional[str] = None,
                 precision: str = "bf16", seed: int = 0, device="cuda",
                 training: bool = False, **cfg_overrides) -> CLIP:
    """Build a CLIP model. ``cfg_overrides`` are CLIPCfg fields, with
    ``vision_cfg``/``text_cfg`` dicts merged into the JSON config. The model
    carries ``cfg``, ``model_name`` and ``preprocess_cfg``. ``training``
    gives float32 parameters that require grad, in train mode; the weights
    drawn from a seed are the same either way (then rounded to the compute
    dtype for serving)."""
    if pretrained:
        raise NotImplementedError(
            f"pretrained={pretrained!r} is not ported to spatial_clip_tpu_torch")
    if precision not in PRECISION_DTYPES:
        raise ValueError(f"unknown precision {precision!r}: {sorted(PRECISION_DTYPES)}")
    cfg = resolve_clip_cfg(model_name, **cfg_overrides)
    dtype = PRECISION_DTYPES[precision]
    model = CLIP(cfg, dtype=dtype, device=torch.device(device),
                 param_dtype=torch.float32 if training else dtype, training=training)
    init_weights(model, seed)
    model.model_name = model_name
    model.preprocess_cfg = PreprocessCfg(
        size=cfg.vision_cfg.image_size, mean=OPENAI_DATASET_MEAN, std=OPENAI_DATASET_STD)
    if training:
        return model.train().requires_grad_(True)
    return model.eval().requires_grad_(False)


def get_tokenizer(model_name: str = ""):
    """The CLIP byte-BPE tokenizer, or the hashing tokenizer for
    architectures whose vocab is smaller than the BPE's (e.g. ViT-Test)."""
    cfg = resolve_clip_cfg(model_name) if model_name else CLIPCfg()
    if cfg.text_cfg.hf_tokenizer_name:
        raise NotImplementedError(
            f"text_cfg.hf_tokenizer_name={cfg.text_cfg.hf_tokenizer_name!r} is not "
            "ported to spatial_clip_tpu_torch")
    if cfg.gene_cfg is not None:
        raise NotImplementedError("gene_cfg tokenizers are not ported to spatial_clip_tpu_torch")
    ctx = cfg.text_cfg.context_length or DEFAULT_CONTEXT_LENGTH
    tok = SimpleTokenizer(context_length=ctx)
    if cfg.text_cfg.vocab_size and cfg.text_cfg.vocab_size < tok.vocab_size:
        return HashTokenizer(vocab_size=cfg.text_cfg.vocab_size, context_length=ctx)
    return tok
