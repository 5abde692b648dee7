"""Model and tokenizer factory (counterpart of ``spatial_clip_tpu.models.factory``).

``create_model`` returns the CLIP ``nn.Module`` on ``device``, its weights
drawn from ``seed`` with the distributions the JAX package's flax
initializers use (the values differ: the two frameworks' generators differ).
For serving (the default) the model is in eval mode with its weights stored
in the compute dtype and no grad; with ``training=True`` it is in train mode
with float32 parameters that require grad, cast to the compute dtype at
each use, as the JAX package trains. ``pretrained`` loads local weights
over them (:func:`load_checkpoint`): an open_clip state dict
(``.safetensors``, ``.bin``, ``.pt``, ``.pth``), a JAX ``params.npz`` written
by ``save_params_npz`` (either package's), or a directory holding one of
open_clip's weight-file names (:data:`WEIGHT_FILE_NAMES`). Loading is
strict: a missing or extra key, or a shape that differs, raises. Registry
tags and ``hf-hub:`` names are not ported (ROADMAP Queue 1 item 9).

:func:`create_model_and_transforms` adds the host transforms for training
and evaluation; :func:`get_tokenizer` takes the JAX package's keywords.
"""
from __future__ import annotations

import logging
import math
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from spatial_clip_tpu_torch.models.clip import CLIP
from spatial_clip_tpu_torch.models.config import CLIPCfg, resolve_clip_cfg
from spatial_clip_tpu_torch.models.constants import OPENAI_DATASET_MEAN, OPENAI_DATASET_STD
from spatial_clip_tpu_torch.models.tokenizer import (
    DEFAULT_CONTEXT_LENGTH,
    GeneTokenizer,
    GeneVectorizer,
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
from spatial_clip_tpu_torch.models.transforms import (
    AugmentationCfg,
    HostImageTransform,
    PreprocessCfg,
    image_transform,
)

log = logging.getLogger(__name__)

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
    if cfg.gene_cfg is None:  # the Gene-MLP tower is Dense and LayerNorm only
        normal(model.token_embedding.weight, cfg.text_cfg.width ** -0.5)
        normal(model.positional_embedding, 0.01)
        if not isinstance(model.text_projection, Dense):
            normal(model.text_projection, cfg.text_cfg.width ** -0.5)
    model.logit_scale.fill_(cfg.init_logit_scale)
    if model.logit_bias is not None:
        model.logit_bias.fill_(cfg.init_logit_bias)


def create_model(model_name: str, pretrained: Optional[str] = None,
                 precision: str = "bf16", seed: int = 0, device="cuda",
                 training: bool = False, force_quick_gelu: bool = False,
                 remat: bool = False, **cfg_overrides) -> CLIP:
    """Build a CLIP model. ``cfg_overrides`` are CLIPCfg fields, with
    ``vision_cfg``/``text_cfg`` dicts merged into the JSON config. The model
    carries ``cfg``, ``model_name`` and ``preprocess_cfg``. ``training``
    gives float32 parameters that require grad, in train mode; the weights
    drawn from a seed are the same either way (then rounded to the compute
    dtype for serving). ``pretrained`` names local weights that replace
    them (:func:`load_checkpoint`). ``force_quick_gelu`` sets the config's
    ``quick_gelu``; ``remat`` recomputes each transformer block in the
    backward (activation checkpointing)."""
    if precision not in PRECISION_DTYPES:
        raise ValueError(f"unknown precision {precision!r}: {sorted(PRECISION_DTYPES)}")
    if force_quick_gelu:
        cfg_overrides["quick_gelu"] = True
    cfg = resolve_clip_cfg(model_name, **cfg_overrides)
    dtype = PRECISION_DTYPES[precision]
    model = CLIP(cfg, dtype=dtype, device=torch.device(device),
                 param_dtype=torch.float32 if training else dtype, training=training,
                 remat=remat)
    init_weights(model, seed)
    if pretrained:
        load_checkpoint(model, pretrained)
    model.model_name = model_name
    model.preprocess_cfg = PreprocessCfg(
        size=cfg.vision_cfg.image_size, mean=OPENAI_DATASET_MEAN, std=OPENAI_DATASET_STD)
    if training:
        return model.train().requires_grad_(True)
    return model.eval().requires_grad_(False)


# the names of open_clip's weight files in a model directory, in the order
# open_clip's factory tries them
WEIGHT_FILE_NAMES = ("open_clip_model.safetensors", "open_clip_pytorch_model.safetensors",
                     "open_clip_pytorch_model.bin", "open_clip_pytorch_model.pth")
TORCH_SUFFIXES = (".bin", ".pt", ".pth")


def resolve_weights(path: Union[str, Path]) -> Path:
    """The weight file ``path`` names: the file itself, or in a directory
    the first of :data:`WEIGHT_FILE_NAMES` it holds."""
    p = Path(path)
    if p.is_dir():
        for name in WEIGHT_FILE_NAMES:
            if (p / name).is_file():
                return p / name
        raise FileNotFoundError(f"{p} holds none of the weight files {WEIGHT_FILE_NAMES}")
    if p.is_file():
        return p
    if str(path).startswith("hf-hub:") or not p.suffix:
        raise NotImplementedError(
            f"pretrained={str(path)!r}: registry tags and hf-hub names are not ported to "
            "spatial_clip_tpu_torch (ROADMAP Queue 1 item 9); pass a local file or directory")
    raise FileNotFoundError(f"pretrained weights not found: {p}")


def read_state_dict(path: Union[str, Path]) -> Dict[str, torch.Tensor]:
    """The state dict in a weight file, in this package's (open_clip's) key
    layout: a safetensors or torch file (a ``state_dict`` entry unwrapped,
    ``module.``/``_orig_mod.`` prefixes stripped), or a JAX-layout
    ``.npz`` mapped through :func:`convert.from_jax_params`."""
    from spatial_clip_tpu_torch.models.convert import from_jax_params
    from spatial_clip_tpu_torch.train.checkpoints import load_params_npz

    p = resolve_weights(path)
    suffix = p.suffix.lower()
    if suffix == ".npz":
        return from_jax_params(load_params_npz(p))
    if suffix == ".safetensors":
        from safetensors.torch import load_file

        obj = load_file(str(p))
    elif suffix in TORCH_SUFFIXES:
        obj = torch.load(str(p), map_location="cpu", weights_only=True)
        if isinstance(obj, dict) and isinstance(obj.get("state_dict"), dict):
            obj = obj["state_dict"]
    else:
        raise ValueError(f"unrecognized weight file {p}: want .npz, .safetensors or one of "
                         f"{TORCH_SUFFIXES}")
    out = {}
    for k, v in obj.items():
        for prefix in ("module.", "_orig_mod."):
            if k.startswith(prefix):
                k = k[len(prefix):]
        out[k] = torch.as_tensor(v)
    return out


def load_checkpoint(model: CLIP, path: Union[str, Path]) -> CLIP:
    """Load the weights at ``path`` (:func:`read_state_dict`) into
    ``model`` strictly: a missing or extra key, or another shape, raises."""
    with torch.no_grad():
        model.load_state_dict(read_state_dict(path), strict=True)
    return model


def create_model_and_transforms(
        model_name: str, pretrained: Optional[str] = None, precision: str = "bf16",
        image_mean: Optional[Tuple[float, ...]] = None,
        image_std: Optional[Tuple[float, ...]] = None,
        image_interpolation: Optional[str] = None, image_resize_mode: Optional[str] = None,
        aug_cfg: Optional[Union[dict, AugmentationCfg]] = None, seed: int = 0,
        **model_kwargs) -> Tuple[CLIP, HostImageTransform, HostImageTransform]:
    """(model, train host transform, val host transform), as the JAX
    package's: the train transform's random crops are drawn from ``seed``."""
    model = create_model(model_name, pretrained=pretrained, precision=precision, seed=seed,
                         **model_kwargs)
    pp = model.preprocess_cfg
    mean = tuple(image_mean) if image_mean else pp.mean
    std = tuple(image_std) if image_std else pp.std
    interp = image_interpolation or pp.interpolation
    resize_mode = image_resize_mode or pp.resize_mode
    train_t = image_transform(pp.size, is_train=True, mean=mean, std=std, interpolation=interp,
                              aug_cfg=aug_cfg, seed=seed)
    val_t = image_transform(pp.size, is_train=False, mean=mean, std=std, interpolation=interp,
                            resize_mode=resize_mode, fill_color=pp.fill_color)
    return model, train_t, val_t


def get_tokenizer(model_name: str = "", context_length: Optional[int] = None,
                  gene_vocab=None, bpe_path: Optional[str] = None, **kwargs):
    """The tokenizer of ``model_name``, resolved in the JAX package's order:
    for a model with a Gene-MLP tower (``gene_cfg``), the
    :class:`GeneVectorizer` over ``gene_vocab`` (a list or a file; missing
    raises ValueError, a size other than ``num_genes`` warns); else with
    ``gene_vocab`` the :class:`GeneTokenizer`; else the CLIP byte-BPE
    tokenizer (from ``bpe_path`` when given), or the hashing tokenizer for
    architectures whose vocab is smaller than the BPE's (e.g. ViT-Test) or
    where no merges file is found, at ``context_length`` (default: the
    model's). Hugging Face tokenizers are not ported."""
    cfg = resolve_clip_cfg(model_name) if model_name else CLIPCfg()
    ctx = context_length or cfg.text_cfg.context_length or DEFAULT_CONTEXT_LENGTH
    if cfg.gene_cfg is not None:
        if gene_vocab is None:
            raise ValueError(f"model '{model_name}' uses the gene-MLP tower; pass gene_vocab= "
                             "(e.g. global_hvgs.txt) to build its vectorizer")
        vec = GeneVectorizer(gene_vocab)
        if vec.num_genes != cfg.gene_cfg.num_genes:
            log.warning("gene vocab size %d != model num_genes %d; pad/truncate applies",
                        vec.num_genes, cfg.gene_cfg.num_genes)
        return vec
    if cfg.text_cfg.hf_tokenizer_name or kwargs:
        raise NotImplementedError(
            f"text_cfg.hf_tokenizer_name={cfg.text_cfg.hf_tokenizer_name!r} (keywords "
            f"{sorted(kwargs)}) is not ported to spatial_clip_tpu_torch")
    if gene_vocab is not None:
        return GeneTokenizer(gene_vocab, context_length=ctx)
    try:
        tok = SimpleTokenizer(bpe_path=bpe_path, context_length=ctx)
    except FileNotFoundError:
        return HashTokenizer(vocab_size=cfg.text_cfg.vocab_size, context_length=ctx)
    if cfg.text_cfg.vocab_size and cfg.text_cfg.vocab_size < tok.vocab_size:
        return HashTokenizer(vocab_size=cfg.text_cfg.vocab_size, context_length=ctx)
    return tok
