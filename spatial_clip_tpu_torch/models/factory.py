"""Model and tokenizer factory (counterpart of ``spatial_clip_tpu.models.factory``).

``create_model`` returns the CLIP ``nn.Module`` on ``device``, its weights
drawn from ``seed`` with the distributions the JAX package's flax
initializers use (the values differ: the two frameworks' generators differ).
For serving (the default) the model is in eval mode with its weights stored
in the compute dtype and no grad; with ``training=True`` it is in train mode
with float32 parameters that require grad, cast to the compute dtype at
each use, as the JAX package trains. ``pretrained`` loads local weights
over them (:func:`load_checkpoint`): an open_clip state dict
(``.safetensors``, ``.bin``, ``.pt``, ``.pth``), an OpenAI TorchScript
archive, a JAX ``params.npz`` written by ``save_params_npz`` (either
package's), a directory holding one of open_clip's weight-file names
(:data:`WEIGHT_FILE_NAMES`), a registry tag of the model
(``models/pretrained.py``: its file in the local cache, never downloaded)
or an ``hf-hub:`` name (its cached snapshot). An ``hf-hub:`` model name
takes its config, weights and preprocessing from the snapshot. Loading is
strict: a missing or extra key, or a shape that differs, raises (a ViT's
positional embedding of another length is resized first, as JAX's
converter does). A name that resolves to no file raises: nothing falls
back to weights drawn from a seed.

:func:`create_model_and_transforms` adds the host transforms for training
and evaluation; :func:`get_tokenizer` takes the JAX package's keywords.
"""
from __future__ import annotations

import json
import logging
import math
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple, Union

import torch
from torch import nn

from spatial_clip_tpu_torch.models.clip import CLIP
from spatial_clip_tpu_torch.models.coca import CoCa
from spatial_clip_tpu_torch.models.config import (
    CLIPCfg,
    hf_hub_snapshot,
    list_model_configs,
    resolve_clip_cfg,
)
from spatial_clip_tpu_torch.models.constants import OPENAI_DATASET_MEAN, OPENAI_DATASET_STD
from spatial_clip_tpu_torch.models.timm_model import Conv
from spatial_clip_tpu_torch.models.tokenizer import (
    DEFAULT_CONTEXT_LENGTH,
    GeneTokenizer,
    GeneVectorizer,
    HashTokenizer,
    HFTokenizer,
    SimpleTokenizer,
)
from spatial_clip_tpu_torch.models.hf_model import Embed
from spatial_clip_tpu_torch.models.modified_resnet import RNConv
from spatial_clip_tpu_torch.models.pretrained import (
    download_pretrained,
    get_pretrained_cfg,
    list_pretrained_tags_by_model,
    preprocess_overrides,
)
from spatial_clip_tpu_torch.models.transformer import (
    Dense,
    LayerNorm,
    LayerScale,
    MultiHeadAttention,
    PatchEmbed,
    TextTransformer,
)
from spatial_clip_tpu_torch.models.transforms import (
    AugmentationCfg,
    HostImageTransform,
    PreprocessCfg,
    image_transform,
)

log = logging.getLogger(__name__)


def list_models() -> list:
    """Every architecture name: the built-in configs and the registered ones."""
    return list_model_configs()


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
    dense, patch and convolution kernels (fan_in = in / groups x k x k),
    zero biases, normal(width^-1/2) for embeddings and
    projections, normal(0.01) for the text positions, ones/zeros for
    LayerNorm, constants for layer-scale and the logit scale/bias. A timm
    tower's other parameters come from its modules' ``init_params``, with
    JAX's initializers (normal(0.02) for class tokens, positions, the MAP
    probe and Swin's bias table, normal(C^-1/2) for the attention pool's
    positions, 1e-6 for ConvNeXt's layer-scale). The modified ResNet's
    convolutions are lecun too, its frozen BatchNorms ones / zeros (mean 0,
    var 1) and its attention pool's positions normal(C^-1/2); the Hugging
    Face encoders draw as transformers' Flax modules do (BERT family:
    normal(``initializer_range``) for embeddings and dense kernels; T5 its
    per-projection stds; the M2M encoder flax's defaults), the projections
    lecun."""
    g = torch.Generator().manual_seed(seed)
    cfg = model.cfg

    def lecun(p: torch.Tensor, fan_in: int) -> None:
        if p.is_meta:  # nothing to fill: a model on the meta device has shapes only
            return
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        p.copy_(nn.init.trunc_normal_(torch.empty(p.shape), 0.0, std, -2 * std, 2 * std,
                                      generator=g))

    def normal(p: torch.Tensor, std: float) -> None:
        if not p.is_meta:
            p.copy_(torch.randn(p.shape, generator=g) * std)

    for name, mod in model.named_modules():
        if isinstance(mod, Dense):
            if getattr(mod, "init_std", None) is not None:  # the HF encoders' normal(std)
                normal(mod.weight, mod.init_std)
            else:
                lecun(mod.weight, mod.in_features)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, Embed):
            if mod.init_std is not None:
                normal(mod.weight, mod.init_std)
            else:  # flax's default embedding init: lecun over the features
                lecun(mod.weight, mod.weight.shape[1])
        elif isinstance(mod, RNConv):
            lecun(mod.weight, mod.weight[0].numel())
        elif isinstance(mod, Conv):
            lecun(mod.weight, mod.weight[0].numel())
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
        if hasattr(mod, "init_params"):
            mod.init_params(normal)
    if not cfg.vision_cfg.timm_model_name and not isinstance(cfg.vision_cfg.layers, (list,
                                                                                  tuple)):
        v_width = cfg.vision_cfg.width
        normal(model.visual.class_embedding, v_width ** -0.5)
        normal(model.visual.positional_embedding, v_width ** -0.5)
        normal(model.visual.proj, v_width ** -0.5)
    # the CLIP text tower's parameters: on the model itself (CLIP) or under
    # text (CoCa); the Gene-MLP and HF towers draw through their modules
    text = model.text if isinstance(model.text, TextTransformer) else model
    if model.text is None or text is not model:
        normal(text.token_embedding.weight, cfg.text_cfg.width ** -0.5)
        normal(text.positional_embedding, 0.01)
        if not isinstance(text.text_projection, Dense):
            normal(text.text_projection, cfg.text_cfg.width ** -0.5)
        if text.cls_emb is not None:
            normal(text.cls_emb, 0.01)
    model.logit_scale.fill_(cfg.init_logit_scale)
    if model.logit_bias is not None:
        model.logit_bias.fill_(cfg.init_logit_bias)


def create_model(model_name: str, pretrained: Optional[str] = None,
                 precision: str = "bf16", seed: int = 0, device="cuda",
                 training: bool = False, force_quick_gelu: bool = False,
                 remat: bool = False, **cfg_overrides) -> Union[CLIP, CoCa]:
    """Build a CLIP model, or CoCa where the config sets ``multimodal_cfg``.
    ``cfg_overrides`` are CLIPCfg fields, with ``vision_cfg`` / ``text_cfg`` /
    ``multimodal_cfg`` dicts merged into the JSON config. The model
    carries ``cfg``, ``model_name`` and ``preprocess_cfg``. ``training``
    gives float32 parameters that require grad, in train mode; the weights
    drawn from a seed are the same either way (then rounded to the compute
    dtype for serving). ``pretrained`` names local weights that replace
    them (:func:`load_checkpoint`). An ``hf-hub:`` model name with no
    ``pretrained`` loads its snapshot's weights (a snapshot with none
    raises), and its ``preprocess_cfg`` applies. A registry tag sets
    ``quick_gelu`` where it was trained with it (with a warning) and pins
    its preprocess keys over the snapshot's. ``force_quick_gelu`` sets the
    config's ``quick_gelu``; ``remat`` recomputes each transformer block in
    the backward (activation checkpointing)."""
    if precision not in PRECISION_DTYPES:
        raise ValueError(f"unknown precision {precision!r}: {sorted(PRECISION_DTYPES)}")
    if force_quick_gelu:
        cfg_overrides["quick_gelu"] = True
    cfg = resolve_clip_cfg(model_name, **cfg_overrides)
    hub_pp = {}
    if model_name.startswith("hf-hub:"):
        snap = hf_hub_snapshot(model_name)
        raw = json.loads((snap / "open_clip_config.json").read_text())
        fields = PreprocessCfg.__dataclass_fields__
        hub_pp = {k: v for k, v in raw.get("preprocess_cfg", {}).items() if k in fields}
        if pretrained is None:
            try:
                pretrained = str(resolve_weights(snap))
            except FileNotFoundError as e:
                raise FileNotFoundError(
                    f"{e}; refusing to return weights drawn from a seed for '{model_name}'. "
                    "Pass pretrained= to load other weights.") from None
    tag_pp = {}
    tag_cfg = get_pretrained_cfg(model_name, str(pretrained)) if pretrained else None
    if tag_cfg is not None:
        tag_pp = preprocess_overrides(tag_cfg)
        if tag_cfg.get("quick_gelu") and not cfg.quick_gelu:
            log.warning("Pretrained tag %s:%s was trained with QuickGELU; enabling it (use the "
                        "'-quickgelu' model name to make this explicit).", model_name, pretrained)
            cfg.quick_gelu = True
    # resolved before the model is built: a name that resolves to nothing fails fast
    weights = resolve_weights(pretrained, model_name) if pretrained else None
    dtype = PRECISION_DTYPES[precision]
    model = (CoCa if cfg.multimodal_cfg is not None else CLIP)(
        cfg, dtype=dtype, device=torch.device(device),
        param_dtype=torch.float32 if training else dtype, training=training, remat=remat)
    init_weights(model, seed)
    if weights is not None:
        load_checkpoint(model, weights)
    model.model_name = model_name
    pp_kw = dict(size=cfg.vision_cfg.image_size, mean=OPENAI_DATASET_MEAN,
                 std=OPENAI_DATASET_STD)
    for k, v in {**hub_pp, **tag_pp}.items():  # the snapshot's first, the tag's win
        pp_kw[k] = tuple(v) if isinstance(v, list) else v
    model.preprocess_cfg = PreprocessCfg(**pp_kw)
    if training:
        return model.train().requires_grad_(True)
    return model.eval().requires_grad_(False)


# the names of open_clip's weight files in a model directory, in the order
# open_clip's factory tries them
WEIGHT_FILE_NAMES = ("open_clip_model.safetensors", "open_clip_pytorch_model.safetensors",
                     "open_clip_pytorch_model.bin", "open_clip_pytorch_model.pth")
TORCH_SUFFIXES = (".bin", ".pt", ".pth")


def resolve_weights(path: Union[str, Path], model_name: str = "") -> Path:
    """The weight file ``path`` names: the file itself; in a directory the
    first of :data:`WEIGHT_FILE_NAMES` it holds; for an ``hf-hub:org/name``
    that file in its cached snapshot; for a registry tag of
    ``model_name`` its local file (``pretrained.download_pretrained``,
    which downloads nothing). Anything else raises FileNotFoundError."""
    spec = str(path)
    if spec.startswith("hf-hub:"):
        return resolve_weights(hf_hub_snapshot(spec))
    p = Path(path)
    if p.is_dir():
        for name in WEIGHT_FILE_NAMES:
            if (p / name).is_file():
                return p / name
        raise FileNotFoundError(f"{p} holds none of the weight files {WEIGHT_FILE_NAMES}")
    if p.is_file():
        return p
    if get_pretrained_cfg(model_name, spec) is not None:
        return Path(download_pretrained(model_name, spec))
    raise FileNotFoundError(
        f"pretrained weights {spec!r} are neither a local file or directory nor a registry tag "
        f"of model {model_name!r} (its tags: {list_pretrained_tags_by_model(model_name)})")


def read_state_dict(path: Union[str, Path], model_name: str = "") -> Dict[str, torch.Tensor]:
    """The state dict in a weight file (:func:`resolve_weights`), in this
    package's (open_clip's) key layout: a safetensors or torch file (a
    ``state_dict`` entry unwrapped, ``module.``/``_orig_mod.`` prefixes
    stripped, a BatchNorm's ``num_batches_tracked`` dropped, as JAX's RN
    converter drops it; an open_clip timm ConvNeXt or ViT image tower
    mapped through :func:`convert.from_open_clip_timm`), an OpenAI
    TorchScript archive (:func:`convert.read_openai_archive`: the scripted
    module's state dict, its three integer entries dropped), or a
    JAX-layout ``.npz`` mapped through :func:`convert.from_jax_params`."""
    from spatial_clip_tpu_torch.models.convert import (
        from_jax_params,
        is_torchscript_archive,
        read_openai_archive,
    )
    from spatial_clip_tpu_torch.train.checkpoints import load_params_npz

    p = resolve_weights(path, model_name)
    suffix = p.suffix.lower()
    if suffix == ".npz":
        return from_jax_params(load_params_npz(p))
    if suffix == ".safetensors":
        from safetensors.torch import load_file

        obj = load_file(str(p))
    elif is_torchscript_archive(p):
        obj = read_openai_archive(p)
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
        if k.endswith(".num_batches_tracked"):  # an open_clip RN's BatchNorm counters
            continue
        out[k] = torch.as_tensor(v)
    if "visual.trunk.stem.0.weight" in out or "visual.trunk.patch_embed.proj.weight" in out:
        from spatial_clip_tpu_torch.models.convert import from_open_clip_timm

        return from_open_clip_timm(out)  # open_clip's timm ConvNeXt / ViT layout
    return out


def load_checkpoint(model: CLIP, path: Union[str, Path], model_name: str = "") -> CLIP:
    """Load the weights ``path`` names (:func:`read_state_dict`; a registry
    tag is looked up under ``model_name``, default the model's own) into
    ``model`` strictly: a missing or extra key, or another shape, raises.
    A positional embedding of another length is resized to the model's
    first (:func:`convert.fit_positional_embeddings`)."""
    from spatial_clip_tpu_torch.models.convert import fit_positional_embeddings

    name = model_name or getattr(model, "model_name", "")
    with torch.no_grad():
        sd = fit_positional_embeddings(read_state_dict(path, name), model.state_dict())
        model.load_state_dict(sd, strict=True)
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
    model's). A text config naming ``hf_tokenizer_name`` gets the
    :class:`HFTokenizer` (local files only; ``kwargs`` go to its
    ``from_pretrained``)."""
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
    if cfg.text_cfg.hf_tokenizer_name:
        return HFTokenizer(cfg.text_cfg.hf_tokenizer_name, context_length=ctx, **kwargs)
    if kwargs:
        raise NotImplementedError(f"tokenizer keywords {sorted(kwargs)} are not ported to "
                                  "spatial_clip_tpu_torch")
    if gene_vocab is not None:
        return GeneTokenizer(gene_vocab, context_length=ctx)
    try:
        tok = SimpleTokenizer(bpe_path=bpe_path, context_length=ctx)
    except FileNotFoundError:
        return HashTokenizer(vocab_size=cfg.text_cfg.vocab_size, context_length=ctx)
    if cfg.text_cfg.vocab_size and cfg.text_cfg.vocab_size < tok.vocab_size:
        return HashTokenizer(vocab_size=cfg.text_cfg.vocab_size, context_length=ctx)
    return tok


def create_loss(args) -> Callable:
    """The loss that a namespace or dict of open_clip-style options names,
    keyed as the JAX package's ``create_loss``: ``use_spatial_loss`` (or
    ``name='spatial'``) the spatial loss, ``siglip`` (or ``name='siglip'``)
    SigLIP, else CLIP; the options ``cap_logit_scale``,
    ``temp_reg_weight``, ``neighbor_alpha_scale``, ``float32_logits`` and
    ``loss_dist_impl`` (as ``dist_impl``) go to :func:`losses.make_loss`."""
    from spatial_clip_tpu_torch.losses import make_loss

    get = (lambda k, d=None: args.get(k, d)) if isinstance(args, dict) else (
        lambda k, d=None: getattr(args, k, d))
    if get("use_spatial_loss") or get("name") == "spatial":
        kind = "spatial"
    elif get("siglip") or get("name") == "siglip":
        kind = "siglip"
    else:
        kind = "clip"
    return make_loss(
        kind,
        local_loss=bool(get("local_loss", True)),
        cap_logit_scale=get("cap_logit_scale"),
        temp_reg_weight=float(get("temp_reg_weight", 0.0) or 0.0),
        neighbor_alpha_scale=float(get("neighbor_alpha_scale", 1.0) or 1.0),
        float32_logits=bool(get("float32_logits", True)),
        dist_impl=get("loss_dist_impl", "gather"),
    )
