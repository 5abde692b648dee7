"""Model architecture configuration.

The same dataclasses and JSON resolution as ``spatial_clip_tpu.models.config``,
reading that package's ``model_configs/*.json`` in place, by path.
:func:`check_ported` names any field whose feature this package does not
implement yet, so that no configuration is silently served with a
different architecture.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

# the JAX package's data directory, read in place
REFERENCE_MODELS_DIR = Path(__file__).resolve().parents[2] / "spatial_clip_tpu" / "models"
CONFIG_DIR = REFERENCE_MODELS_DIR / "model_configs"


def _filter_kwargs(cls, cfg: Dict[str, Any]) -> Dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in cfg.items() if k in names}


@dataclass
class VisionCfg:
    image_size: Union[int, Tuple[int, int]] = 224
    patch_size: int = 32
    width: int = 768
    layers: int = 12
    heads: Optional[int] = None  # default width // 64
    mlp_ratio: float = 4.0
    ls_init_value: Optional[float] = None
    patch_dropout: float = 0.0
    attentional_pool: bool = False
    no_ln_pre: bool = False
    pos_embed_type: str = "learnable"
    final_ln_after_pool: bool = False
    pool_type: str = "tok"  # tok | avg | none
    qk_norm: bool = False
    scaled_cosine: bool = False
    patchify_impl: str = "reshape"
    output_tokens: bool = False
    norm_eps: float = 1e-5
    timm_model_name: Optional[str] = None

    def __post_init__(self):
        if self.heads is None:
            self.heads = max(1, self.width // 64)

    @property
    def size(self) -> int:
        im = self.image_size
        return im[0] if isinstance(im, (tuple, list)) else im


@dataclass
class TextCfg:
    context_length: int = 77
    vocab_size: int = 49408
    width: int = 512
    heads: int = 8
    layers: int = 12
    mlp_ratio: float = 4.0
    ls_init_value: Optional[float] = None
    embed_cls: bool = False
    no_causal_mask: bool = False
    final_ln_after_pool: bool = False
    pool_type: str = "argmax"  # argmax | last | first | avg | none
    qk_norm: bool = False
    proj_bias: bool = False
    norm_eps: float = 1e-5
    hf_tokenizer_name: Optional[str] = None
    hf_model_name: Optional[str] = None
    hf_config: Optional[Dict[str, Any]] = None


@dataclass
class CLIPCfg:
    embed_dim: int = 512
    vision_cfg: VisionCfg = field(default_factory=VisionCfg)
    text_cfg: TextCfg = field(default_factory=TextCfg)
    gene_cfg: Optional[Dict[str, Any]] = None
    multimodal_cfg: Optional[Dict[str, Any]] = None
    attn_impl: str = "auto"
    zip_towers: str = "off"
    mlp_impl: str = "dense"
    ln_gemm_impl: str = "dense"
    ln_impl: str = "onepass"  # onepass (f32 E[x^2]-E[x]^2) | fp32 (two-pass)
    init_logit_scale: float = 2.6592  # ln(1/0.07)
    init_logit_bias: Optional[float] = None
    quick_gelu: bool = False

    @classmethod
    def from_dict(cls, cfg: Dict[str, Any]) -> "CLIPCfg":
        cfg = dict(cfg)
        vision = cfg.pop("vision_cfg", {}) or {}
        text = cfg.pop("text_cfg", {}) or {}
        return cls(
            vision_cfg=VisionCfg(**_filter_kwargs(VisionCfg, vision)),
            text_cfg=TextCfg(**_filter_kwargs(TextCfg, text)),
            **_filter_kwargs(cls, cfg),
        )


def check_ported(cfg: CLIPCfg) -> None:
    """Raise NotImplementedError naming the first field this port lacks."""
    v, t = cfg.vision_cfg, cfg.text_cfg
    unported = [
        ("gene_cfg", cfg.gene_cfg, cfg.gene_cfg is not None),
        ("multimodal_cfg", cfg.multimodal_cfg, cfg.multimodal_cfg is not None),
        ("attn_impl", cfg.attn_impl, cfg.attn_impl not in ("auto", "pallas")),
        ("zip_towers", cfg.zip_towers, cfg.zip_towers not in ("off", "auto")),
        ("mlp_impl", cfg.mlp_impl, cfg.mlp_impl != "dense"),
        ("ln_gemm_impl", cfg.ln_gemm_impl, cfg.ln_gemm_impl != "dense"),
        ("ln_impl", cfg.ln_impl, cfg.ln_impl not in ("onepass", "fp32")),
        ("vision_cfg.timm_model_name", v.timm_model_name, v.timm_model_name is not None),
        ("vision_cfg.layers", v.layers, isinstance(v.layers, (list, tuple))),
        ("vision_cfg.qk_norm", v.qk_norm, v.qk_norm),
        ("vision_cfg.scaled_cosine", v.scaled_cosine, v.scaled_cosine),
        ("vision_cfg.attentional_pool", v.attentional_pool, v.attentional_pool),
        ("vision_cfg.patch_dropout", v.patch_dropout, v.patch_dropout > 0),
        ("vision_cfg.pos_embed_type", v.pos_embed_type, v.pos_embed_type != "learnable"),
        ("vision_cfg.patchify_impl", v.patchify_impl, v.patchify_impl != "reshape"),
        ("vision_cfg.output_tokens", v.output_tokens, v.output_tokens),
        ("text_cfg.hf_model_name", t.hf_model_name, t.hf_model_name is not None),
        ("text_cfg.hf_config", t.hf_config, t.hf_config is not None),
        ("text_cfg.qk_norm", t.qk_norm, t.qk_norm),
        ("text_cfg.embed_cls", t.embed_cls, t.embed_cls),
    ]
    for name, value, bad in unported:
        if bad:
            raise NotImplementedError(
                f"{name}={value!r} is not ported to spatial_clip_tpu_torch")


def list_model_configs() -> list:
    return sorted(p.stem for p in CONFIG_DIR.glob("*.json"))


def load_model_config(model_name: str) -> Dict[str, Any]:
    """A built-in name (``ViT-B-32``) or a path to a ``.json`` file."""
    builtin = CONFIG_DIR / f"{model_name.replace('/', '-')}.json"
    if builtin.exists():
        return json.loads(builtin.read_text())
    p = Path(model_name)
    if p.suffix == ".json" and p.exists():
        return json.loads(p.read_text())
    if model_name.startswith("hf-hub:"):
        raise NotImplementedError(
            f"model_name={model_name!r}: hf-hub names are not ported to "
            "spatial_clip_tpu_torch")
    raise ValueError(
        f"Unknown model '{model_name}'. Built-ins: {list_model_configs()}")


def resolve_clip_cfg(model_name: str, **overrides) -> CLIPCfg:
    """JSON config plus overrides; ``vision_cfg``/``text_cfg`` dicts merge."""
    raw = load_model_config(model_name)
    for key, value in overrides.items():
        if key in ("vision_cfg", "text_cfg") and isinstance(value, dict) \
                and isinstance(raw.get(key), dict):
            raw[key] = {**raw[key], **value}
        else:
            raw[key] = value
    return CLIPCfg.from_dict(raw)
