"""Model architecture configuration.

The same dataclasses and JSON resolution as ``spatial_clip_tpu.models.config``,
reading that package's ``model_configs/*.json`` in place, by path.
:func:`check_ported` names any field whose feature this package does not
implement yet, so that no configuration is silently served with a
different architecture. Unlike the JAX package, a JSON key that no
dataclass carries is not dropped unseen: :meth:`CLIPCfg.from_dict` records
it in ``CLIPCfg.dropped``, and :func:`check_ported` refuses it unless it is
one of :data:`IGNORED_KEYS`.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

# the JAX package's data directory, read in place
REFERENCE_MODELS_DIR = Path(__file__).resolve().parents[2] / "spatial_clip_tpu" / "models"
CONFIG_DIR = REFERENCE_MODELS_DIR / "model_configs"


# JSON keys that no dataclass carries and that change nothing this package
# builds: open_clip's CustomTextCLIP flag (the same function here), the timm
# trunk's pretrained flag and drop path, which the JAX package's timm towers
# ignore as well (no trunk downloads, none has a drop path), and the JAX
# VisionCfg's act_kwargs, which no JAX image tower reads (the JAX package's
# save_for_hf writes it).
IGNORED_KEYS = frozenset({
    "custom_text",
    "vision_cfg.timm_model_pretrained", "vision_cfg.timm_drop_path", "vision_cfg.act_kwargs",
})
# the text pool types text_global_pool computes, as the JAX towers do
TEXT_POOL_TYPES = ("argmax", "last", "first", "avg", "none")
# the attn_impl settings the towers take: the kernels' and JAX's plain routes
ATTN_IMPLS = ("auto", "pallas", "pallas3", "pallas_inter", "pallas_t", "pallas_split",
              "einsum", "einsum_bf16", "xla", "fold", "fold_bf16")


def _filter_kwargs(cls, cfg: Dict[str, Any]) -> Dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in cfg.items() if k in names}


def _dropped_keys(cls, cfg: Dict[str, Any], prefix: str = "") -> Tuple[str, ...]:
    names = {f.name for f in dataclasses.fields(cls)}
    return tuple(prefix + k for k in cfg if k not in names)


@dataclass
class VisionCfg:
    image_size: Union[int, Tuple[int, int]] = 224
    patch_size: int = 32
    width: int = 768
    layers: int = 12
    heads: Optional[int] = None  # default width // 64
    # open_clip's head width (its heads = width // head_width); the towers
    # take heads, and check_ported refuses a head_width that disagrees
    head_width: Optional[int] = None
    mlp_ratio: float = 4.0
    ls_init_value: Optional[float] = None
    patch_dropout: float = 0.0
    attentional_pool: bool = False
    attn_pooler_queries: int = 256
    attn_pooler_heads: int = 8
    no_ln_pre: bool = False
    pos_embed_type: str = "learnable"
    final_ln_after_pool: bool = False
    pool_type: str = "tok"  # tok | avg | none
    qk_norm: bool = False
    scaled_cosine: bool = False
    patchify_impl: str = "reshape"
    output_tokens: bool = False
    norm_eps: float = 1e-5
    # the timm-style tower (models/timm_model.py) when timm_model_name is set
    timm_model_name: Optional[str] = None
    timm_pool: str = "avg"  # avg | '' | token | map | abs_attn | rot_attn
    timm_proj: Optional[str] = "linear"  # linear | mlp | none | None / ''
    timm_proj_bias: bool = False
    timm_drop: float = 0.0  # dropout before the projection (0 in every built-in config)

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
    eos_id: Optional[int] = None  # the token that pool_type 'eos' pools (not ported)
    qk_norm: bool = False
    proj_bias: bool = False
    norm_eps: float = 1e-5
    pad_id: int = 0
    hf_tokenizer_name: Optional[str] = None
    # the Hugging Face text tower (models/hf_model.py) when hf_model_name or
    # hf_config is set: built from the architecture's class defaults
    # updated by hf_config, never downloaded
    hf_model_name: Optional[str] = None
    hf_model_arch: Optional[str] = None  # None: inferred from hf_model_name
    hf_config: Optional[Dict[str, Any]] = None
    hf_pooler_type: str = "mean_pooler"  # cls_pooler | mean_pooler | max_pooler | last
    hf_proj_type: str = "linear"  # linear | mlp

    def __post_init__(self):
        if self.hf_model_arch is None:
            self.hf_model_arch = (infer_hf_arch(self.hf_model_name) if self.hf_model_name
                                  else "bert")
        # the architecture's pad token: m2m_100 and the RoBERTa family pad
        # with 1, BERT and T5 with 0 (JAX's TextCfg, explicit arch included)
        if (self.hf_tower and self.hf_model_arch in ("m2m_100", "roberta", "xlm-roberta")
                and self.pad_id == 0):
            self.pad_id = 1

    @property
    def hf_tower(self) -> bool:
        return bool(self.hf_model_name) or self.hf_config is not None


def infer_hf_arch(name: str) -> str:
    """A hub id's architecture family, matched by name as JAX's
    ``infer_hf_arch`` does (nllb-clip's text tower is the m2m_100 encoder)."""
    n = name.lower()
    if "nllb" in n or "m2m" in n:
        return "m2m_100"
    if "xlm-roberta" in n or "xlm_roberta" in n:
        return "xlm-roberta"
    if "roberta" in n:
        return "roberta"
    if "mt5" in n:
        return "mt5"
    if "t5" in n:
        return "t5"
    return "bert"


@dataclass
class GeneCfg:
    """The Gene-MLP tower: a rank-weighted gene-expression vector through an
    MLP, in place of the text transformer."""
    num_genes: int = 5000
    width: int = 1024
    layers: int = 3
    gene_dropout: float = 0.0  # train-time gene masking, without rescaling
    norm_eps: float = 1e-5


@dataclass
class MultimodalCfg:
    """The CoCa decoder (JAX's ``MultimodalCfg``): ``layers`` multimodal
    blocks, ``caption_queries`` (+ 1 contrastive) attentional-pooler queries.

    The other fields are open_clip's decoder keys, which JAX's
    ``MultimodalCfg`` drops: JAX builds the decoder at the text tower's
    width, heads, context and vocab with an MLP ratio of 4, and the pooler
    with ``caption_queries + 1`` queries at ``vision_cfg.attn_pooler_heads``.
    :func:`check_ported` takes each where it equals what JAX builds
    (:meth:`jax_builds`) and refuses it otherwise, naming it."""
    layers: int = 6
    caption_queries: int = 64
    caption_loss_weight: float = 2.0
    contrastive_loss_weight: float = 1.0
    width: Optional[int] = None
    heads: Optional[int] = None
    context_length: Optional[int] = None
    vocab_size: Optional[int] = None
    mlp_ratio: Optional[float] = None
    dim_head: Optional[int] = None
    n_queries: Optional[int] = None
    attn_pooler_heads: Optional[int] = None

    def jax_builds(self, vision: VisionCfg, text: TextCfg) -> Dict[str, Any]:
        """The value JAX's CoCa builds for each open_clip decoder key."""
        return {"width": text.width, "heads": text.heads, "context_length": text.context_length,
                "vocab_size": text.vocab_size, "mlp_ratio": 4.0,
                "dim_head": text.width // text.heads, "n_queries": self.caption_queries + 1,
                "attn_pooler_heads": vision.attn_pooler_heads}


@dataclass
class CLIPCfg:
    embed_dim: int = 512
    vision_cfg: VisionCfg = field(default_factory=VisionCfg)
    text_cfg: TextCfg = field(default_factory=TextCfg)
    gene_cfg: Optional[GeneCfg] = None  # if set, replaces the text tower
    multimodal_cfg: Optional[MultimodalCfg] = None  # if set, the model is CoCa
    # auto | pallas3 (the qkv GEMM and attention as one autograd function) |
    # pallas (with ln_gemm_impl='pallas': ln_1 -> qkv fused, then attention) |
    # pallas_inter | pallas_t | pallas_split (other layouts of the kernels);
    # each takes JAX's einsum attention where JAX's gate refuses its kernel |
    # einsum | einsum_bf16 | xla | fold | fold_bf16 (JAX's plain routes)
    attn_impl: str = "auto"
    # off | auto (JAX zips only on a TPU: the towers run apart here) | on (each
    # layer's image and text attention as one pair-kernel launch)
    zip_towers: str = "off"
    mlp_impl: str = "dense"  # dense | pallas (the fused MLP kernel); int8 is not ported
    ln_gemm_impl: str = "dense"  # dense | pallas (ln_2 -> c_fc, ln_1 -> qkv fused)
    # onepass (f32 E[x^2]-E[x]^2) | fp32 (two-pass) | pallas (the fused_ln kernels)
    ln_impl: str = "onepass"
    init_logit_scale: float = 2.6592  # ln(1/0.07)
    init_logit_bias: Optional[float] = None
    quick_gelu: bool = False
    # the JSON keys from_dict found no field for ("vision_cfg.<key>", ...)
    dropped: Tuple[str, ...] = ()

    @classmethod
    def from_dict(cls, cfg: Dict[str, Any]) -> "CLIPCfg":
        cfg = dict(cfg)
        vision = cfg.pop("vision_cfg", {}) or {}
        text = cfg.pop("text_cfg", {}) or {}
        gene = cfg.pop("gene_cfg", None)
        multimodal = cfg.pop("multimodal_cfg", None)
        dropped = (_dropped_keys(cls, cfg) + _dropped_keys(VisionCfg, vision, "vision_cfg.")
                   + _dropped_keys(TextCfg, text, "text_cfg.")
                   + _dropped_keys(GeneCfg, gene or {}, "gene_cfg.")
                   + _dropped_keys(MultimodalCfg, multimodal or {}, "multimodal_cfg."))
        return cls(
            vision_cfg=VisionCfg(**_filter_kwargs(VisionCfg, vision)),
            text_cfg=TextCfg(**_filter_kwargs(TextCfg, text)),
            gene_cfg=GeneCfg(**_filter_kwargs(GeneCfg, gene)) if gene else None,
            multimodal_cfg=(MultimodalCfg(**_filter_kwargs(MultimodalCfg, multimodal))
                            if multimodal else None),
            **{**_filter_kwargs(cls, cfg), "dropped": dropped},
        )


def check_ported(cfg: CLIPCfg) -> None:
    """Raise NotImplementedError naming the first field this port lacks:
    an unported feature, a ``timm_model_name`` outside the trunk registry
    (``timm_model.TRUNKS``; raised as a KeyError too, listing the trunks, as
    JAX's adapter raises it), a tower dropout (``timm_drop``), a
    ``head_width`` that disagrees with ``heads``
    (open_clip builds width // head_width heads; these towers build
    ``heads``), a text ``pool_type`` outside :data:`TEXT_POOL_TYPES`
    (``'eos'``), a dropped JSON key outside :data:`IGNORED_KEYS` (the
    SigLIP text towers' ``norm_kwargs`` / ``act_kwargs``, a tokenizer's
    ``tokenizer_kwargs``), or a Hugging Face text tower whose architecture,
    pooler, projection or ``hf_config`` key the port's encoders do not build
    (``hf_model.check_hf``).

    The attentional pooler and the cls-token text tower are the ViT's and
    the CLIP text transformer's options: on another tower, which JAX
    builds without them, they are refused. Under ``multimodal_cfg`` (CoCa)
    every setting JAX's CoCa ignores is refused where it is not its default
    (:func:`_coca_ignored`), and so is an open_clip decoder key whose value
    is not the one JAX builds (:meth:`MultimodalCfg.jax_builds`)."""
    v, t = cfg.vision_cfg, cfg.text_cfg
    vit = not v.timm_model_name and not isinstance(v.layers, (list, tuple))
    clip_text = not t.hf_tower and cfg.gene_cfg is None
    unported = [
        ("attn_impl", cfg.attn_impl, cfg.attn_impl not in ATTN_IMPLS),
        ("zip_towers", cfg.zip_towers, cfg.zip_towers not in ("off", "auto", "on")),
        ("mlp_impl", cfg.mlp_impl, cfg.mlp_impl not in ("dense", "pallas")),
        ("ln_gemm_impl", cfg.ln_gemm_impl, cfg.ln_gemm_impl not in ("dense", "pallas")),
        ("ln_impl", cfg.ln_impl, cfg.ln_impl not in ("onepass", "fp32", "pallas")),
        ("vision_cfg.timm_drop", v.timm_drop, bool(v.timm_model_name) and v.timm_drop > 0),
        # open_clip's ModifiedResNet has four stages (layer1 ... layer4)
        ("vision_cfg.layers", v.layers,
         isinstance(v.layers, (list, tuple)) and len(v.layers) != 4),
        ("vision_cfg.qk_norm", v.qk_norm, v.qk_norm),
        ("vision_cfg.scaled_cosine", v.scaled_cosine, v.scaled_cosine),
        ("vision_cfg.attentional_pool", v.attentional_pool, v.attentional_pool and not vit),
        ("vision_cfg.patch_dropout", v.patch_dropout, v.patch_dropout > 0),
        ("vision_cfg.pos_embed_type", v.pos_embed_type, v.pos_embed_type != "learnable"),
        ("vision_cfg.patchify_impl", v.patchify_impl, v.patchify_impl != "reshape"),
        ("text_cfg.qk_norm", t.qk_norm, t.qk_norm),
        ("text_cfg.embed_cls", t.embed_cls, t.embed_cls and not clip_text),
        ("vision_cfg.head_width", v.head_width,
         v.head_width is not None and v.head_width * v.heads != v.width),
        ("text_cfg.pool_type", t.pool_type, t.pool_type not in TEXT_POOL_TYPES),
    ]
    if cfg.multimodal_cfg is not None:
        unported = _coca_ignored(cfg) + unported
    if v.timm_model_name is not None:
        from spatial_clip_tpu_torch.models.timm_model import TRUNKS, UnknownTrunkError

        if v.timm_model_name not in TRUNKS:
            raise UnknownTrunkError(
                f"vision_cfg.timm_model_name={v.timm_model_name!r} is not ported to "
                f"spatial_clip_tpu_torch: unknown timm-style trunk; available: {sorted(TRUNKS)}")
    for name, value, bad in unported:
        if bad:
            raise NotImplementedError(
                f"{name}={value!r} is not ported to spatial_clip_tpu_torch")
    for key in cfg.dropped:
        if key not in IGNORED_KEYS:
            raise NotImplementedError(
                f"{key} is not ported to spatial_clip_tpu_torch (no field carries it, and it "
                "changes the function)")
    m = cfg.multimodal_cfg
    if m is not None:
        for key, want in m.jax_builds(v, t).items():
            got = getattr(m, key)
            if got is not None and got != want:
                raise NotImplementedError(
                    f"multimodal_cfg.{key}={got!r} is not ported to spatial_clip_tpu_torch: "
                    f"JAX's CoCa drops the key and builds {want!r}")
    if t.hf_tower and cfg.gene_cfg is None:
        from spatial_clip_tpu_torch.models.hf_model import check_hf

        check_hf(t.hf_model_arch, t.hf_config, t.hf_pooler_type, t.hf_proj_type,
                 t.hf_model_name)


def _coca_ignored(cfg: CLIPCfg) -> list:
    """(field, value, refused) for each setting JAX's CoCa does not read
    (``coca.py:122-183`` builds a ViT with the attentional pooler, the CLIP
    text tower with the cls token, einsum attention and two-pass LayerNorm,
    whatever these say): refused where it differs from its default. The
    pooler's ``attn_pooler_queries`` is ``caption_queries + 1``, and the
    tower options CoCa forces (``attentional_pool``, ``output_tokens``,
    ``embed_cls``) are taken either way."""
    v, t, m = cfg.vision_cfg, cfg.text_cfg, cfg.multimodal_cfg
    return [
        ("attn_impl", cfg.attn_impl, cfg.attn_impl != "auto"),
        ("zip_towers", cfg.zip_towers, cfg.zip_towers != "off"),
        ("mlp_impl", cfg.mlp_impl, cfg.mlp_impl != "dense"),
        ("ln_gemm_impl", cfg.ln_gemm_impl, cfg.ln_gemm_impl != "dense"),
        ("ln_impl", cfg.ln_impl, cfg.ln_impl != "onepass"),
        ("init_logit_bias", cfg.init_logit_bias, cfg.init_logit_bias is not None),
        ("gene_cfg", cfg.gene_cfg, cfg.gene_cfg is not None),
        ("vision_cfg.timm_model_name", v.timm_model_name, bool(v.timm_model_name)),
        ("vision_cfg.layers", v.layers, isinstance(v.layers, (list, tuple))),
        ("vision_cfg.ls_init_value", v.ls_init_value, v.ls_init_value is not None),
        ("vision_cfg.no_ln_pre", v.no_ln_pre, v.no_ln_pre),
        ("vision_cfg.final_ln_after_pool", v.final_ln_after_pool, v.final_ln_after_pool),
        ("vision_cfg.pool_type", v.pool_type, v.pool_type != "tok"),
        ("vision_cfg.attn_pooler_queries", v.attn_pooler_queries,
         v.attn_pooler_queries not in (256, m.caption_queries + 1)),
        ("text_cfg.hf_model_name", t.hf_model_name, bool(t.hf_model_name)),
        ("text_cfg.hf_config", t.hf_config, t.hf_config is not None),
        ("text_cfg.ls_init_value", t.ls_init_value, t.ls_init_value is not None),
        ("text_cfg.no_causal_mask", t.no_causal_mask, t.no_causal_mask),
        ("text_cfg.pool_type", t.pool_type, t.pool_type != "argmax"),
        ("text_cfg.final_ln_after_pool", t.final_ln_after_pool, t.final_ln_after_pool),
        ("text_cfg.proj_bias", t.proj_bias, t.proj_bias),
    ]


# configs registered at run time (register_model_config, add_model_config):
# consulted before the built-in JSON directory
_EXTRA_CONFIGS: Dict[str, Dict[str, Any]] = {}


def register_model_config(name: str, cfg: Dict[str, Any]) -> None:
    """Register an architecture config dict under ``name``; it wins over a
    built-in of the same name."""
    _EXTRA_CONFIGS[name.replace("/", "-")] = dict(cfg)


def add_model_config(path) -> None:
    """Register every ``*.json`` model config under ``path`` (a file or a
    directory), each under its file's stem."""
    p = Path(path)
    if not p.exists():
        raise FileNotFoundError(f"add_model_config: {p} does not exist")
    files = [p] if p.is_file() else sorted(p.glob("*.json"))
    if not files or any(f.suffix.lower() != ".json" for f in files):
        raise ValueError(f"add_model_config: {p} contains no .json model configs")
    for f in files:
        register_model_config(f.stem, json.loads(f.read_text()))


def list_model_configs() -> list:
    """Every architecture name: the built-in JSONs and the registered ones."""
    return sorted({p.stem for p in CONFIG_DIR.glob("*.json")} | set(_EXTRA_CONFIGS))


def hf_cache_snapshot(repo: str) -> Optional[Path]:
    """The newest snapshot of ``repo`` in a local Hugging Face hub cache
    that holds an ``open_clip_config.json``, or None. The cache roots are
    ``$HF_HUB_CACHE``, ``$HUGGINGFACE_HUB_CACHE`` and ``$HF_HOME/hub``
    (default ``~/.cache/huggingface/hub``), each laid out as
    ``models--org--name/snapshots/<revision>/``. Nothing is fetched."""
    roots = [Path(os.environ[var]) for var in ("HF_HUB_CACHE", "HUGGINGFACE_HUB_CACHE")
             if os.environ.get(var)]
    roots.append(Path(os.environ.get("HF_HOME", Path.home() / ".cache" / "huggingface")) / "hub")
    for root in roots:
        snaps = root / ("models--" + repo.replace("/", "--")) / "snapshots"
        if not snaps.is_dir():
            continue
        for snap in sorted(snaps.iterdir(), key=lambda q: q.stat().st_mtime, reverse=True):
            if (snap / "open_clip_config.json").is_file():
                return snap
    return None


def hf_hub_snapshot(model_name: str) -> Path:
    """The cached snapshot an ``hf-hub:org/name`` model name resolves to;
    raises ValueError where the cache holds none."""
    repo = model_name[len("hf-hub:"):]
    snap = hf_cache_snapshot(repo)
    if snap is None:
        raise ValueError(
            f"'{model_name}' resolves through the Hugging Face hub; no cached snapshot with "
            f"open_clip_config.json was found under the HF cache, and nothing is downloaded. "
            f"Populate the cache (models--{repo.replace('/', '--')}/snapshots/<rev>/ under "
            f"$HF_HUB_CACHE) or pass a local-dir: name or a .json config.")
    return snap


def load_model_config(model_name: str) -> Dict[str, Any]:
    """The raw JSON config of ``model_name``: an ``hf-hub:org/name`` (the
    ``model_cfg`` of its cached snapshot's ``open_clip_config.json``), a
    registered name, a built-in name (``ViT-B-32``), a path to a ``.json``
    file, or ``local-dir:<dir>`` (the ``model_cfg`` of
    ``<dir>/open_clip_config.json``)."""
    if model_name.startswith("hf-hub:"):
        cfg = json.loads((hf_hub_snapshot(model_name) / "open_clip_config.json").read_text())
        return cfg.get("model_cfg", cfg)
    name = model_name.replace("/", "-")
    if name in _EXTRA_CONFIGS:
        return dict(_EXTRA_CONFIGS[name])
    builtin = CONFIG_DIR / f"{name}.json"
    if builtin.exists():
        return json.loads(builtin.read_text())
    p = Path(model_name)
    if p.suffix == ".json" and p.exists():
        return json.loads(p.read_text())
    if model_name.startswith("local-dir:"):
        cfg_file = Path(model_name[len("local-dir:"):]) / "open_clip_config.json"
        cfg = json.loads(cfg_file.read_text())
        return cfg.get("model_cfg", cfg)
    raise ValueError(
        f"Unknown model '{model_name}'. Built-ins: {list_model_configs()}")


def resolve_clip_cfg(model_name: str, **overrides) -> CLIPCfg:
    """JSON config plus overrides; ``vision_cfg``/``text_cfg``/``gene_cfg``/
    ``multimodal_cfg`` dicts merge."""
    raw = load_model_config(model_name)
    for key, value in overrides.items():
        if key in ("vision_cfg", "text_cfg", "gene_cfg", "multimodal_cfg") \
                and isinstance(value, dict) \
                and isinstance(raw.get(key), dict):
            raw[key] = {**raw[key], **value}
        else:
            raw[key] = value
    return CLIPCfg.from_dict(raw)
