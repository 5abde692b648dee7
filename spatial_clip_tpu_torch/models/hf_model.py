"""Hugging Face text towers (counterpart of ``spatial_clip_tpu.models.hf_model``).

The JAX package wraps transformers' Flax encoders as a CLIP text tower
(``HFTextTower``): BERT, RoBERTa and XLM-RoBERTa (``FlaxBertModule`` and
its copies), T5 and mT5 (``FlaxT5EncoderModule``) and its own flax
M2M100 / NLLB encoder (``models/m2m_encoder.py``), each built from the
architecture's config class, ``config_cls(**(hf_config or {}))``: a JSON
that names only ``hf_model_name`` gets transformers' class defaults
(:data:`HF_DEFAULTS`), never the hub's sizes. This module writes those
encoders natively in PyTorch, with the same parameters under the same
names (flax's path, ``/`` as ``.``; a ``kernel`` (in, out) is a ``weight``
(out, in), an ``embedding`` or a LayerNorm's ``scale`` a ``weight``) and
the same rounding points:

- BERT family: post-LN layers, learned absolute positions ``arange(L)``
  and zero token types (as JAX hands them to the module; transformers'
  torch RoBERTa counts positions from ``padding_idx + 1`` instead), the
  exact-erf GELU (``hidden_act='gelu'``), flax's one-pass LayerNorm with the
  config's ``layer_norm_eps``; the pooler (``pooler.dense``) is built, as in
  JAX's tree, and unused.
- T5 family: RMSNorm with its variance in f32 (and its output in f32, as
  flax's ``FlaxT5LayerNorm`` multiplies by an f32 weight), a bucketed
  bidirectional relative bias computed in block 0 and shared by every
  block, no ``1/sqrt(d)`` on the scores, an inner width of ``heads x d_kv``,
  ReLU (``'relu'``) or the gated tanh GELU (``'gated-gelu'``) FFN.

Attention takes flax's ``dot_product_attention_weights`` route: scores,
the mask bias (``finfo(dtype).min``) and the softmax in the compute dtype,
through ``ops.attention_plain.encoder_attention`` (counted), never SDPA.
The tower pools the last hidden state (``cls_pooler``, ``mean_pooler``,
``max_pooler``, ``last``) and projects it, ``linear`` (one bias-free dense
layer) or ``mlp`` (two, with flax's ``nn.gelu``, the tanh form, between).

Dropout runs where flax's runs in a training step (JAX's Trainer applies
the HF encoders with ``deterministic=False``): the embeddings, the
attention weights (broadcast over batch and heads in the BERT and T5
families, as ``dot_product_attention_weights`` draws them), each residual
branch and T5's FFN activation. Its masks come from :class:`DropoutDraws`,
a counter-based hash of (seed, call, element) in integer tensor ops, so the
card and the CPU draw the same masks for the same seed; JAX's bits come
from its own generator and cannot be matched, so the CPU tests compare
these towers with their dropout rates at 0.

``transformers`` is not imported here: :data:`HF_DEFAULTS` holds each
architecture's defaults for the fields the encoders read, and a test holds
it against the config classes where transformers is installed.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from spatial_clip_tpu_torch.models.transformer import Dense, LayerNorm, _param, gelu_tanh
from spatial_clip_tpu_torch.ops.attention_plain import encoder_attention

HF_ARCHS = ("bert", "roberta", "xlm-roberta", "t5", "mt5", "m2m_100")
POOLERS = ("cls_pooler", "mean_pooler", "max_pooler", "last")
PROJ_TYPES = ("linear", "mlp")

_BERT = dict(vocab_size=30522, hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
             intermediate_size=3072, hidden_act="gelu", hidden_dropout_prob=0.1,
             attention_probs_dropout_prob=0.1, max_position_embeddings=512, type_vocab_size=2,
             initializer_range=0.02, layer_norm_eps=1e-12, position_embedding_type="absolute",
             pad_token_id=0, is_decoder=False, add_cross_attention=False)
_T5 = dict(vocab_size=32128, d_model=512, d_kv=64, d_ff=2048, num_layers=6, num_heads=8,
           relative_attention_num_buckets=32, relative_attention_max_distance=128,
           dropout_rate=0.1, layer_norm_epsilon=1e-6, initializer_factor=1.0,
           feed_forward_proj="relu", pad_token_id=0, is_decoder=False,
           add_cross_attention=False)
# transformers' config classes at their defaults, the fields these encoders read
HF_DEFAULTS: Dict[str, Dict[str, Any]] = {
    "bert": _BERT,
    "roberta": {**_BERT, "vocab_size": 50265, "pad_token_id": 1},
    "xlm-roberta": {**_BERT, "pad_token_id": 1},  # XLMRobertaConfig(): vocab 30522
    "t5": _T5,
    "mt5": {**_T5, "vocab_size": 250112, "d_ff": 1024, "num_layers": 8, "num_heads": 6,
            "feed_forward_proj": "gated-gelu"},
    "m2m_100": dict(vocab_size=128112, max_position_embeddings=1024, d_model=1024,
                    encoder_ffn_dim=4096, encoder_layers=12, encoder_attention_heads=16,
                    dropout=0.1, attention_dropout=0.1, activation_dropout=0.0,
                    activation_function="relu", scale_embedding=True, pad_token_id=1,
                    is_decoder=False, add_cross_attention=False),
}
# config keys that change nothing an encoder computes: generation and output
# settings, special tokens other than the pad, the decoder's sizes, and
# settings the JAX encoders ignore (M2M100's layer drop and init_std: JAX's
# flax encoder has neither)
IGNORED_HF_KEYS = frozenset({
    "return_dict", "output_hidden_states", "output_attentions", "torchscript", "dtype",
    "torch_dtype", "use_bfloat16", "tie_word_embeddings", "is_encoder_decoder",
    "tie_encoder_decoder", "architectures", "finetuning_task", "id2label", "label2id",
    "num_labels", "task_specific_params", "problem_type", "tokenizer_class", "prefix",
    "bos_token_id", "eos_token_id", "sep_token_id", "decoder_start_token_id",
    "max_length", "min_length", "do_sample", "early_stopping", "num_beams", "temperature",
    "top_k", "top_p", "typical_p", "repetition_penalty", "length_penalty",
    "no_repeat_ngram_size", "encoder_no_repeat_ngram_size", "bad_words_ids",
    "num_return_sequences", "output_scores", "return_dict_in_generate", "forced_bos_token_id",
    "forced_eos_token_id", "remove_invalid_values", "exponential_decay_length_penalty",
    "suppress_tokens", "begin_suppress_tokens", "num_beam_groups", "diversity_penalty",
    "_name_or_path", "tf_legacy_loss", "transformers_version", "model_type", "use_cache",
    "classifier_dropout", "chunk_size_feed_forward", "cross_attention_hidden_size",
    "pruned_heads", "gradient_checkpointing", "num_decoder_layers", "decoder_layers",
    "decoder_attention_heads", "decoder_ffn_dim", "decoder_layerdrop", "encoder_layerdrop",
    "init_std",
})
# hidden_act values and the functions flax's ACT2FN gives them
_ACTS = {"gelu": F.gelu, "gelu_new": gelu_tanh, "gelu_pytorch_tanh": gelu_tanh, "relu": F.relu}


def _refuse(arch: str, key: str, value) -> None:
    raise NotImplementedError(
        f"text_cfg.hf_config[{key!r}]={value!r} ({arch}) is not ported to "
        "spatial_clip_tpu_torch")


def resolve_hf_config(arch: str, hf_config: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """The architecture's defaults updated by ``hf_config``, as the config
    class builds them. A key the encoders do not read (and that is not in
    :data:`IGNORED_HF_KEYS`), or a value they do not build, raises
    NotImplementedError naming it (an unknown ``arch``: :func:`check_hf`)."""
    cfg = dict(HF_DEFAULTS[arch])
    for key, value in (hf_config or {}).items():
        if key in cfg:
            cfg[key] = value
        elif key not in IGNORED_HF_KEYS:
            _refuse(arch, key, value)
    for key in ("is_decoder", "add_cross_attention"):
        if cfg[key]:
            _refuse(arch, key, cfg[key])
    if arch in ("t5", "mt5"):
        if cfg["feed_forward_proj"] not in ("relu", "gated-gelu"):
            _refuse(arch, "feed_forward_proj", cfg["feed_forward_proj"])
    elif arch == "m2m_100":
        if cfg["activation_function"] != "relu":  # JAX's encoder applies ReLU whatever it says
            _refuse(arch, "activation_function", cfg["activation_function"])
    else:
        if cfg["position_embedding_type"] != "absolute":
            _refuse(arch, "position_embedding_type", cfg["position_embedding_type"])
        if cfg["hidden_act"] not in _ACTS:
            _refuse(arch, "hidden_act", cfg["hidden_act"])
    return cfg


def check_hf(arch: str, hf_config, pooler_type: str, proj_type: str,
             model_name: Optional[str] = None) -> None:
    """Raise NotImplementedError naming the first Hugging Face tower setting
    this port does not build (``check_ported`` calls it)."""
    if arch not in HF_DEFAULTS:
        raise NotImplementedError(
            f"text_cfg.hf_model_arch={arch!r} (text_cfg.hf_model_name={model_name!r}) is not "
            f"ported to spatial_clip_tpu_torch (available: {list(HF_ARCHS)})")
    resolve_hf_config(arch, hf_config)
    if pooler_type not in POOLERS:
        raise NotImplementedError(f"text_cfg.hf_pooler_type={pooler_type!r} is not ported to "
                                  f"spatial_clip_tpu_torch (available: {list(POOLERS)})")
    if proj_type not in PROJ_TYPES:
        raise NotImplementedError(f"text_cfg.hf_proj_type={proj_type!r} is not ported to "
                                  f"spatial_clip_tpu_torch (available: {list(PROJ_TYPES)})")


# ---------------------------------------------------------------------------
# dropout masks
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_HASH_MUL = 0x45D9F3B  # < 2**27: every product of a 32-bit value stays inside int64
_IDX_MUL = 0x7FEB352D  # odd and < 2**31: a bijection of the low 32 bits, no int64 overflow


def _mix(x):
    """A 32-bit integer hash of int64 values in [0, 2**32); the same bits
    for a Python int and for a tensor on any device."""
    x = x ^ (x >> 16)
    x = (x * _HASH_MUL) & _M32
    x = x ^ (x >> 16)
    x = (x * _HASH_MUL) & _M32
    return x ^ (x >> 16)


class DropoutDraws:
    """The dropout masks of one forward: call ``n`` draws its mask from the
    key ``mix(seed, n)``, element ``i`` (counted from ``row_offset`` rows
    into the batch, for masks with a batch dimension) kept where
    ``mix((i * c) mod 2**32 xor key) >> 8`` falls below ``keep * 2**24``.
    The masks are a function of the seed and the call order alone, on the
    card as on the CPU."""

    def __init__(self, seed: int, row_offset: int = 0):
        self.seed, self.row_offset, self.calls = int(seed) & _M32, int(row_offset), 0

    def keep(self, shape: Tuple[int, ...], rate: float, device, batched: bool = True):
        key = _mix(_mix(self.seed) ^ self.calls)
        self.calls += 1
        n = math.prod(shape)
        start = self.row_offset * (n // shape[0]) if batched and shape else 0
        idx = torch.arange(start, start + n, device=device, dtype=torch.int64)
        x = _mix(((idx & _M32) * _IDX_MUL & _M32) ^ key)
        return ((x >> 8) < int((1.0 - rate) * (1 << 24))).view(shape)


def dropout(x: torch.Tensor, rate: float, draws: Optional[DropoutDraws]) -> torch.Tensor:
    """flax ``nn.Dropout``: ``x / keep`` where the mask keeps, else 0; the
    identity without draws (evaluation) or at rate 0."""
    if draws is None or rate == 0.0:
        return x
    keep = draws.keep(tuple(x.shape), rate, x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def attention_dropout(rate: float, draws: Optional[DropoutDraws]):
    """``dot_product_attention_weights``' dropout: one (Lq, Lk) mask for every
    batch row and head, the weights times ``keep / keep_prob`` in their
    dtype; None where nothing drops."""
    if draws is None or rate == 0.0:
        return None

    def drop(p: torch.Tensor) -> torch.Tensor:
        keep = draws.keep(tuple(p.shape[-2:]), rate, p.device, batched=False)
        mult = keep.to(p.dtype) / torch.tensor(1.0 - rate, dtype=p.dtype, device=p.device)
        return p * mult

    return drop


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


class Embed(nn.Module):
    """flax ``nn.Embed(dtype)``: an f32 (or ``param_dtype``) table gathered
    and cast to the compute dtype. ``init_std`` None: flax's default init
    (lecun over the feature width)."""

    def __init__(self, num: int, dim: int, dtype, param_dtype, device,
                 init_std: Optional[float] = None):
        super().__init__()
        self.dtype, self.init_std = dtype, init_std
        self.weight = _param(num, dim, dtype=param_dtype, device=device)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight).to(self.dtype)


def _dense(n_in, n_out, dtype, param_dtype, device, std=None, bias=True) -> Dense:
    """A Dense whose kernel ``factory.init_weights`` draws from
    normal(``std``) (lecun where ``std`` is None)."""
    d = Dense(n_in, n_out, dtype, param_dtype, device, bias=bias)
    d.init_std = std
    return d


# ---------------------------------------------------------------------------
# the BERT family
# ---------------------------------------------------------------------------


class _Module(nn.Module):
    """A container whose children are set as keyword arguments."""

    def __init__(this, /, **children):  # children may be named "self", as in BERT
        super().__init__()
        for name, child in children.items():
            setattr(this, name, child)


class BertLayer(nn.Module):
    """flax ``FlaxBertLayer``: self-attention, dense, dropout, residual and
    LayerNorm; then the intermediate dense with the activation, the output
    dense, dropout, residual and LayerNorm."""

    def __init__(self, cfg, dtype, param_dtype, device):
        super().__init__()
        D, std, eps = cfg["hidden_size"], cfg["initializer_range"], cfg["layer_norm_eps"]
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device, std=std)
        self.heads, self.act = cfg["num_attention_heads"], _ACTS[cfg["hidden_act"]]
        self.p_hidden, self.p_attn = cfg["hidden_dropout_prob"], cfg["attention_probs_dropout_prob"]
        self.attention = _Module(
            self=_Module(query=_dense(D, D, **kw), key=_dense(D, D, **kw),
                         value=_dense(D, D, **kw)),
            output=_Module(dense=_dense(D, D, **kw),
                           LayerNorm=LayerNorm(D, eps, "onepass", dtype, device)))
        self.intermediate = _Module(dense=_dense(D, cfg["intermediate_size"], **kw))
        self.output = _Module(dense=_dense(cfg["intermediate_size"], D, **kw),
                              LayerNorm=LayerNorm(D, eps, "onepass", dtype, device))

    def forward(self, x, bias, draws):
        a = self.attention
        ctx = encoder_attention(a.self.query(x), a.self.key(x), a.self.value(x), self.heads,
                                bias=bias, scale="div",
                                drop=attention_dropout(self.p_attn, draws))
        x = a.output.LayerNorm(dropout(a.output.dense(ctx), self.p_hidden, draws) + x)
        h = self.act(self.intermediate.dense(x))
        return self.output.LayerNorm(dropout(self.output.dense(h), self.p_hidden, draws) + x)


class BertEncoder(nn.Module):
    """``FlaxBertModule`` (and the RoBERTa / XLM-RoBERTa copies) as JAX calls
    it: ``arange(L)`` positions, zero token types, the padding mask as an
    additive ``finfo(dtype).min`` bias. Returns the last hidden state."""

    def __init__(self, cfg, dtype, param_dtype, device):
        super().__init__()
        D, std = cfg["hidden_size"], cfg["initializer_range"]
        emb = dict(dtype=dtype, param_dtype=param_dtype, device=device, init_std=std)
        self.dtype, self.p_hidden = dtype, cfg["hidden_dropout_prob"]
        self.embeddings = _Module(
            word_embeddings=Embed(cfg["vocab_size"], D, **emb),
            position_embeddings=Embed(cfg["max_position_embeddings"], D, **emb),
            token_type_embeddings=Embed(cfg["type_vocab_size"], D, **emb),
            LayerNorm=LayerNorm(D, cfg["layer_norm_eps"], "onepass", dtype, device))
        self.encoder = _Module(layer=nn.ModuleList(
            BertLayer(cfg, dtype, param_dtype, device) for _ in range(cfg["num_hidden_layers"])))
        # in JAX's tree (FlaxBertModule's add_pooling_layer), never used by the tower
        self.pooler = _Module(dense=_dense(D, D, dtype, param_dtype, device, std))

    def forward(self, ids, mask, draws=None):
        e = self.embeddings
        L = ids.shape[1]
        pos = torch.arange(L, device=ids.device)
        x = (e.word_embeddings(ids) + e.token_type_embeddings(torch.zeros_like(ids))
             + e.position_embeddings(pos)[None])
        x = dropout(e.LayerNorm(x), self.p_hidden, draws)
        bias = torch.where(mask[:, None, None, :] > 0,
                           torch.zeros((), dtype=self.dtype, device=ids.device),
                           torch.tensor(torch.finfo(self.dtype).min, dtype=self.dtype,
                                        device=ids.device))
        for layer in self.encoder.layer:
            x = layer(x, bias, draws)
        return x


# ---------------------------------------------------------------------------
# the T5 family
# ---------------------------------------------------------------------------


class T5LayerNorm(nn.Module):
    """flax ``FlaxT5LayerNorm``: ``weight * x / sqrt(mean(x^2) + eps)`` with
    the statistic in f32 and an f32 result (the weight is not cast)."""

    def __init__(self, width: int, eps: float, device):
        super().__init__()
        self.eps = eps
        self.weight = _param(width, dtype=torch.float32, device=device)

    def forward(self, x):
        var = x.float().pow(2).mean(dim=-1, keepdim=True)
        return self.weight * (x.float() / torch.sqrt(var + self.eps))

    def init_params(self, normal):
        self.weight.fill_(1.0)


def relative_position_bucket(L: int, num_buckets: int, max_distance: int) -> torch.Tensor:
    """flax T5's bidirectional bucket of ``key - query`` for an (L, L) grid,
    in its f32 arithmetic (CPU int64)."""
    rel = torch.arange(L)[None, :] - torch.arange(L)[:, None]
    half = num_buckets // 2
    buckets = (rel > 0).to(torch.int64) * half
    rel = rel.abs()
    max_exact = half // 2
    large = max_exact + (torch.log(rel.float() / max_exact)
                         / torch.log(torch.tensor(max_distance / max_exact, dtype=torch.float32))
                         * (half - max_exact))
    large = large.clamp(max=half - 1)
    return (buckets + torch.where(rel < max_exact, rel.float(), large)).to(torch.int64)


class T5Block(nn.Module):
    """``FlaxT5Block`` of an encoder: RMSNorm, self-attention (no scaling),
    dropout, residual; RMSNorm, the FFN, dropout, residual."""

    def __init__(self, cfg, first: bool, dtype, param_dtype, device):
        super().__init__()
        D, H, dkv, dff = cfg["d_model"], cfg["num_heads"], cfg["d_kv"], cfg["d_ff"]
        inner, f = H * dkv, cfg["initializer_factor"]
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device, bias=False)
        self.heads, self.p, self.dtype = H, cfg["dropout_rate"], dtype
        self.gated = cfg["feed_forward_proj"] == "gated-gelu"
        self.act = gelu_tanh if self.gated else F.relu
        attn = _Module(q=_dense(D, inner, std=f * (inner * dkv) ** -0.5, **kw),
                       k=_dense(D, inner, std=f * inner ** -0.5, **kw),
                       v=_dense(D, inner, std=f * inner ** -0.5, **kw),
                       o=_dense(inner, D, std=f * inner ** -0.5, **kw))
        if first:
            attn.relative_attention_bias = Embed(cfg["relative_attention_num_buckets"], H, dtype,
                                                 param_dtype, device, init_std=f * inner ** -0.5)
        wi = f * D ** -0.5
        ffn = (_Module(wi_0=_dense(D, dff, std=wi, **kw), wi_1=_dense(D, dff, std=wi, **kw),
                       wo=_dense(dff, D, std=f * dff ** -0.5, **kw)) if self.gated else
               _Module(wi=_dense(D, dff, std=wi, **kw), wo=_dense(dff, D, std=f * dff ** -0.5,
                                                                   **kw)))
        eps = cfg["layer_norm_epsilon"]
        self.layer = nn.ModuleList([
            _Module(SelfAttention=attn, layer_norm=T5LayerNorm(D, eps, device)),
            _Module(DenseReluDense=ffn, layer_norm=T5LayerNorm(D, eps, device))])

    def forward(self, x, bias, draws):
        sa, ff = self.layer
        h = sa.layer_norm(x).to(self.dtype)  # flax's Dense casts its f32 input
        a = sa.SelfAttention
        ctx = encoder_attention(a.q(h), a.k(h), a.v(h), self.heads, bias=bias, scale=None,
                                drop=attention_dropout(self.p, draws))
        x = x + dropout(a.o(ctx), self.p, draws)
        h = ff.layer_norm(x).to(self.dtype)
        d = ff.DenseReluDense
        if self.gated:
            h = self.act(d.wi_0(h)) * d.wi_1(h)
        else:
            h = self.act(d.wi(h))
        return x + dropout(d.wo(dropout(h, self.p, draws)), self.p, draws)


class T5Encoder(nn.Module):
    """``FlaxT5EncoderModule``: the shared embedding, the blocks (block 0's
    relative bias, plus the padding mask's ``finfo(dtype).min``, shared by
    every block), the final RMSNorm. Returns the last hidden state (f32)."""

    def __init__(self, cfg, dtype, param_dtype, device):
        super().__init__()
        self.cfg, self.dtype, self.p = cfg, dtype, cfg["dropout_rate"]
        self.shared = Embed(cfg["vocab_size"], cfg["d_model"], dtype, param_dtype, device,
                            init_std=cfg["initializer_factor"])
        self.encoder = _Module(
            block=nn.ModuleList(T5Block(cfg, i == 0, dtype, param_dtype, device)
                                for i in range(cfg["num_layers"])),
            final_layer_norm=T5LayerNorm(cfg["d_model"], cfg["layer_norm_epsilon"], device))

    def forward(self, ids, mask, draws=None):
        cfg, L = self.cfg, ids.shape[1]
        x = dropout(self.shared(ids), self.p, draws)
        buckets = relative_position_bucket(L, cfg["relative_attention_num_buckets"],
                                           cfg["relative_attention_max_distance"]).to(ids.device)
        table = self.encoder.block[0].layer[0].SelfAttention.relative_attention_bias
        pos = table(buckets).permute(2, 0, 1)[None]  # (1, H, L, L) in the compute dtype
        neg = torch.tensor(torch.finfo(self.dtype).min, dtype=self.dtype, device=ids.device)
        bias = pos + torch.where(mask[:, None, None, :] > 0,
                                 torch.zeros((), dtype=self.dtype, device=ids.device), neg)
        for block in self.encoder.block:
            x = block(x, bias, draws)
        return dropout(self.encoder.final_layer_norm(x), self.p, draws)


# ---------------------------------------------------------------------------
# the tower
# ---------------------------------------------------------------------------


class HFTextTower(nn.Module):
    """JAX's ``HFTextTower``: the encoder under ``hf``, the pad mask
    ``text != pad_id``, the pooler and the projection (``proj1``, and
    ``proj2`` for ``mlp``). ``forward(text, draws)``: draws (a
    :class:`DropoutDraws`) in a training step, None otherwise."""

    def __init__(self, output_dim: int, arch: str = "bert",
                 hf_config: Optional[Dict[str, Any]] = None, pooler_type: str = "mean_pooler",
                 proj_type: str = "linear", pad_id: int = 0, dtype=torch.float32,
                 param_dtype=None, device=None):
        super().__init__()
        check_hf(arch, hf_config, pooler_type, proj_type)
        param_dtype = param_dtype or dtype
        self.arch, self.pooler_type, self.proj_type, self.pad_id = (arch, pooler_type, proj_type,
                                                                     pad_id)
        self.dtype = dtype
        self.config = cfg = resolve_hf_config(arch, hf_config)
        if arch in ("t5", "mt5"):
            self.hf = T5Encoder(cfg, dtype, param_dtype, device)
        elif arch == "m2m_100":
            from spatial_clip_tpu_torch.models.m2m_encoder import M2M100Encoder

            self.hf = M2M100Encoder(cfg, dtype, param_dtype, device)
        else:
            self.hf = BertEncoder(cfg, dtype, param_dtype, device)
        hidden = cfg["d_model"] if "d_model" in cfg else cfg["hidden_size"]
        if proj_type == "mlp":
            mid = (hidden + output_dim) // 2
            self.proj1 = Dense(hidden, mid, dtype, param_dtype, device, bias=False)
            self.proj2 = Dense(mid, output_dim, dtype, param_dtype, device, bias=False)
        else:
            self.proj1 = Dense(hidden, output_dim, dtype, param_dtype, device, bias=False)
            self.proj2 = None

    @property
    def vocab_size(self) -> int:
        return self.config["vocab_size"]

    @property
    def dropout_rates(self) -> Tuple[float, ...]:
        c = self.config
        keys = (("dropout_rate",) if self.arch in ("t5", "mt5") else
                ("dropout", "attention_dropout", "activation_dropout")
                if self.arch == "m2m_100" else
                ("hidden_dropout_prob", "attention_probs_dropout_prob"))
        return tuple(float(c[k]) for k in keys)

    def forward(self, text: torch.Tensor, draws: Optional[DropoutDraws] = None) -> torch.Tensor:
        mask = (text != self.pad_id).to(torch.int32)
        hidden = self.hf(text, mask, draws)
        if self.pooler_type == "cls_pooler":
            pooled = hidden[:, 0]
        elif self.pooler_type == "max_pooler":
            neg = torch.tensor(-math.inf, dtype=hidden.dtype, device=hidden.device)
            pooled = torch.where(mask[..., None] > 0, hidden, neg).amax(dim=1)
        elif self.pooler_type == "last":
            last = (mask.sum(dim=1) - 1).long()
            pooled = hidden[torch.arange(hidden.shape[0], device=hidden.device), last]
        else:  # mean_pooler, in f32
            m = mask.float()[..., None]
            pooled = (hidden * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
        x = self.proj1(pooled.to(self.dtype))
        if self.proj2 is not None:
            x = self.proj2(gelu_tanh(x))
        return x
