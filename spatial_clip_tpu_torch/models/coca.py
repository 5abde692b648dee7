"""CoCa: contrastive + captioning (counterpart of ``spatial_clip_tpu.models.coca``).

A ViT image tower with the attentional pooler (one contrastive query and
``caption_queries`` caption queries), the CLIP text tower with the cls
token, and a causal multimodal decoder whose cross-attention reads the
caption queries, laid out as JAX's CoCa: ``visual.*`` (the pooler under
``visual.attn_pool``), ``text.*`` (``text.cls_emb``), the decoder's own
token embedding ``token_embedding_dec``, ``img_to_text_width``,
``decoder.resblocks.{i}`` / ``decoder.ln_final`` / ``decoder.to_logits``,
``dec_positional_embedding`` and ``logit_scale``.

JAX's CoCa builds its towers without the model's ``attn_impl``, ``ln_impl``,
``mlp_impl`` or ``ln_gemm_impl`` (``config.check_ported`` refuses them where
they are not their defaults): every attention here is JAX's einsum route or
its inline einsum (``ops.attention_plain``), every LayerNorm two-pass f32,
every MLP dense, so CoCa launches none of the port's attention kernels.
The decoder's MLP takes flax's ``nn.gelu`` (the tanh form) even under
``quick_gelu``, which only the towers take; ``remat`` reaches the towers
only. Parameters are f32 for training (``param_dtype``) and the compute is
in ``dtype``, as in :class:`~spatial_clip_tpu_torch.models.clip.CLIP`.

Generation (:func:`greedy_generate`, :func:`beam_search_generate`,
:func:`sample_generate`, the :func:`generate` dispatcher) re-decodes the
whole prefix at each step, as JAX's scans do. Beam search breaks ties in
``lax.top_k``'s order (the lowest flat index first). Sampling draws from a
``torch.Generator`` on the model's device: its draws are not JAX's
``categorical`` bits.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from spatial_clip_tpu_torch.models.clip import l2_normalize
from spatial_clip_tpu_torch.models.config import CLIPCfg, check_ported
from spatial_clip_tpu_torch.models.hf_model import Embed
from spatial_clip_tpu_torch.models.transformer import (
    MLP,
    Dense,
    LayerNorm,
    MultiHeadAttention,
    TextTransformer,
    VisionTransformer,
    _param,
    causal_mask,
    gelu_tanh,
    quick_gelu,
)
from spatial_clip_tpu_torch.ops.attention_plain import dot_product_attention

NEG = -1e9  # the generators' masked logit, as JAX's


class CrossAttention(nn.Module):
    """q from the text stream, k and v from the image context (one ``kv``
    projection), ``jax.nn.dot_product_attention``, then ``out``."""

    def __init__(self, width: int, heads: int, dtype, param_dtype, device):
        super().__init__()
        self.heads = heads
        self.q = Dense(width, width, dtype, param_dtype, device)
        self.kv = Dense(width, 2 * width, dtype, param_dtype, device)
        self.out = Dense(width, width, dtype, param_dtype, device)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        B, Lq, W = x.shape
        hd = W // self.heads
        q = self.q(x).reshape(B, Lq, self.heads, hd)
        k, v = (t.reshape(B, context.shape[1], self.heads, hd)
                for t in self.kv(context).chunk(2, dim=-1))
        return self.out(dot_product_attention(q, k, v).reshape(B, Lq, W))


class MultimodalBlock(nn.Module):
    """ln_1 -> causal self-attention (JAX's einsum route), ln_1_kv ->
    cross-attention over the image context, ln_2 -> MLP (tanh GELU), each
    added to the residual."""

    def __init__(self, width: int, heads: int, mlp_ratio: float = 4.0, norm_eps: float = 1e-5,
                 dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        param_dtype = param_dtype or dtype
        self.ln_1 = LayerNorm(width, norm_eps, "fp32", dtype, device)
        self.attn = MultiHeadAttention(width, heads, dtype, param_dtype, device, impl="einsum")
        self.ln_1_kv = LayerNorm(width, norm_eps, "fp32", dtype, device)
        self.cross_attn = CrossAttention(width, heads, dtype, param_dtype, device)
        self.ln_2 = LayerNorm(width, norm_eps, "fp32", dtype, device)
        self.mlp = MLP(width, int(width * mlp_ratio), gelu_tanh, dtype, param_dtype, device)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), attn_mask)
        x = x + self.cross_attn(self.ln_1_kv(x), context)
        return x + self.mlp(self.ln_2(x))


class MultimodalTransformer(nn.Module):
    """The decoder: ``layers`` blocks under a finfo(f32).min causal mask,
    ``ln_final`` and the bias-free ``to_logits``."""

    def __init__(self, width: int, layers: int, heads: int, vocab_size: int,
                 mlp_ratio: float = 4.0, norm_eps: float = 1e-5, dtype=torch.float32,
                 param_dtype=None, device=None):
        super().__init__()
        param_dtype = param_dtype or dtype
        self.resblocks = nn.ModuleList(
            MultimodalBlock(width, heads, mlp_ratio, norm_eps, dtype, param_dtype, device)
            for _ in range(layers))
        self.ln_final = LayerNorm(width, norm_eps, "fp32", dtype, device)
        self.to_logits = Dense(width, vocab_size, dtype, param_dtype, device, bias=False)

    def forward(self, token_embs: torch.Tensor, image_ctx: torch.Tensor) -> torch.Tensor:
        mask = causal_mask(token_embs.shape[1], token_embs.device)
        x = token_embs
        for block in self.resblocks:
            x = block(x, image_ctx, mask)
        return self.to_logits(self.ln_final(x))


class CoCa(nn.Module):
    """``text`` token rows end with EOT; the text tower's cls row gives the
    contrastive feature and the decoder predicts each next token of the
    caption from the caption queries (teacher forcing in :meth:`forward`).
    ``dtype`` is the compute dtype, ``param_dtype`` (default: ``dtype``)
    stores the matrices and embeddings, as in ``CLIP``."""

    def __init__(self, cfg: CLIPCfg, dtype=torch.float32, device=None, param_dtype=None,
                 training: bool = False, remat: bool = False):
        super().__init__()
        check_ported(cfg)
        self.cfg, self.dtype, self.remat = cfg, dtype, remat
        v, t, m = cfg.vision_cfg, cfg.text_cfg, cfg.multimodal_cfg
        param_dtype = param_dtype or dtype
        act = quick_gelu if cfg.quick_gelu else gelu_tanh
        tower = dict(ln_stats="fp32", act=act, dtype=dtype, param_dtype=param_dtype,
                     device=device, training=training, attn_impl="einsum", remat=remat)
        self.visual = VisionTransformer(
            v.size, v.patch_size, v.width, v.layers, v.heads, v.mlp_ratio, cfg.embed_dim,
            norm_eps=v.norm_eps, attentional_pool=True,
            attn_pooler_queries=m.caption_queries + 1, attn_pooler_heads=v.attn_pooler_heads,
            output_tokens=True, **tower)
        self.text = TextTransformer(
            t.context_length, t.vocab_size, t.width, t.heads, t.layers, t.mlp_ratio,
            cfg.embed_dim, norm_eps=t.norm_eps, embed_cls=True, **tower)
        self.token_embedding_dec = Embed(t.vocab_size, t.width, dtype, param_dtype, device)
        self.img_to_text_width = Dense(v.width, t.width, dtype, param_dtype, device)
        self.decoder = MultimodalTransformer(t.width, m.layers, t.heads, t.vocab_size,
                                             norm_eps=t.norm_eps, dtype=dtype,
                                             param_dtype=param_dtype, device=device)
        self.logit_scale = nn.Parameter(torch.empty((), device=device))
        self.logit_bias = None
        self.dec_positional_embedding = _param(t.context_length, t.width, dtype=param_dtype,
                                               device=device)

    def init_params(self, normal) -> None:
        normal(self.dec_positional_embedding, 0.01)

    @property
    def hf_text(self) -> bool:
        return False

    def _encode_image_full(self, images: torch.Tensor):
        """(pooled, projected feature; the caption queries' tokens)."""
        return self.visual(images)

    def encode_image(self, images: torch.Tensor, normalize: bool = True) -> torch.Tensor:
        pooled, _ = self._encode_image_full(images)
        return l2_normalize(pooled) if normalize else pooled

    def encode_text(self, text: torch.Tensor, normalize: bool = True) -> torch.Tensor:
        feats = self.text(text)
        return l2_normalize(feats) if normalize else feats

    def decode(self, text_in: torch.Tensor, image_tokens: torch.Tensor) -> torch.Tensor:
        """Caption logits (B, L, vocab) in the compute dtype for the token
        rows ``text_in`` (B, L) given the caption queries' tokens."""
        ctx = self.img_to_text_width(image_tokens)
        embs = self.token_embedding_dec(text_in)
        embs = embs + self.dec_positional_embedding[:embs.shape[1]].to(self.dtype)
        return self.decoder(embs, ctx)

    def forward(self, images: Optional[torch.Tensor] = None,
                text: Optional[torch.Tensor] = None, gene_keep=None,
                text_dropout=None) -> Dict[str, torch.Tensor]:
        """The trainer's keywords ``gene_keep`` and ``text_dropout`` are None
        for CoCa (no Gene-MLP or Hugging Face tower)."""
        out: Dict[str, torch.Tensor] = {}
        tokens = None
        if images is not None:
            pooled, tokens = self._encode_image_full(images)
            out["image_features"] = l2_normalize(pooled)
        if text is not None:
            out["text_features"] = self.encode_text(text)
        if images is not None and text is not None:
            out["caption_logits"] = self.decode(text[:, :-1], tokens)
            out["caption_labels"] = text[:, 1:]
        out["logit_scale"] = self.logit_scale.exp()
        return out

    def forward_intermediates(self, image=None, text=None, **kwargs):
        """Per-block intermediates (:func:`~spatial_clip_tpu_torch.models.
        intermediates.forward_intermediates`)."""
        from spatial_clip_tpu_torch.models.intermediates import forward_intermediates

        return forward_intermediates(self, image=image, text=text, **kwargs)


def caption_nll(caption_logits: torch.Tensor, caption_labels: torch.Tensor,
                pad_id: int = 0):
    """(summed token NLL over the non-pad labels, their count), in f32:
    the log-softmax of the logits cast to f32."""
    logp = F.log_softmax(caption_logits.float(), dim=-1)
    picked = logp.gather(-1, caption_labels[..., None].long())[..., 0]
    mask = (caption_labels != pad_id).float()
    return -(picked * mask).sum(), mask.sum()


def coca_caption_loss(caption_logits: torch.Tensor, caption_labels: torch.Tensor,
                      pad_id: int = 0) -> torch.Tensor:
    """Token-level CE over the non-pad positions: the summed NLL over
    ``max(count, 1)`` (JAX's ``coca_caption_loss``)."""
    total, count = caption_nll(caption_logits, caption_labels, pad_id)
    return total / count.clamp_min(1.0)


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------

def _start(model: CoCa, images: torch.Tensor, sot_token: int, rows: int):
    """(caption-query tokens, a (rows, context_length) buffer of zeros with
    the SOT in column 0)."""
    tokens = model._encode_image_full(images)[1]
    ctx_len = model.cfg.text_cfg.context_length
    seq = torch.zeros(rows, ctx_len, dtype=torch.long, device=images.device)
    seq[:, 0] = sot_token
    return tokens, seq


def top_k_first(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last dimension: the k largest values in
    descending order, equal values by the lowest index first (a stable
    sort; ``torch.topk`` promises no order among ties)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


@torch.no_grad()
def greedy_generate(model: CoCa, images: torch.Tensor, sot_token: int, eot_token: int,
                    max_len: int = 30) -> torch.Tensor:
    """Greedy caption decoding: (B, context_length) token ids; ``max_len``
    counts the SOT. A row emits pads (0) after its EOT."""
    B = images.shape[0]
    tokens, seq = _start(model, images, sot_token, B)
    ctx_len = seq.shape[1]
    done = torch.zeros(B, dtype=torch.bool, device=seq.device)
    for i in range(min(max_len - 1, ctx_len - 1)):
        logits = model.decode(seq[:, :ctx_len - 1], tokens)
        nxt = logits[:, i].argmax(dim=-1)
        nxt = torch.where(done, torch.zeros_like(nxt), nxt)
        seq[:, i + 1] = nxt
        done |= nxt == eot_token
    return seq


@torch.no_grad()
def beam_search_generate(model: CoCa, images: torch.Tensor, sot_token: int, eot_token: int,
                         max_len: int = 30, beam_size: int = 4,
                         length_penalty: float = 1.0) -> torch.Tensor:
    """Beam-search caption decoding (JAX's ``beam_search_generate``): the
    beams are a batch dimension, each step keeps the ``beam_size`` best of
    beam x vocab f32 log-probabilities (:func:`top_k_first`), a finished
    beam keeps its score and continues with pad; the best beam by score
    over length (non-zero tokens) ** ``length_penalty``. (B, context_length)."""
    B = images.shape[0]
    vocab = model.cfg.text_cfg.vocab_size
    tokens, seq = _start(model, images, sot_token, B * beam_size)
    ctx_len, device = seq.shape[1], seq.device
    tiled = tokens.repeat_interleave(beam_size, dim=0)
    seq = seq.view(B, beam_size, ctx_len)
    scores = torch.full((B, beam_size), NEG, dtype=torch.float32, device=device)
    scores[:, 0] = 0.0
    done = torch.zeros(B, beam_size, dtype=torch.bool, device=device)
    pad_only = torch.full((vocab,), NEG, dtype=torch.float32, device=device)
    pad_only[0] = 0.0
    for i in range(min(max_len - 1, ctx_len - 1)):
        logits = model.decode(seq.reshape(B * beam_size, ctx_len)[:, :ctx_len - 1], tiled)
        logp = F.log_softmax(logits[:, i].float(), dim=-1).view(B, beam_size, vocab)
        logp = torch.where(done[:, :, None], pad_only, logp)
        cand = (scores[:, :, None] + logp).reshape(B, beam_size * vocab)
        scores, top = top_k_first(cand, beam_size)
        beam_idx, tok = top // vocab, top % vocab
        seq = seq.gather(1, beam_idx[:, :, None].expand(-1, -1, ctx_len)).clone()
        done = done.gather(1, beam_idx)
        seq[:, :, i + 1] = tok
        done = done | (tok == eot_token)
    lengths = (seq != 0).sum(dim=-1).float()
    norm = scores / torch.pow(lengths.clamp_min(1.0), length_penalty)
    best = norm.argmax(dim=1)
    return seq[torch.arange(B, device=device), best]


def _top_k_warp(logits: torch.Tensor, k: int, neg: float = NEG) -> torch.Tensor:
    """Keep the k most probable tokens; ties at the threshold are all kept."""
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, neg), logits)


def _top_p_warp(logits: torch.Tensor, p: float, min_tokens_to_keep: int = 1,
                neg: float = NEG) -> torch.Tensor:
    """Nucleus filtering: drop the low-probability tail whose ascending
    cumulative mass is <= 1 - p, keeping at least ``min_tokens_to_keep``."""
    sorted_logits = torch.sort(logits, dim=-1).values  # ascending
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    remove = cum <= (1.0 - p)
    remove[..., -min_tokens_to_keep:] = False
    kept_min = torch.where(remove, torch.full_like(sorted_logits, float("inf")),
                           sorted_logits).min(dim=-1, keepdim=True).values
    return torch.where(logits < kept_min, torch.full_like(logits, neg), logits)


@torch.no_grad()
def sample_generate(model: CoCa, images: torch.Tensor, sot_token: int, eot_token: int,
                    generator: Optional[torch.Generator] = None, max_len: int = 30,
                    generation_type: str = "top_p", top_p: float = 0.1, top_k: int = 1,
                    temperature: float = 1.0, min_seq_len: int = 5,
                    repetition_penalty: float = 1.0, pad_token: int = 0) -> torch.Tensor:
    """Sampled caption decoding with top-k / top-p warping (JAX's
    ``sample_generate``): no EOT before ``min_seq_len`` tokens, the
    repetition penalty on the tokens of the prefix, the warper, then a
    draw from softmax(logits / temperature) as the argmax of the logits
    plus Gumbel noise from ``generator`` (default: seed 0 on the images'
    device); the last step emits EOT, a finished row pad. (B, context_length)."""
    if generation_type not in ("top_p", "top_k"):
        raise ValueError("generation_type has to be one of | top_k | top_p | beam_search |.")
    B = images.shape[0]
    vocab = model.cfg.text_cfg.vocab_size
    tokens, seq = _start(model, images, sot_token, B)
    ctx_len, device = seq.shape[1], seq.device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    n_steps = min(max_len - 1, ctx_len - 1)
    done = torch.zeros(B, dtype=torch.bool, device=device)
    is_eot = torch.arange(vocab, device=device)[None, :] == eot_token
    tiny = torch.finfo(torch.float32).tiny
    for i in range(n_steps):
        logits = model.decode(seq[:, :ctx_len - 1], tokens)[:, i].float()
        if i + 1 < min_seq_len:
            logits = torch.where(is_eot, torch.full_like(logits, NEG), logits)
        if repetition_penalty != 1.0:
            valid = torch.arange(ctx_len, device=device)[None, :] <= i
            idx = torch.where(valid, seq, torch.full_like(seq, vocab))
            presence = torch.zeros(B, vocab + 1, dtype=torch.bool, device=device)
            presence = presence.scatter(1, idx, True)[:, :vocab]
            penalized = torch.where(logits > 0, logits / repetition_penalty,
                                    logits * repetition_penalty)
            logits = torch.where(presence, penalized, logits)
        if generation_type == "top_k":
            logits = _top_k_warp(logits, top_k)
        else:
            logits = _top_p_warp(logits, top_p)
        u = torch.rand(logits.shape, generator=generator, device=device).clamp_min(tiny)
        nxt = (logits / temperature - torch.log(-torch.log(u))).argmax(dim=-1)
        if i == n_steps - 1:  # the final emitted token is EOT
            nxt = torch.full_like(nxt, eot_token)
        nxt = torch.where(done, torch.full_like(nxt, pad_token), nxt)
        seq[:, i + 1] = nxt
        done |= nxt == eot_token
    return seq


def generate(model: CoCa, images: torch.Tensor, sot_token: int = 49406,
             eot_token: int = 49407, seq_len: int = 30, generation_type: str = "beam_search",
             generator: Optional[torch.Generator] = None, top_p: float = 0.1, top_k: int = 1,
             temperature: float = 1.0, num_beams: int = 6, min_seq_len: int = 5,
             repetition_penalty: float = 1.0, length_penalty: float = 1.0) -> torch.Tensor:
    """JAX's dispatcher: ``beam_search``, ``greedy``, ``top_k`` or
    ``top_p`` (these two draw from ``generator``)."""
    if generation_type == "beam_search":
        return beam_search_generate(model, images, sot_token, eot_token, max_len=seq_len,
                                    beam_size=num_beams, length_penalty=length_penalty)
    if generation_type == "greedy":
        return greedy_generate(model, images, sot_token, eot_token, max_len=seq_len)
    if generation_type in ("top_k", "top_p"):
        return sample_generate(model, images, sot_token, eot_token, generator, max_len=seq_len,
                               generation_type=generation_type, top_p=top_p, top_k=top_k,
                               temperature=temperature, min_seq_len=min_seq_len,
                               repetition_penalty=repetition_penalty)
    raise ValueError("generation_type has to be one of | greedy | top_k | top_p | beam_search |.")
