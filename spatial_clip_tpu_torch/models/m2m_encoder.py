"""The M2M100 / NLLB text encoder (counterpart of ``spatial_clip_tpu.models.m2m_encoder``).

nllb-clip's text tower. The JAX package writes it natively in flax
(transformers dropped its Flax M2M100), and so does this module in PyTorch,
with the same math and parameter names: word embeddings scaled by
``sqrt(d_model)`` (``scale_embedding``), pad-aware sinusoidal positions
(non-pad tokens count ``pad + 1, pad + 2, ...``, pads stay at row ``pad``,
which is zero; the table is ``[sin | cos]`` concatenated, not interleaved),
pre-LN layers (self-attention, then a ReLU FFN) and a final LayerNorm.
Attention scales q by ``hd^-1/2`` in the compute dtype and takes its scores,
the padding bias (``finfo(f32).min``) and the softmax in f32
(``ops.attention_plain.encoder_attention``). The flax names hold dots
(``layers.0/self_attn.q_proj/kernel``); here they are modules
(``layers.0.self_attn.q_proj.weight``), which ``models/convert.py`` maps
one to one.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from spatial_clip_tpu_torch.models.hf_model import Embed, dropout
from spatial_clip_tpu_torch.models.transformer import Dense, LayerNorm
from spatial_clip_tpu_torch.ops.attention_plain import encoder_attention


def sinusoidal_table(n_rows: int, dim: int, padding_idx: int) -> np.ndarray:
    """transformers' ``M2M100SinusoidalPositionalEmbedding.get_embedding``:
    ``[sin | cos]`` of position x frequency, the padding row zero (f32)."""
    half = dim // 2
    freq = np.exp(np.arange(half, dtype=np.float64) * (-math.log(10000.0) / (half - 1)))
    ang = np.arange(n_rows, dtype=np.float64)[:, None] * freq[None, :]
    table = np.concatenate([np.sin(ang), np.cos(ang)], axis=1)
    if dim % 2 == 1:
        table = np.concatenate([table, np.zeros((n_rows, 1))], axis=1)
    table[padding_idx] = 0.0
    return table.astype(np.float32)


class _SelfAttention(nn.Module):
    def __init__(self, D, dtype, param_dtype, device):
        super().__init__()
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, Dense(D, D, dtype, param_dtype, device))


class M2M100EncoderLayer(nn.Module):
    """Pre-LN: ``x + drop(out_proj(attn(ln(x))))``, then ``x +
    drop(fc2(drop(relu(fc1(ln(x))))))``."""

    def __init__(self, cfg, dtype, param_dtype, device):
        super().__init__()
        D = cfg["d_model"]
        self.heads = cfg["encoder_attention_heads"]
        self.p, self.p_attn, self.p_act = (cfg["dropout"], cfg["attention_dropout"],
                                           cfg["activation_dropout"])
        self.self_attn_layer_norm = LayerNorm(D, 1e-5, "onepass", dtype, device)
        self.self_attn = _SelfAttention(D, dtype, param_dtype, device)
        self.final_layer_norm = LayerNorm(D, 1e-5, "onepass", dtype, device)
        self.fc1 = Dense(D, cfg["encoder_ffn_dim"], dtype, param_dtype, device)
        self.fc2 = Dense(cfg["encoder_ffn_dim"], D, dtype, param_dtype, device)

    def forward(self, x, pad_bias, draws):
        h = self.self_attn_layer_norm(x)
        a = self.self_attn
        ctx = encoder_attention(a.q_proj(h), a.k_proj(h), a.v_proj(h), self.heads,
                                bias=pad_bias, scale="mul", acc_dtype=torch.float32,
                                drop=None if draws is None or self.p_attn == 0 else
                                (lambda p: dropout(p, self.p_attn, draws)))
        x = x + dropout(a.out_proj(ctx), self.p, draws)
        h = dropout(torch.relu(self.fc1(self.final_layer_norm(x))), self.p_act, draws)
        return x + dropout(self.fc2(h), self.p, draws)


class M2M100Encoder(nn.Module):
    """JAX's ``M2M100EncoderModule`` over a resolved config dict
    (``hf_model.resolve_hf_config``). Returns the last hidden state."""

    def __init__(self, cfg, dtype, param_dtype, device):
        super().__init__()
        D = cfg["d_model"]
        self.cfg, self.dtype = cfg, dtype
        self.scale = math.sqrt(D) if cfg["scale_embedding"] else 1.0
        self.embed_tokens = Embed(cfg["vocab_size"], D, dtype, param_dtype, device)
        self.layers = nn.ModuleList(M2M100EncoderLayer(cfg, dtype, param_dtype, device)
                                    for _ in range(cfg["encoder_layers"]))
        self.layer_norm = LayerNorm(D, 1e-5, "onepass", dtype, device)
        self.register_buffer("positions_table", torch.from_numpy(sinusoidal_table(
            cfg["max_position_embeddings"] + 2, D, cfg["pad_token_id"])).to(device),
            persistent=False)

    def forward(self, ids, mask, draws=None):
        pad = self.cfg["pad_token_id"]
        x = self.embed_tokens(ids) * torch.tensor(self.scale, dtype=self.dtype, device=ids.device)
        nonpad = (ids != pad).to(torch.int64)
        positions = torch.cumsum(nonpad, dim=1) * nonpad + pad
        x = x + self.positions_table[positions].to(self.dtype)
        x = dropout(x, self.cfg["dropout"], draws)
        neg = torch.finfo(torch.float32).min
        pad_bias = torch.where(mask[:, None, None, :] > 0,
                               torch.zeros((), device=ids.device),
                               torch.tensor(neg, device=ids.device))
        for layer in self.layers:
            x = layer(x, pad_bias, draws)
        return self.layer_norm(x)
