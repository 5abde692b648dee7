"""Caption tokenizers: byte-level BPE and the hashing fallback.

Id-for-id the same as ``spatial_clip_tpu.models.tokenizer``'s
``SimpleTokenizer`` and ``HashTokenizer``. The BPE merges file is read in
place from the JAX package's data directory (or ``bpe_path=`` /
``$SPATIAL_CLIP_BPE_PATH``). Tokenizers are callables
``texts -> np.ndarray[int32] (B, context_length)``.
"""
from __future__ import annotations

import gzip
import html
import os
import re
from functools import lru_cache
from pathlib import Path
from typing import List, Optional, Sequence, Union

import numpy as np

from spatial_clip_tpu_torch.models.config import REFERENCE_MODELS_DIR

DEFAULT_CONTEXT_LENGTH = 77


@lru_cache()
def bytes_to_unicode():
    """Reversible byte <-> printable-unicode map (GPT-2 byte-level BPE)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    return {(a, b) for a, b in zip(word[:-1], word[1:])}


def basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def canonicalize_text(text: str) -> str:
    """HTML-unescape, collapse whitespace, lowercase (open_clip's 'lower')."""
    return whitespace_clean(basic_clean(text)).lower()


def _resolve_bpe_path(bpe_path: Optional[str]) -> Path:
    if bpe_path:
        return Path(bpe_path)
    env = os.environ.get("SPATIAL_CLIP_BPE_PATH")
    if env:
        return Path(env)
    return REFERENCE_MODELS_DIR / "bpe_simple_vocab_16e6.txt.gz"


class SimpleTokenizer:
    """Byte-level BPE tokenizer over the CLIP merges: 256 byte symbols, 256
    end-of-word symbols, the merges, then ``<start_of_text>`` and
    ``<end_of_text>``."""

    WORD_PATTERN = (
        r"<start_of_text>|<end_of_text>|'s|'t|'re|'ve|'m|'ll|'d|"
        r"[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"
    )

    def __init__(self, bpe_path: Optional[str] = None,
                 context_length: int = DEFAULT_CONTEXT_LENGTH,
                 n_merges: int = 48894):
        path = _resolve_bpe_path(bpe_path)
        if not path.exists():
            raise FileNotFoundError(f"SimpleTokenizer: no BPE merges file at {path}")
        self.context_length = context_length
        self.byte_encoder = bytes_to_unicode()
        opener = gzip.open if str(path).endswith(".gz") else open
        with opener(path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        # first line is a version header
        merges = [tuple(l.split()) for l in lines[1: n_merges + 1] if l.strip()]
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merges)
        vocab.extend(["<start_of_text>", "<end_of_text>"])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {"<start_of_text>": "<start_of_text>",
                      "<end_of_text>": "<end_of_text>"}
        try:
            import regex

            self._findall = regex.compile(self.WORD_PATTERN, regex.IGNORECASE).findall
        except ImportError:
            # ASCII-class fallback, as the JAX package has it, for installs
            # without the `regex` module
            self._findall = re.compile(
                r"<start_of_text>|<end_of_text>|'s|'t|'re|'ve|'m|'ll|'d|"
                r"[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
                re.IGNORECASE,
            ).findall
        self.sot_token = self.encoder["<start_of_text>"]
        self.eot_token = self.encoder["<end_of_text>"]
        self.vocab_size = len(self.encoder)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok in self._findall(canonicalize_text(text)):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(tok).split(" "))
        return ids

    def __call__(self, texts: Union[str, Sequence[str]],
                 context_length: Optional[int] = None) -> np.ndarray:
        return _pack(self, texts, context_length)


class HashTokenizer:
    """Whitespace tokens hashed (FNV-1a) into ``[4, vocab_size)``; the
    tokenizer of architectures whose vocab is smaller than the BPE's."""

    PAD, SOT, EOT = 0, 1, 2
    N_SPECIAL = 4

    def __init__(self, vocab_size: int = 49408,
                 context_length: int = DEFAULT_CONTEXT_LENGTH):
        self.vocab_size = vocab_size
        self.context_length = context_length
        self.sot_token = self.SOT
        self.eot_token = self.EOT

    @staticmethod
    def _fnv1a(s: str) -> int:
        h = 0xCBF29CE484222325
        for b in s.encode("utf-8"):
            h ^= b
            h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
        return h

    def encode(self, text: str) -> List[int]:
        span = self.vocab_size - self.N_SPECIAL
        return [self.N_SPECIAL + self._fnv1a(tok) % span
                for tok in canonicalize_text(text).split(" ") if tok]

    def __call__(self, texts: Union[str, Sequence[str]],
                 context_length: Optional[int] = None) -> np.ndarray:
        return _pack(self, texts, context_length)


def _pack(tok, texts, context_length) -> np.ndarray:
    """``<sot> ids[:L-2] <eot>`` per text, zero-padded to (B, L) int32."""
    if isinstance(texts, str):
        texts = [texts]
    L = context_length or tok.context_length
    out = np.zeros((len(texts), L), dtype=np.int32)
    for i, text in enumerate(texts):
        ids = [tok.sot_token] + tok.encode(text)[: L - 2] + [tok.eot_token]
        out[i, : len(ids)] = ids
    return out
