"""Synthetic spatial dataset (counterpart of
``spatial_clip_tpu.data.datasets.synthetic.SyntheticSpatialDataset``): the
fake-data perf/smoke backend, with a spatial neighbor graph so the spatial
loss path runs without real HEST shards.

Spots sit on a sqrt(n) x sqrt(n) grid; each spot's neighbors are its 4-ring
grid adjacency with distance-decayed alphas; gene sentences are deterministic
draws from a synthetic gene vocabulary.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

_SYNTH_GENES = [f"GENE{i}" for i in range(500)]


class SyntheticSpatialDataset:
    def __init__(
        self,
        num_samples: int = 256,
        image_size: int = 224,
        k_neighbors: int = 6,
        sentence_len: int = 50,
        preprocess_fn: Optional[Callable] = None,
        tokenizer: Optional[Callable] = None,
        seed: int = 0,
    ):
        self.num_samples = num_samples
        self.image_size = image_size
        self.k_neighbors = k_neighbors
        self.sentence_len = sentence_len
        self.preprocess_fn = preprocess_fn
        self.tokenizer = tokenizer
        self.seed = seed
        side = int(np.ceil(np.sqrt(num_samples)))
        self._side = side
        rng = np.random.default_rng(seed)
        self._gene_ranks = rng.permuted(
            np.tile(np.arange(len(_SYNTH_GENES)), (num_samples, 1)), axis=1
        )[:, :sentence_len]

    def __len__(self) -> int:
        return self.num_samples

    def _neighbors(self, idx: int):
        side = self._side
        r, c = divmod(idx, side)
        cand = []
        for dr, dc in ((-1, 0), (1, 0), (0, -1), (0, 1), (-1, -1), (1, 1), (-1, 1), (1, -1)):
            rr, cc = r + dr, c + dc
            j = rr * side + cc
            if 0 <= rr < side and 0 <= cc < side and j < self.num_samples:
                dist = float(np.hypot(dr, dc))
                cand.append((j, 1.0 / dist))
        cand.sort(key=lambda t: -t[1])
        ids = [j for j, _ in cand[: self.k_neighbors]]
        alphas = [a for _, a in cand[: self.k_neighbors]]
        while len(ids) < self.k_neighbors:  # pad (schema: -1 / 0.0)
            ids.append(-1)
            alphas.append(0.0)
        return ids, alphas

    def _render_tile(self, rng, gene_ranks) -> "np.ndarray":
        """Tile whose appearance is a deterministic function of the top
        expressed genes (sinusoidal gratings keyed by gene id) plus noise —
        so image<->sentence correspondence is LEARNABLE and val retrieval
        measures generalization, not memorization."""
        s = self.image_size
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / max(s, 1)
        img = np.zeros((s, s, 3), np.float32)
        for rank, g in enumerate(gene_ranks[:6]):
            g = int(g)
            freq = 1.0 + (g % 7)
            angle = (g % 13) / 13.0 * np.pi
            phase = (g % 29) / 29.0 * 2 * np.pi
            wave = np.sin(
                2 * np.pi * freq * (np.cos(angle) * xx + np.sin(angle) * yy) + phase
            )
            img[:, :, g % 3] += wave * (1.0 - 0.12 * rank)
        img = (img - img.min()) / max(img.max() - img.min(), 1e-6)
        noise = rng.normal(0, 0.05, img.shape)
        return np.clip((img + noise) * 255, 0, 255).astype(np.uint8)

    def __getitem__(self, idx: int) -> dict:
        rng = np.random.default_rng(self.seed * 100003 + idx)
        img = self._render_tile(rng, self._gene_ranks[idx])
        sentence = " ".join(_SYNTH_GENES[g] for g in self._gene_ranks[idx])
        if self.preprocess_fn is not None:
            image = self.preprocess_fn(img)
        else:
            image = img
        if self.tokenizer is not None:
            text = np.asarray(self.tokenizer([sentence])[0])
        else:
            text = np.zeros(8, dtype=np.int32)
        nbr_ids, alphas = self._neighbors(idx)
        return {
            "image": image,
            "text": text,
            "raw_text": sentence,
            "anchor_tile_id": idx,
            "neighbor_tile_ids": nbr_ids,
            "neighbor_alphas": alphas,
        }


def synthetic_gene_list():
    return list(_SYNTH_GENES)
