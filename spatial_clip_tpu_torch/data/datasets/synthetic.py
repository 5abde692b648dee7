"""Synthetic spatial dataset (counterpart of
``spatial_clip_tpu.data.datasets.synthetic.SyntheticSpatialDataset``): the
fake-data perf/smoke backend, with a spatial neighbor graph so the spatial
loss path runs without real HEST shards.

Spots sit on a sqrt(n) x sqrt(n) grid; each spot's neighbors are its 4-ring
grid adjacency with distance-decayed alphas; gene sentences are deterministic
draws from a synthetic gene vocabulary. :class:`SyntheticExpressionDataset`
(the JAX package's, item for item the same bits) draws its sentences from
continuous expression statistics instead.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from spatial_clip_tpu_torch.models.transforms import skip_draws

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

    def skip_item(self, idx: int) -> None:
        """Advances the host transform's random state as ``self[idx]``
        would, without rendering the tile (a rank skips the rows of a global
        batch that other ranks take)."""
        skip_draws(self.preprocess_fn, lambda: (self.image_size, self.image_size))

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


class SyntheticExpressionDataset(SyntheticSpatialDataset):
    """Continuous-expression synthetic generator (counterpart of the JAX
    package's, item for item the same bits). Unlike the base class, whose
    tiles are a function of gene identities, it is grounded in continuous
    expression statistics:

    - a smooth low-dimensional latent tissue field z(r, c) over the slide
      (a sum of random low-frequency plane waves per latent dim), following
      ``seed``;
    - gene counts ~ Poisson(exp(z @ W + b)) with sparse random loadings W
      and base b, following ``world_seed`` (shared across splits);
    - the tile rendered from z (fixed gratings, not keyed by genes);
    - the sentence: the top ``sentence_len`` genes by count, stable order.

    Image <-> expression correspondence exists only through the latent
    field, and the Poisson draw makes ranks noisy.
    """

    def __init__(self, *args, n_latent: int = 8, n_waves: int = 4,
                 expr_scale: float = 1.2, world_seed: int = 1234, **kwargs):
        super().__init__(*args, **kwargs)
        self.n_latent = n_latent
        # the latent FIELD (which tissue the slide shows) follows `seed`
        # (train/val draw different slides); the WORLD (gene loadings +
        # morphology rendering basis) follows `world_seed` and must be
        # shared across splits — it IS the learnable structure
        rng = np.random.default_rng(self.seed + 777)
        world = np.random.default_rng(world_seed)
        side = self._side
        G = len(_SYNTH_GENES)
        # latent field: per latent dim, a sum of low-frequency plane waves
        r = (np.arange(side, dtype=np.float32) / max(side, 1))[:, None]
        c = (np.arange(side, dtype=np.float32) / max(side, 1))[None, :]
        z = np.zeros((side, side, n_latent), np.float32)
        for k in range(n_latent):
            for _ in range(n_waves):
                fr, fc = rng.uniform(0.5, 3.0, 2) * rng.choice([-1, 1], 2)
                phase = rng.uniform(0, 2 * np.pi)
                amp = rng.uniform(0.4, 1.0)
                z[:, :, k] += amp * np.sin(2 * np.pi * (fr * r + fc * c) + phase)
        z = (z - z.mean(axis=(0, 1))) / (z.std(axis=(0, 1)) + 1e-6)
        self._z = z.reshape(side * side, n_latent)[: self.num_samples]
        # gene loadings: sparse-ish so genes belong to latent programs
        W = world.normal(0, 1, (n_latent, G)).astype(np.float32)
        W *= (world.uniform(size=(n_latent, G)) < 0.35)
        self._W = W * expr_scale / np.sqrt(max(1, n_latent * 0.35))
        self._gene_base = world.normal(0.3, 0.3, G).astype(np.float32)
        # per-latent rendering basis (fixed gratings, NOT keyed by genes)
        self._render_freq = world.uniform(1.0, 6.0, n_latent).astype(np.float32)
        self._render_angle = world.uniform(0, np.pi, n_latent).astype(np.float32)
        self._render_phase = world.uniform(0, 2 * np.pi, n_latent).astype(np.float32)

    def _expression(self, idx: int, rng) -> np.ndarray:
        logmu = self._z[idx] @ self._W + self._gene_base
        return rng.poisson(np.exp(np.clip(logmu, -6, 6))).astype(np.float32)

    def _render_latent_tile(self, rng, z) -> np.ndarray:
        s = self.image_size
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / max(s, 1)
        img = np.zeros((s, s, 3), np.float32)
        for k in range(self.n_latent):
            wave = np.sin(
                2 * np.pi * self._render_freq[k]
                * (np.cos(self._render_angle[k]) * xx
                   + np.sin(self._render_angle[k]) * yy)
                + self._render_phase[k]
            )
            img[:, :, k % 3] += z[k] * wave
        img = (img - img.min()) / max(img.max() - img.min(), 1e-6)
        noise = rng.normal(0, 0.05, img.shape)
        return np.clip((img + noise) * 255, 0, 255).astype(np.uint8)

    def __getitem__(self, idx: int) -> dict:
        rng = np.random.default_rng(self.seed * 100003 + idx)
        counts = self._expression(idx, rng)
        order = np.argsort(-counts, kind="stable")[: self.sentence_len]
        sentence = " ".join(_SYNTH_GENES[g] for g in order)
        img = self._render_latent_tile(rng, self._z[idx])
        image = self.preprocess_fn(img) if self.preprocess_fn is not None else img
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
