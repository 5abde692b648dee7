"""Parquet nodes/edges dataset backend (counterpart of
``spatial_clip_tpu.data.datasets.parquet_backend``).

A split directory contains ``nodes.parquet`` (tile_id, image_path,
gene_sentence) and ``edges.parquet`` (src_tile_id, nbr_tile_id, alpha). Per
anchor we take the top-k neighbors by alpha, padding with -1/0.0. pandas
and Pillow are imported inside the functions that use them.
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, Optional, Union

import numpy as np

from spatial_clip_tpu_torch.models.transforms import skip_draws


class ParquetSpatialDataset:
    def __init__(
        self,
        data_path: Union[str, Path],
        k_neighbors: int,
        preprocess_fn: Optional[Callable] = None,
        tokenizer: Optional[Callable] = None,
    ):
        self.data_path = Path(data_path)
        self.k_neighbors = k_neighbors
        self.preprocess_fn = preprocess_fn
        self.tokenizer = tokenizer
        import pandas as pd

        nodes = pd.read_parquet(self.data_path / "nodes.parquet")
        edges = pd.read_parquet(self.data_path / "edges.parquet")
        self.tile_ids = nodes["tile_id"].to_numpy()
        self.image_paths = nodes["image_path"].astype(str).to_numpy()
        self.sentences = nodes["gene_sentence"].astype(str).to_numpy()

        # vectorized per-anchor top-k by alpha
        k = k_neighbors
        n = len(nodes)
        self._nbr_ids = np.full((n, k), -1, dtype=np.int64)
        self._nbr_alphas = np.zeros((n, k), dtype=np.float32)
        if len(edges):
            edges = edges.sort_values(["src_tile_id", "alpha"], ascending=[True, False])
            pos_of_tile = {int(t): i for i, t in enumerate(self.tile_ids)}
            grouped = edges.groupby("src_tile_id", sort=False)
            for src, grp in grouped:
                row = pos_of_tile.get(int(src))
                if row is None:
                    continue
                ids = grp["nbr_tile_id"].to_numpy()[:k]
                al = grp["alpha"].to_numpy()[:k]
                self._nbr_ids[row, : len(ids)] = ids
                self._nbr_alphas[row, : len(al)] = al

    def __len__(self) -> int:
        return len(self.tile_ids)

    def skip_item(self, idx: int) -> None:
        """Advances the host transform's random state as ``self[idx]``
        would, reading the image's size from its header only (a rank skips
        the rows of a global batch that other ranks take)."""
        from PIL import Image

        def size():
            with Image.open(self.image_paths[idx]) as im:
                return im.size

        skip_draws(self.preprocess_fn, size)

    def __getitem__(self, idx: int) -> Dict:
        from PIL import Image

        img = Image.open(self.image_paths[idx]).convert("RGB")
        image = self.preprocess_fn(img) if self.preprocess_fn else np.asarray(img)
        sentence = self.sentences[idx]
        if self.tokenizer is not None:
            text = np.asarray(self.tokenizer([sentence])[0])
        else:
            text = np.zeros(8, dtype=np.int32)
        return {
            "image": image,
            "text": text,
            "raw_text": sentence,
            "anchor_tile_id": int(self.tile_ids[idx]),
            "neighbor_tile_ids": self._nbr_ids[idx].tolist(),
            "neighbor_alphas": self._nbr_alphas[idx].tolist(),
        }
