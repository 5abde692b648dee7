"""CSV image / caption dataset (counterpart of
``spatial_clip_tpu.data.datasets.csv_backend``).

Rows: an image path and a caption column (tab-separated by default, columns
``filepath`` / ``title``), read with the standard ``csv`` module. Items have
the spatial schema with no neighbors (ids -1, alphas 0.0), so they feed the
same collate and the plain CLIP loss. The JAX package reads the file with
pandas, which parses cells as numbers and reads an empty cell as ``nan``;
here every cell is its text as written, which is the same string for
paths and captions that are not numbers and not empty.
"""
from __future__ import annotations

import csv
from pathlib import Path
from typing import Callable, Optional, Union

import numpy as np


class CsvDataset:
    def __init__(self, input_filename: Union[str, Path], preprocess_fn: Optional[Callable] = None,
                 tokenizer: Optional[Callable] = None, img_key: str = "filepath",
                 caption_key: str = "title", sep: str = "\t", k_neighbors: int = 0):
        with open(input_filename, newline="") as f:
            rows = list(csv.DictReader(f, delimiter=sep))
        self.images = [row[img_key] for row in rows]
        self.captions = [row[caption_key] for row in rows]
        self.root = Path(input_filename).parent
        self.preprocess_fn = preprocess_fn
        self.tokenizer = tokenizer
        self.k_neighbors = max(k_neighbors, 1)

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, idx: int) -> dict:
        from PIL import Image

        path = Path(self.images[idx])
        if not path.is_absolute():
            path = self.root / path
        img = Image.open(path).convert("RGB")
        image = self.preprocess_fn(img) if self.preprocess_fn else np.asarray(img)
        caption = self.captions[idx]
        text = (np.asarray(self.tokenizer([caption])[0]) if self.tokenizer
                else np.zeros(8, dtype=np.int32))
        return {
            "image": image,
            "text": text,
            "raw_text": caption,
            "anchor_tile_id": idx,
            "neighbor_tile_ids": [-1] * self.k_neighbors,
            "neighbor_alphas": [0.0] * self.k_neighbors,
        }
