"""Weighted multi-source resampling (counterpart of
``spatial_clip_tpu.data.resampling``): the ``::``-weighted ``--train-data``
syntax and :class:`ResampledDataset`, which mixes map-style datasets by
weight. Each epoch draws ``samples_per_epoch`` (dataset, index) pairs from
the mixture with the seed ``seed * 1_000_003 + epoch``, so every process
derives the same plan.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def parse_weighted_spec(spec: str):
    """'pathA::2 pathB::1' or 'pathA pathB' -> (paths, weights)."""
    paths, weights = [], []
    for part in spec.split():
        if "::" in part:
            p, w = part.rsplit("::", 1)
            paths.append(p)
            weights.append(float(w))
        else:
            paths.append(part)
            weights.append(1.0)
    return paths, weights


class ResampledDataset:
    def __init__(self, datasets: Sequence, weights: Optional[Sequence[float]] = None,
                 samples_per_epoch: Optional[int] = None, seed: int = 0):
        self.datasets = list(datasets)
        w = np.asarray(weights if weights is not None else [1.0] * len(datasets),
                       dtype=np.float64)
        self.weights = w / w.sum()
        self.samples_per_epoch = samples_per_epoch or sum(len(d) for d in datasets)
        self.seed = seed
        self._epoch = 0
        self._plan = self._make_plan()

    def set_epoch(self, epoch: int):
        """Draw the plan of ``epoch``."""
        self._epoch = epoch
        self._plan = self._make_plan()

    def _make_plan(self) -> List:
        rng = np.random.default_rng(self.seed * 1_000_003 + self._epoch)
        ds_choice = rng.choice(len(self.datasets), size=self.samples_per_epoch, p=self.weights)
        return [(int(d), int(rng.integers(len(self.datasets[d])))) for d in ds_choice]

    def __len__(self) -> int:
        return self.samples_per_epoch

    def __getitem__(self, idx: int):
        d, i = self._plan[idx]
        return self.datasets[d][i]

    def skip_item(self, idx: int) -> None:
        """Advances the planned dataset's host transform as ``self[idx]``
        would (its ``skip_item``)."""
        d, i = self._plan[idx]
        self.datasets[d].skip_item(i)
