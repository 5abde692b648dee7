"""Block-index helpers (counterpart of ``spatial_clip_tpu.ops.flops``; only
:func:`feature_take_indices` so far)."""
from __future__ import annotations


def feature_take_indices(num_blocks: int, indices) -> list:
    """The block ids a ``*_indices`` argument names: None every block, an
    int n the last n blocks, a sequence its ids with negatives wrapped."""
    if indices is None:
        return list(range(num_blocks))
    if isinstance(indices, int):
        return list(range(num_blocks - indices, num_blocks))
    return [i if i >= 0 else num_blocks + i for i in indices]
