"""Dataset factory (counterpart of ``spatial_clip_tpu.data.datasets``): the
``synthetic``, ``shards``/``shards_v1`` and ``parquet``/``parquet_v1``
formats. ``csv`` is not ported yet (ROADMAP Queue 1 item 2).
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Callable, Dict, Optional, Union

from spatial_clip_tpu_torch.data.datasets.parquet_backend import ParquetSpatialDataset
from spatial_clip_tpu_torch.data.datasets.shard_backend import ShardedSpatialDataset
from spatial_clip_tpu_torch.data.datasets.synthetic import (
    SyntheticExpressionDataset,
    SyntheticSpatialDataset,
)

__all__ = [
    "ParquetSpatialDataset",
    "ShardedSpatialDataset",
    "SyntheticExpressionDataset",
    "SyntheticSpatialDataset",
    "create_spatial_dataset",
]


def _resolve_sample_ids(split_spec: Any, data_dir: Path) -> list:
    """Split spec forms: a list of sample ids, a path to a txt file (one id per line), or a split
    name treated as '<data_dir>/<name>.txt' if present."""
    if isinstance(split_spec, (list, tuple)):
        return list(split_spec)
    spec = str(split_spec)
    p = Path(spec)
    if p.suffix == ".txt":
        if not p.exists():
            p = data_dir / spec
        with open(p) as f:
            return [line.strip() for line in f if line.strip()]
    listing = data_dir / f"{spec}.txt"
    if listing.exists():
        with open(listing) as f:
            return [line.strip() for line in f if line.strip()]
    # fall back: every sample directory
    return sorted(d.name for d in data_dir.iterdir() if d.is_dir() and not d.name.startswith("."))


def create_spatial_dataset(
    format_name: str,
    data_dir: Union[str, Path],
    split_name: str,
    split_spec: Any,
    k_neighbors: int,
    preprocess_fn: Optional[Callable] = None,
    tokenizer: Optional[Callable] = None,
    format_kwargs: Optional[Dict[str, Any]] = None,
):
    data_dir = Path(data_dir)
    kwargs = dict(format_kwargs or {})
    fmt = format_name.lower()
    if fmt in ("parquet", "parquet_v1"):
        sub = split_spec if isinstance(split_spec, str) else split_name
        return ParquetSpatialDataset(
            data_path=data_dir / sub,
            k_neighbors=k_neighbors,
            preprocess_fn=preprocess_fn,
            tokenizer=tokenizer,
            **kwargs,
        )
    if fmt in ("shards", "shards_v1"):
        sample_ids = _resolve_sample_ids(split_spec, data_dir)
        return ShardedSpatialDataset(
            dataset_root=data_dir,
            split=split_name,
            sample_ids=sample_ids,
            k_neighbors=k_neighbors,
            preprocess_fn=preprocess_fn,
            tokenizer=tokenizer,
            **kwargs,
        )
    if fmt == "csv":
        raise NotImplementedError(
            "dataset_format 'csv' (csv_backend.CsvDataset) is not ported to "
            "spatial_clip_tpu_torch: ROADMAP Queue 1 item 2")
    if fmt == "synthetic":
        kwargs.setdefault("num_samples", 256)
        if split_name == "val":
            kwargs["num_samples"] = max(kwargs["num_samples"] // 4, 8)
            kwargs.setdefault("seed", 1)
        return SyntheticSpatialDataset(
            k_neighbors=k_neighbors,
            preprocess_fn=preprocess_fn,
            tokenizer=tokenizer,
            **kwargs,
        )
    raise ValueError(f"Unknown dataset format: {format_name}")
