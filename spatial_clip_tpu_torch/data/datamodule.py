"""Datamodule: dataset construction + batching + collate + prefetch
(counterpart of ``spatial_clip_tpu.data.datamodule``).

The same constructor surface, model<->data handshake (the entry point
assigns ``preprocess_fn``/``tokenizer`` before ``setup()``), collate schema,
loader (thread or spawned process workers, per-worker generator seeding,
drop-last batches, the shuffle drawn from ``seed + epoch``) and batches
(numpy dicts) as the JAX package's. The process's rank and the world size,
which the JAX package reads from ``jax.process_index``/``process_count``,
are constructor arguments (default 0 and 1): with a world size above 1 each
rank takes the strided share ``idx[rank::world_size]`` of the permutation
every rank derives alike.
"""
from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np

log = logging.getLogger(__name__)


def collate_spatial(items: List[Dict[str, Any]]) -> Dict[str, Any]:
    """List of per-spot dicts -> batch dict."""
    batch: Dict[str, Any] = {
        "images": np.stack([np.asarray(it["image"]) for it in items]),
        "texts": np.stack([np.asarray(it["text"]) for it in items]),
    }
    anchor = np.asarray([it["anchor_tile_id"] for it in items], dtype=np.int32)
    batch["image_tile_ids"] = anchor
    batch["text_tile_ids"] = anchor  # symmetric setup: same ids both towers
    batch["neighbor_tile_ids"] = np.asarray(
        [it["neighbor_tile_ids"] for it in items], dtype=np.int32
    )
    batch["neighbor_alphas"] = np.asarray(
        [it["neighbor_alphas"] for it in items], dtype=np.float32
    )
    if "raw_text" in items[0]:
        batch["raw_text"] = [it["raw_text"] for it in items]
    rwv = items[0].get("rank_weighted_vector")
    if rwv is not None and np.asarray(rwv).size > 0:
        batch["rank_weighted_vector"] = np.stack(
            [np.asarray(it["rank_weighted_vector"], dtype=np.float32) for it in items]
        )
    return batch


_WORKER_DATASET = None


def _init_worker_dataset(dataset, counter, seed_base):
    # runs once in each pool process; the dataset pickles its index +
    # preprocess/tokenizer state and re-reads shard files lazily per item
    global _WORKER_DATASET
    _WORKER_DATASET = dataset
    # distinct augmentation streams per (worker, epoch): without this every
    # worker forks/spawns with an IDENTICAL copy of the transform RNG, and
    # each epoch's fresh pool replays the same crop/flip sequence (torch
    # seeds workers base_seed + worker_id for the same reason)
    with counter.get_lock():
        worker_id = counter.value
        counter.value += 1
    pf = getattr(dataset, "preprocess_fn", None)
    if pf is not None and hasattr(pf, "rng"):
        pf.rng = np.random.default_rng(seed_base + worker_id)


def _worker_getitem(i: int):
    return _WORKER_DATASET[i]


class DataLoader:
    """Minimal map-style loader: shuffle, drop-last batching, parallel decode.

    ``num_workers`` workers fetch+preprocess items ahead of the consumer
    (plays the role of torch DataLoader workers). ``worker_type='thread'``
    (default) uses a thread pool — cheap, zero-copy, and sufficient where
    PIL/numpy release the GIL during decode/resize; ``'process'`` uses a
    process pool (the torch-workers analogue) for hosts where the Python
    bytes between decode and collate become the bottleneck — each worker
    deserializes the dataset once at pool startup, items return via pickle.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = True,
        num_workers: int = 0,
        collate_fn: Callable = collate_spatial,
        seed: int = 0,
        prefetch_batches: int = 2,
        shard_by_process: bool = True,
        worker_type: str = "thread",
        rank: int = 0,
        world_size: int = 1,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.collate_fn = collate_fn
        self.seed = seed
        self.prefetch_batches = prefetch_batches
        self.shard_by_process = shard_by_process
        if worker_type not in ("thread", "process"):
            raise ValueError(f"worker_type must be thread|process, got {worker_type!r}")
        self.worker_type = worker_type
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} outside a world of {world_size}")
        self.rank, self.world_size = rank, world_size
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.shard_by_process:
            pc = self.world_size
            n = len(range(self.rank, n, pc)) if pc > 1 else n
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def set_epoch(self, epoch: int):
        """Deterministic epoch-synced shuffling: every rank derives the same
        permutation."""
        self._epoch = epoch

    def _index_batches(self) -> List[np.ndarray]:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            # every rank derives the SAME permutation, then takes a
            # disjoint strided slice
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(idx)
        if self.shard_by_process:
            pc, pi = self.world_size, self.rank
            if pc > 1:
                idx = idx[pi::pc]  # strided split ~= DistributedSampler
        nb = len(idx) // self.batch_size if self.drop_last else -(-len(idx) // self.batch_size)
        return [idx[i * self.batch_size : (i + 1) * self.batch_size] for i in range(nb)]

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        batches = self._index_batches()
        if self.num_workers <= 0:
            for b in batches:
                yield self.collate_fn([self.dataset[int(i)] for i in b])
            return

        if self.worker_type == "process":
            import multiprocessing
            from concurrent.futures import ProcessPoolExecutor

            # spawn, not fork: forking a parent that runs threads (the
            # checkpoint writer, PyTorch's pools) can deadlock a child on
            # an inherited lock
            ctx = multiprocessing.get_context("spawn")
            pool_cm = ProcessPoolExecutor(
                max_workers=self.num_workers,
                mp_context=ctx,
                initializer=_init_worker_dataset,
                initargs=(
                    self.dataset,
                    ctx.Value("i", 0),
                    self.seed + 1009 * (self._epoch + 1),
                ),
            )
            getitem = _worker_getitem
        else:
            pool_cm = ThreadPoolExecutor(max_workers=self.num_workers)
            getitem = self.dataset.__getitem__
        with pool_cm as pool:
            # flat per-item futures (no nested pool work -> no deadlock);
            # prefetch_batches batches stay in flight while the consumer runs
            pending: List[List] = []
            it = iter(batches)

            def submit_next():
                try:
                    b = next(it)
                except StopIteration:
                    return None
                return [pool.submit(getitem, int(i)) for i in b]

            for _ in range(self.prefetch_batches):
                futs = submit_next()
                if futs:
                    pending.append(futs)
            while pending:
                futs = pending.pop(0)
                nxt = submit_next()
                if nxt:
                    pending.append(nxt)
                yield self.collate_fn([f.result() for f in futs])


class SpatialClipDataModule:
    """The JAX package's ``SpatialClipDataModule``, with the process's
    ``rank`` and the ``world_size`` passed in."""

    def __init__(
        self,
        data_dir: str = "",
        k_neighbors: int = 6,
        batch_size: int = 128,
        num_workers: int = 0,
        pin_memory: bool = False,  # accepted for config parity; the trainer pins on a GPU
        worker_type: str = "thread",
        dataset_format: str = "parquet_v1",
        dataset_format_kwargs: Optional[Dict[str, Any]] = None,
        splits: Optional[Dict[str, Any]] = None,
        seed: int = 42,
        rank: int = 0,
        world_size: int = 1,
    ):
        self.data_dir = Path(data_dir) if data_dir else Path(".")
        self.k_neighbors = k_neighbors
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.worker_type = worker_type
        self.dataset_format = dataset_format
        self.dataset_format_kwargs = dict(dataset_format_kwargs or {})
        default_splits = {"train": "train", "val": "val", "test": None}
        self.splits = {**default_splits, **(dict(splits) if splits else {})}
        self.seed = seed
        self.rank, self.world_size = rank, world_size

        self.data_train = None
        self.data_val = None
        # set by the model<->data handshake before setup()
        self.preprocess_fn: Optional[Callable] = None
        self.preprocess_fn_val: Optional[Callable] = None
        self.tokenizer: Optional[Callable] = None

    # ---------------------------------------------------------------- stages
    def prepare_data(self) -> None:
        """Path verification only."""
        if self.dataset_format in {"parquet", "parquet_v1"}:
            missing = []
            for split_name in ("train", "val"):
                spec = self.splits.get(split_name)
                if isinstance(spec, str):
                    candidate = self.data_dir / spec
                    if not candidate.exists():
                        missing.append(candidate)
            if missing:
                raise FileNotFoundError(
                    "Missing parquet dataset splits: "
                    + ", ".join(str(p) for p in missing)
                )
        elif self.dataset_format != "synthetic":
            if not self.data_dir.exists():
                raise FileNotFoundError(f"Dataset directory '{self.data_dir}' not found.")
        log.info("Dataset paths verified for format %s", self.dataset_format)

    def setup(self, stage: Optional[str] = None) -> None:
        if self.preprocess_fn is None or self.tokenizer is None:
            raise ValueError(
                "DataModule requires preprocess_fn and tokenizer to be set "
                "before setup()."
            )
        if stage in ("fit", None):
            if self.data_train is None:
                self.data_train = self._build_dataset("train", train=True)
            if self.data_val is None:
                self.data_val = self._build_dataset("val", train=False)

    def _build_dataset(self, split_name: str, train: bool):
        from spatial_clip_tpu_torch.data.datasets import create_spatial_dataset

        split_spec = self.splits.get(split_name)
        if split_spec is None:
            raise ValueError(f"No split specification provided for '{split_name}'")
        pp = self.preprocess_fn if train or self.preprocess_fn_val is None else self.preprocess_fn_val
        return create_spatial_dataset(
            format_name=self.dataset_format,
            data_dir=self.data_dir,
            split_name=split_name,
            split_spec=split_spec,
            k_neighbors=self.k_neighbors,
            preprocess_fn=pp,
            tokenizer=self.tokenizer,
            format_kwargs=self.dataset_format_kwargs,
        )

    # --------------------------------------------------------------- loaders
    def _loader(self, dataset, shuffle: bool) -> DataLoader:
        return DataLoader(
            dataset,
            batch_size=self.batch_size,
            shuffle=shuffle,
            drop_last=True,
            num_workers=self.num_workers,
            worker_type=self.worker_type,
            seed=self.seed,
            rank=self.rank,
            world_size=self.world_size,
        )

    def train_dataloader(self) -> DataLoader:
        return self._loader(self.data_train, shuffle=True)

    def val_dataloader(self) -> DataLoader:
        return self._loader(self.data_val, shuffle=False)

    def test_dataloader(self) -> DataLoader:
        return self._loader(self.data_val, shuffle=False)
