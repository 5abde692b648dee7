"""Datamodule: dataset construction + batching + collate + prefetch
(counterpart of ``spatial_clip_tpu.data.datamodule``).

The same constructor surface, model<->data handshake (the entry point
assigns ``preprocess_fn``/``tokenizer`` before ``setup()``), collate schema,
loader (thread or spawned process workers, per-worker generator seeding,
drop-last batches, the shuffle drawn from ``seed + epoch``) and batches
(numpy dicts) as the JAX package's. The process's rank and the world size
are constructor arguments (default 0 and 1). ``batch_size`` is the global
batch, as in JAX's single-process mesh, which shards it over its devices:
every rank derives the same permutation and the same global batches, and
rank r takes the rows ``[r b, (r + 1) b)`` of each, b = batch_size /
world_size, so a data-parallel run sees the one-process run's batches. At
``num_workers`` 0 it also takes their host random crops: the rank walks
every row of each global batch in the one-process order and, for the rows
of other ranks, advances the transform's random state as their crops would
(the dataset's ``skip_item``, which reads an image's size and not its
pixels). Workers draw in no fixed order, even in one process; under a group
their streams differ by rank as well. (The
JAX package's multi-host loader means another thing: ``batch_size`` rows a
process, from its strided share ``idx[pi::pc]`` of the permutation.)
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


def _init_worker_dataset(dataset, counter, seed_base, rank=0):
    # runs once in each pool process; the dataset pickles its index +
    # preprocess/tokenizer state and re-reads shard files lazily per item
    global _WORKER_DATASET
    _WORKER_DATASET = dataset
    # distinct augmentation streams per (worker, epoch): without this every
    # worker forks/spawns with an IDENTICAL copy of the transform RNG, and
    # each epoch's fresh pool replays the same crop/flip sequence (torch
    # seeds workers base_seed + worker_id for the same reason); the ranks of
    # a group past the first draw from streams of their own as well
    with counter.get_lock():
        worker_id = counter.value
        counter.value += 1
    pf = getattr(dataset, "preprocess_fn", None)
    if pf is not None and hasattr(pf, "rng"):
        seed = seed_base + worker_id
        pf.rng = np.random.default_rng(seed if rank == 0 else [seed, rank])


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
        if shard_by_process and world_size > 1 and (batch_size % world_size or not drop_last):
            raise ValueError(f"a global batch of {batch_size} (drop_last={drop_last}) does not "
                             f"split over {world_size} ranks: it takes whole batches that the "
                             "ranks divide")
        self.rank, self.world_size = rank, world_size
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def set_epoch(self, epoch: int):
        """Deterministic epoch-synced shuffling: every rank derives the same
        permutation."""
        self._epoch = epoch

    def _global_batches(self) -> List[np.ndarray]:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            # every rank derives the SAME permutation and global batches
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(idx)
        return [idx[i * self.batch_size : (i + 1) * self.batch_size] for i in range(len(self))]

    def _sharded(self) -> bool:
        return self.shard_by_process and self.world_size > 1

    def _own_rows(self) -> slice:
        """This rank's rows of each global batch."""
        b = self.batch_size // self.world_size
        return slice(self.rank * b, (self.rank + 1) * b)

    def _index_batches(self) -> List[np.ndarray]:
        batches = self._global_batches()
        if self._sharded():
            batches = [g[self._own_rows()] for g in batches]
        return batches

    def _rank_items(self, batch: np.ndarray) -> List[Dict[str, Any]]:
        """This rank's items of a global batch, the host transform's random
        state advanced over the other ranks' rows in the one-process order
        (the dataset's ``skip_item``, which every indexed dataset has)."""
        own = self._own_rows()
        items = []
        for pos, i in enumerate(batch):
            if own.start <= pos < own.stop:
                items.append(self.dataset[int(i)])
            else:
                self.dataset.skip_item(int(i))
        return items

    def _reseed_threads(self) -> None:
        """Under a group, the thread workers' shared transform draws from a
        stream of this rank's (and epoch's): no two ranks share one."""
        pf = getattr(self.dataset, "preprocess_fn", None)
        if self._sharded() and pf is not None and hasattr(pf, "rng"):
            pf.rng = np.random.default_rng([self.seed, self._epoch, self.rank])

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        if self.num_workers <= 0:
            if self._sharded():
                for g in self._global_batches():
                    yield self.collate_fn(self._rank_items(g))
                return
            for b in self._index_batches():
                yield self.collate_fn([self.dataset[int(i)] for i in b])
            return
        batches = self._index_batches()

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
                    self.rank if self._sharded() else 0,
                ),
            )
            getitem = _worker_getitem
        else:
            self._reseed_threads()
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
