"""The port's data layer against the JAX package's on the same inputs: the
host image transforms, the synthetic, tar-shard and parquet datasets, the
collate function and the loader (no workers, thread workers and spawned
process workers, two epochs of shuffling).

The shards and the parquet split are built in ``tmp_path`` as
``tests/test_spatial_datasets.py`` builds them. Everything here is numpy
and PIL on both sides, so every comparison is exact: the same uint8 tiles,
token ids, tile ids, neighbor ids and weights, key by key.
"""
from __future__ import annotations

import tests.helpers.torch_threads  # noqa: F401  (xdist workers share the cores)

import json
import tarfile
from io import BytesIO
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
from PIL import Image

from spatial_clip_tpu.data import datamodule as jax_dm
from spatial_clip_tpu.data.datasets import create_spatial_dataset as jax_create_dataset
from spatial_clip_tpu.models import transforms as jax_tf
from spatial_clip_tpu.models.factory import get_tokenizer as jax_get_tokenizer
from spatial_clip_tpu_torch.data import datamodule
from spatial_clip_tpu_torch.data.datasets import create_spatial_dataset
from spatial_clip_tpu_torch.models import transforms as tf
from spatial_clip_tpu_torch.models.factory import get_tokenizer


def _image(seed: int, size=(40, 30)) -> Image.Image:
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 256, (size[1], size[0], 3), dtype=np.uint8))


def _same_items(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape, k
            np.testing.assert_array_equal(x, y, err_msg=k)
        else:
            assert x == y, k


# ----------------------------------------------------------- host transforms

@pytest.mark.parametrize("aug", [None, dict(scale=(0.3, 1.0), ratio=(0.5, 2.0))])
def test_train_transform_draws_jax_crops(aug):
    """Train mode: the same random resized crops from the same seed, over a
    run of images of several sizes (the generator's state carries over)."""
    ours = tf.image_transform(24, is_train=True, aug_cfg=aug, seed=3)
    theirs = jax_tf.image_transform(24, is_train=True, aug_cfg=aug, seed=3)
    for i, size in enumerate([(40, 30), (30, 40), (24, 24), (100, 17), (9, 9)] * 2):
        img = _image(i, size)
        got, want = ours(img), theirs(img)
        assert got.shape == (24, 24, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ours(np.asarray(_image(99))), theirs(np.asarray(_image(99))))


@pytest.mark.parametrize("resize_mode", ["shortest", "squash", "longest"])
@pytest.mark.parametrize("interpolation", ["bicubic", "bilinear"])
def test_val_transform_matches_jax(resize_mode, interpolation):
    ours = tf.image_transform((20, 28), resize_mode=resize_mode, interpolation=interpolation,
                              fill_color=7)
    theirs = jax_tf.image_transform((20, 28), resize_mode=resize_mode,
                                    interpolation=interpolation, fill_color=7)
    for i, size in enumerate([(40, 30), (30, 40), (28, 20), (5, 60)]):
        np.testing.assert_array_equal(ours(_image(i, size)), theirs(_image(i, size)))
        np.testing.assert_array_equal(ours(_image(i, size).convert("L")),
                                      theirs(_image(i, size).convert("L")))


def test_val_transform_passes_model_sized_ndarrays_through():
    t = tf.image_transform(16)
    tile = np.asarray(_image(1, (16, 16)))
    assert t(tile) is tile and t.ndarray_fast_size == (16, 16) == (
        jax_tf.image_transform(16).ndarray_fast_size)
    assert tf.image_transform(16, is_train=True).ndarray_fast_size is None
    assert tf.AugmentationCfg.from_any({"scale": [0.5, 1.0], "other": 1}) == tf.AugmentationCfg(
        scale=(0.5, 1.0))


# ----------------------------------------------------------------- datasets

def _write_png(path: Path, color: int) -> None:
    Image.new("RGB", (4, 4), color=(color, color, color)).save(path)


def _make_parquet_split(root: Path) -> Path:
    split_dir = root / "train"
    split_dir.mkdir(parents=True)
    paths = []
    for i, color in enumerate((10, 20, 30)):
        paths.append(split_dir / f"img{i}.png")
        _write_png(paths[-1], color)
    pd.DataFrame({
        "tile_id": [1, 2, 3],
        "image_path": [str(p) for p in paths],
        "gene_sentence": ["gene A", "gene B", "gene C GENE7"],
    }).to_parquet(split_dir / "nodes.parquet")
    pd.DataFrame({
        "src_tile_id": [1, 1, 2, 3, 3, 3],
        "nbr_tile_id": [1, 2, 1, 1, 2, 9],
        "alpha": [0.6, 0.4, 1.0, 0.2, 0.9, 0.5],
    }).to_parquet(split_dir / "edges.parquet")
    return split_dir


def _make_shards(root: Path) -> Path:
    dataset_root = root / "processed"
    for sample, n in (("SAMPLE_A", 5), ("SAMPLE_B", 3)):
        sample_dir = dataset_root / sample
        sample_dir.mkdir(parents=True, exist_ok=True)
        with tarfile.open(sample_dir / f"{sample}_000000.tar", "w") as tar:
            for idx in range(n):
                base = f"{sample}_{idx:03d}"
                buf = BytesIO()
                Image.new("RGB", (6, 6), color=(idx * 20, 40, 0)).save(buf, format="PNG")
                payloads = (
                    ("png", buf.getvalue()),
                    ("txt", f"spot {idx} GENE{idx}".encode()),
                    ("json", json.dumps({"sample_id": sample, "x": idx * 5,
                                         "y": (idx * 7) % 11}).encode()),
                )
                for ext, payload in payloads:
                    info = tarfile.TarInfo(name=f"{base}.{ext}")
                    info.size = len(payload)
                    tar.addfile(info, BytesIO(payload))
    return dataset_root


def _both_datasets(fmt, data_dir, split, split_spec, k, train, tmp_path, **kw):
    """The port's dataset and the JAX package's on the same files, with their
    own host transforms (seeded alike) and tokenizers; shard neighbor caches
    in separate directories, so each package builds its own graph."""
    out = []
    for create, transforms, tokenizer, tag in (
            (create_spatial_dataset, tf, get_tokenizer("ViT-Test"), "port"),
            (jax_create_dataset, jax_tf, jax_get_tokenizer("ViT-Test"), "jax")):
        fkw = dict(kw)
        if fmt.startswith("shards"):
            fkw.update(cache_dir=tmp_path / f"cache_{tag}", rebuild_cache=True)
        pp = transforms.image_transform(8, is_train=train, seed=5) if train is not None else None
        out.append(create(format_name=fmt, data_dir=data_dir, split_name=split,
                          split_spec=split_spec, k_neighbors=k, preprocess_fn=pp,
                          tokenizer=tokenizer, format_kwargs=fkw))
    return out


@pytest.mark.parametrize("train", [True, False, None])
@pytest.mark.parametrize("split", ["train", "val"])
def test_synthetic_dataset_matches_jax(split, train):
    ours, theirs = _both_datasets("synthetic", "", split, split, 6, train, None,
                                  num_samples=40, image_size=12)
    assert len(ours) == len(theirs) == (40 if split == "train" else 10)
    for i in range(len(ours)):
        _same_items(ours[i], theirs[i])


@pytest.mark.parametrize("train", [True, False, None])
def test_shard_dataset_matches_jax(tmp_path, train):
    root = _make_shards(tmp_path)
    ours, theirs = _both_datasets("shards_v1", root, "train", ["SAMPLE_A", "SAMPLE_B"], 3,
                                  train, tmp_path)
    assert len(ours) == len(theirs) == 8
    np.testing.assert_array_equal(ours._graph["ids"], theirs._graph["ids"])
    np.testing.assert_array_equal(ours._graph["alphas"], theirs._graph["alphas"])
    for i in range(len(ours)):
        _same_items(ours[i], theirs[i])


@pytest.mark.parametrize("raw", ["png", "npy"])
def test_shard_skip_item_draws_as_getitem(tmp_path, raw):
    """A shard dataset's ``skip_item`` (what a rank does with the rows of a
    global batch that other ranks take) leaves the train transform's random
    state where ``self[idx]`` leaves it, from the png's or the npy tile's
    header alone; npy tiles 9 high and 7 wide, so a swapped size draws other
    boxes."""
    from spatial_clip_tpu_torch.data.datasets.shard_backend import ShardedSpatialDataset

    if raw == "png":
        root = _make_shards(tmp_path)
        samples = ["SAMPLE_A", "SAMPLE_B"]
    else:
        root, samples = tmp_path / "processed", ["S"]
        (root / "S").mkdir(parents=True)
        with tarfile.open(root / "S" / "S_000000.tar", "w") as tar:
            for idx in range(4):
                buf = BytesIO()
                np.save(buf, np.full((9, 7, 3), idx * 30, np.uint8))
                for ext, payload in (("npy", buf.getvalue()), ("txt", f"spot {idx}".encode()),
                                     ("json", json.dumps({"sample_id": "S", "x": idx,
                                                          "y": 0}).encode())):
                    info = tarfile.TarInfo(name=f"S_{idx:03d}.{ext}")
                    info.size = len(payload)
                    tar.addfile(info, BytesIO(payload))
    ours = [ShardedSpatialDataset(root, "train", samples, 2, cache_dir=tmp_path / "cache",
                                  preprocess_fn=tf.image_transform(6, is_train=True, seed=5,
                                                                   aug_cfg={"scale": (0.3, 1)}))
            for _ in range(2)]
    for i in range(len(ours[0])):
        ours[0][i]
        ours[1].skip_item(i)
        assert (ours[0].preprocess_fn.rng.bit_generator.state
                == ours[1].preprocess_fn.rng.bit_generator.state), i


def test_shard_split_specs_resolve_as_jax(tmp_path):
    """A split listing file, a .txt path and a bare directory scan."""
    from spatial_clip_tpu.data.datasets import _resolve_sample_ids as jax_resolve
    from spatial_clip_tpu_torch.data.datasets import _resolve_sample_ids

    root = _make_shards(tmp_path)
    (root / "val.txt").write_text("SAMPLE_B\n\n")
    (tmp_path / "list.txt").write_text("SAMPLE_A\nSAMPLE_B\n")
    for spec in ("val", str(tmp_path / "list.txt"), "train", ["SAMPLE_B"]):
        assert _resolve_sample_ids(spec, root) == jax_resolve(spec, root)


@pytest.mark.parametrize("train", [True, False, None])
def test_parquet_dataset_matches_jax(tmp_path, train):
    split_dir = _make_parquet_split(tmp_path)
    ours, theirs = _both_datasets("parquet_v1", split_dir.parent, "train", "train", 2, train,
                                  tmp_path)
    assert len(ours) == len(theirs) == 3
    for i in range(3):
        _same_items(ours[i], theirs[i])
    assert ours[2]["neighbor_tile_ids"] == [2, 9]  # top-k by alpha


def test_unported_dataset_formats_raise(tmp_path):
    """``csv`` builds from ``<data_dir>/<split>.csv`` (its items against
    JAX's: ``test_torch_port_cli_data.py``); an unknown format raises."""
    (tmp_path / "train.csv").write_text("filepath\ttitle\na.png\ta tile\n")
    ds = create_spatial_dataset("csv", tmp_path, "train", "train", 2)
    assert len(ds) == 1 and ds.captions == ["a tile"] and ds.k_neighbors == 2
    with pytest.raises(ValueError, match="Unknown dataset format"):
        create_spatial_dataset("webdataset", tmp_path, "train", "train", 2)


# ------------------------------------------------------------------- loader

def _batches(loader_cls, dataset, workers, worker_type, epochs=2, **kw):
    loader = loader_cls(dataset, batch_size=8, shuffle=True, num_workers=workers,
                        worker_type=worker_type, seed=11, **kw)
    out = []
    for epoch in range(epochs):
        loader.set_epoch(epoch)
        out.append(list(loader))
    return len(loader), out


@pytest.mark.parametrize("workers,worker_type", [(0, "thread"), (3, "thread"), (2, "process")])
def test_loader_gives_jax_batches(workers, worker_type):
    """Two epochs of shuffled, collated batches (a val-mode transform, so
    the workers' order of items cannot change a tile): key by key and bit
    for bit the JAX loader's; the epochs differ from each other."""
    from spatial_clip_tpu.data.datasets.synthetic import SyntheticSpatialDataset as JaxSynth
    from spatial_clip_tpu_torch.data.datasets.synthetic import SyntheticSpatialDataset

    kw = dict(num_samples=37, image_size=10, k_neighbors=4)
    ours = SyntheticSpatialDataset(preprocess_fn=tf.image_transform(8),
                                   tokenizer=get_tokenizer("ViT-Test"), **kw)
    theirs = JaxSynth(preprocess_fn=jax_tf.image_transform(8),
                      tokenizer=jax_get_tokenizer("ViT-Test"), **kw)
    n, got = _batches(datamodule.DataLoader, ours, workers, worker_type)
    jn, want = _batches(jax_dm.DataLoader, theirs, workers, worker_type)
    assert n == jn == 4 and [len(e) for e in got] == [len(e) for e in want] == [4, 4]
    for g_epoch, w_epoch in zip(got, want):
        for g, w in zip(g_epoch, w_epoch):
            _same_items(g, w)
    assert not np.array_equal(got[0][0]["image_tile_ids"], got[1][0]["image_tile_ids"])


def test_loader_rank_takes_its_strided_share():
    """World size 2: every rank derives the one-process permutation and
    global batches of 6, and rank r takes the rows [3r, 3r + 3) of each, so
    the ranks' shares are disjoint and together are the one-process
    batches. (Before data parallelism was ported a rank took the strided
    share idx[rank::2], JAX's multi-host meaning, which
    test_torch_port_dist_entry.py pins as a difference.)"""
    from spatial_clip_tpu_torch.data.datasets.synthetic import SyntheticSpatialDataset

    ds = SyntheticSpatialDataset(num_samples=36, image_size=4, k_neighbors=2)
    whole = [b["image_tile_ids"] for b in datamodule.DataLoader(ds, batch_size=6, shuffle=True,
                                                                seed=3)]
    shares = []
    for rank in (0, 1):
        loader = datamodule.DataLoader(ds, batch_size=6, shuffle=True, seed=3, rank=rank,
                                       world_size=2)
        assert len(loader) == 6
        got = [b["image_tile_ids"] for b in loader]
        for g, w in zip(got, whole):
            np.testing.assert_array_equal(g, w[3 * rank:3 * rank + 3])
        shares.append(np.concatenate(got))
    assert not set(shares[0]) & set(shares[1])
    with pytest.raises(ValueError, match="rank"):
        datamodule.DataLoader(ds, batch_size=6, rank=2, world_size=2)
    with pytest.raises(ValueError, match="split over 4 ranks"):
        datamodule.DataLoader(ds, batch_size=6, rank=0, world_size=4)


def test_datamodule_matches_jax_datamodule():
    """The datamodule's handshake, splits and loaders on the synthetic format."""
    kw = dict(batch_size=8, num_workers=0, dataset_format="synthetic",
              dataset_format_kwargs=dict(num_samples=48, image_size=12))
    ours, theirs = datamodule.SpatialClipDataModule(**kw), jax_dm.SpatialClipDataModule(**kw)
    with pytest.raises(ValueError, match="preprocess_fn"):
        ours.setup("fit")
    for dm, t, tok in ((ours, tf, get_tokenizer("ViT-Test")),
                       (theirs, jax_tf, jax_get_tokenizer("ViT-Test"))):
        dm.preprocess_fn = t.image_transform(8, is_train=True, seed=0)
        dm.preprocess_fn_val = t.image_transform(8)
        dm.tokenizer = tok
        dm.prepare_data()
        dm.setup("fit")
    for name in ("train_dataloader", "val_dataloader", "test_dataloader"):
        got, want = list(getattr(ours, name)()), list(getattr(theirs, name)())
        assert len(got) == len(want) > 0, name
        for g, w in zip(got, want):
            _same_items(g, w)


def test_native_libraries_are_looked_up_only_in_the_checkout(tmp_path, monkeypatch):
    """The tar indexer and the image decoder load only the repository's own
    built ``native/*.so`` (or ``$SPATIAL_CLIP_NATIVE`` for the indexer),
    never a library in the directories around the checkout."""
    from spatial_clip_tpu_torch.data.datasets import _native

    root = Path(_native.__file__).resolve().parents[3]
    monkeypatch.delenv("SPATIAL_CLIP_NATIVE", raising=False)
    for name in ("libspatialclip_native.so", "libscimagedec.so"):
        found = _native._find_lib(name)
        assert found is None or found == root / "native" / name, found
    decoy = tmp_path / "elsewhere.so"
    decoy.write_bytes(b"")
    monkeypatch.setenv("SPATIAL_CLIP_NATIVE", str(decoy))
    assert _native._find_lib() == decoy
    assert _native._find_lib("libscimagedec.so") in (None, root / "native/libscimagedec.so")
