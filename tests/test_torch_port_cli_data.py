"""``cli.embed`` and the modules only the open_clip-style trainer reaches,
against the JAX package's on the same inputs: the ``.npz`` that both embed
CLIs write from the same weights (from a ``params.npz``, and the port's
from its ``step_N`` directory), ``CsvDataset``, ``ResampledDataset``,
``ImageFolderDataset`` (items and loader batches) and ``remote_sync`` /
``start_sync_process``.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

from spatial_clip_tpu.cli import embed as jax_embed
from spatial_clip_tpu.data import resampling as jax_resampling
from spatial_clip_tpu.data.datasets import csv_backend as jax_csv
from spatial_clip_tpu.data.datasets import imagefolder as jax_imagefolder
from spatial_clip_tpu.utils import file_sync as jax_file_sync
from spatial_clip_tpu_torch.cli import embed
from spatial_clip_tpu_torch.data import resampling
from spatial_clip_tpu_torch.data.datasets import create_spatial_dataset
from spatial_clip_tpu_torch.data.datasets import csv_backend, imagefolder
from spatial_clip_tpu_torch.utils import file_sync


# -------------------------------------------------------------------- embed

def test_embed_matches_jax_on_the_same_weights(tmp_path):
    """Both CLIs embed a csv split of 5 images at batch 4 (the last batch
    partial: JAX pads it to its jitted shape, the port encodes it as it is)
    from the same params.npz: the same tile ids, embeddings at atol 2e-5;
    the port from a checkpoint directory of the same weights (its newest
    ``step_N``) gives the same bits as from the npz."""
    from spatial_clip_tpu_torch import create_model
    from spatial_clip_tpu_torch.train.checkpoints import CheckpointManager, save_params_npz
    from spatial_clip_tpu_torch.train.loop import Trainer

    model = create_model("ViT-Test", precision="fp32", device="cpu", seed=3, training=True)
    save_params_npz(dict(model.named_parameters()), tmp_path / "params.npz")
    mgr = CheckpointManager(tmp_path / "ckpts")
    mgr.save(Trainer(model).init_state(), 7)
    mgr.wait()
    _images(tmp_path / "imgs", 5)
    rows = ["filepath\ttitle"] + [f"imgs/img_{i}.png\tspot {i} EPCAM" for i in range(5)]
    (tmp_path / "val.csv").write_text("\n".join(rows) + "\n")
    common = ["--model", "ViT-Test", "--precision", "fp32", "--data", str(tmp_path / "val.csv"),
              "--dataset-type", "csv", "--batch-size", "4", "--workers", "0"]
    jax_embed.main([*common, "--ckpt", str(tmp_path / "params.npz"),
                    "--out", str(tmp_path / "jax.npz")])
    stats = embed.main([*common, "--ckpt", str(tmp_path / "params.npz"), "--device", "cpu",
                        "--out", str(tmp_path / "port.npz")])
    embed.main([*common, "--ckpt", str(tmp_path / "ckpts"), "--device", "cpu",
                "--out", str(tmp_path / "step.npz")])
    theirs, ours = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    step = np.load(tmp_path / "step.npz")
    assert sorted(ours.files) == sorted(theirs.files) == sorted(step.files)
    assert stats["n"] == 5 and stats["dim"] == ours["image_embeddings"].shape[1]
    np.testing.assert_array_equal(ours["tile_ids"], theirs["tile_ids"])
    for k in ("image_embeddings", "text_embeddings"):
        assert ours[k].dtype == np.float32 and ours[k].shape == theirs[k].shape == (5, 32)
        np.testing.assert_allclose(ours[k], theirs[k], atol=2e-5, rtol=0, err_msg=k)
        np.testing.assert_array_equal(ours[k], step[k])
    assert json.loads(json.dumps(stats))["out"] == str(tmp_path / "port.npz")


# --------------------------------------------------------------------- data

def _images(root: Path, n: int, size=(20, 24)):
    rng = np.random.default_rng(n)
    from PIL import Image

    root.mkdir(parents=True, exist_ok=True)
    paths = []
    for i in range(n):
        p = root / f"img_{i}.png"
        Image.fromarray(rng.integers(0, 256, (*size, 3), dtype=np.uint8)).save(p)
        paths.append(p)
    return paths


def _same_items(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("sep", ["\t", ","])
def test_csv_dataset_matches_jax(tmp_path, sep):
    """The same items from the same tab- or comma-separated file (relative
    and absolute paths, a quoted caption holding the separator), with the
    host transform and a tokenizer; ``create_spatial_dataset('csv')``
    builds it from ``<data_dir>/<split>.csv``."""
    from spatial_clip_tpu_torch.models.factory import get_tokenizer
    from spatial_clip_tpu_torch.models.transforms import image_transform

    paths = _images(tmp_path / "imgs", 3)
    rows = [("filepath", "title"), ("imgs/img_0.png", "a tumor tile"),
            (str(paths[1]), f'"stroma{sep} lymphocytes"'), ("imgs/img_2.png", "EPCAM KRT8")]
    (tmp_path / "train.csv").write_text("\n".join(sep.join(r) for r in rows) + "\n")
    pp = image_transform(32, is_train=False)
    tok = get_tokenizer("ViT-Test")
    ours = csv_backend.CsvDataset(tmp_path / "train.csv", pp, tok, sep=sep, k_neighbors=3)
    theirs = jax_csv.CsvDataset(tmp_path / "train.csv", pp, tok, sep=sep, k_neighbors=3)
    assert len(ours) == len(theirs) == 3
    for i in range(3):
        _same_items(ours[i], theirs[i])
    assert ours[1]["raw_text"] == f"stroma{sep} lymphocytes"
    built = create_spatial_dataset("csv", tmp_path, "train", "train", 3, pp, tok,
                                   {"sep": sep})
    _same_items(built[2], theirs[2])


def test_resampled_dataset_matches_jax():
    """The same plan, epoch by epoch, from the same seed and weights; the
    ``::`` spec parsed alike."""
    spec = "a::2 b c::0.5"
    assert resampling.parse_weighted_spec(spec) == jax_resampling.parse_weighted_spec(spec)
    sources = [list(range(5)), list(range(100, 103)), list(range(200, 211))]
    ours = resampling.ResampledDataset(sources, [2.0, 1.0, 0.5], seed=7)
    theirs = jax_resampling.ResampledDataset(sources, [2.0, 1.0, 0.5], seed=7)
    for epoch in range(3):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        assert len(ours) == len(theirs) == 19
        assert [ours[i] for i in range(19)] == [theirs[i] for i in range(19)]
    assert resampling.ResampledDataset(sources, samples_per_epoch=4)._plan == \
        jax_resampling.ResampledDataset(sources, samples_per_epoch=4)._plan


@pytest.mark.parametrize("names", [["dog", "cat", "emu"], ["10", "2", "7"]])
def test_imagefolder_dataset_and_loader_match_jax(tmp_path, names):
    """Class order (numeric names sorted as numbers), the seeded per-class
    subsample, the items and the loader's batches."""
    for j, name in enumerate(names):
        _images(tmp_path / name, 3 + j)
    (tmp_path / names[0] / "notes.txt").write_text("skipped")
    ours = imagefolder.ImageFolderDataset(tmp_path, max_per_class=4, seed=1)
    theirs = jax_imagefolder.ImageFolderDataset(tmp_path, max_per_class=4, seed=1)
    assert ours.classes == theirs.classes and ours.items == theirs.items
    for i in range(len(ours)):
        _same_items(ours[i], theirs[i])
    pp = lambda img: np.asarray(img.resize((8, 8)))  # noqa: E731
    loader, classes = imagefolder.get_imagenet_loader(tmp_path, pp, batch_size=4)
    jloader, jclasses = jax_imagefolder.get_imagenet_loader(tmp_path, pp, batch_size=4)
    assert classes == jclasses
    got, want = list(loader), list(jloader)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        _same_items(a, b)


# ---------------------------------------------------------------- file sync

def test_remote_sync_matches_jax(tmp_path):
    """The same mirror of the same tree (in-flight ``latest`` / ``.tmp``
    files skipped), then the same after a file grows, except that the port
    also skips a file inside a ``.tmp_step_N`` directory (a checkpoint
    being written), which JAX copies; fsspec gives JAX's
    answer; an unknown protocol is False in both. Without the aws CLI the
    port's s3 sync returns False where JAX's raises FileNotFoundError."""
    import shutil

    src = tmp_path / "run"
    (src / "checkpoints" / "step_2").mkdir(parents=True)
    (src / "checkpoints" / "step_2" / "state.pt").write_bytes(b"x" * 10)
    (src / "checkpoints" / ".tmp_step_4").mkdir()
    (src / "checkpoints" / ".tmp_step_4" / "state.pt").write_bytes(b"y")
    (src / "latest.json").write_text("{}")
    (src / "metrics.csv").write_text("a,b\n")

    def tree(root):
        return {str(p.relative_to(root)): p.read_bytes() for p in root.rglob("*") if p.is_file()}

    in_flight = "checkpoints/.tmp_step_4/state.pt"
    for round_ in range(2):
        assert file_sync.remote_sync(str(src), str(tmp_path / "ours"), "local")
        assert jax_file_sync.remote_sync(str(src), str(tmp_path / "theirs"), "local")
        theirs = tree(tmp_path / "theirs")
        assert theirs.pop(in_flight) == b"y"  # JAX looks at the file's name alone
        assert tree(tmp_path / "ours") == theirs
        (src / "metrics.csv").write_text("a,b\n1,2\n")
    assert set(tree(tmp_path / "ours")) == {"checkpoints/step_2/state.pt", "metrics.csv"}
    assert file_sync.remote_sync(str(src), str(tmp_path / "f1"), "fsspec") == \
        jax_file_sync.remote_sync(str(src), str(tmp_path / "f2"), "fsspec")
    assert not file_sync.remote_sync(str(src), str(tmp_path / "u"), "ftp")
    assert not jax_file_sync.remote_sync(str(src), str(tmp_path / "u"), "ftp")
    if shutil.which("aws") is None:
        assert not file_sync.remote_sync(str(src), str(tmp_path / "s3"), "s3")
        with pytest.raises(FileNotFoundError):
            jax_file_sync.remote_sync(str(src), str(tmp_path / "s3"), "s3")


def test_sync_process_mirrors_in_the_background(tmp_path):
    import time

    src = tmp_path / "run"
    src.mkdir()
    (src / "a.txt").write_text("1")
    proc = file_sync.start_sync_process(0.2, str(src), str(tmp_path / "mirror"))
    assert proc.daemon and not proc.is_alive()
    proc.start()
    try:
        deadline = time.time() + 30
        while not (tmp_path / "mirror" / "a.txt").exists() and time.time() < deadline:
            time.sleep(0.1)
    finally:
        proc.terminate()
        proc.join()
    assert (tmp_path / "mirror" / "a.txt").read_text() == "1"
