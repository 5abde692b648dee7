"""The entry points over a process group: ``.train trainer=ddp_sim`` (spawned
gloo ranks on the CPU) against the one-process run, ``cli.main_train``'s
run name broadcast from rank 0, the keys that still raise, and the batch
meaning of the rank-aware loader against the JAX package's multi-host
loader. The spawned ranks import the port only.
"""
from __future__ import annotations

import tests.helpers.torch_threads  # noqa: F401  (xdist workers share the cores)

import csv

import numpy as np
import pytest
import torch

from spatial_clip_tpu_torch.parallel.launch import spawn
from spatial_clip_tpu_torch.train import entry
from tests.helpers import dist_ranks

# the host transform's random crop always takes the whole 32 px tile: the
# experiment's loader has no workers, so the ranks take the one-process
# run's crops (test_ranks_take_the_one_process_runs_random_crops); the runs
# are compared where the crop draws cannot move the pixels all the same
WHOLE_CROP = "model.aug_cfg={scale:[1.0,1.0],ratio:[1.0,1.0]}"


def _train(tmp_path, *overrides):
    cfg = entry.compose_train(["experiment=smoke_synthetic", "trainer.platform=cpu", WHOLE_CROP,
                               f"paths.root_dir={tmp_path}", "save_ckpt=true", *overrides])
    value, objects = entry.train(cfg)
    with open(objects["output_dir"] / "metrics.csv") as f:
        rows = [r for r in csv.DictReader(f) if r.get("train/loss")]
    return objects, [(int(r["step"]), float(r["train/loss"])) for r in rows]


def test_ddp_sim_gives_the_one_process_runs_losses(tmp_path):
    """``.train experiment=smoke_synthetic trainer=ddp_sim
    trainer.sim_devices=2`` (global batch 16 = 2 x 8 on two spawned gloo
    ranks) logs the one-process run's per-step losses within 1e-5 (rank 0
    alone writes metrics.csv), its validation metrics within 1e-5, ends on
    its parameters within 1e-5, and writes the checkpoints once; ``.eval``
    under trainer=ddp_sim runs in one process on them."""
    from spatial_clip_tpu_torch import eval as port_eval
    from spatial_clip_tpu_torch.config import compose

    sim, sim_losses = _train(tmp_path / "sim", "trainer=ddp_sim", "trainer.sim_devices=2")
    one, one_losses = _train(tmp_path / "one")
    assert sim["world_size"] == 2 and sim["rank"] == 0
    assert [s for s, _ in sim_losses] == [s for s, _ in one_losses] == [1, 2, 3, 4]
    assert max(abs(a - b) for (_, a), (_, b) in zip(sim_losses, one_losses)) <= 1e-5
    for k, v in one["metrics"].items():
        if k.startswith("val/"):
            assert abs(sim["metrics"][k] - v) <= 1e-5 * max(1.0, abs(v)), k
    one_params = one["state"].flat["params"]
    assert float((sim["params"] - one_params).abs().max()) <= 1e-5
    ckpts = sim["output_dir"] / "checkpoints"
    assert sorted(p.name for p in ckpts.iterdir()) == sorted(
        p.name for p in (one["output_dir"] / "checkpoints").iterdir())
    metrics = port_eval.evaluate(compose(entry.CONFIG_DIR, "eval", [
        "experiment=smoke_synthetic", "trainer=ddp_sim", f"paths.root_dir={tmp_path / 'eval'}",
        f"ckpt_path={ckpts}"]))
    assert abs(metrics["test/loss"] - sim["metrics"]["test/loss"]) <= 1e-5


def test_ranks_take_the_one_process_runs_random_crops():
    """Two gloo ranks' loaders at num_workers 0, under the host transform's
    random resized crop, give rows [r b, (r + 1) b) of the one-process
    run's image batches bit for bit over two epochs (each rank skips the
    other's rows through the dataset's ``skip_item``); the crops do move the
    pixels from batch to batch."""
    ranks = spawn(dist_ranks.crop_rank, 2, (2,), threads=1)
    one = dist_ranks.crop_batches(epochs=2)
    assert len(one) == 6 and [len(r) for r in ranks] == [6, 6]
    for r, got in enumerate(ranks):
        for g, want in zip(got, one):
            assert g.shape == (4, 32, 32, 3) and np.array_equal(g, dist_ranks.rows(want, r, 2))
    first = [dist_ranks.crop_batches(epochs=1)[0] for _ in range(2)]
    assert np.array_equal(first[0], first[1]) and not np.array_equal(one[0], one[3])


def test_process_workers_draw_streams_by_rank():
    """A process worker's transform stream: seed_base + worker id at rank 0
    (the one-process run's), another stream at each later rank of a group."""
    import multiprocessing

    from spatial_clip_tpu_torch.data import datamodule
    from spatial_clip_tpu_torch.models.transforms import image_transform

    class Item:
        def __init__(self):
            self.preprocess_fn = image_transform(32, is_train=True, seed=0)

    draws = []
    for rank in (0, 1, 2):
        item = Item()
        datamodule._init_worker_dataset(item, multiprocessing.Value("i", 0), 11, rank)
        draws.append(item.preprocess_fn.rng.integers(1 << 30, size=4))
    assert np.array_equal(draws[0], np.random.default_rng(11).integers(1 << 30, size=4))
    assert not np.array_equal(draws[0], draws[1]) and not np.array_equal(draws[1], draws[2])


def test_main_train_takes_rank_zeros_run_name(tmp_path):
    """``cli.main_train`` on two ranks whose clocks disagree by a day makes
    one run directory, rank 0's (its name broadcast), where both ranks
    train; ``maybe_init_distributed`` finds the group up."""
    from tests.test_torch_port_cli import TINY

    argv = [*TINY, "--device", "cpu", "--logs", str(tmp_path)]
    ranks = spawn(dist_ranks.main_train_rank, 2, (argv,), threads=1)
    assert ranks[0]["runs"] == ranks[1]["runs"] and len(ranks[0]["runs"]) == 1
    assert ranks[0]["loss"] == ranks[1]["loss"]
    assert all(r["joined"] for r in ranks)
    run = tmp_path / ranks[0]["runs"][0]
    assert (run / "results.json").is_file() and (run / "checkpoints").is_dir()


@pytest.mark.parametrize("override,error,match", [
    ("trainer.platform=tpu", NotImplementedError, "trainer.platform.*item 7"),
    ("trainer.multihost=true", NotImplementedError, "trainer.multihost.*item 7"),
    ("trainer.platform=gpu", ValueError, "sim_devices.*platform=cpu"),
])
def test_keys_that_still_raise_name_their_item(tmp_path, override, error, match):
    """trainer.platform other than cpu / gpu / cuda and trainer.multihost
    raise, naming ROADMAP Queue 1 item 7; sim_devices simulates ranks on
    the CPU only."""
    cfg = entry.compose_train(["experiment=smoke_synthetic", "trainer=ddp_sim",
                               f"paths.root_dir={tmp_path}", override])
    with pytest.raises(error, match=match):
        entry.train(cfg)


def test_trainer_mesh_takes_the_model_on_its_device():
    from spatial_clip_tpu_torch import create_model
    from spatial_clip_tpu_torch.parallel.mesh import make_mesh
    from spatial_clip_tpu_torch.train.loop import Trainer

    model = create_model("ViT-Test", precision="fp32", device="cpu", training=True)
    with pytest.raises(ValueError, match="mesh's device"):
        Trainer(model, mesh=make_mesh(device="meta"))
    trainer = Trainer(model, mesh=make_mesh(device="cpu"))
    assert (trainer.group, trainer.rank, trainer.world) == (None, 0, 1)


def test_mesh_names_the_current_card_for_a_bare_cuda_device(monkeypatch):
    """``make_mesh(device='cuda')`` names ``cuda:{current card}``, the device a
    model's tensors report, so the trainer's device check takes it."""
    from spatial_clip_tpu_torch.parallel.mesh import make_mesh

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert make_mesh(device="cuda").device == torch.device("cuda", 3)
    assert make_mesh(device=torch.device("cuda")).device == torch.device("cuda", 3)
    assert make_mesh(device="cuda:1").device == torch.device("cuda", 1)
    assert make_mesh(device="cpu").device == torch.device("cpu")


def test_loader_batch_meaning_differs_from_jax_multihost(monkeypatch):
    """Difference pinned (ROADMAP Queue 3): the port's ``batch_size`` is the
    global batch, and rank r takes rows [r b, (r + 1) b) of each, so the
    ranks together see the one-process batches; JAX's multi-host loader
    gives each process ``batch_size`` rows of its strided share
    ``idx[pi::pc]``, a global batch of pc x batch_size other rows."""
    import jax

    from spatial_clip_tpu.data import datamodule as jax_dm
    from spatial_clip_tpu.data.datasets.synthetic import SyntheticSpatialDataset as JaxSynthetic
    from spatial_clip_tpu_torch.data import datamodule
    from spatial_clip_tpu_torch.data.datasets.synthetic import SyntheticSpatialDataset

    def ids(loader):
        return [b["image_tile_ids"] for b in loader]

    ours = SyntheticSpatialDataset(num_samples=32, image_size=4, k_neighbors=2)
    whole = ids(datamodule.DataLoader(ours, batch_size=8, shuffle=True, seed=3))
    port = [ids(datamodule.DataLoader(ours, batch_size=8, shuffle=True, seed=3, rank=r,
                                      world_size=2)) for r in (0, 1)]
    theirs = JaxSynthetic(num_samples=32, image_size=4, k_neighbors=2)
    jax_ranks = []
    for r in (0, 1):
        monkeypatch.setattr(jax, "process_count", lambda: 2)
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        jax_ranks.append(ids(jax_dm.DataLoader(theirs, batch_size=8, shuffle=True, seed=3)))
    assert [len(p) for p in port] == [4, 4] and [len(j) for j in jax_ranks] == [2, 2]
    for i, w in enumerate(whole):
        np.testing.assert_array_equal(np.concatenate([port[0][i], port[1][i]]), w)
    assert all(len(b) == 4 for p in port for b in p)
    assert all(len(b) == 8 for j in jax_ranks for b in j)
    perm = np.concatenate(whole)
    np.testing.assert_array_equal(np.concatenate(jax_ranks[0]), perm[0::2])
    assert not np.array_equal(np.concatenate([jax_ranks[0][0], jax_ranks[1][0]]),
                              np.concatenate(whole[:2]))
