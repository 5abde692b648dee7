"""The port's open_clip-style CLIs and the modules only they reach, against
the JAX package's on the same inputs (``cli.embed`` and the data and sync
modules: ``test_torch_port_cli_data.py``):

- ``cli.main_train``: ``parse_args`` (every flag and default), the dataset
  type it detects, and the Trainer configuration and loss it builds for the
  same argv; a whole run on the CPU (``--device cpu``) with its checkpoint,
  ``results.json`` (the keys JAX's run writes) and the mirrored run
  directory; the refusals;
- ``cli.sweep`` (a grid, and a failed trial recorded as JAX records it) and
  ``cli.test_datamodule`` (the same first batch as JAX's);
- without a GPU and without ``--device cpu`` (``trainer.platform=cpu``)
  each CLI raises.

ViT-Test as it is (heads of 16: JAX's einsum route, and the port's), fp32.
"""
from __future__ import annotations

import tests.helpers.torch_threads  # noqa: F401  (xdist workers share the cores)

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from spatial_clip_tpu.cli import main_train as jax_main_train  # noqa: E402
from spatial_clip_tpu.cli import sweep as jax_sweep  # noqa: E402
from spatial_clip_tpu.cli import test_datamodule as jax_test_datamodule  # noqa: E402
from spatial_clip_tpu_torch.cli import embed, main_train, sweep, test_datamodule  # noqa: E402

TINY = ["--model", "ViT-Test", "--precision", "fp32", "--dataset-type", "synthetic",
        "--synthetic-num-samples", "32", "--synthetic-image-size", "32", "--batch-size", "8",
        "--epochs", "1", "--workers", "0", "--log-every-n-steps", "1"]


# ----------------------------------------------------------------- main_train

ARGVS = [
    [],
    ["--model", "RN50", "--lr", "1e-3"],
    ["--spatial-data-dir", "/data/hest", "--use-spatial-loss", "--logit-scale-cap", "50"],
    ["--siglip", "--loss-dist-impl", "bidir", "--opt", "lion", "--beta2", "0.99"],
    ["--opt", "sgd", "--momentum", "0.7", "--grad-checkpointing", "--accum-freq", "2",
     "--accum-mode", "simple", "--skip-scheduler"],
    ["--lock-image", "--lock-image-unlocked-groups", "2", "--lock-text",
     "--lock-text-unlocked-layers", "1", "--lock-text-freeze-layer-norm"],
    ["--distill-model", "ViT-L-14", "--distill-pretrained", "x.pt", "--torchcompile",
     "--use-bnb-linear", "--dist-url", "env://", "--report-to", "csv"],
    ["--train-data", "a::2 b::1", "--dataset-resampled", "--csv-separator", ",",
     "--lr-scheduler", "const-cooldown", "--epochs-cooldown", "2", "--remote-sync", "/m",
     "--remote-sync-protocol", "s3", "--imagenet-val", "/iv", "--zeroshot-templates", "simple"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a)[:40] or "defaults")
def test_parse_args_matches_jax(argv):
    """Every flag, default and implication (the model's optimizer defaults,
    ``--spatial-data-dir``, the ``--logit-scale-cap`` alias) as JAX parses
    it; only ``--device`` differs (JAX's is a no-op, None by default; the
    port's says where the run goes, cuda by default)."""
    ours, theirs = vars(main_train.parse_args(argv)), vars(jax_main_train.parse_args(argv))
    assert ours.pop("device") == "cuda" and theirs.pop("device") is None
    assert ours == theirs


def test_detect_dataset_type_matches_jax(tmp_path):
    (tmp_path / "pq" / "train").mkdir(parents=True)
    (tmp_path / "pq" / "train" / "nodes.parquet").write_bytes(b"")
    (tmp_path / "tars" / "s1").mkdir(parents=True)
    (tmp_path / "tars" / "s1" / "shard-0.tar").write_bytes(b"")
    (tmp_path / "empty").mkdir()
    cases = [[], ["--dataset-type", "csv"], ["--train-data", "a::2 b::1"],
             ["--train-data", str(tmp_path / "x.csv")], ["--train-data", str(tmp_path / "x.tsv")],
             ["--train-data", str(tmp_path / "pq")], ["--train-data", str(tmp_path / "tars")],
             ["--train-data", str(tmp_path / "empty")]]
    got = [main_train._detect_dataset_type(main_train.parse_args(a)) for a in cases]
    want = [jax_main_train._detect_dataset_type(jax_main_train.parse_args(a)) for a in cases]
    assert got == want == ["synthetic", "csv", "shards", "csv", "csv", "parquet", "shards",
                           "synthetic"]


class _Built(Exception):
    pass


def _trainer_args(monkeypatch, module, main, argv):
    """(config, loss, teacher) that ``main(argv)`` hands to its Trainer."""
    got = {}

    def capture(model, loss=None, config=None, mesh=None, teacher=None):
        got.update(config=config, loss=loss, teacher=teacher)
        raise _Built

    monkeypatch.setattr(module, "Trainer", capture)
    with pytest.raises(_Built):
        main(argv)
    return got


BUILD_ARGVS = [
    [],
    ["--use-spatial-loss", "--cap-logit-scale", "50", "--use-fused-kernel",
     "--temp-reg-weight", "0.1"],
    ["--siglip", "--opt", "lion", "--wd", "0.1"],
    ["--opt", "sgd", "--momentum", "0.7", "--skip-scheduler", "--accum-freq", "2",
     "--accum-mode", "simple", "--delete-previous-checkpoint"],
    ["--lock-image-tower", "--lock-image-unlocked-groups", "1", "--lock-text-tower",
     "--lr-scheduler", "const-cooldown", "--epochs-cooldown", "1", "--warmup", "2"],
    ["--distill-model", "ViT-Test", "--grad-clip-norm", "1.0"],
    ["--model", "coca_ViT-Test"],  # JAX's selection never picks the coca loss: clip
]


@pytest.mark.parametrize("argv", BUILD_ARGVS, ids=lambda a: " ".join(a)[:40] or "defaults")
def test_main_train_builds_jax_trainer_config_and_loss(tmp_path, monkeypatch, argv):
    """For the same argv the port's TrainerConfig has JAX's value in every
    field both have (the checkpoint directory under each run's logs), the
    loss is the same kind with the same options, and a teacher comes with
    ``--distill-model``."""
    import spatial_clip_tpu.train.loop as jax_loop
    import spatial_clip_tpu_torch.train.loop as loop

    common = [*TINY, "--name", "run", *argv]
    ours = _trainer_args(monkeypatch, loop, main_train.main,
                         [*common, "--device", "cpu", "--logs", str(tmp_path / "port")])
    theirs = _trainer_args(monkeypatch, jax_loop, jax_main_train.main,
                           [*common, "--logs", str(tmp_path / "jax")])
    want = dataclasses.asdict(theirs["config"])
    got = dataclasses.asdict(ours["config"])
    for key in ("ckpt_dir",):
        assert Path(got.pop(key)).relative_to(tmp_path / "port") == \
            Path(want.pop(key)).relative_to(tmp_path / "jax")
    shared = {k: v for k, v in want.items() if k in got}
    assert {k: got[k] for k in shared} == shared
    assert set(want) - set(got) == {"compiler_options", "scan_steps"}
    assert (ours["loss"].name, ours["loss"].options) == (theirs["loss"].name,
                                                         theirs["loss"].options)
    assert (ours["teacher"] is None) == (theirs["teacher"] is None)
    if ours["teacher"] is not None:
        assert not ours["teacher"].training


def test_main_train_runs_on_the_cpu_and_mirrors_the_run(tmp_path):
    """A whole run (spatial loss, Lion, the image tower locked, remat, the
    local mirror): a checkpoint, results.json with the keys JAX's run
    writes (and finite values), the mirror holding the run directory, the
    locked tower's parameters the same bits in the checkpoint as at init,
    and the codebase copied."""
    from spatial_clip_tpu_torch.train.checkpoints import state_file_params

    argv = [*TINY, "--name", "run", "--use-spatial-loss", "--opt", "lion", "--lock-image-tower",
            "--grad-checkpointing", "--copy-codebase", "--remote-sync", str(tmp_path / "mirror"),
            "--remote-sync-frequency", "1"]
    metrics = main_train.main([*argv, "--device", "cpu", "--logs", str(tmp_path / "port")])
    jax_main_train.main([*argv[:-5], "--logs", str(tmp_path / "jax")])
    run = tmp_path / "port" / "run"
    ours = json.loads((run / "results.json").read_text())
    theirs = json.loads((tmp_path / "jax" / "run" / "results.json").read_text())
    assert set(ours) == set(theirs) and ours == json.loads(json.dumps(metrics, default=float))
    assert all(np.isfinite(v) for v in ours.values())
    assert sorted(p.name for p in (run / "checkpoints").iterdir()) == ["step_4"]
    mirror = tmp_path / "mirror" / "run"
    assert {p.relative_to(mirror) for p in mirror.rglob("*") if p.is_file()} == {
        p.relative_to(run) for p in run.rglob("*") if p.is_file()}
    assert (run / "code" / "spatial_clip_tpu_torch" / "cli" / "main_train.py").is_file()
    trained = state_file_params(run / "checkpoints" / "step_4")
    from spatial_clip_tpu_torch import create_model

    init = dict(create_model("ViT-Test", precision="fp32", device="cpu", seed=0,
                             training=True).named_parameters())
    for k, v in trained.items():
        assert torch.equal(v, init[k].detach()) == k.startswith("visual."), k


@pytest.mark.parametrize("argv,what", [
    (["--force-patch-dropout", "0.5"], "item 6"),
    (["--scan-steps", "4"], "item 11"),
])
def test_main_train_refusals_name_their_roadmap_item(tmp_path, argv, what):
    with pytest.raises(NotImplementedError, match=what):
        main_train.main([*TINY, *argv, "--device", "cpu", "--logs", str(tmp_path)])


# --------------------------------------------------- sweep, test_datamodule

def test_sweep_runs_a_grid_and_records_a_failed_trial_as_jax_does(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    base = ["experiment=smoke_synthetic", f"paths.root_dir={tmp_path}"]
    summary = sweep.main(["--device", "cpu", "--mode", "grid", "--param",
                          "optimizer.learning_rate=choice:0.001,0.0001", "--out",
                          str(tmp_path / "grid.json"), "--", *base])
    assert [r["trial"] for r in summary["results"]] == [0, 1]
    assert all(np.isfinite(r["value"]) for r in summary["results"])
    assert summary["best"] == min(summary["results"], key=lambda r: r["value"])
    assert json.loads((tmp_path / "grid.json").read_text())["best"]["trial"] == summary[
        "best"]["trial"]
    bad = ["--mode", "grid", "--param", "optimizer.learning_rate=choice:abc"]
    ours = sweep.main(["--device", "cpu", *bad, "--out", str(tmp_path / "a.json"), "--",
                       *base])
    theirs = jax_sweep.main([*bad, "--out", str(tmp_path / "b.json"), "--", *base,
                             "trainer.platform=cpu"])
    assert ours == theirs
    assert ours["best"] is None and "abc" in ours["results"][0]["error"]


def test_sweep_tpe_and_random_draw_the_jax_candidates():
    """The search-space helpers are JAX's, draw for draw."""
    specs = ["a=loguniform:1e-5,1e-2", "b=choice:0.0,0.1,x", "c=uniform:-1,1"]
    space = dict(sweep._parse_space(s) for s in specs)
    assert space == dict(jax_sweep._parse_space(s) for s in specs)
    history = [{"params": sweep._sample(space, np.random.default_rng(i)), "value": float(i)}
               for i in range(6)]
    for fn in ("_sample", "_tpe_sample"):
        args = (space,) if fn == "_sample" else (space, history)
        kw = {} if fn == "_sample" else {"direction": "minimize"}
        assert getattr(sweep, fn)(*args, rng=np.random.default_rng(9), **kw) == getattr(
            jax_sweep, fn)(*args, rng=np.random.default_rng(9), **kw)


def test_test_datamodule_takes_the_batch_jax_takes():
    argv = ["experiment=smoke_synthetic", "trainer.platform=cpu"]
    ours, theirs = test_datamodule.main(argv), jax_test_datamodule.main(argv)
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(ours[k], v, err_msg=k)


@pytest.mark.parametrize("cli", ["main_train", "embed", "sweep", "test_datamodule"])
def test_clis_raise_without_a_gpu(tmp_path, monkeypatch, cli):
    """No GPU (as here, or hidden) and no ``--device cpu`` /
    ``trainer.platform=cpu``: each CLI raises before it builds anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"main_train": [*TINY, "--logs", str(tmp_path)],
            "embed": ["--model", "ViT-Test", "--data", str(tmp_path), "--dataset-type",
                      "synthetic", "--out", str(tmp_path / "e.npz")],
            "sweep": ["--out", str(tmp_path / "s.json"), "--", "experiment=smoke_synthetic"],
            "test_datamodule": ["experiment=smoke_synthetic"]}[cli]
    module = {"main_train": main_train, "embed": embed, "sweep": sweep,
              "test_datamodule": test_datamodule}[cli]
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        module.main(argv)
    assert not list(tmp_path.iterdir())
