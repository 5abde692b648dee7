"""The port's Trainer over a gloo group of 2 and 4 spawned CPU processes
(``Trainer(mesh=make_mesh(...))``), each rank on its rows of the global
batch, against the JAX single-device Trainer step on the global batch and
against the port's one-process Trainer on the same weights, batches and
draws.

Tolerances (f32, widened ViT-Test): the step's loss 1e-5 of JAX's
(``__graft_entry__.py``'s gate for the n-device step, ``augment=False``);
against the port's one-process step the loss 1e-5 and the flat gradient's
max abs difference 1e-5 x max|g| (the ranks sum the batch's gradient in
other orders); the ranks hold the same parameter, mu and nu bits after
every step. The spawned ranks import the port only.
"""
from __future__ import annotations

import tests.helpers.torch_threads  # noqa: F401  (xdist workers share the cores)

import numpy as np
import pytest
import torch

from spatial_clip_tpu_torch.parallel.launch import spawn
from tests.helpers import dist_ranks

WIDE = dict(vision_cfg=dict(width=128, heads=2), text_cfg=dict(width=128, heads=2))
LOSS = ("spatial", {"cap_logit_scale": 50.0, "temp_reg_weight": 0.1})
FUSED = ("spatial", {"cap_logit_scale": 50.0, "use_fused_kernel": True})
CFG = dict(learning_rate=1e-3, warmup_steps=2, total_steps=50, seed=0)


def _batch(seed, B=8, size=32, ctx=16, vocab=512, k=4):
    rng = np.random.default_rng(seed)
    ids = np.arange(B, dtype=np.int32)
    return {"images": rng.integers(0, 256, (B, size, size, 3), dtype=np.uint8),
            "texts": rng.integers(0, vocab, (B, ctx), dtype=np.int32),
            "image_tile_ids": ids, "text_tile_ids": ids.copy(),
            "neighbor_tile_ids": rng.integers(-1, B, (B, k)).astype(np.int32),
            "neighbor_alphas": rng.uniform(0, 1, (B, k)).astype(np.float32)}


BATCHES = [_batch(1), _batch(2)]
GENE_BATCHES = [{**b, "texts": np.random.default_rng(i).uniform(0, 1, (8, 300)).astype(
    np.float32)} for i, b in enumerate(BATCHES)]
SPECS = {
    "plain": dict(overrides=WIDE, loss=LOSS, cfg={**CFG, "augment": False}, batches=BATCHES),
    "augment": dict(overrides=WIDE, loss=LOSS, batches=BATCHES,
                    cfg={**CFG, "augment": True, "color_jitter": 0.2}),
    "cached": dict(overrides=WIDE, loss=FUSED, batches=BATCHES,
                   cfg={**CFG, "augment": True, "grad_accum": 2}),
    "simple": dict(overrides=WIDE, loss=LOSS, batches=BATCHES,
                   cfg={**CFG, "augment": False, "grad_accum": 2, "grad_accum_mode": "simple"}),
    "gene": dict(overrides={**WIDE, "gene_cfg": dict(num_genes=300, width=32, layers=1,
                                                     gene_dropout=0.5)},
                 loss=("clip", {}), batches=GENE_BATCHES, cfg={**CFG, "augment": True}),
}


def _regrouped(batch, world=2, accum=2):
    """The global batch with its rows in the order 2 ranks' simple
    microbatches score them: microbatch j holds every rank's j-th."""
    b = len(batch["images"]) // world
    mb = b // accum
    order = [r * b + j * mb + i for j in range(accum) for r in range(world) for i in range(mb)]
    return {k: v[order] for k, v in batch.items()}


FIT = dict(overrides=WIDE, loss=FUSED, batch_size=8, data=dict(num_samples=32, image_size=32),
           cfg={**CFG, "augment": True, "log_every": 1, "save_every_steps": 1, "keep_ckpts": 2})


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """JAX's widened ViT-Test (seed 0) converted to the port's names."""
    from spatial_clip_tpu import create_model as jax_create_model
    from spatial_clip_tpu_torch.models.convert import from_jax_params

    jb = jax_create_model("ViT-Test", precision="fp32", seed=0, **WIDE)
    path = tmp_path_factory.mktemp("weights") / "vit_test.pt"
    torch.save(from_jax_params(jb.params), path)
    return jb, str(path)


@pytest.fixture(scope="module")
def runs(weights, tmp_path_factory):
    """Each spec on 2 ranks (with fit) and on 4 (without), and on one
    process; the same weights everywhere."""
    specs = {k: {**v, "weights": weights[1]} if k != "gene" else v for k, v in SPECS.items()}
    out = {}
    for world, names in ((2, list(specs)), (4, ["plain", "augment"])):
        fit = None
        if world == 2:
            fit = {**FIT, "weights": weights[1], "cfg": {
                **FIT["cfg"], "ckpt_dir": str(tmp_path_factory.mktemp("ckpt2"))}}
        out[world] = spawn(dist_ranks.many_rank, world, ({n: specs[n] for n in names}, fit),
                           threads=1)
    out[1] = {n: dist_ranks.run_steps(s) for n, s in specs.items()}
    out[1]["simple_regrouped"] = dist_ranks.run_steps(
        {**specs["simple"], "batches": [_regrouped(b) for b in BATCHES]})
    out[1]["fit"] = dist_ranks.fit_rank(0, {**FIT, "weights": weights[1], "cfg": {
        **FIT["cfg"], "ckpt_dir": str(tmp_path_factory.mktemp("ckpt1"))}})
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_n_rank_step_loss_matches_the_jax_single_device_step(weights, runs, world):
    """One P-rank step (augment=False, the spatial loss with the STE cap and
    temp_reg) gives the JAX single-device Trainer step's loss on the global
    batch within 1e-5, its grad_norm within 1e-5 relative, its R@1."""
    import jax

    from spatial_clip_tpu.losses import make_loss as jax_make_loss
    from spatial_clip_tpu.parallel.mesh import make_mesh
    from spatial_clip_tpu.train.loop import Trainer as JaxTrainer
    from spatial_clip_tpu.train.loop import TrainerConfig as JaxTrainerConfig

    jt = JaxTrainer(weights[0], loss=jax_make_loss(LOSS[0], **LOSS[1]),
                    config=JaxTrainerConfig(**SPECS["plain"]["cfg"]),
                    mesh=make_mesh(devices=jax.devices()[:1]))
    _, m = jt.make_train_step()(jt.init_state(), jt._device_batch(BATCHES[0]))
    for rank in runs[world]:
        got = rank["plain"][0]
        assert abs(got["loss"] - float(m["loss"])) <= 1e-5, (got["loss"], float(m["loss"]))
        assert abs(got["grad_norm"] - float(m["grad_norm"])) <= 1e-5 * float(m["grad_norm"])
        assert got["R@1"] == float(m["R@1"])


@pytest.mark.parametrize("world,name", [(2, "plain"), (2, "augment"), (2, "cached"),
                                        (2, "gene"), (4, "plain"), (4, "augment")])
def test_n_rank_steps_match_the_one_process_steps(runs, world, name):
    """Two P-rank steps against the port's one-process steps on the global
    batches: the augmentation draws made for the global batch (each rank
    its rows), grad_accum=2 cached gathering each microbatch's features, a
    Gene-MLP tower's gene-dropout mask drawn for the global batch;
    loss within 1e-5, gradient max abs difference <= 1e-5 x max|g|, the
    same in-batch logits (the global batch's) within 1e-5, and every rank
    the same gradient and state bits."""
    want = runs[1][name]
    ranks = [r[name] for r in runs[world]]
    for step in range(len(BATCHES)):
        w = want[step]
        for r in ranks:
            got = r[step]
            assert abs(got["fb_loss"] - w["fb_loss"]) <= 1e-5
            assert abs(got["loss"] - w["loss"]) <= 1e-5
            assert np.abs(got["grads"] - w["grads"]).max() <= 1e-5 * np.abs(w["grads"]).max()
            np.testing.assert_allclose(got["logits"], w["logits"], rtol=0, atol=1e-5)
        assert len({r[step]["digest"] for r in ranks}) == 1
        assert all(np.array_equal(r[step]["grads"], ranks[0][step]["grads"]) for r in ranks)


def test_fit_evaluate_and_checkpoints_over_two_ranks(runs):
    """Trainer.fit over the synthetic datamodule on 2 ranks (each its rows of
    the global batches) logs the one-process run's per-step losses within
    1e-5, only on rank 0, and its evaluate gives the one-process metrics
    over the whole split; only rank 0 copies the state for a checkpoint,
    the newest 2 are kept, and a resume on every rank restores rank 0's
    final state bits."""
    one, ranks = runs[1]["fit"], [r["fit"] for r in runs[2]]
    assert ranks[1]["logged"] == [] and ranks[1]["copies"] == []
    want = [(s, m["train/loss"]) for s, m in one["logged"] if "train/loss" in m]
    got = [(s, m["train/loss"]) for s, m in ranks[0]["logged"] if "train/loss" in m]
    assert [s for s, _ in got] == [s for s, _ in want] == [1, 2, 3, 4]
    assert max(abs(g - w) for (_, g), (_, w) in zip(got, want)) <= 1e-5
    for k, v in one["last"].items():
        if k.startswith("val/"):
            assert abs(ranks[0]["last"][k] - v) <= 1e-5 * max(1.0, abs(v)), k
    assert ranks[0]["last"]["val/num_samples"] == one["last"]["val/num_samples"]
    assert ranks[0]["copies"] == one["copies"]
    assert ranks[0]["steps_on_disk"] == ["step_3", "step_4"]
    assert ranks[0]["digest"] == ranks[1]["digest"]
    assert all(r["resumed_digest"] == r["digest"] and r["resumed_step"] == 4 for r in ranks)


def test_simple_grad_accum_scores_the_ranks_jth_microbatches_together(runs):
    """Under grad_accum_mode='simple' on 2 ranks, microbatch j's loss scores
    every rank's j-th microbatch together: the steps give the one-process
    steps on the global batches with their rows so regrouped (loss within
    1e-5, gradient max abs difference <= 1e-5 x max|g|, the last
    microbatch's logits within 1e-5), and not the one-process steps on the
    batches as they are, whose microbatches pair other rows (ROADMAP
    Queue 3)."""
    regrouped, as_is = runs[1]["simple_regrouped"], runs[1]["simple"]
    for rank in runs[2]:
        for got, w, other in zip(rank["simple"], regrouped, as_is):
            assert abs(got["fb_loss"] - w["fb_loss"]) <= 1e-5
            assert abs(got["loss"] - w["loss"]) <= 1e-5
            assert np.abs(got["grads"] - w["grads"]).max() <= 1e-5 * np.abs(w["grads"]).max()
            np.testing.assert_allclose(got["logits"], w["logits"], rtol=0, atol=1e-5)
            assert abs(got["fb_loss"] - other["fb_loss"]) > 1e-3
