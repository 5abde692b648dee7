"""The port's distributed losses and collectives over a gloo group of 2 and 4
spawned CPU processes, against the JAX package's global formulation on the
same numpy inputs (the properties ``__graft_entry__.py`` pins for JAX's
mesh): each rank holds its rows of the global batch, and the loss it
returns must be the global loss, the same on every rank; its gradients,
summed over the ranks' losses and averaged as data parallelism averages
them, must be the global loss's.

Tolerances (f32): the clip, spatial (dense and fused), ring and distill
losses 1e-5 (values), SigLIP 1e-4 x max(1, |want|); the gradients
1e-5 x max|g| + 1e-7 (SigLIP 1e-4 x max|g|). The spawned ranks import the
port only; JAX is imported inside the tests.
"""
from __future__ import annotations

import tests.helpers.torch_threads  # noqa: F401  (xdist workers share the cores)

import io
import tarfile

import numpy as np
import pytest
import torch

from spatial_clip_tpu_torch.parallel.launch import spawn
from tests.helpers import dist_ranks

B, D, K = 8, 16, 3
WORLDS = (2, 4)
SIGLIP_IMPLS = ("gather", "reduce", "shift", "bidir")
CASES = [
    ("clip", "clip", {}),
    ("spatial", "spatial", {"cap_logit_scale": 50.0, "temp_reg_weight": 0.1}),
    ("spatial_fused", "spatial", {"cap_logit_scale": 50.0, "use_fused_kernel": True}),
    ("distill", "distill", {}),
    ("ring", "spatial_ring", {"cap_logit_scale": 50.0}),
    *[(f"siglip_{impl}", "siglip", {"dist_impl": impl}) for impl in SIGLIP_IMPLS],
    ("coca", "coca", {"caption_loss_weight": 2.0}),
]


def _unit(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _inputs():
    rng = np.random.default_rng(0)
    ids = (np.arange(B) + 100).astype(np.int32)  # unique: the ring and fused paths need it
    return {
        "img": _unit(rng, (B, D)), "txt": _unit(rng, (B, D)),
        "dist_image_features": _unit(rng, (B, D)), "dist_text_features": _unit(rng, (B, D)),
        "image_tile_ids": ids, "text_tile_ids": ids.copy(),
        "neighbor_tile_ids": rng.integers(99, 100 + B, (B, K)).astype(np.int32),  # 99: padding
        "neighbor_alphas": rng.uniform(0, 1, (B, K)).astype(np.float32),
        "scale": np.float32(10.0), "dist_scale": np.float32(7.0), "bias": np.float32(-10.0),
        "weights": rng.normal(size=(B, D)).astype(np.float32),
        # CoCa's caption logits over a vocab of 7; row i ends in i % 4 pads, so
        # the ranks hold different counts of labels
        "caption_logits": rng.normal(size=(B, 5, 7)).astype(np.float32),
        "caption_labels": np.array([[int(v) if j < 5 - i % 4 else 0 for j, v in enumerate(row)]
                                    for i, row in enumerate(rng.integers(1, 7, (B, 5)))]),
    }


INPUTS = _inputs()
INPUTS["neighbor_tile_ids"][INPUTS["neighbor_tile_ids"] == 99] = -1


@pytest.fixture(scope="module")
def ranks():
    """Every rank's results, one spawned group per world size."""
    cache = {}

    def get(world):
        if world not in cache:
            cache[world] = spawn(dist_ranks.loss_rank, world, (CASES, INPUTS), threads=1)
        return cache[world]

    return get


def _jax_global(name, kind, opts):
    """The JAX package's loss on the global batch (axis_name=None): the value,
    the extras, and the gradients of the features, the scale, the bias and
    the caption logits (zero where the kind does not take them)."""
    import jax
    import jax.numpy as jnp

    from spatial_clip_tpu.losses import make_loss as jax_make_loss

    loss = jax_make_loss("spatial" if kind == "spatial_ring" else kind, **opts)
    fixed = {k: jnp.asarray(INPUTS[k]) for k in (
        "image_tile_ids", "text_tile_ids", "neighbor_tile_ids", "neighbor_alphas",
        "dist_image_features", "dist_text_features")}
    fixed["dist_logit_scale"] = jnp.float32(INPUTS["dist_scale"])

    def f(img, txt, scale, bias, cap):
        kw = {**fixed, "image_features": img, "text_features": txt, "logit_scale": scale}
        if kind == "siglip":
            kw["logit_bias"] = bias
        if kind == "coca":
            kw.update(caption_logits=cap, caption_labels=jnp.asarray(INPUTS["caption_labels"]))
        out = loss(**kw)
        return out["contrastive_loss"], out

    (value, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        jnp.asarray(INPUTS["img"]), jnp.asarray(INPUTS["txt"]), jnp.float32(INPUTS["scale"]),
        jnp.float32(INPUTS["bias"]), jnp.asarray(INPUTS["caption_logits"]))
    extras = {k: float(v) for k, v in out.items() if k != "contrastive_loss"}
    return float(value), extras, [np.asarray(g) for g in grads]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name,kind,opts", CASES, ids=[c[0] for c in CASES])
def test_distributed_loss_is_the_global_loss(ranks, world, name, kind, opts):
    """Every rank returns JAX's global loss; the ranks' gradients, averaged
    (the features' concatenated over the ranks), are its gradients. The
    ring loss is held to JAX's dense spatial loss (unique tile ids), the
    fused path to JAX's fused path. The coca loss's caption term is the
    global batch's token mean (the ranks hold different counts of labels),
    as JAX computes it on the global arrays."""
    results = [r[name] for r in ranks(world)]
    want, want_extras, (g_img, g_txt, g_scale, g_bias, g_cap) = _jax_global(name, kind, opts)
    siglip = kind == "siglip"
    tol = 1e-4 * max(1.0, abs(want)) if siglip else 1e-5
    for r in results:
        assert abs(r["loss"] - want) <= tol, (r["loss"], want)
        for k, v in want_extras.items():
            assert abs(r["extras"][k] - v) <= tol, (k, r["extras"][k], v)
    assert len({r["loss"] for r in results}) == 1  # the same bits on every rank
    got_img = np.concatenate([r["img"] for r in results]) / world
    got_txt = np.concatenate([r["txt"] for r in results]) / world
    for got, w in ((got_img, g_img), (got_txt, g_txt)):
        atol = (1e-4 if siglip else 1e-5) * np.abs(w).max() + 1e-7
        np.testing.assert_allclose(got, w, rtol=0, atol=atol)
    scale = np.mean([r["scale"] for r in results])
    assert abs(scale - float(g_scale)) <= (1e-4 if siglip else 1e-5) * max(1.0, abs(float(g_scale)))
    if siglip:
        bias = np.mean([r["bias"] for r in results])
        assert abs(bias - float(g_bias)) <= 1e-4 * max(1.0, abs(float(g_bias)))
    if kind == "coca":
        got_cap = np.concatenate([r["cap"] for r in results]) / world
        np.testing.assert_allclose(got_cap, g_cap, rtol=0, atol=1e-5 * np.abs(g_cap).max() + 1e-7)


@pytest.mark.parametrize("world", WORLDS)
def test_gather_features_values_and_gradients(ranks, world):
    """gather_features returns the global matrices on every rank; the
    gradient of a rank's rows is the sum over the ranks' losses (here each
    rank's loss reads every row, so world x its weights)."""
    w = INPUTS["weights"]
    for rank, r in enumerate(ranks(world)):
        g = r["gather"]
        np.testing.assert_array_equal(g["img"], INPUTS["img"])
        np.testing.assert_array_equal(g["txt"], INPUTS["txt"])
        mine = dist_ranks.rows(w, rank, world)
        np.testing.assert_allclose(g["img_grad"], world * mine, rtol=1e-6)
        np.testing.assert_allclose(g["txt_grad"], 2 * world * mine, rtol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_object_collectives_and_mesh_helpers(ranks, world):
    """broadcast_object gives rank 0's object everywhere, all_gather_object
    every rank's in rank order; the mesh names the rank and the group's
    size, local_batch_size divides the global batch (and raises where it
    does not divide), process_shard_indices gives contiguous ranges."""
    results = ranks(world)
    for rank, r in enumerate(results):
        assert r["objects"]["broadcast"] == {"name": "run-of-rank-0"}
        assert r["objects"]["all_gather"] == [("rank", q, "x" * q) for q in range(world)]
        m = r["mesh"]
        assert (m["rank"], m["size"], m["shape"], m["local"]) == (rank, world, {"data": world}, 8)
        assert "not divisible" in m["indivisible"]
    shards = [r["mesh"]["shard"] for r in results]
    assert shards[0][0] == 0 and shards[-1][1] == 10
    assert all(a[1] == b[0] for a, b in zip(shards, shards[1:]))


def test_one_process_ring_loss_matches_jax():
    """make_loss('spatial_ring') no longer raises; without a group it is
    JAX's single-block ring loss (values and gradients, 1e-5)."""
    import jax
    import jax.numpy as jnp

    from spatial_clip_tpu.losses import make_loss as jax_make_loss
    from spatial_clip_tpu_torch.losses import make_loss

    keys = ("image_tile_ids", "text_tile_ids", "neighbor_tile_ids", "neighbor_alphas")
    jl = jax_make_loss("spatial_ring", cap_logit_scale=50.0)

    def f(img, txt, s):
        return jl(image_features=img, text_features=txt, logit_scale=s,
                  **{k: jnp.asarray(INPUTS[k]) for k in keys})["contrastive_loss"]

    want, (gi, gt, gs) = jax.value_and_grad(f, argnums=(0, 1, 2))(
        jnp.asarray(INPUTS["img"]), jnp.asarray(INPUTS["txt"]), jnp.float32(10.0))
    img = torch.tensor(INPUTS["img"], requires_grad=True)
    txt = torch.tensor(INPUTS["txt"], requires_grad=True)
    s = torch.tensor(10.0, requires_grad=True)
    got = make_loss("ring", cap_logit_scale=50.0)(
        image_features=img, text_features=txt, logit_scale=s,
        **{k: torch.tensor(INPUTS[k]) for k in keys})["contrastive_loss"]
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= 1e-5
    np.testing.assert_allclose(img.grad.numpy(), np.asarray(gi), atol=1e-6)
    np.testing.assert_allclose(txt.grad.numpy(), np.asarray(gt), atol=1e-6)
    assert abs(float(s.grad) - float(gs)) <= 1e-5


def test_unported_mesh_axes_raise():
    """A model axis (dp x tp) and the hybrid mesh's replica axis name ROADMAP
    Queue 1 item 7; the backend is the caller's and must be one of two."""
    from spatial_clip_tpu_torch.parallel.mesh import make_mesh, maybe_init_distributed

    for axes, sizes in ((("data", "model"), (1, 2)), (("replica", "data"), (2, 1))):
        with pytest.raises(NotImplementedError, match="item 7"):
            make_mesh(axes, sizes, device="cpu")
    mesh = make_mesh(device="cpu")  # no group: this process alone
    assert (mesh.group, mesh.rank, mesh.size, mesh.shape) == (None, 0, 1, {"data": 1})
    assert maybe_init_distributed("gloo") is False  # one process: nothing to join
    with pytest.raises(ValueError, match="backend"):
        maybe_init_distributed("mpi")


# ----------------------------------------------------------- iterable shards

def _tar(path, members):
    with tarfile.open(path, "w") as tf:
        for name, payload in members:
            info = tarfile.TarInfo(name)
            info.size = len(payload)
            tf.addfile(info, io.BytesIO(payload))


def _npy(a):
    buf = io.BytesIO()
    np.save(buf, a)
    return buf.getvalue()


def _shards(tmp_path, n=4, per=3):
    rng = np.random.default_rng(1)
    for s in range(n):
        _tar(tmp_path / f"shard-{s:06d}.tar", [
            m for i in range(per) for m in (
                (f"{s}_{i}.npy", _npy(rng.integers(0, 255, (6, 6, 3), dtype=np.uint8))),
                (f"{s}_{i}.txt", f"G{s} G{i}".encode()))])
    return str(tmp_path / f"shard-{{000000..{n - 1:06d}}}.tar")


def test_iterable_shards_per_rank_match_jax_multihost_share(tmp_path, monkeypatch):
    """Each rank reads shards[rank::world] of the list every rank shuffles
    alike (JAX's split across hosts, its process index and count
    patched); the ranks' samples are disjoint and cover every shard; one
    rank's samples equal JAX's bit for bit, in order, through the shuffle
    buffer and the batches."""
    import jax

    from spatial_clip_tpu.data.datasets import iterable_shards as jax_shards
    from spatial_clip_tpu_torch.data.datasets.iterable_shards import (
        IterableTarDataset,
        iter_batches,
    )

    spec = _shards(tmp_path)
    seen = []
    for rank in (0, 1):
        ours = IterableTarDataset(spec, shuffle_buffer=3, seed=5, rank=rank, world_size=2)
        ours.set_epoch(1)
        monkeypatch.setattr(jax, "process_count", lambda: 2)
        monkeypatch.setattr(jax, "process_index", lambda r=rank: r)
        theirs = jax_shards.IterableTarDataset(spec, shuffle_buffer=3, seed=5)
        theirs.set_epoch(1)
        got, want = list(ours), list(theirs)
        assert [s["raw_text"] for s in got] == [s["raw_text"] for s in want] and len(got) == 6
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["image"], w["image"])
        seen += [s["raw_text"] for s in got]
        batches = list(iter_batches(ours, 4))
        assert len(batches) == 1 and batches[0]["images"].shape == (4, 6, 6, 3)
    assert len(seen) == len(set(seen)) == 12


def test_iterable_shards_refuse_a_non_uint8_npy_sample(tmp_path):
    """With a transform, a float npy sample raises ValueError naming it (JAX
    drops it with a warning: one sample fewer); without one it passes as
    it is, in both packages."""
    from spatial_clip_tpu.data.datasets import iterable_shards as jax_shards
    from spatial_clip_tpu_torch.data.datasets.iterable_shards import IterableTarDataset

    good = np.zeros((4, 4, 3), np.uint8)
    _tar(tmp_path / "s-000000.tar", [("a.npy", _npy(good)), ("a.txt", b"A"),
                                     ("b.npy", _npy(good.astype(np.float32) + 0.5)),
                                     ("b.txt", b"B")])
    spec = str(tmp_path / "s-000000.tar")
    with pytest.raises(ValueError, match="sample b: a float32"):
        list(IterableTarDataset(spec, preprocess_fn=np.asarray))
    assert [s["raw_text"] for s in jax_shards.IterableTarDataset(
        spec, preprocess_fn=np.asarray)] == ["A"]
    ours = list(IterableTarDataset(spec))
    assert [s["image"].dtype for s in ours] == [np.uint8, np.float32]
