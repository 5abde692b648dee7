"""What each rank runs in the data-parallel CPU tests
(``tests/test_torch_port_dist*.py``): functions that
``spatial_clip_tpu_torch.parallel.launch.spawn`` runs in a gloo group of
spawned processes. This module imports torch and the port only: the
spawned interpreters must not import jax."""
from __future__ import annotations

import hashlib
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist


def rows(x, rank: int, world: int):
    """Rank ``rank``'s rows of a global-batch array."""
    b = x.shape[0] // world
    return x[rank * b:(rank + 1) * b]


def digest(state) -> str:
    """One hash of the parameters', mu's and nu's bits."""
    h = hashlib.sha256()
    for k in ("params", "mu", "nu"):
        h.update(state.flat[k].detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


# ------------------------------------------------------------------ data

def crop_batches(rank: int = 0, world: int = 1, epochs: int = 2) -> list:
    """The image batches rank ``rank`` of ``world`` loads in ``epochs``
    epochs: 24 synthetic 40 px tiles under the host transform's random
    resized crop to 32 px (scale 0.3-1, seed 5), shuffled, global batch 8,
    num_workers 0."""
    from spatial_clip_tpu_torch.data.datamodule import DataLoader
    from spatial_clip_tpu_torch.data.datasets.synthetic import SyntheticSpatialDataset
    from spatial_clip_tpu_torch.models.transforms import image_transform

    crop = image_transform(32, is_train=True, aug_cfg={"scale": (0.3, 1.0)}, seed=5)
    ds = SyntheticSpatialDataset(num_samples=24, image_size=40, k_neighbors=2, preprocess_fn=crop)
    loader = DataLoader(ds, batch_size=8, shuffle=True, seed=3, rank=rank, world_size=world)
    out = []
    for epoch in range(epochs):
        loader.set_epoch(epoch)
        out.extend(b["images"] for b in loader)
    return out


def crop_rank(rank: int, epochs: int) -> list:
    """:func:`crop_batches` of this rank of the group."""
    return crop_batches(rank, dist.get_world_size(), epochs)


# ----------------------------------------------------------------- losses

def loss_rank(rank: int, cases, inputs) -> dict:
    """Every loss case on this rank's rows: the loss value and the gradients
    of this rank's features and of the scale (and bias); then
    gather_features, the object collectives and the mesh helpers."""
    from spatial_clip_tpu_torch.losses import gather_features, make_loss
    from spatial_clip_tpu_torch.parallel.mesh import (
        all_gather_object,
        broadcast_object,
        local_batch_size,
        make_mesh,
        process_shard_indices,
    )

    group = dist.group.WORLD
    world = dist.get_world_size()
    out = {}
    for name, kind, opts in cases:
        img = torch.tensor(rows(inputs["img"], rank, world), requires_grad=True)
        txt = torch.tensor(rows(inputs["txt"], rank, world), requires_grad=True)
        scale = torch.tensor(inputs["scale"], requires_grad=True)
        kw = {"image_features": img, "text_features": txt, "logit_scale": scale}
        for key in ("image_tile_ids", "text_tile_ids", "neighbor_tile_ids", "neighbor_alphas",
                    "dist_image_features", "dist_text_features"):
            kw[key] = torch.tensor(rows(inputs[key], rank, world))
        kw["dist_logit_scale"] = torch.tensor(inputs["dist_scale"])
        bias = cap = None
        if kind == "siglip":
            bias = torch.tensor(inputs["bias"], requires_grad=True)
            kw["logit_bias"] = bias
        if kind == "coca":
            cap = torch.tensor(rows(inputs["caption_logits"], rank, world), requires_grad=True)
            kw.update(caption_logits=cap,
                      caption_labels=torch.tensor(rows(inputs["caption_labels"], rank, world)))
        res = make_loss(kind, **opts)(group=group, **kw)
        res["contrastive_loss"].backward()
        out[name] = {"loss": float(res["contrastive_loss"].detach()),
                     "extras": {k: float(v.detach()) for k, v in res.items()
                                if k != "contrastive_loss"},
                     "img": img.grad.numpy(), "txt": txt.grad.numpy(),
                     "scale": float(scale.grad),
                     "bias": None if bias is None else float(bias.grad),
                     "cap": None if cap is None else cap.grad.numpy()}
    img = torch.tensor(rows(inputs["img"], rank, world), requires_grad=True)
    txt = torch.tensor(rows(inputs["txt"], rank, world), requires_grad=True)
    all_img, all_txt = gather_features(img, txt, group)
    w = torch.tensor(inputs["weights"])
    ((all_img * w).sum() + (all_txt * w * 2).sum()).backward()
    out["gather"] = {"img": all_img.detach().numpy(), "txt": all_txt.detach().numpy(),
                     "img_grad": img.grad.numpy(), "txt_grad": txt.grad.numpy()}
    mesh = make_mesh(device="cpu")
    try:
        local_batch_size(world * 3 + 1, mesh)
        indivisible = "no error"
    except ValueError as e:
        indivisible = str(e)
    out["mesh"] = {"rank": mesh.rank, "size": mesh.size, "shape": mesh.shape,
                   "local": local_batch_size(8 * world, mesh), "indivisible": indivisible,
                   "shard": process_shard_indices(10)}
    out["objects"] = {"broadcast": broadcast_object({"name": f"run-of-rank-{rank}"}),
                      "all_gather": all_gather_object(("rank", rank, "x" * rank))}
    return out


# ---------------------------------------------------------------- trainer

def build_trainer(spec, world: int):
    from spatial_clip_tpu_torch import create_model
    from spatial_clip_tpu_torch.losses import make_loss
    from spatial_clip_tpu_torch.parallel.mesh import make_mesh
    from spatial_clip_tpu_torch.train.loop import Trainer, TrainerConfig

    model = create_model(spec.get("model", "ViT-Test"), precision="fp32", device="cpu", seed=0,
                         training=True, **spec.get("overrides", {}))
    if spec.get("weights"):
        model.load_state_dict(torch.load(spec["weights"], weights_only=True))
    kind, opts = spec["loss"]
    mesh = make_mesh(device="cpu") if dist.is_initialized() else None
    cfg = TrainerConfig(**spec["cfg"])
    return Trainer(model, make_loss(kind, **opts), cfg, mesh=mesh)


def torch_batch(batch) -> dict:
    return {k: torch.from_numpy(np.array(v)).long() if k == "texts" and v.dtype == np.int32
            else torch.from_numpy(np.array(v)) for k, v in batch.items()}


def run_steps(spec, rank: int = 0, world: int = 1) -> list:
    """``forward_backward`` then ``train_step`` on each global batch of the
    spec (this rank's rows): the loss, the flat gradient and the step
    metrics, and the state's digest after the step."""
    trainer = build_trainer(spec, world)
    state = trainer.init_state()
    out = []
    for batch in spec["batches"]:
        tb = torch_batch({k: rows(v, rank, world) for k, v in batch.items()})
        loss, logits, grads = trainer.forward_backward(state, tb)
        state, m = trainer.train_step(state, tb)
        out.append({"fb_loss": float(loss), "grads": grads.numpy().copy(),
                    "logits": logits.numpy().copy(),
                    **{k: float(m[k]) for k in ("loss", "grad_norm", "logit_scale", "R@1")},
                    "digest": digest(state)})
    return out


def steps_rank(rank: int, spec) -> list:
    return run_steps(spec, rank, dist.get_world_size())


class ListLogger:
    def __init__(self):
        self.rows = []

    def log(self, step, metrics):
        self.rows.append((step, dict(metrics)))


def fit_rank(rank: int, spec) -> dict:
    """``Trainer.fit`` (synthetic datamodule, this rank's rows, validation,
    a checkpoint every step) counting the host copies each rank makes for a
    checkpoint; then a second trainer resumes the newest step on every
    rank."""
    from spatial_clip_tpu_torch.data.datamodule import SpatialClipDataModule
    from spatial_clip_tpu_torch.models.transforms import HostImageTransform, PreprocessCfg
    from spatial_clip_tpu_torch.models.factory import get_tokenizer
    from spatial_clip_tpu_torch.train import checkpoints

    world = dist.get_world_size() if dist.is_initialized() else 1
    copies = []
    original = checkpoints.host_state
    checkpoints.host_state = lambda state: copies.append(state.step) or original(state)
    dm = SpatialClipDataModule(batch_size=spec["batch_size"], dataset_format="synthetic",
                               dataset_format_kwargs=spec["data"], rank=rank, world_size=world)
    pp = HostImageTransform(PreprocessCfg(size=spec["data"]["image_size"]), is_train=False)
    dm.preprocess_fn = dm.preprocess_fn_val = pp
    dm.tokenizer = get_tokenizer("ViT-Test")
    dm.setup("fit")
    trainer = build_trainer(spec, world)
    logger = ListLogger()
    state, last = trainer.fit(lambda: dm.train_dataloader(), lambda: dm.val_dataloader(),
                              epochs=1, logger=logger)
    checkpoints.host_state = original
    resumed = build_trainer(spec, world)
    rstate, _ = resumed.fit(lambda: iter(()), None, epochs=1, resume="latest")
    return {"logged": logger.rows, "last": last, "digest": digest(state),
            "resumed_digest": digest(rstate), "resumed_step": rstate.step, "copies": copies,
            "steps_on_disk": sorted(p.name for p in Path(spec["cfg"]["ckpt_dir"]).iterdir())}


# ------------------------------------------------------------ entry points

def main_train_rank(rank: int, argv) -> dict:
    """``cli.main_train`` on every rank, rank 1's clock a day later (so its
    own run name would differ): the run directories made, and whether
    ``maybe_init_distributed`` finds the group up."""
    from spatial_clip_tpu_torch.cli import main_train
    from spatial_clip_tpu_torch.parallel.mesh import maybe_init_distributed

    if rank == 1:
        main_train.time = type("Clock", (), {"strftime": staticmethod(
            lambda fmt, t=None: time.strftime(fmt, time.localtime(time.time() + 86400)))})
    metrics = main_train.main(list(argv))
    dist.barrier()
    logs = Path(argv[argv.index("--logs") + 1])
    return {"runs": sorted(p.name for p in logs.iterdir()), "loss": metrics["loss"],
            "joined": maybe_init_distributed("gloo")}


def many_rank(rank: int, specs: dict, fit_spec=None) -> dict:
    """:func:`run_steps` for each named spec, then :func:`fit_rank`."""
    world = dist.get_world_size()
    out = {name: run_steps(spec, rank, world) for name, spec in specs.items()}
    if fit_spec is not None:
        out["fit"] = fit_rank(rank, fit_spec)
    return out
