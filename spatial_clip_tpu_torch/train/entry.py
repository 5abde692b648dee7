"""Training entry point (counterpart of the repository's root ``train.py``).

    python -m spatial_clip_tpu_torch.train experiment=smoke_synthetic trainer.epochs=1 seed=1

composes ``configs/train.yaml`` with the overrides (:mod:`spatial_clip_tpu_torch.config`)
and runs :func:`train` (:func:`build`, then ``Run.fit``), the
orchestration of the JAX package's entry:
seed -> datamodule -> model -> model<->data handshake -> ``Trainer.fit``
(with checkpoints under ``<paths.output_dir>/checkpoints`` when
``save_ckpt`` is true, and ``resume``) -> test on the test split, returning
the optimized metric for sweeps and the objects built.

The run goes on the GPU (``cuda``) unless ``trainer.platform=cpu``
(``configs/trainer/cpu.yaml``) asks for the CPU; with no GPU it raises
rather than carry on on the CPU. Keys with no counterpart here raise
NotImplementedError naming the key: ``trainer.platform`` other than
cpu / gpu / cuda and ``trainer.multihost`` (ROADMAP Queue 1 item 7), and
``trainer.scan_steps`` above 1 (an XLA dispatch knob).

Data parallelism, one process per device over a ``torch.distributed`` group
(:mod:`spatial_clip_tpu_torch.parallel`), with ``data.batch_size`` the global
batch the ranks shard:

- ``trainer.sim_devices=N`` with ``trainer.platform=cpu``
  (``trainer=ddp_sim``), the counterpart of JAX's ``jax_num_cpu_devices``,
  spawns N processes on the CPU in a gloo group and returns rank 0's
  result;
- under ``torchrun --nproc_per_node N -m spatial_clip_tpu_torch.train ...``
  each process joins the group torchrun describes (nccl on the GPU, gloo
  on the CPU) and drives ``cuda:{LOCAL_RANK}``.

Only rank 0 writes the log file, the metric loggers and the checkpoints.

The debug presets' keys (``configs/debug/``): ``trainer.detect_anomaly``
(JAX's ``jax_debug_nans``) stops the run with FloatingPointError at the
first step whose loss or gradient holds a NaN, and runs ``fit`` under
``torch.autograd.set_detect_anomaly``, so a NaN made inside a backward
function names that function; ``trainer.profiler`` (any value: the
configs' ``jax`` means on) writes a ``torch.profiler`` trace of ``fit``
(CPU and, on the GPU, CUDA activity) under ``<output_dir>/profile`` in
TensorBoard's layout. ``model.remat`` recomputes each block in the
backward (``create_model(remat=True)``).
"""
from __future__ import annotations

import logging
import math
import os
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

log = logging.getLogger(__name__)

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs"
PLATFORMS = {"cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}


def resolve_device(cfg: Dict[str, Any]):
    """The torch device the run goes on, after refusing every key that has
    no counterpart in this package."""
    import torch

    tcfg = cfg.get("trainer") or {}
    platform = tcfg.get("platform")
    refused = [
        ("trainer.platform", platform, platform is not None and platform not in PLATFORMS,
         " (ROADMAP Queue 1 item 7)"),
        ("trainer.multihost", tcfg.get("multihost"), bool(tcfg.get("multihost")),
         " (ROADMAP Queue 1 item 7)"),
        ("trainer.scan_steps", tcfg.get("scan_steps"), int(tcfg.get("scan_steps") or 1) > 1,
         " (an XLA dispatch knob; ROADMAP Queue 1 item 11)"),
    ]
    for key, value, bad, why in refused:
        if bad:
            raise NotImplementedError(f"{key}={value!r} is not ported to spatial_clip_tpu_torch"
                                      f"{why}")
    device = torch.device(PLATFORMS.get(platform or "cuda"))
    if sim_devices(cfg) > 1 and device.type != "cpu":
        raise ValueError("trainer.sim_devices simulates ranks on the CPU: it takes "
                         "trainer.platform=cpu (on GPUs, run under torchrun)")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA GPU: pass trainer.platform=cpu to run on the CPU")
    return device


def sim_devices(cfg: Dict[str, Any]) -> int:
    """``trainer.sim_devices``: the ranks a CPU run simulates (1: none)."""
    return int((cfg.get("trainer") or {}).get("sim_devices") or 1)


def join_group(device):
    """The data mesh of this process: the group torchrun describes, or the
    one a spawning parent made; None for a run of one process. Each rank
    drives ``cuda:{LOCAL_RANK}`` on the GPU."""
    from spatial_clip_tpu_torch.parallel.mesh import make_mesh, maybe_init_distributed

    if not maybe_init_distributed("nccl" if device.type == "cuda" else "gloo"):
        return None
    return make_mesh(device=None if device.type == "cuda" else device)


def build_datamodule(cfg: Dict[str, Any]):
    from spatial_clip_tpu_torch.config import instantiate

    return instantiate(cfg["data"])


def build_model(cfg: Dict[str, Any], device="cuda"):
    """(model for training, train transform, val transform, tokenizer, HVG
    bank path) from ``cfg['model']``, as the JAX package's entry builds
    them. The gene vocabulary is ``model.tokenizer.gene_vocab``, or
    ``model.global_hvg_path`` where that file exists. ``model.gene_cfg`` (or
    a model JSON with one) builds the Gene-MLP tower over the
    :class:`GeneVectorizer` of that vocabulary, whose size sets
    ``num_genes`` (no vocabulary raises ValueError); otherwise a vocabulary
    makes the text tower's ``vocab_size`` the :class:`GeneTokenizer`'s."""
    from spatial_clip_tpu_torch.models.factory import (
        create_model_and_transforms,
        get_tokenizer,
    )
    from spatial_clip_tpu_torch.models.tokenizer import GeneVectorizer

    mcfg = dict(cfg["model"])
    tok_cfg = mcfg.pop("tokenizer", None) or {}
    hvg = mcfg.pop("global_hvg_path", None)
    model_name = mcfg.pop("model_name")
    gene_vocab = tok_cfg.get("gene_vocab") or (hvg if hvg and Path(hvg).exists() else None)
    overrides = {}
    gene_cfg_user = mcfg.pop("gene_cfg", None)
    if gene_cfg_user:
        if gene_vocab is None:
            raise ValueError("model.gene_cfg requires a gene vocab (global_hvg_path)")
        tokenizer = GeneVectorizer(gene_vocab)
        overrides["gene_cfg"] = {**dict(gene_cfg_user), "num_genes": int(tokenizer.num_genes)}
    else:
        tokenizer = get_tokenizer(model_name, gene_vocab=gene_vocab,
                                  bpe_path=tok_cfg.get("bpe_path"))
    if hasattr(tokenizer, "num_genes") and "gene_cfg" not in overrides:
        # a Gene-MLP tower from the model JSON: the vectorizer sets its input width
        overrides["gene_cfg"] = {"num_genes": int(tokenizer.num_genes)}
    elif gene_vocab is not None and hasattr(tokenizer, "vocab_size"):
        # the gene tokenizer's closed vocabulary sizes the text tower's embedding table
        overrides["text_cfg"] = {**dict(mcfg.pop("text_cfg", None) or {}),
                                 "vocab_size": int(tokenizer.vocab_size)}
    model, pp_train, pp_val = create_model_and_transforms(
        model_name,
        pretrained=mcfg.pop("pretrained", None),
        precision=mcfg.pop("precision", "bf16"),
        aug_cfg=mcfg.pop("aug_cfg", None),
        remat=mcfg.pop("remat", False),
        force_quick_gelu=mcfg.pop("force_quick_gelu", False),
        seed=int(cfg.get("seed", 0)),
        device=device,
        training=True,
        **overrides,
    )
    return model, pp_train, pp_val, tokenizer, hvg


def build_trainer(cfg: Dict[str, Any], model, total_steps: int, mesh=None):
    from spatial_clip_tpu_torch.losses import make_loss
    from spatial_clip_tpu_torch.train.loop import Trainer, TrainerConfig

    tcfg = cfg.get("trainer", {})
    ocfg = cfg.get("optimizer", {})
    scfg = cfg.get("scheduler", {})
    lcfg = dict(cfg.get("loss", {}))
    loss = make_loss(lcfg.pop("name", "spatial"), **lcfg)
    aug = (cfg.get("model") or {}).get("aug_cfg") or {}
    callbacks = cfg.get("callbacks") or {}
    checkpoint_cb = callbacks.get("model_checkpoint") or {}
    config = TrainerConfig(
        learning_rate=float(ocfg.get("learning_rate", 5e-4)),
        weight_decay=float(ocfg.get("weight_decay", 0.2)),
        betas=tuple(ocfg.get("betas", (0.9, 0.98))),
        eps=float(ocfg.get("eps", 1e-6)),
        grad_clip_norm=tcfg.get("grad_clip_norm", 1.0),
        schedule=scfg.get("name", "cosine"),
        warmup_steps=int(scfg.get("warmup_steps", 500)),
        total_steps=max(int(total_steps), 1),
        grad_accum=int(tcfg.get("grad_accum", 1)),
        grad_accum_mode=tcfg.get("grad_accum_mode", "cached"),
        augment=bool(tcfg.get("augment", True)) and aug is not None,
        color_jitter=(aug or {}).get("color_jitter"),
        seed=int(cfg.get("seed", 42)),
        log_every=int(tcfg.get("log_every", 10)),
        ckpt_dir=(str(Path(cfg["paths"]["output_dir"]) / "checkpoints")
                  if cfg.get("save_ckpt") else None),
        save_every_steps=tcfg.get("save_every_steps"),
        keep_ckpts=int(tcfg.get("keep_ckpts", 3)),
        monitor=checkpoint_cb.get("monitor", "R@1"),
        monitor_mode=checkpoint_cb.get("mode", "max"),
        early_stop_patience=(callbacks.get("early_stopping") or {}).get("patience"),
        debug_nans=bool(tcfg.get("detect_anomaly")),
    )
    return Trainer(model, loss=loss, config=config, mesh=mesh)


@dataclass
class Run:
    """What :func:`build` makes of a composed config: the objects, the
    loggers, the loaders' factories and the epoch plan that :meth:`fit`
    hands to ``Trainer.fit``."""

    cfg: Dict[str, Any]
    device: Any
    output_dir: Path
    datamodule: Any
    model: Any
    trainer: Any
    loggers: Any
    train_iter: Callable[[], Iterable[Dict[str, Any]]]
    val_iter: Optional[Callable[[], Iterable[Dict[str, Any]]]]
    epochs: int
    steps_per_epoch: int

    def fit(self, train_iter=None, steps_per_epoch: Optional[int] = None):
        """``Trainer.fit`` over the run's loaders (or ``train_iter`` with
        ``steps_per_epoch`` in its place), resuming as ``cfg['resume']``
        says, under the debug presets' anomaly mode and profiler; returns
        (state, last metrics)."""
        import contextlib

        import torch

        tcfg = self.cfg.get("trainer") or {}
        with contextlib.ExitStack() as stack:
            if tcfg.get("detect_anomaly"):
                stack.enter_context(torch.autograd.set_detect_anomaly(True))
            if tcfg.get("profiler"):
                stack.enter_context(self._profile(torch))
            return self.trainer.fit(
                train_iter or self.train_iter,
                self.val_iter,
                epochs=self.epochs,
                steps_per_epoch=steps_per_epoch or self.steps_per_epoch,
                logger=self.loggers,
                resume=self.cfg.get("resume"),
            )

    def _profile(self, torch):
        """A torch.profiler context over ``fit`` that writes its trace under
        ``<output_dir>/profile`` as TensorBoard's profiler plugin lays it out
        (``<worker>.<time>.pt.trace.json``)."""
        from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        log.info("profiler trace goes to %s", self.output_dir / "profile")
        return profile(activities=activities,
                       on_trace_ready=tensorboard_trace_handler(str(self.output_dir / "profile")))


def build(cfg: Dict[str, Any]) -> Run:
    """Everything :func:`train` runs, built from the composed config: the
    device (refusing the keys with no counterpart), the output directory and
    its log, the datamodule, the model and the model <-> data handshake, the
    trainer, the loggers and the loaders' factories."""
    import numpy as np

    from spatial_clip_tpu_torch.train.logging_utils import make_loggers, setup_logging

    device = resolve_device(cfg)
    mesh = join_group(device)
    rank = 0
    if mesh is not None:
        device, rank = mesh.device, mesh.rank
    out_dir = Path(cfg["paths"]["output_dir"])
    out_dir.mkdir(parents=True, exist_ok=True)
    setup_logging(str(out_dir / "train.log"), rank=rank)
    np.random.seed(int(cfg.get("seed", 42)))

    log.info("Instantiating datamodule and model on %s%s", device,
             f" (rank {rank} of {mesh.size})" if mesh is not None else "")
    dm = build_datamodule(cfg)
    if mesh is not None:  # data.batch_size is the global batch; this rank takes its rows
        dm.rank, dm.world_size = mesh.rank, mesh.size
    model, pp_train, pp_val, tokenizer, hvg = build_model(cfg, device)

    # model <-> datamodule handshake
    dm.preprocess_fn = pp_train
    dm.preprocess_fn_val = pp_val
    dm.tokenizer = tokenizer
    dm.prepare_data()
    dm.setup("fit")

    tcfg = cfg.get("trainer", {})
    steps_per_epoch = len(dm.train_dataloader())
    limit = tcfg.get("limit_batches")
    if limit:
        steps_per_epoch = min(steps_per_epoch, int(limit))
    overfit = int(tcfg.get("overfit_batches") or 0)
    if overfit:  # configs/debug/overfit.yaml: train repeatedly on N batches
        steps_per_epoch = overfit
    epochs = int(tcfg.get("epochs", 1))
    max_steps = int(tcfg.get("max_steps", -1))
    total_steps = max_steps if max_steps > 0 else epochs * max(steps_per_epoch, 1)

    trainer = build_trainer(cfg, model, total_steps, mesh)
    loggers = make_loggers(cfg.get("logger", {}).get("report_to", "csv"), str(out_dir),
                           rank=rank)

    def train_iter():
        loader = dm.train_dataloader()
        loader.set_epoch(getattr(train_iter, "epoch", 0))
        train_iter.epoch = getattr(train_iter, "epoch", 0) + 1
        return loader

    if overfit:
        import itertools

        cached = list(itertools.islice(iter(dm.train_dataloader()), overfit))

        def train_iter():  # noqa: F811 — the overfit preset replaces the loader
            return iter(cached)

    val_iter = (lambda: dm.val_dataloader()) if dm.data_val is not None else None
    return Run(cfg, device, out_dir, dm, model, trainer, loggers, train_iter, val_iter, epochs,
               min(steps_per_epoch, max_steps) if max_steps > 0 else steps_per_epoch)


def train(cfg: Dict[str, Any]) -> Tuple[Optional[float], Dict[str, Any]]:
    """Run the composed config: returns (the ``optimized_metric``'s value or
    None, the objects built: state, trainer, datamodule, model, metrics,
    output_dir). Under ``trainer.sim_devices=N`` the run goes on N spawned
    ranks, and the objects are rank 0's metrics, output_dir, its final
    flat parameters (``params``, on the CPU) and ``world_size``."""
    import torch.distributed as dist

    n = sim_devices(cfg)
    under_torchrun = int(os.environ.get("WORLD_SIZE", "1")) > 1
    if n > 1 and not (dist.is_initialized() or under_torchrun):
        from spatial_clip_tpu_torch.parallel.launch import spawn

        resolve_device(cfg)  # refuse what the ranks would refuse, before spawning them
        threads = max(1, len(os.sched_getaffinity(0)) // n)
        return spawn(_train_rank, n, (cfg,), backend="gloo", threads=threads)[0]
    run = build(cfg)
    state, metrics = run.fit()

    dm, trainer = run.datamodule, run.trainer
    if cfg.get("test", False) and run.val_iter is not None:
        test_metrics = trainer.evaluate(state, dm.test_dataloader())
        metrics.update({f"test/{k}": v for k, v in test_metrics.items()})
        run.loggers.log(int(state.step), {f"test/{k}": v for k, v in test_metrics.items()})

    metric_name = cfg.get("optimized_metric")
    value = metrics.get(metric_name) if metric_name else None
    objects = {
        "state": state,
        "trainer": trainer,
        "datamodule": dm,
        "model": run.model,
        "metrics": metrics,
        "output_dir": run.output_dir,
    }
    log.info("Final metrics: %s", {k: v for k, v in metrics.items() if isinstance(v, float)})
    return value, objects


def _train_rank(rank: int, cfg: Dict[str, Any]):
    """One spawned rank of a ``trainer.sim_devices`` run: what it can send
    back of :func:`train`'s result."""
    value, objects = train(cfg)
    state = objects["state"]
    return value, {"metrics": objects["metrics"], "output_dir": objects["output_dir"],
                   "params": state.flat["params"].detach().cpu(), "world_size":
                   objects["trainer"].world, "rank": rank}


def compose_train(overrides) -> Dict[str, Any]:
    from spatial_clip_tpu_torch.config import compose

    return compose(CONFIG_DIR, "train", list(overrides))


def main(argv=None):
    """``python -m spatial_clip_tpu_torch.train key=value ...``: returns the
    optimized metric; a non-finite one raises."""
    cfg = compose_train(argv if argv is not None else sys.argv[1:])
    value, _ = train(cfg)
    if value is not None and not math.isfinite(float(value)):
        raise RuntimeError(f"optimized metric is not finite: {value}")
    return value
