"""open_clip_train-style argparse trainer (counterpart of
``spatial_clip_tpu.cli.main_train``).

    python -m spatial_clip_tpu_torch.cli.main_train \
        --model ViT-B-32 --dataset-type synthetic --batch-size 64 --epochs 1

The JAX package's flag surface, mapped onto the same Trainer and datamodule
as ``python -m spatial_clip_tpu_torch.train``: the spatial and CLIP losses,
SigLIP (``--siglip``), distillation (``--distill-model``), ``--opt
adamw|sgd|lion``, LiT-style tower locking (``--lock-image-tower``,
``--lock-text-tower`` and their partial unlocking), activation
checkpointing (``--grad-checkpointing``), synthetic / parquet / tar-shard /
csv data and ``::``-weighted multi-source resampling, the ImageFolder
zero-shot evaluation (``--imagenet-val``, ``--imagenet-v2``), checkpoints
under ``<logs>/<name>/checkpoints``, ``results.json`` and the run
directory's mirror (``--remote-sync``).

The run goes on the GPU unless ``--device cpu`` asks for the CPU; with no
GPU it raises. The run name is taken on this process (the JAX package
broadcasts it across hosts; multi-GPU is ROADMAP Queue 1 item 7). The
open_clip trainer's torch-runtime flags (``--torchcompile``,
``--use-bnb-linear``, ...) are accepted and do nothing, with a warning, as
in the JAX package. ``--force-patch-dropout`` above 0 and ``--scan-steps``
above 1 raise NotImplementedError.
"""
from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from pathlib import Path

log = logging.getLogger(__name__)

NOOP_FLAGS = ("torchscript", "torchcompile", "trace", "horovod", "use_bn_sync",
              "ddp_static_graph", "no_set_device_rank", "use_bnb_linear")


def get_default_params(model_name: str) -> dict:
    """Model-conditioned optimizer defaults."""
    model_name = model_name.lower()
    if "vit" in model_name:
        return {"lr": 5.0e-4, "beta1": 0.9, "beta2": 0.98, "eps": 1.0e-6}
    return {"lr": 5.0e-4, "beta1": 0.9, "beta2": 0.999, "eps": 1.0e-8}


def parse_args(args=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="spatial_clip_tpu_torch standalone trainer")
    # data
    p.add_argument("--train-data", default=None, help="dataset dir / csv / shards root")
    p.add_argument("--val-data", default=None)
    p.add_argument("--dataset-type", choices=["auto", "parquet", "shards", "synthetic", "csv"],
                   default="auto")
    p.add_argument("--spatial-data-dir", default=None,
                   help="spatial dataset root; implies --use-spatial-dataset")
    p.add_argument("--imagenet-v2", default=None,
                   help="second zero-shot eval folder (ImageNetV2 layout)")
    p.add_argument("--imagenet-val", default=None, help="ImageFolder root for zero-shot eval")
    p.add_argument("--zeroshot-frequency", type=int, default=2,
                   help="run zero-shot every N epochs")
    p.add_argument("--zeroshot-templates", default="openai", choices=["openai", "simple"])
    p.add_argument("--train-split", default="train")
    p.add_argument("--val-split", default="val")
    p.add_argument("--csv-img-key", default="filepath")
    p.add_argument("--csv-caption-key", default="title")
    p.add_argument("--csv-separator", default="\t")
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--worker-type", choices=["thread", "process"], default="thread")
    p.add_argument("--use-spatial-dataset", action="store_true")
    p.add_argument("--k-neighbors", type=int, default=6)
    p.add_argument("--train-num-samples", type=int, default=None,
                   help="cap/declare the train set size")
    p.add_argument("--val-num-samples", type=int, default=None)
    p.add_argument("--dataset-resampled", action="store_true",
                   help="sample shards with replacement")
    p.add_argument("--train-data-upsampling-factors", default=None,
                   help="':'-separated per-source weights (alternative to "
                        "'::'-weighted --train-data)")
    # model
    p.add_argument("--model", default="ViT-B-32")
    p.add_argument("--pretrained", default="")
    p.add_argument("--precision", default="bf16",
                   choices=["bf16", "fp32", "amp_bf16", "pure_bf16", "float32"])
    p.add_argument("--force-quick-gelu", action="store_true")
    p.add_argument("--grad-checkpointing", action="store_true")
    p.add_argument("--lock-image-tower", "--lock-image", action="store_true",
                   dest="lock_image_tower", help="LiT-style frozen image tower")
    p.add_argument("--lock-text-tower", "--lock-text", action="store_true",
                   dest="lock_text_tower")
    p.add_argument("--lock-image-unlocked-groups", type=int, default=0,
                   help="leave the last N vision blocks trainable when locking")
    p.add_argument("--lock-text-unlocked-layers", type=int, default=0)
    p.add_argument("--lock-image-freeze-bn-stats", action="store_true",
                   help="parity flag: the towers hold no BatchNorm statistics")
    p.add_argument("--lock-text-freeze-layer-norm", action="store_true",
                   help="also freeze LayerNorm params inside locked text blocks")
    p.add_argument("--pretrained-image", action="store_true",
                   help="default base weights for a timm-style image trunk (registry "
                        "weights are not read; the tower starts at init)")
    p.add_argument("--force-patch-dropout", type=float, default=None,
                   help="override the config's patch_dropout")
    p.add_argument("--force-custom-text", action="store_true",
                   help="accepted for parity; one tower implementation here")
    p.add_argument("--cache-dir", default=None, help="pretrained checkpoint cache dir")
    p.add_argument("--gene-vocab", default=None)
    p.add_argument("--bpe-path", default=None)
    # distillation
    p.add_argument("--distill-model", default=None)
    p.add_argument("--distill-pretrained", default=None)
    # CoCa loss weights
    p.add_argument("--coca-caption-loss-weight", type=float, default=2.0)
    p.add_argument("--coca-contrastive-loss-weight", type=float, default=1.0)
    # optimization
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--epochs", type=int, default=32)
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--beta1", type=float, default=None)
    p.add_argument("--beta2", type=float, default=None)
    p.add_argument("--eps", type=float, default=None)
    p.add_argument("--wd", type=float, default=0.2)
    p.add_argument("--warmup", type=int, default=10000)
    p.add_argument("--lr-scheduler", default="cosine",
                   choices=["cosine", "const", "const-cooldown"])
    p.add_argument("--epochs-cooldown", type=int, default=None,
                   help="cooldown epochs for const-cooldown")
    p.add_argument("--lr-cooldown-end", type=float, default=0.0)
    p.add_argument("--lr-cooldown-power", type=float, default=1.0)
    p.add_argument("--grad-clip-norm", type=float, default=None)
    p.add_argument("--opt", default="adamw", choices=["adamw", "sgd", "lion"],
                   help="optimizer family")
    p.add_argument("--momentum", type=float, default=None, help="sgd momentum")
    p.add_argument("--skip-scheduler", action="store_true",
                   help="constant LR, no warmup/decay")
    p.add_argument("--accum-freq", type=int, default=1)
    p.add_argument("--accum-mode", choices=["cached", "simple"], default="cached")
    p.add_argument("--scan-steps", type=int, default=1,
                   help="the JAX package's steps per XLA program; only 1 here")
    # loss
    p.add_argument("--use-spatial-loss", action="store_true")
    p.add_argument("--local-loss", action="store_true")
    p.add_argument("--gather-with-grad", action="store_true",
                   help="accepted for parity; one process holds the whole batch")
    p.add_argument("--siglip", action="store_true")
    p.add_argument("--loss-dist-impl", default="shift",
                   choices=["bidir", "shift", "reduce", "gather"])
    p.add_argument("--cap-logit-scale", "--logit-scale-cap", dest="cap_logit_scale",
                   type=float, default=None,
                   help="straight-through cap on exp(logit_scale) in the spatial loss")
    p.add_argument("--temp-reg-weight", type=float, default=0.0)
    p.add_argument("--neighbor-alpha-scale", type=float, default=1.0)
    p.add_argument("--float32-logits", action="store_true", default=True)
    p.add_argument("--use-fused-kernel", action="store_true",
                   help="the fused spatial cross-entropy kernels")
    # run management
    p.add_argument("--logs", default="./logs/")
    p.add_argument("--name", default=None)
    p.add_argument("--resume", default=None)
    p.add_argument("--save-frequency", type=int, default=1)
    p.add_argument("--save-most-recent", action="store_true", default=True,
                   help="keep an always-current latest checkpoint")
    p.add_argument("--delete-previous-checkpoint", action="store_true",
                   help="keep only the newest step checkpoint (keep=1)")
    p.add_argument("--copy-codebase", action="store_true",
                   help="snapshot the package source into the run dir")
    p.add_argument("--debug", action="store_true", help="DEBUG-level logging")
    # open_clip's torch-runtime flags: accepted, no-ops here (a warning is
    # logged when one is set)
    for noop in ("--torchscript", "--torchcompile", "--trace", "--horovod",
                 "--use-bn-sync", "--ddp-static-graph", "--no-set-device-rank",
                 "--use-bnb-linear", "--log-local"):
        p.add_argument(noop, action="store_true", help="accepted for parity; no-op")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the run goes; cuda raises without a GPU")
    p.add_argument("--dist-backend", default=None, help="accepted for parity; no-op")
    p.add_argument("--dist-url", default=None, help="accepted for parity; no-op")
    p.add_argument("--val-frequency", type=int, default=1)
    p.add_argument("--report-to", default="csv,jsonl")
    p.add_argument("--wandb-notes", default=None)
    p.add_argument("--wandb-project-name", default=None)
    p.add_argument("--remote-sync", default=None,
                   help="directory to mirror the run dir into")
    p.add_argument("--remote-sync-frequency", type=int, default=300)
    p.add_argument("--remote-sync-protocol", default="local", choices=["local", "fsspec", "s3"])
    p.add_argument("--log-every-n-steps", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic-num-samples", type=int, default=1024)
    p.add_argument("--synthetic-image-size", type=int, default=224)
    ns = p.parse_args(args)
    for k, v in get_default_params(ns.model).items():
        if getattr(ns, k.replace("-", "_")) is None:
            setattr(ns, k.replace("-", "_"), v)
    if ns.spatial_data_dir:
        # --spatial-data-dir implies the spatial dataset
        ns.train_data = ns.train_data or ns.spatial_data_dir
        ns.use_spatial_dataset = True
    return ns


def _detect_dataset_type(args) -> str:
    if args.dataset_type != "auto":
        return args.dataset_type
    if not args.train_data:
        return "synthetic"
    if " " in args.train_data.strip():
        return "shards"  # '::'-weighted multi-source
    p = Path(args.train_data)
    if p.suffix == ".csv" or p.suffix == ".tsv":
        return "csv"
    if (p / args.train_split / "nodes.parquet").exists() or (p / "nodes.parquet").exists():
        return "parquet"
    if any(p.rglob("*.tar")):
        return "shards"
    return "synthetic"


def _lock_prefixes(model, args) -> tuple:
    """The JAX parameter-path prefixes that tower locking freezes, with the
    last ``--lock-image-unlocked-groups`` vision blocks and
    ``--lock-text-unlocked-layers`` text blocks left trainable; inside a
    locked text block the LayerNorms stay trainable unless
    ``--lock-text-freeze-layer-norm``. ``train/optim.py``'s ``freeze_mask``
    matches them on whole path components."""
    prefixes = []
    v, t = model.cfg.vision_cfg, model.cfg.text_cfg
    if args.lock_image_tower:
        n = args.lock_image_unlocked_groups
        if n and isinstance(v.layers, int):
            prefixes += ["visual/conv1", "visual/class_embedding",
                         "visual/positional_embedding", "visual/ln_pre"]
            prefixes += [f"visual/transformer/resblocks_{i}"
                         for i in range(max(v.layers - n, 0))]
        else:
            prefixes.append("visual")
    if args.lock_text_tower:
        n = args.lock_text_unlocked_layers
        if n and t is not None:
            prefixes += ["text/token_embedding", "text/positional_embedding"]
            for i in range(max(t.layers - n, 0)):
                blk = f"text/transformer/resblocks_{i}"
                if getattr(args, "lock_text_freeze_layer_norm", False):
                    prefixes.append(blk)  # the whole block, LayerNorms included
                else:
                    prefixes += [f"{blk}/attn", f"{blk}/mlp"]
        else:
            prefixes.append("text")
    return tuple(prefixes)


def resolve_device(name: str):
    """``--device``: a torch device; cuda without a GPU raises."""
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA GPU: pass --device cpu to run on the CPU")
    return device


def main(args=None):
    from spatial_clip_tpu_torch.data.datamodule import SpatialClipDataModule
    from spatial_clip_tpu_torch.losses import make_loss
    from spatial_clip_tpu_torch.models.factory import (
        create_model,
        create_model_and_transforms,
        get_tokenizer,
    )
    from spatial_clip_tpu_torch.train.logging_utils import make_loggers, setup_logging
    from spatial_clip_tpu_torch.train.loop import Trainer, TrainerConfig

    args = parse_args(args)
    device = resolve_device(args.device)
    if args.force_patch_dropout:
        raise NotImplementedError("--force-patch-dropout (PatchDropout) is not ported to "
                                  "spatial_clip_tpu_torch (ROADMAP Queue 1 item 6)")
    if args.scan_steps > 1:
        raise NotImplementedError("--scan-steps > 1 is an XLA dispatch knob with no "
                                  "counterpart in spatial_clip_tpu_torch (ROADMAP Queue 1 "
                                  "item 11)")
    name = args.name or time.strftime("%Y_%m_%d-%H_%M_%S")
    out_dir = Path(args.logs) / name
    out_dir.mkdir(parents=True, exist_ok=True)
    setup_logging(str(out_dir / "out.log"))

    if args.debug:
        logging.getLogger().setLevel(logging.DEBUG)
    for noop in NOOP_FLAGS:
        if getattr(args, noop, False):
            log.warning("--%s is a flag of open_clip's torch trainer; accepted, no-op here",
                        noop.replace("_", "-"))
    if args.copy_codebase:
        import shutil

        import spatial_clip_tpu_torch as pkg

        shutil.copytree(Path(pkg.__file__).parent, out_dir / "code" / "spatial_clip_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"), dirs_exist_ok=True)

    overrides = {}
    if args.force_patch_dropout is not None:
        overrides["vision_cfg"] = {"patch_dropout": args.force_patch_dropout}
    model, pp_train, pp_val = create_model_and_transforms(
        args.model, pretrained=args.pretrained or None, precision=args.precision,
        force_quick_gelu=args.force_quick_gelu, remat=args.grad_checkpointing, seed=args.seed,
        device=device, training=True, **overrides)

    if args.pretrained_image and not args.pretrained:
        log.warning("--pretrained-image: registry weights are not read here; the image tower "
                    "starts at init")
    if args.lock_image_freeze_bn_stats and args.lock_image_tower:
        log.info("--lock-image-freeze-bn-stats: the towers hold no BatchNorm statistics; "
                 "nothing to freeze")

    teacher = None
    if args.distill_model:
        teacher = create_model(args.distill_model, pretrained=args.distill_pretrained or None,
                               precision=args.precision, seed=args.seed, device=device)
    tokenizer = get_tokenizer(args.model, gene_vocab=args.gene_vocab, bpe_path=args.bpe_path)

    dtype = _detect_dataset_type(args)
    fmt = {"parquet": "parquet_v1", "shards": "shards_v1", "synthetic": "synthetic",
           "csv": "csv"}[dtype]
    format_kwargs = {}
    if fmt == "synthetic":
        format_kwargs = {"num_samples": args.train_num_samples or args.synthetic_num_samples,
                         "image_size": args.synthetic_image_size}
    dm = SpatialClipDataModule(
        data_dir=args.train_data or "", k_neighbors=args.k_neighbors,
        batch_size=args.batch_size, num_workers=args.workers, worker_type=args.worker_type,
        dataset_format=fmt, dataset_format_kwargs=format_kwargs,
        splits={"train": args.train_split, "val": args.val_split}, seed=args.seed)
    dm.preprocess_fn, dm.preprocess_fn_val, dm.tokenizer = pp_train, pp_val, tokenizer
    if dtype == "shards" and args.train_data and (" " in args.train_data.strip()):
        # '::'-weighted multi-source syntax: --train-data 'a::2 b::1'
        from spatial_clip_tpu_torch.data.datasets import (
            ShardedSpatialDataset,
            _resolve_sample_ids,
        )
        from spatial_clip_tpu_torch.data.resampling import (
            ResampledDataset,
            parse_weighted_spec,
        )

        def shards(root, split, pp):
            root = Path(root)
            return ShardedSpatialDataset(
                dataset_root=root, split=split, sample_ids=_resolve_sample_ids(split, root),
                k_neighbors=args.k_neighbors, preprocess_fn=pp, tokenizer=tokenizer)

        paths, weights = parse_weighted_spec(args.train_data)
        dm.data_train = ResampledDataset([shards(p, args.train_split, pp_train) for p in paths],
                                         weights, seed=args.seed)
        if args.val_data:
            dm.data_val = shards(args.val_data, args.val_split, pp_val)
    elif fmt == "csv":
        from spatial_clip_tpu_torch.data.datasets.csv_backend import CsvDataset

        dm.data_train = CsvDataset(args.train_data, pp_train, tokenizer, args.csv_img_key,
                                   args.csv_caption_key, args.csv_separator, args.k_neighbors)
        if args.val_data:
            dm.data_val = CsvDataset(args.val_data, pp_val, tokenizer, args.csv_img_key,
                                     args.csv_caption_key, args.csv_separator, args.k_neighbors)
    else:
        dm.prepare_data()
        dm.setup("fit")

    if teacher is not None:
        loss = make_loss("distill", float32_logits=args.float32_logits)
    elif args.use_spatial_loss:
        loss = make_loss("spatial", cap_logit_scale=args.cap_logit_scale,
                         temp_reg_weight=args.temp_reg_weight,
                         neighbor_alpha_scale=args.neighbor_alpha_scale,
                         float32_logits=args.float32_logits,
                         use_fused_kernel=args.use_fused_kernel)
    elif args.siglip:
        loss = make_loss("siglip", dist_impl=args.loss_dist_impl)
    else:
        loss = make_loss("clip", float32_logits=args.float32_logits)

    steps_per_epoch = args.steps_per_epoch or len(dm.train_dataloader())
    total_steps = args.epochs * max(steps_per_epoch, 1)
    cfg = TrainerConfig(
        learning_rate=args.lr,
        weight_decay=args.wd,
        betas=(args.beta1, args.beta2),
        eps=args.eps,
        grad_clip_norm=args.grad_clip_norm,
        opt=args.opt,
        momentum=args.momentum,
        schedule="const" if args.skip_scheduler else args.lr_scheduler,
        warmup_steps=0 if args.skip_scheduler else min(args.warmup, max(total_steps // 10, 1)),
        total_steps=total_steps,
        grad_accum=args.accum_freq,
        grad_accum_mode=args.accum_mode,
        seed=args.seed,
        log_every=args.log_every_n_steps,
        ckpt_dir=str(out_dir / "checkpoints"),
        keep_ckpts=1 if args.delete_previous_checkpoint else 3,
        frozen_prefixes=_lock_prefixes(model, args),
        extra={"schedule_kwargs": (
            {"cooldown_steps": (args.epochs_cooldown or 0) * max(steps_per_epoch, 1),
             "cooldown_power": args.lr_cooldown_power,
             "cooldown_end_lr": args.lr_cooldown_end}
            if args.lr_scheduler == "const-cooldown" and args.epochs_cooldown else {})},
    )
    trainer = Trainer(model, loss=loss, config=cfg, teacher=teacher)
    loggers = make_loggers(args.report_to, str(out_dir), wandb_project=args.wandb_project_name,
                           wandb_notes=args.wandb_notes)

    sync_proc = None
    if args.remote_sync:
        from spatial_clip_tpu_torch.utils.file_sync import remote_sync, start_sync_process

        remote_run_dir = str(Path(args.remote_sync) / name)
        # one synchronous sync checks the destination before training
        if not remote_sync(str(out_dir), remote_run_dir, args.remote_sync_protocol):
            raise RuntimeError(f"initial remote sync failed: {remote_run_dir}")
        sync_proc = start_sync_process(args.remote_sync_frequency, str(out_dir),
                                       remote_run_dir, args.remote_sync_protocol)
        sync_proc.start()
    try:
        state, metrics = trainer.fit(
            lambda: dm.train_dataloader(),
            (lambda: dm.val_dataloader()) if dm.data_val is not None else None,
            epochs=args.epochs, steps_per_epoch=args.steps_per_epoch, logger=loggers,
            resume=args.resume)
        for zs_dir, zs_tag in ((args.imagenet_val, "imagenet"), (args.imagenet_v2, "imagenetv2")):
            if zs_dir:
                zs = _zero_shot(model, state, tokenizer, pp_val, zs_dir, args)
                zs = {f"{zs_tag}-{k}" if zs_tag != "imagenet" else k: v for k, v in zs.items()}
                metrics.update(zs)
                log.info("%s zero-shot: %s", zs_tag, zs)
        (out_dir / "results.json").write_text(json.dumps(metrics, indent=2, default=float))
    finally:
        if sync_proc is not None:
            sync_proc.terminate()
            sync_proc.join()
    if sync_proc is not None:
        from spatial_clip_tpu_torch.utils.file_sync import remote_sync

        # a last full sync, so the mirror holds the finished run
        remote_sync(str(out_dir), str(Path(args.remote_sync) / name), args.remote_sync_protocol)
    log.info("done: %s", metrics)
    return metrics


def _zero_shot(model, state, tokenizer, pp_val, root, args) -> dict:
    """ImageFolder zero-shot top-1 / top-5. Folders named by ImageNet class
    are used as they are; the standard 1000-class layout (named or numeric)
    takes the metadata's class order; a numeric subset maps each folder to
    its metadata class name."""
    from spatial_clip_tpu_torch.data.datasets.imagefolder import get_imagenet_loader
    from spatial_clip_tpu_torch.train.zero_shot import (
        imagenet_zero_shot_eval,
        load_imagenet_metadata,
    )

    loader, classes = get_imagenet_loader(root, pp_val, batch_size=args.batch_size)
    if len(classes) == 1000:
        names = None
    elif all(c.isdigit() for c in classes):
        meta_names, _ = load_imagenet_metadata(args.zeroshot_templates)
        names = [meta_names[int(c)] for c in classes]
    else:
        names = classes
    return imagenet_zero_shot_eval(model, state.params, tokenizer, loader,
                                   template_set=args.zeroshot_templates, classnames=names)


if __name__ == "__main__":
    main(sys.argv[1:])
