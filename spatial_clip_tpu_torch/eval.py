"""Evaluation entry point (counterpart of the repository's root ``eval.py``).

    python -m spatial_clip_tpu_torch.eval ckpt_path=logs/train/runs/x/checkpoints experiment=...

composes ``configs/eval.yaml`` with the overrides, builds the datamodule,
model and trainer as :mod:`spatial_clip_tpu_torch.train.entry` does, and
restores ``ckpt_path``: a checkpoint directory (the newest of its
``step_*``), one ``step_N`` directory, or a weights file or directory that
``create_model(pretrained=...)`` takes. It then runs ``Trainer.evaluate``
on the test split, adds ``zero_shot_pcc`` (the zero-shot gene-expression
Pearson correlation, :func:`~spatial_clip_tpu_torch.train.evaluate.zero_shot_gene_expression`)
when ``model.global_hvg_path`` names an existing HVG list, and writes
``eval_metrics.json`` and the loggers' files under ``paths.output_dir``.
The device rules and refused keys are the training entry's; it runs in one
process, also under ``trainer.sim_devices`` (a group's evaluation gathers
the features and gives the same metrics).
"""
from __future__ import annotations

import json
import logging
import sys
from pathlib import Path
from typing import Any, Dict

log = logging.getLogger(__name__)

CONFIG_DIR = Path(__file__).resolve().parents[1] / "configs"


def restore(trainer, ckpt_path):
    """The trainer's state with ``ckpt_path`` restored into it (see the
    module docstring), and a description of what was restored."""
    from spatial_clip_tpu_torch.models.factory import load_checkpoint
    from spatial_clip_tpu_torch.train.checkpoints import STATE_FILE, CheckpointManager

    p = Path(ckpt_path)
    if p.is_dir() and any(p.glob("step_*")):
        state, step = CheckpointManager(p).restore(trainer.init_state())
        return state, f"checkpoint step {step} from {p}"
    if p.is_dir() and p.name.startswith("step_") and (p / STATE_FILE).is_file():
        state, step = CheckpointManager(p.parent).restore(trainer.init_state(),
                                                          int(p.name[len("step_"):]))
        return state, f"checkpoint step {step} from {p.parent}"
    load_checkpoint(trainer.model, p)
    return trainer.init_state(), f"weights from {p}"


def evaluate(cfg: Dict[str, Any]) -> Dict[str, float]:
    from spatial_clip_tpu_torch.train.entry import (
        build_datamodule,
        build_model,
        build_trainer,
        resolve_device,
        sim_devices,
    )
    from spatial_clip_tpu_torch.train.logging_utils import make_loggers, setup_logging

    device = resolve_device(cfg)
    if sim_devices(cfg) > 1:
        log.info("trainer.sim_devices=%d: the evaluation runs in one process", sim_devices(cfg))
    out_dir = Path(cfg["paths"]["output_dir"])
    out_dir.mkdir(parents=True, exist_ok=True)
    setup_logging(str(out_dir / "eval.log"))

    dm = build_datamodule(cfg)
    model, pp_train, pp_val, tokenizer, hvg = build_model(cfg, device)
    dm.preprocess_fn = pp_val  # deterministic transforms for eval
    dm.preprocess_fn_val = pp_val
    dm.tokenizer = tokenizer
    dm.prepare_data()
    dm.setup("fit")

    trainer = build_trainer(cfg, model, total_steps=1)
    ckpt_path = cfg.get("ckpt_path")
    if ckpt_path:
        state, what = restore(trainer, ckpt_path)
        log.info("Restored %s", what)
    else:
        state = trainer.init_state()

    metrics = trainer.evaluate(state, dm.test_dataloader())
    if hvg and Path(hvg).exists():
        from spatial_clip_tpu_torch.train.evaluate import zero_shot_gene_expression

        metrics["zero_shot_pcc"] = zero_shot_gene_expression(
            model, state.params, tokenizer, hvg, dm.test_dataloader())
    metrics = {f"test/{k}": float(v) for k, v in metrics.items()}
    loggers = make_loggers(cfg.get("logger", {}).get("report_to", "csv,jsonl"), str(out_dir))
    loggers.log(0, metrics)
    log.info("Eval metrics: %s", metrics)
    (out_dir / "eval_metrics.json").write_text(json.dumps(metrics, indent=2))
    return metrics


def main(argv=None):
    """``python -m spatial_clip_tpu_torch.eval ckpt_path=... key=value ...``"""
    from spatial_clip_tpu_torch.config import compose

    overrides = list(argv if argv is not None else sys.argv[1:])
    return evaluate(compose(CONFIG_DIR, "eval", overrides))


if __name__ == "__main__":
    main()
