"""Metric writers and rank-aware logging (counterpart of
``spatial_clip_tpu.train.logging_utils``).

The logger stack that ``configs/logger/*`` names: ``metrics.csv``,
``results.jsonl``, TensorBoard, and the third-party backends (wandb,
mlflow, neptune, comet), each skipped with a warning when its package is
missing, as in the JAX package; and :class:`RankedLogger`, with the
process's rank passed in. Under a process group only rank 0 writes:
:func:`make_loggers` gives the other ranks no writer, and
:func:`setup_logging` gives them no log file.
"""
from __future__ import annotations

import csv
import json
import logging
import os
from pathlib import Path
from typing import Any, Dict, List, Optional


class RankedLogger(logging.LoggerAdapter):
    """Prefixes records with the process's ``rank``; optionally rank-0 only."""

    def __init__(self, name: str = __name__, rank_zero_only: bool = False, rank: int = 0):
        super().__init__(logging.getLogger(name), {})
        self.rank_zero_only = rank_zero_only
        self.rank = rank

    def log(self, level, msg, *args, **kwargs):
        if self.isEnabledFor(level):
            rank = self.rank
            if self.rank_zero_only and rank != 0:
                return
            msg = f"[rank{rank}] {msg}"
            self.logger.log(level, msg, *args, **kwargs)


def setup_logging(log_file: Optional[str] = None, level=logging.INFO, rank: int = 0):
    """Console and (on rank 0) file logging."""
    handlers: List[logging.Handler] = [logging.StreamHandler()]
    if log_file and rank == 0:
        handlers.append(logging.FileHandler(log_file))
    logging.basicConfig(
        level=level,
        format="%(asctime)s | %(levelname)s | %(name)s | %(message)s",
        handlers=handlers,
        force=True,
    )


class CSVLogger:
    """Append-only wide-format CSV metric log."""

    def __init__(self, path: str):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fieldnames: Optional[List[str]] = None

    def log(self, step: int, metrics: Dict[str, Any]):
        row = {"step": step, **{k: v for k, v in metrics.items() if _is_scalar(v)}}
        names = sorted(row)
        if self._fieldnames is None or any(n not in self._fieldnames for n in names):
            # rewrite header when new columns appear
            old_rows = []
            if self.path.exists():
                with open(self.path) as f:
                    old_rows = list(csv.DictReader(f))
            self._fieldnames = sorted(
                set(names) | {c for r in old_rows for c in r}
            )
            with open(self.path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=self._fieldnames)
                w.writeheader()
                for r in old_rows:
                    w.writerow(r)
        with open(self.path, "a", newline="") as f:
            csv.DictWriter(f, fieldnames=self._fieldnames).writerow(row)


class JSONLLogger:
    """results.jsonl-style appender."""

    def __init__(self, path: str):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def log(self, step: int, metrics: Dict[str, Any]):
        with open(self.path, "a") as f:
            f.write(json.dumps({"step": step, **metrics}, default=float) + "\n")


class TensorBoardLogger:
    def __init__(self, log_dir: str):
        from torch.utils.tensorboard import SummaryWriter

        self.writer = SummaryWriter(log_dir)

    def log(self, step: int, metrics: Dict[str, Any]):
        for k, v in metrics.items():
            if _is_scalar(v):
                self.writer.add_scalar(k, float(v), step)


class MultiLogger:
    def __init__(self, loggers: List[Any]):
        self.loggers = list(loggers)

    def log(self, step: int, metrics: Dict[str, Any]):
        for lg in self.loggers:
            lg.log(step, metrics)


def _is_scalar(v) -> bool:
    if isinstance(v, (int, float)):
        return True
    try:
        import numpy as np

        return np.ndim(v) == 0
    except Exception:
        return False


def make_loggers(spec: str, out_dir: str, wandb_project: str = None,
                 wandb_notes: str = None, rank: int = 0) -> MultiLogger:
    """Build loggers from a comma list: 'csv,jsonl,tensorboard' (the
    configs' ``logger.report_to``); none on a rank other than 0."""
    out = []
    if rank != 0:
        return MultiLogger(out)
    os.makedirs(out_dir, exist_ok=True)
    for name in (spec or "csv").split(","):
        name = name.strip().lower()
        if not name or name == "none":
            continue
        if name in ("csv", "aim_csv", "aim"):
            out.append(CSVLogger(os.path.join(out_dir, "metrics.csv")))
        elif name == "jsonl":
            out.append(JSONLLogger(os.path.join(out_dir, "results.jsonl")))
        elif name == "wandb":
            try:
                import wandb  # noqa: F401

                class _Wandb:
                    def __init__(self, out):
                        wandb.init(project=wandb_project or "spatial-clip-tpu",
                                   notes=wandb_notes, dir=out)

                    def log(self, step, metrics):
                        wandb.log(metrics, step=step)

                out.append(_Wandb(out_dir))
            except ImportError:
                logging.getLogger(__name__).warning("wandb unavailable; skipped")
        elif name in ("tensorboard", "tb"):
            try:
                out.append(TensorBoardLogger(os.path.join(out_dir, "tb")))
            except ImportError:
                logging.getLogger(__name__).warning("tensorboard unavailable")
        elif name in ("mlflow", "neptune", "comet"):
            # gated third-party backends (configs/logger/{mlflow,neptune,
            # comet}.yaml); each is skipped with a warning when the client
            # library is not installed
            adapter = _third_party_logger(name, out_dir)
            if adapter is not None:
                out.append(adapter)
        elif name == "many_loggers":
            # configs/logger/many_loggers.yaml: every available backend
            return make_loggers("csv,jsonl,tensorboard,wandb,mlflow", out_dir,
                                wandb_project, wandb_notes)
        else:
            logging.getLogger(__name__).warning("unknown logger '%s' skipped", name)
    return MultiLogger(out)


def _third_party_logger(name: str, out_dir: str):
    log_ = logging.getLogger(__name__)
    try:
        if name == "mlflow":
            import mlflow

            class _MLflow:
                def __init__(self, out):
                    mlflow.set_tracking_uri(f"file:{out}/mlflow")
                    mlflow.start_run()

                def log(self, step, metrics):
                    mlflow.log_metrics(
                        {k.replace("/", "_"): float(v) for k, v in metrics.items()
                         if isinstance(v, (int, float))},
                        step=step,
                    )

            return _MLflow(out_dir)
        if name == "neptune":
            import neptune

            class _Neptune:
                def __init__(self):
                    self.run = neptune.init_run(mode="offline")

                def log(self, step, metrics):
                    for k, v in metrics.items():
                        if isinstance(v, (int, float)):
                            self.run[k].append(float(v), step=step)

            return _Neptune()
        if name == "comet":
            import comet_ml

            class _Comet:
                def __init__(self):
                    self.exp = comet_ml.Experiment()

                def log(self, step, metrics):
                    self.exp.log_metrics(
                        {k: v for k, v in metrics.items()
                         if isinstance(v, (int, float))},
                        step=step,
                    )

            return _Comet()
    except ImportError:
        log_.warning("%s unavailable; skipped", name)
    return None
