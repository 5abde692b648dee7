"""Hyperparameter sweep over the training entry point (counterpart of
``spatial_clip_tpu.cli.sweep``): grid, random or TPE search over override
values, each trial a full ``spatial_clip_tpu_torch.train.entry.train(cfg)``
run ranked by its ``optimized_metric``. A trial that raises is recorded
with its error and the sweep goes on. The summary (the best trial and every
result) is written to ``--out``.

    python -m spatial_clip_tpu_torch.cli.sweep --trials 4 --mode random \
        --param optimizer.learning_rate=loguniform:1e-5,1e-3 \
        --param loss.temp_reg_weight=choice:0.0,0.1,1.0 \
        -- experiment=smoke_synthetic

The trials run on the GPU unless ``--device cpu`` (which adds
``trainer.platform=cpu`` to every trial); with no GPU they raise before the
first trial.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Any, Dict, List

import numpy as np


def _parse_space(spec: str):
    key, _, rng = spec.partition("=")
    kind, _, args = rng.partition(":")
    vals = args.split(",")
    if kind == "choice":
        return key, ("choice", [json.loads(v) if v[0].isdigit() or v[0] in "-." else v
                                for v in vals])
    if kind == "uniform":
        return key, ("uniform", (float(vals[0]), float(vals[1])))
    if kind == "loguniform":
        return key, ("loguniform", (float(vals[0]), float(vals[1])))
    raise ValueError(f"bad param spec: {spec} (use choice:/uniform:/loguniform:)")


def _sample(space, rng: np.random.Generator) -> Dict[str, Any]:
    out = {}
    for key, (kind, arg) in space.items():
        if kind == "choice":
            out[key] = arg[int(rng.integers(len(arg)))]
        elif kind == "uniform":
            out[key] = float(rng.uniform(*arg))
        else:
            lo, hi = np.log(arg[0]), np.log(arg[1])
            out[key] = float(np.exp(rng.uniform(lo, hi)))
    return out


def _tpe_sample(
    space,
    history: List[Dict[str, Any]],
    rng: np.random.Generator,
    direction: str,
    n_startup: int = 4,
    n_candidates: int = 24,
    gamma: float = 0.25,
) -> Dict[str, Any]:
    """One step of a Tree-structured Parzen Estimator (Optuna's sampler,
    self-contained): split the scored trials into good and bad at the
    gamma-quantile of the objective, model each numeric parameter with
    Gaussian-kernel densities l(x) (good) and g(x) (bad) and each choice
    with add-one category weights, and pick the candidate that maximizes
    l(x) / g(x). The first ``n_startup`` trials are random."""
    scored = [h for h in history if h.get("value") is not None]
    if len(scored) < n_startup:
        return _sample(space, rng)
    vals = np.array([h["value"] for h in scored], dtype=float)
    order = np.argsort(vals if direction == "minimize" else -vals)
    n_good = max(1, int(np.ceil(gamma * len(scored))))
    good = [scored[i]["params"] for i in order[:n_good]]
    bad = [scored[i]["params"] for i in order[n_good:]] or good

    def _log_parzen(x, obs, lo, hi):
        obs = np.asarray(obs, dtype=float)
        sigma = max((hi - lo) / max(len(obs), 1), 1e-12)
        d = (x - obs[:, None]) / sigma  # (n_obs, n_x)
        return np.log(np.mean(np.exp(-0.5 * d * d) + 1e-12, axis=0))

    cands = [_sample(space, rng) for _ in range(n_candidates)]
    scores = np.zeros(len(cands))
    for key, (kind, arg) in space.items():
        xs = np.array([c[key] if kind == "choice" else float(c[key]) for c in cands],
                      dtype=object if kind == "choice" else float)
        if kind == "choice":
            cats = list(arg)
            gw = np.ones(len(cats))
            bw = np.ones(len(cats))
            for p in good:
                gw[cats.index(p[key])] += 1
            for p in bad:
                bw[cats.index(p[key])] += 1
            gw /= gw.sum()
            bw /= bw.sum()
            idx = np.array([cats.index(x) for x in xs])
            scores += np.log(gw[idx]) - np.log(bw[idx])
        else:
            lo, hi = (np.log(arg[0]), np.log(arg[1])) if kind == "loguniform" else arg
            f = np.log if kind == "loguniform" else (lambda v: v)
            xv = np.array([f(float(x)) for x in xs])
            scores += _log_parzen(xv, [f(float(p[key])) for p in good], lo, hi)
            scores -= _log_parzen(xv, [f(float(p[key])) for p in bad], lo, hi)
    return cands[int(np.argmax(scores))]


def _grid(space) -> List[Dict[str, Any]]:
    import itertools

    keys = list(space)
    choices = []
    for k in keys:
        kind, arg = space[k]
        if kind != "choice":
            raise ValueError("grid mode requires choice: spaces")
        choices.append(arg)
    return [dict(zip(keys, combo)) for combo in itertools.product(*choices)]


def main(argv=None):
    from spatial_clip_tpu_torch.train import entry

    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=8)
    ap.add_argument("--mode", choices=["random", "grid", "tpe"], default="random")
    ap.add_argument("--param", action="append", default=[], dest="params")
    ap.add_argument("--direction", choices=["minimize", "maximize"], default="minimize")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="sweep_results.json")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the trials run; cuda raises without a GPU")
    ap.add_argument("overrides", nargs="*", default=[])
    args = ap.parse_args(argv)
    overrides = list(args.overrides) + (["trainer.platform=cpu"] if args.device == "cpu" else [])
    entry.resolve_device(entry.compose_train(overrides))  # no GPU: raise before any trial

    space = dict(_parse_space(s) for s in args.params)
    rng = np.random.default_rng(args.seed)
    if args.mode == "grid":
        grid = _grid(space)[: args.trials or None]
        trials, n_trials = iter(grid), len(grid)
    elif args.mode == "tpe":
        trials, n_trials = None, args.trials  # drawn one by one from the history
    else:
        trials = iter([_sample(space, rng) for _ in range(args.trials)])
        n_trials = args.trials

    results = []
    for i in range(n_trials):
        trial = (_tpe_sample(space, results, rng, args.direction) if args.mode == "tpe"
                 else next(trials))
        trial_overrides = overrides + [f"{k}={v}" for k, v in trial.items()] + [
            f"name=sweep_trial_{i}"]
        cfg = entry.compose_train(trial_overrides)
        try:
            value, _ = entry.train(cfg)
            results.append({"trial": i, "params": trial, "value": value})
            print(json.dumps(results[-1]))
        except Exception as e:  # noqa: BLE001 (a failed trial is recorded, not fatal)
            results.append({"trial": i, "params": trial, "error": str(e)})
            print(f"trial {i} failed: {e}", file=sys.stderr)
    scored = [r for r in results if r.get("value") is not None]
    best = ((min if args.direction == "minimize" else max)(scored, key=lambda r: r["value"])
            if scored else None)
    summary = {"best": best, "results": results}
    Path(args.out).write_text(json.dumps(summary, indent=2, default=float))
    print("best:", json.dumps(best, default=float))
    return summary


if __name__ == "__main__":
    main()
