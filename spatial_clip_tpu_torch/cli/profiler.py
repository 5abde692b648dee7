"""Per-model GFLOPs / MParams profiler (counterpart of
``spatial_clip_tpu.cli.profiler``): one JSON row a model on stdout, a CSV
with ``--results-file``. Each model is built on the ``meta`` device (no
memory, no card) and counted by ``ops/flops.profile_model``.

    python -m spatial_clip_tpu_torch.cli.profiler --model ViT-B-32 RN50 [--train]
    python -m spatial_clip_tpu_torch.cli.profiler --model all --results-file costs.csv
"""
from __future__ import annotations

import argparse
import csv
import json
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="model FLOPs/params profiler")
    ap.add_argument("--model", nargs="+", default=["ViT-B-32"],
                    help="model names, or 'all' for every built-in config")
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--train", action="store_true", help="include fwd+bwd cost")
    ap.add_argument("--precision", default="bf16")
    ap.add_argument("--results-file", default=None, help="write CSV here")
    args = ap.parse_args(argv)

    from spatial_clip_tpu_torch.models.factory import create_model, list_models
    from spatial_clip_tpu_torch.ops.flops import profile_model

    names = list_models() if args.model == ["all"] else args.model
    rows = []
    for name in names:
        try:
            model = create_model(name, precision=args.precision, device="meta")
            row = profile_model(model, batch_size=args.batch_size, train=args.train)
            rows.append(row)
            print(json.dumps(row), flush=True)
        except Exception as e:  # a config this package does not build: say so, go on
            print(f"skip {name}: {type(e).__name__}: {e}", file=sys.stderr)
    if args.results_file and rows:
        with open(args.results_file, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)
    return rows


if __name__ == "__main__":
    main()
