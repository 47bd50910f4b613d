"""Evaluate dumped detections offline (as ``tools/eval_metric.py`` of the
JAX package).

    python -m pavenet_tpu_torch.tools.eval_metric <config.py> <dets.json>
        [--cfg-options k=v ...]

The config's ``data.test`` dataset (no pipeline) and a detections json of
``tools.test --out``, through ``apis/test.py::evaluate_dataset``: one
``key: value`` line per metric, as the JAX CLI prints them. ``main(argv)``
returns the metrics.
"""
from __future__ import annotations

import argparse
import json


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate dumped detections")
    p.add_argument("config")
    p.add_argument("results", help="detections json from tools.test --out")
    p.add_argument("--cfg-options", nargs="+", default=[])
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    from pavenet_tpu_torch.apis.test import evaluate_dataset
    from pavenet_tpu_torch.tools.train import build_dataset, load_config

    cfg = load_config(args.config, args.cfg_options)
    dataset = build_dataset(cfg, "test", None)
    with open(args.results) as f:
        detections = json.load(f)
    metrics = evaluate_dataset(dataset, detections)
    for k, v in metrics.items():
        print(f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}")
    return metrics


if __name__ == "__main__":
    main()
