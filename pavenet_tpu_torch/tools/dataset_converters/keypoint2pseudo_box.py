"""Pseudo boxes from keypoints for single-stage pose training (as
``tools/dataset_converters/keypoint2pseudo_box.py`` of the JAX package).

Replaces each annotation's bbox by the rectangle around its visible
keypoints, widened by ``--margin`` of its width and height on each side,
and its area by that box's.

    python -m pavenet_tpu_torch.tools.dataset_converters.keypoint2pseudo_box \\
        IN.json OUT.json [--margin 0.1]
"""
from __future__ import annotations

import argparse
import json

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Keypoint pseudo boxes")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--margin", type=float, default=0.1,
                   help="relative expansion of the keypoint bbox")
    return p.parse_args(argv)


def pseudo_boxes(data: dict, margin: float = 0.1) -> int:
    """Rewrite ``bbox`` and ``area`` of every annotation with a visible
    keypoint, in place; returns how many."""
    n = 0
    for ann in data.get("annotations", []):
        k = np.asarray(ann.get("keypoints", []), np.float32).reshape(-1, 3)
        vis = k[:, 2] > 0
        if not vis.any():
            continue
        x0, y0 = k[vis, 0].min(), k[vis, 1].min()
        x1, y1 = k[vis, 0].max(), k[vis, 1].max()
        w, h = x1 - x0, y1 - y0
        mx, my = w * margin, h * margin
        ann["bbox"] = [float(x0 - mx), float(y0 - my),
                       float(w + 2 * mx), float(h + 2 * my)]
        ann["area"] = float((w + 2 * mx) * (h + 2 * my))
        n += 1
    return n


def main(argv=None) -> int:
    args = parse_args(argv)
    with open(args.input) as f:
        data = json.load(f)
    n = pseudo_boxes(data, args.margin)
    with open(args.output, "w") as f:
        json.dump(data, f)
    print(f"rewrote {n} boxes -> {args.output}")
    return n


if __name__ == "__main__":
    main()
