"""One image or clip through a pose model, its skeletons drawn onto the
middle frame (as ``demo/image_demo.py`` of the JAX package).

    python -m pavenet_tpu_torch.demo.image_demo IMG [IMG ...] CONFIG CHECKPOINT
        [--out-file demo_result.jpg] [--score-thr 0.3] [--device cuda|cpu]

One image for PETR, one per frame for a video model (a single image is
repeated over the frames). ``CHECKPOINT`` is a port checkpoint
(``step_N.pt``) or a reference ``.pth``. Pose models only, as in JAX.
``main(argv)`` returns the poses drawn and the output file.
"""
from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Pose demo on one image or clip")
    p.add_argument("img", nargs="+",
                   help="image path (1 for PETR, T for video models)")
    p.add_argument("config")
    p.add_argument("checkpoint")
    p.add_argument("--out-file", default="demo_result.jpg")
    p.add_argument("--score-thr", type=float, default=0.3)
    p.add_argument("--device", default="cuda", help="'cuda', 'cuda:N' or "
                   "'cpu'")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    import cv2
    import numpy as np
    import torch
    from pavenet_tpu_torch.apis.inference import (inference_detector,
                                                  init_detector)
    from pavenet_tpu_torch.utils.visualize import draw_poses

    if str(args.device).startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device (pass --device cpu "
                         "to run on the CPU)")
    model = init_detector(args.config, device=args.device,
                          checkpoint=args.checkpoint)
    out = inference_detector(model, args.img if len(args.img) > 1
                             else args.img[0])
    keep = np.asarray(out["keep"])
    kpts = np.asarray(out["det_kpts"])[keep]
    scores = np.asarray(out["det_bboxes"])[keep][:, 4]
    img = cv2.imread(args.img[len(args.img) // 2])
    if img is None:
        raise FileNotFoundError(args.img[len(args.img) // 2])
    img = draw_poses(img, kpts, scores, args.score_thr)
    cv2.imwrite(args.out_file, img)
    poses = int((scores >= args.score_thr).sum())
    print(f"{poses} poses -> {args.out_file}")
    return dict(poses=poses, out_file=args.out_file)


if __name__ == "__main__":
    main()
