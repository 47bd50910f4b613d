"""Evaluate a checkpoint on a dataset (as ``tools/test.py`` of the JAX
package: keypoint models, and the single-image models SOIT, DK-DETR and
InsPose).

    python -m pavenet_tpu_torch.tools.test <config.py> <checkpoint>
        [--eval keypoints] [--out dets.json] [--format-only]
        [--flip-test] [--aug-scales 1.0 0.75 ...]
        [--dtype f32|bf16] [--device cuda|cpu] [--dist-backend nccl|gloo]
        [--cfg-options k=v ...]

    # one process per card
    pavenet_tpu_torch/tools/dist_test.sh <config.py> <checkpoint> <GPUS>

``data.test`` through the test pipeline with the uint8 feed normalised on
the card (unless ``test_pipeline_kwargs`` sets ``normalize_on_device``
False), the checkpoint's model weights (a port checkpoint ``step_N.pt``,
or a reference ``.pth`` converted by ``utils/reference_convert.py``:
``apis/inference.py::load_checkpoint``), ``run_inference`` (with
``--flip-test`` the flip merge, with ``--aug-scales`` one pass per scale
and flip, merged), then ``--out`` and the keypoint metrics. ``main(argv)``
returns the metrics and the loop's timing.

Under a launcher (``parallel/dist.py``) each rank runs its shard of the
dataset, the detections are gathered in rank order
(``gather_detections``), and rank 0 writes ``--out`` and evaluates; the
other ranks return ``metrics`` None.

A single-image model (SOIT, DK-DETR, InsPose) takes host-normalised single
images (``normalize_on_device`` stays off unless the config sets it),
DK-DETR the class embeddings of ``model.text_encoder.text_feat_path`` (one
row per class of the dataset), keeps the detections of
``test_cfg.score_thr`` (default 0.05) and up, writes ``--out`` without the
masks, and evaluates box and mask AP or the dataset's own protocol (LVIS,
VOC mAP); InsPose's detections are boxes (its keypoints' extent and
soft-NMS score), evaluated as box AP, as the JAX CLI evaluates them;
``--flip-test`` and ``--aug-scales`` are for keypoint models.

Not here: ``--show``, ``--show-dir``, ``--show-score-thr``,
``--show-wait``, ``--compile-cache``.
"""
from __future__ import annotations

import argparse
import json
import os

from pavenet_tpu_torch.tools.train import add_dist_args


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Test a pose or detection model",
        epilog="Not ported: --show, --show-dir, --show-score-thr, "
               "--show-wait, --compile-cache.")
    p.add_argument("config")
    p.add_argument("checkpoint")
    p.add_argument("--eval", default="keypoints", choices=["keypoints"],
                   help="a keypoint model's metric (a detection model is "
                        "evaluated by its dataset's protocol)")
    p.add_argument("--flip-test", action="store_true",
                   help="merge each clip's detections with its horizontal "
                        "flip's (box NMS)")
    p.add_argument("--aug-scales", type=float, nargs="+", default=None,
                   help="multi-scale test-time augmentation ratios, merged "
                        "by box NMS (with --flip-test: scales x flip)")
    p.add_argument("--out", default=None, help="dump detections json")
    p.add_argument("--format-only", action="store_true",
                   help="dump --out without evaluating")
    p.add_argument("--dtype", default="auto", choices=["auto", "f32", "bf16"],
                   help="activation dtype ('auto' follows the config's "
                        "act_dtype)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (under a launcher the rank's own card), "
                        "'cuda:N' or 'cpu'")
    add_dist_args(p)
    p.add_argument("--cfg-options", nargs="+", default=[])
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    import torch
    from pavenet_tpu_torch.parallel import dist
    from pavenet_tpu_torch.tools.train import load_config, start_ranks

    cfg = load_config(args.config, args.cfg_options)
    if str(args.device).startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device (pass --device cpu "
                         "to test on the CPU)")
    device, owns_group = start_ranks(args)
    try:
        return _test(args, cfg, device)
    finally:
        if owns_group:
            dist.destroy()


def _test(args, cfg, device) -> dict:
    from pavenet_tpu_torch.apis.inference import init_detector
    from pavenet_tpu_torch.apis.test import (evaluate_dataset,
                                             gather_detections,
                                             run_det_inference,
                                             run_inference)
    from pavenet_tpu_torch.datasets import ClipLoader
    from pavenet_tpu_torch.datasets.pipelines import build_test_pipeline
    from pavenet_tpu_torch.models.detectors import (InsPoseDetector,
                                                    SOITDetector)
    from pavenet_tpu_torch.models.text_encoder import PseudoTextEncoder
    from pavenet_tpu_torch.parallel import dist
    from pavenet_tpu_torch.tools.train import (build_dataset,
                                               eval_pipeline_kwargs,
                                               rank_logger)

    logger = rank_logger(None)
    model = init_detector(cfg, device=device, dtype=args.dtype,
                          checkpoint=args.checkpoint)
    is_det = isinstance(model, (SOITDetector, InsPoseDetector))
    if is_det:
        if args.flip_test or args.aug_scales:
            raise SystemExit("--flip-test and --aug-scales are for keypoint "
                             "models")
        kwargs = dict(cfg.get("test_pipeline_kwargs", {}) or {})
        img_norm = eval_pipeline_kwargs(cfg)[1]
    else:
        kwargs, img_norm = eval_pipeline_kwargs(cfg)
    dataset = build_dataset(cfg, "test", build_test_pipeline(**kwargs))
    loader = ClipLoader(dataset, batch_size=1, shuffle=False,
                        drop_last=False, num_keypoints=dataset.NUM_KEYPOINTS,
                        num_shards=dist.world_size(),
                        shard_index=dist.rank())
    timing = {}
    if is_det:
        text_feats = None
        text_cfg = cfg.model.get("text_encoder") or {}
        if text_cfg.get("text_feat_path"):
            text_feats = PseudoTextEncoder(
                text_cfg["text_feat_path"],
                text_cfg.get("text_dim", 512)).get_text_feat()
            logger.info(f"text embeddings: {text_cfg['text_feat_path']} "
                        f"{text_feats.shape}")
        detections = gather_detections(run_det_inference(
            model, loader, (cfg.model.get("test_cfg") or {}).get(
                "score_thr", 0.05), text_feats=text_feats, logger=logger,
            img_norm=img_norm, timing=timing))
        dump = [{k: v for k, v in d.items() if k != "segmentation"}
                for d in detections]
    else:
        detections = gather_detections(run_inference(
            model, loader, logger=logger, img_norm=img_norm, timing=timing,
            flip_test=args.flip_test, aug_scales=args.aug_scales))
        dump = detections
    if not dist.is_main():
        return dict(metrics=None, detections=len(detections),
                    checkpoint=os.path.abspath(args.checkpoint), **timing)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dump, f)
        logger.info(f"wrote {len(detections)} detections to {args.out}")
    metrics = None
    if not args.format_only:
        metrics = evaluate_dataset(dataset, detections)
        for k, v in metrics.items():
            logger.info(f"{k}: {v:.4f}")
    return dict(metrics=metrics, detections=len(detections),
                checkpoint=os.path.abspath(args.checkpoint), **timing)


if __name__ == "__main__":
    main()
