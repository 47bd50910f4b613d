"""Evaluate a checkpoint on a dataset (as ``tools/test.py`` of the JAX
package: keypoint models, and the single-image models SOIT, DK-DETR and
InsPose).

    python -m pavenet_tpu_torch.tools.test <config.py> <checkpoint>
        [--eval keypoints] [--out dets.json] [--format-only]
        [--flip-test] [--aug-scales 1.0 0.75 ...]
        [--show] [--show-dir DIR] [--show-score-thr S] [--show-wait MS]
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

``--show-dir`` draws each test image's detections onto its source image
(``utils/visualize.py::render_detections``: skeletons, or boxes with their
class names and masks) and writes it under the image's path relative to
the dataset's ``img_prefix``;
``--show`` shows them in a window, and without a ``DISPLAY`` warns and
goes on. Rank 0 renders, after the gather, from the detections as they
come, masks included (``--out`` drops them).

Left out, as the JAX CLI's TPU-only option: ``--compile-cache``.
"""
from __future__ import annotations

import argparse
import json
import os
import time

from pavenet_tpu_torch.tools.train import add_dist_args


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Test a pose or detection model",
        epilog="Left out (TPU-only): --compile-cache.")
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
    p.add_argument("--show", action="store_true",
                   help="show the rendered detections in a window (needs a "
                        "DISPLAY; without one it warns and goes on)")
    p.add_argument("--show-dir", default=None,
                   help="write the detections drawn onto the source images "
                        "here")
    p.add_argument("--show-score-thr", type=float, default=0.3,
                   help="score threshold of --show and --show-dir")
    p.add_argument("--show-wait", type=int, default=0,
                   help="--show's wait per image in ms (0: until a key)")
    p.add_argument("--dtype", default="auto", choices=["auto", "f32", "bf16"],
                   help="activation dtype ('auto' follows the config's "
                        "act_dtype)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (under a launcher the rank's own card), "
                        "'cuda:N' or 'cpu'")
    add_dist_args(p)
    p.add_argument("--cfg-options", nargs="+", default=[])
    return p.parse_args(argv)


def show_results(dataset, detections, show_dir, score_thr, logger,
                 show=False, wait=0) -> int:
    """Render each image's detections (``--show-dir``, ``--show``):
    grouped by ``image_id``, the source image from ``dataset.img_prefix``
    and ``data_infos``, the class names from ``dataset.CLASSES``, written
    under ``show_dir`` at the image's path relative to ``img_prefix`` (the
    reference's ``ori_filename``: video frames share base names); a
    missing image is warned about and skipped. Returns the images
    rendered."""
    from pavenet_tpu_torch.utils.visualize import render_detections
    if show_dir:
        os.makedirs(show_dir, exist_ok=True)
    if show and not os.environ.get("DISPLAY"):
        logger.warning("--show: no DISPLAY available (headless): skipping "
                       "the window; use --show-dir")
        show = False
    by_img = {}
    for d in detections:
        by_img.setdefault(d["image_id"], []).append(d)
    infos = {info["id"]: info for info in dataset.data_infos}
    class_names = getattr(dataset, "CLASSES", None)
    n = 0
    for img_id, dets in by_img.items():
        info = infos.get(img_id)
        if info is None:
            continue
        src = os.path.join(dataset.img_prefix, info["file_name"])
        out_file = None
        if show_dir:
            out_file = os.path.join(show_dir, info["file_name"])
            os.makedirs(os.path.dirname(out_file), exist_ok=True)
        try:
            rendered = render_detections(
                src, dets, score_thr=score_thr, out_file=out_file,
                class_names=class_names)
            n += 1
        except FileNotFoundError:
            logger.warning(f"show: missing source image {src}")
            continue
        if show:
            import cv2
            cv2.imshow("pavenet", rendered)
            if cv2.waitKey(wait) & 0xFF in (27, ord("q")):
                show = False
                cv2.destroyAllWindows()
    if show:
        import cv2
        cv2.destroyAllWindows()
    if show_dir:
        logger.info(f"rendered {n} images to {show_dir}")
    return n


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
    if args.show_dir or args.show:
        t0 = time.perf_counter()
        timing["rendered"] = show_results(
            dataset, detections, args.show_dir, args.show_score_thr, logger,
            show=args.show, wait=args.show_wait)
        timing["render_s"] = time.perf_counter() - t0
    metrics = None
    if not args.format_only:
        metrics = evaluate_dataset(dataset, detections)
        for k, v in metrics.items():
            logger.info(f"{k}: {v:.4f}")
    return dict(metrics=metrics, detections=len(detections),
                checkpoint=os.path.abspath(args.checkpoint), **timing)


if __name__ == "__main__":
    main()
