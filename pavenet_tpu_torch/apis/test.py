"""Evaluation loop (as ``pavenet_tpu/apis/test.py``): inference over a
dataset's loader, detections as COCO-style dicts, and the keypoint
evaluators.

``run_inference`` is the JAX package's single-scale path without flip:
each batch's image (uint8 or float) goes to the card, is normalised there
(``apis/prep.py``), runs ``forward_test``, and the detections the NMS keeps
become dicts. Left out: the packed fetch and its double buffering (a
remote-device workaround), flip and multi-scale test-time augmentation,
the detection and instance-segmentation branch, and MOTA.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from typing import List, Optional

import numpy as np
import torch

from .prep import IMG_NORM_MEAN, IMG_NORM_STD
from .train import model_feed


def run_inference(model, loader, score_thr: float = 0.0, logger=None,
                  img_norm=(IMG_NORM_MEAN, IMG_NORM_STD),
                  timing: Optional[dict] = None) -> List[dict]:
    """COCO-style keypoint detections (image_id, category_id, keypoints
    with the per-joint score in the v slot, score) of ``model`` over
    ``loader``, in eval mode; repeat-padded rows (``_row_valid`` False) and
    scores under ``score_thr`` are left out.

    ``timing``, when given, receives ``clips``, ``first_clip_s`` (the first
    batch, warm-up included) and ``ms_per_clip`` (the rest, host pipeline
    included: loader wait, copy, model and host decoding)."""
    device = next(model.parameters()).device
    was_training = model.training
    model.eval()
    detections: List[dict] = []
    t_total, t_first, n_clips, n_steady = 0.0, None, 0, 0
    t0 = time.perf_counter()
    try:
        for batch in loader:
            with torch.inference_mode():
                out = model.forward_test(model_feed(
                    {k: batch[k] for k in ("img", "img_shape",
                                           "scale_factor")},
                    device, img_norm))
            out = {k: v.float().cpu().numpy() if v.is_floating_point()
                   else v.cpu().numpy() for k, v in out.items()}
            n = len(batch["img"])
            row_valid = batch.get("_row_valid", np.ones(n, bool))
            for b in range(n):
                if not row_valid[b]:
                    continue
                kpts = out["det_kpts"][b]
                scores = out["det_bboxes"][b, :, 4]
                for m in np.where(out["keep"][b])[0]:
                    if scores[m] < score_thr:
                        continue
                    detections.append(dict(
                        image_id=int(batch["image_id"][b]),
                        category_id=1,
                        keypoints=kpts[m].reshape(-1).astype(float).tolist(),
                        score=float(scores[m])))
            dt, t0 = time.perf_counter() - t0, time.perf_counter()
            if t_first is None:
                t_first = dt
            else:
                t_total += dt
                n_steady += n
            n_clips += n
    finally:
        model.train(was_training)
    steady = (t_total / n_steady * 1e3 if n_steady
              else (t_first or 0.0) * 1e3)
    if timing is not None:
        timing.update(clips=n_clips, first_clip_s=t_first or 0.0,
                      ms_per_clip=steady)
    if logger is not None and n_clips:
        logger.info(f"inference: {n_clips} clips, {steady:.1f} ms/clip "
                    f"steady-state (incl. host; first clip {t_first:.1f}s)")
    return detections


def gather_detections(detections: List[dict]) -> List[dict]:
    """Detections of every process of an initialised ``torch.distributed``
    group, in rank order; with one process, ``detections`` itself."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return detections
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, detections)
    return [d for part in gathered for d in part]


def evaluate_dataset(dataset, detections: List[dict],
                     max_dets: int = 30) -> "OrderedDict":
    """Keypoint metrics of ``detections`` on ``dataset``: COCO OKS AP as
    ``coco/...``, and for PoseTrack the per-joint AP as ``posetrack/...``.
    (The port has no dataset of the CrowdPose protocol yet.)"""
    from ..core.eval.coco_keypoint_eval import COCOKeypointEval
    from ..core.eval.posetrack_eval import (evaluate_posetrack_ap,
                                            frames_from_coco)
    from ..models.losses.oks_loss import OKS_SIGMAS

    results = OrderedDict()
    if detections:
        coco = COCOKeypointEval(
            dataset.coco, dataset.coco.load_res(detections),
            sigmas=OKS_SIGMAS.get(getattr(dataset, "NUM_KEYPOINTS", 17)),
            max_dets=max_dets).evaluate()
        results.update({f"coco/{k}": v for k, v in coco.items()})
    if getattr(dataset, "EVAL_PROTOCOL", "coco") == "posetrack":
        pt = evaluate_posetrack_ap(frames_from_coco(
            dataset.coco, detections, max_dets=max_dets))
        for k, v in pt.items():
            if k != "per_joint":
                results[f"posetrack/{k}"] = v
    return results
