"""Evaluation loop (as ``pavenet_tpu/apis/test.py``): inference over a
dataset's loader, detections as COCO-style dicts, and the keypoint
evaluators.

``run_inference``: each batch's image (uint8 or float) goes to the card,
is normalised there (``apis/prep.py``), runs ``forward_test`` (or, with
``flip_test``, ``forward_test_flip``; with ``aug_scales``, one
``forward_test_aug`` pass per scale and flip, each scale resized on the
host by ``_rescale_batch`` before the card normalises it, merged by
``merge_aug_detections``), and the detections the NMS keeps become dicts.
``evaluate_dataset`` adds MOTA where every detection has a ``track_id``.

``run_det_inference`` is the detection and instance-segmentation loop
(SOIT, DK-DETR): host-normalised single images, DK-DETR's ``text_feats``
beside them, and COCO-style dicts with an xywh ``bbox`` and a binary
``segmentation`` of the original image; ``evaluate_dataset`` gives those
COCO box and mask AP, or the dataset's own protocol (LVIS, VOC).
Left out: the packed fetch and its double buffering (a remote-device
workaround).
"""
from __future__ import annotations

import time
from collections import OrderedDict
from typing import List, Optional

import numpy as np
import torch

from ..datasets.pipelines.transforms import DEFAULT_BUCKETS
from .prep import IMG_NORM_MEAN, IMG_NORM_STD
from .train import model_feed

FEED_KEYS = ("img", "img_shape", "scale_factor")


def _rescale_batch(batch, ratio: float) -> dict:
    """Multi-scale test-time augmentation on the host: each sample's valid
    region resized by ``ratio`` (cv2 ``INTER_LINEAR``, in the batch's own
    dtype, uint8 for the uint8 feed) into the smallest bucket of
    ``DEFAULT_BUCKETS`` that holds every resized sample; ``img_shape`` and
    ``scale_factor`` scaled with it."""
    import cv2
    if ratio == 1.0:
        return batch
    img = np.asarray(batch["img"])                  # (B, T, H, W, 3)
    shapes = np.asarray(batch["img_shape"])
    new_shapes = np.maximum((shapes * ratio).round().astype(np.int32), 1)
    nh_max, nw_max = new_shapes.max(0)
    for bh, bw in sorted(DEFAULT_BUCKETS, key=lambda b: b[0] * b[1]):
        if bh >= nh_max and bw >= nw_max:
            break
    else:
        raise ValueError(f"scaled image {nh_max}x{nw_max} exceeds buckets")
    out = np.zeros(img.shape[:2] + (bh, bw, 3), img.dtype)
    for b in range(img.shape[0]):
        ih, iw = shapes[b]
        nh, nw = new_shapes[b]
        for t in range(img.shape[1]):
            out[b, t, :nh, :nw] = cv2.resize(
                img[b, t, :ih, :iw], (int(nw), int(nh)),
                interpolation=cv2.INTER_LINEAR)
    return dict(batch, img=out, img_shape=new_shapes,
                scale_factor=np.asarray(batch["scale_factor"]) * ratio)


def _infer(model, feed, device, img_norm, flip_test, aug_scales):
    """One batch's padded detections: ``forward_test``,
    ``forward_test_flip``, or the multi-scale passes merged."""
    if aug_scales:
        flips = (False, True) if flip_test else (False,)
        outs = []
        for r in aug_scales:
            fb = model_feed(_rescale_batch(feed, float(r)), device, img_norm)
            outs.extend(model.forward_test_aug(fb, flip=f) for f in flips)
        return model.merge_aug_detections(outs)
    feed = model_feed(feed, device, img_norm)
    return (model.forward_test_flip(feed) if flip_test
            else model.forward_test(feed))


def _inference_loop(model, loader, infer, decode, timing, logger,
                    unit: str) -> List[dict]:
    """The loop of both inference paths, in eval mode: ``infer(batch)``
    gives a batch's padded outputs on the device, ``decode(batch, out, b)``
    the detection dicts of its valid row ``b`` from those outputs on the
    host. ``timing`` and the log line as ``run_inference`` says; ``unit``
    names a row ("clip", "image")."""
    was_training = model.training
    model.eval()
    detections: List[dict] = []
    t_total, t_first, n_rows, n_steady = 0.0, None, 0, 0
    t0 = time.perf_counter()
    try:
        for batch in loader:
            with torch.inference_mode():
                out = infer(batch)
            out = {k: v.float().cpu().numpy() if v.is_floating_point()
                   else v.cpu().numpy() for k, v in out.items()}
            n = len(batch["img"])
            row_valid = batch.get("_row_valid", np.ones(n, bool))
            for b in range(n):
                if row_valid[b]:
                    detections.extend(decode(batch, out, b))
            dt, t0 = time.perf_counter() - t0, time.perf_counter()
            if t_first is None:
                t_first = dt
            else:
                t_total += dt
                n_steady += n
            n_rows += n
    finally:
        model.train(was_training)
    steady = (t_total / n_steady * 1e3 if n_steady
              else (t_first or 0.0) * 1e3)
    if timing is not None:
        timing.update(clips=n_rows, first_clip_s=t_first or 0.0,
                      ms_per_clip=steady)
    if logger is not None and n_rows:
        logger.info(f"inference: {n_rows} {unit}s, {len(detections)} "
                    f"detections, {steady:.1f} ms/{unit} steady-state "
                    f"(incl. host; first {unit} {t_first:.1f}s)")
    return detections


def run_inference(model, loader, score_thr: float = 0.0, logger=None,
                  img_norm=(IMG_NORM_MEAN, IMG_NORM_STD),
                  timing: Optional[dict] = None, flip_test: bool = False,
                  aug_scales=None) -> List[dict]:
    """COCO-style keypoint detections (image_id, category_id, keypoints
    with the per-joint score in the v slot, score) of ``model`` over
    ``loader``, in eval mode; repeat-padded rows (``_row_valid`` False) and
    scores under ``score_thr`` are left out.

    ``flip_test`` merges each clip's detections with its flip's by box NMS;
    ``aug_scales`` (ratios) runs one pass per scale (and per flip with
    ``flip_test``) and merges them. A single ratio of 1.0 is no
    multi-scale test.

    ``timing``, when given, receives ``clips``, ``first_clip_s`` (the first
    batch, warm-up included) and ``ms_per_clip`` (the rest, host pipeline
    included: loader wait, copy, model and host decoding)."""
    device = next(model.parameters()).device
    if aug_scales and len(aug_scales) == 1 and float(aug_scales[0]) == 1.0:
        aug_scales = None

    def infer(batch):
        return _infer(model, {k: batch[k] for k in FEED_KEYS}, device,
                      img_norm, flip_test, aug_scales)

    def decode(batch, out, b):
        kpts = out["det_kpts"][b]
        scores = out["det_bboxes"][b, :, 4]
        return [dict(image_id=int(batch["image_id"][b]), category_id=1,
                     keypoints=kpts[m].reshape(-1).astype(float).tolist(),
                     score=float(scores[m]))
                for m in np.where(out["keep"][b])[0]
                if scores[m] >= score_thr]

    return _inference_loop(model, loader, infer, decode, timing, logger,
                           "clip")


def run_det_inference(model, loader, score_thr: float = 0.05,
                      mask_thr: float = 0.5, text_feats=None, logger=None,
                      img_norm=(IMG_NORM_MEAN, IMG_NORM_STD),
                      timing: Optional[dict] = None) -> List[dict]:
    """COCO-style detections (image_id, category_id = label + 1, ``bbox``
    xywh, score, ``segmentation``) of a detection model over ``loader``
    (T=1 batches; a uint8 image normalised on the card with ``img_norm``),
    in eval mode; rows under ``score_thr`` and repeat-padded rows are left
    out. ``text_feats`` (C', D) goes with every batch (DK-DETR). A mask,
    predicted over the padded input at half its resolution, is cropped to
    the valid region, resized to the original image (cv2 ``INTER_LINEAR``)
    and thresholded at ``mask_thr``. ``timing`` as in ``run_inference``,
    per image."""
    import cv2
    device = next(model.parameters()).device
    tf = (None if text_feats is None
          else torch.as_tensor(np.asarray(text_feats, np.float32),
                               device=device))

    def infer(batch):
        feed = model_feed({k: batch[k] for k in FEED_KEYS}, device, img_norm)
        feed["img"] = feed["img"][:, 0]
        if tf is not None:
            feed["text_feats"] = tf
        return model.forward_test(feed)

    def decode(batch, out, b):
        pad_h, pad_w = np.asarray(batch["img"]).shape[-3:-1]
        scores = out["det_bboxes"][b, :, 4]
        sf = np.asarray(batch["scale_factor"][b])
        ih, iw = np.asarray(batch["img_shape"][b])
        ori_w, ori_h = int(round(iw / sf[0])), int(round(ih / sf[1]))
        dets = []
        for m in np.where(scores >= score_thr)[0]:
            x1, y1, x2, y2 = out["det_bboxes"][b, m, :4]
            mk = out["det_masks"][b, m]
            h2 = int(np.ceil(ih / (pad_h / mk.shape[0])))
            w2 = int(np.ceil(iw / (pad_w / mk.shape[1])))
            mk = cv2.resize(mk[:h2, :w2].astype(np.float32), (ori_w, ori_h),
                            interpolation=cv2.INTER_LINEAR)
            dets.append(dict(
                image_id=int(batch["image_id"][b]),
                category_id=int(out["det_labels"][b, m]) + 1,
                bbox=[float(x1), float(y1), float(x2 - x1), float(y2 - y1)],
                score=float(scores[m]), segmentation=mk >= mask_thr))
        return dets

    return _inference_loop(model, loader, infer, decode, timing, logger,
                           "image")


def evaluate_detections(dataset, detections: List[dict]) -> "OrderedDict":
    """Box (and, where the detections carry masks, mask) metrics: the
    dataset's own ``evaluate_detections`` where it has one (LVIS, VOC),
    else COCO AP as ``bbox/...`` and ``segm/...``."""
    from ..core.eval.coco_det_eval import COCODetEval
    if hasattr(dataset, "evaluate_detections"):
        return dataset.evaluate_detections(detections)
    results = OrderedDict()
    dt = dataset.coco.load_res(detections)
    iou_types = ("bbox", "segm") if "segmentation" in detections[0] \
        else ("bbox",)
    for iou_type in iou_types:
        res = COCODetEval(dataset.coco, dt, iou_type=iou_type).evaluate()
        results.update({f"{iou_type}/{k}": v for k, v in res.items()})
    return results


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
                     metric: str = "keypoints",
                     max_dets: int = 30) -> "OrderedDict":
    """Metrics of ``detections`` on ``dataset``: a detection model's
    (detections without ``keypoints``) by ``evaluate_detections``; else the
    keypoint metrics (``metric`` 'keypoints', the only one of a pose
    model): COCO OKS AP as
    ``coco/...``; for CrowdPose its protocol alone, as
    ``keypoints_AP``, ``keypoints_AP(E)``, ``keypoints_AP(M)``,
    ``keypoints_AP(H)`` and the rest; for PoseTrack the per-joint AP as
    ``posetrack/...``, and MOTA, MOTP, precision and recall beside it when
    every detection carries a ``track_id`` (from a tracker outside the
    model)."""
    from ..core.eval.coco_keypoint_eval import (COCOKeypointEval,
                                                CrowdPoseKeypointEval)
    from ..core.eval.posetrack_eval import (evaluate_posetrack_ap,
                                            frames_from_coco)
    from ..models.losses.oks_loss import OKS_SIGMAS

    if detections and "keypoints" not in detections[0]:
        return evaluate_detections(dataset, detections)
    if metric != "keypoints":
        raise ValueError(f"metric {metric!r}: a pose model is evaluated "
                         "by 'keypoints'")
    results = OrderedDict()
    protocol = getattr(dataset, "EVAL_PROTOCOL", "coco")
    if detections:
        dt = dataset.coco.load_res(detections)
        sigmas = OKS_SIGMAS.get(getattr(dataset, "NUM_KEYPOINTS", 17))
        if protocol == "crowdpose":
            crowd = CrowdPoseKeypointEval(dataset.coco, dt,
                                          sigmas=sigmas).evaluate()
            results.update({f"keypoints_{k}": v for k, v in crowd.items()})
            return results
        coco = COCOKeypointEval(dataset.coco, dt, sigmas=sigmas,
                                max_dets=max_dets).evaluate()
        results.update({f"coco/{k}": v for k, v in coco.items()})
    if protocol == "posetrack":
        frames = frames_from_coco(dataset.coco, detections,
                                  max_dets=max_dets)
        pt = evaluate_posetrack_ap(frames)
        for k, v in pt.items():
            if k != "per_joint":
                results[f"posetrack/{k}"] = v
        if detections and all("track_id" in d for d in detections):
            from ..core.eval.posetrack_track_eval import (
                evaluate_posetrack_mota)
            mot = evaluate_posetrack_mota(
                frames, [fr["seq_id"] for fr in frames])
            for k, v in mot.items():
                if k != "mota_per_joint":
                    results[f"posetrack/{k}"] = v
    return results
