"""Pascal VOC box mAP (as ``pavenet_tpu/core/eval/voc_eval.py``, mmdet's
``eval_map``): per class greedy matching at one IoU threshold, difficult GT
ignored (a match to one is neither a true nor a false positive), AP by the
VOC2007 11-point metric or the area under the precision envelope.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


def _iou_xyxy(det: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """(D,4) x (G,4) xyxy IoU matrix."""
    if len(det) == 0 or len(gt) == 0:
        return np.zeros((len(det), len(gt)))
    x1 = np.maximum(det[:, None, 0], gt[None, :, 0])
    y1 = np.maximum(det[:, None, 1], gt[None, :, 1])
    x2 = np.minimum(det[:, None, 2], gt[None, :, 2])
    y2 = np.minimum(det[:, None, 3], gt[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    a_d = (det[:, 2] - det[:, 0]) * (det[:, 3] - det[:, 1])
    a_g = (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1])
    return inter / np.maximum(a_d[:, None] + a_g[None, :] - inter,
                              np.spacing(1))


def _average_precision(recalls: np.ndarray, precisions: np.ndarray,
                       use_07_metric: bool) -> float:
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.01, 0.1):
            prec = precisions[recalls >= t]
            ap += (prec.max() if prec.size else 0.0) / 11.0
        return float(ap)
    mrec = np.concatenate([[0.0], recalls, [1.0]])
    mpre = np.concatenate([[0.0], precisions, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def eval_voc_map(gts: Sequence[dict], detections: List[dict],
                 num_classes: int, iou_thr: float = 0.5,
                 use_07_metric: bool = True) -> float:
    """gts: per-image dicts with ``bboxes`` (G,4 xyxy), ``labels`` (G,),
    ``difficult`` (G,) bool.  detections: dicts with ``image_id`` (index
    into gts), ``bbox`` (xywh), ``score``, ``category_id`` (label+1).
    Returns mAP over classes that have GT or detections."""
    dets_by = [[[] for _ in range(num_classes)] for _ in gts]
    for d in detections:
        c = int(d["category_id"]) - 1
        if 0 <= c < num_classes:
            x, y, w, h = d["bbox"]
            dets_by[int(d["image_id"])][c].append(
                [x, y, x + w, y + h, d.get("score", 0.0)])

    aps = []
    for c in range(num_classes):
        scores, tps, fps = [], [], []
        num_gt = 0
        any_det = False
        for i, gt in enumerate(gts):
            sel = np.asarray(gt["labels"]) == c
            boxes = np.asarray(gt["bboxes"], float).reshape(-1, 4)[sel]
            diff = np.asarray(gt.get("difficult",
                                     np.zeros(len(sel), bool)))[sel]
            num_gt += int((~diff).sum())
            det = np.asarray(dets_by[i][c], float).reshape(-1, 5)
            if len(det) == 0:
                continue
            any_det = True
            det = det[np.argsort(-det[:, 4], kind="mergesort")]
            # mmdet tpfp_default: match real GT first; detections whose
            # only >=thr overlap is a difficult (ignored) GT are neither
            # TP nor FP
            real = _iou_xyxy(det[:, :4], boxes[~diff])
            ign = _iou_xyxy(det[:, :4], boxes[diff])
            covered = np.zeros(int((~diff).sum()), bool)
            for k in range(len(det)):
                scores.append(det[k, 4])
                j = real[k].argmax() if real.shape[1] else -1
                if j >= 0 and real[k, j] >= iou_thr:
                    if not covered[j]:
                        covered[j] = True
                        tps.append(1)
                        fps.append(0)
                    else:
                        tps.append(0)
                        fps.append(1)
                elif ign.shape[1] and ign[k].max() >= iou_thr:
                    tps.append(0)
                    fps.append(0)
                else:
                    tps.append(0)
                    fps.append(1)
        if num_gt == 0 and not any_det:
            continue
        if num_gt == 0:
            aps.append(0.0)
            continue
        order = np.argsort(-np.asarray(scores), kind="mergesort")
        tp = np.cumsum(np.asarray(tps)[order])
        fp = np.cumsum(np.asarray(fps)[order])
        recalls = tp / num_gt
        precisions = tp / np.maximum(tp + fp, np.spacing(1))
        aps.append(_average_precision(recalls, precisions, use_07_metric))
    return float(np.mean(aps)) if aps else 0.0
