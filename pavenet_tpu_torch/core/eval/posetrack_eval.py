"""PoseTrack per-joint AP (as ``pavenet_tpu/core/eval/posetrack_eval.py``,
a port of poseval's ``evaluateAP``) on arrays.

Per frame, greedy pose assignment by PCKh (a joint matches when
``dist / headSize <= 0.5``, ``headSize = 0.6 * |(x2,y2)-(x1,y1)|`` of the
GT head box; each prediction keeps its best-PCK GT, each GT takes its
argmax prediction); matched predictions give per-joint (score, correct)
samples, unmatched ones negatives; AP per joint as the area under the
precision envelope, reported as Head, Shoulder, Elbow, Wrist, Hip, Knee,
Ankle and Mean. ``frames_from_coco`` builds the frames from a COCO index
and detections with the protocol's cap of ``max_dets`` per image, its drop
of frames without annotated GT and its removal of points in ignore
regions.

Joint order is the COCO-PoseTrack 15-keypoint order (nose, head_bottom,
head_top, L/R shoulder, elbow, wrist, hip, knee, ankle).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np

# report groups in COCO-PoseTrack indices
_GROUPS = OrderedDict([
    ("Head", (0, 1, 2)),            # nose, head_bottom(neck), head_top
    ("Shoulder", (3, 4)),
    ("Elbow", (5, 6)),
    ("Wrist", (7, 8)),
    ("Hip", (9, 10)),
    ("Knee", (11, 12)),
    ("Ankle", (13, 14)),
])

NUM_JOINTS = 15


def _voc_ap(recall: np.ndarray, precision: np.ndarray) -> float:
    """poseval ``VOCap``: area under the monotone precision envelope."""
    mpre = np.concatenate([[0.0], precision, [0.0]])
    mrec = np.concatenate([[0.0], recall, [1.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0] + 1
    return float(np.sum((mrec[idx] - mrec[idx - 1]) * mpre[idx]))


def _match_frame(gt_points, gt_head_boxes, pr_points, pr_scores, pr_valid,
                 dist_thresh: float = 0.5):
    """One frame of ``assignGTmulti``.

    gt_points: (G, J, 3) xyv (v>0 = annotated); gt_head_boxes: (G, 4);
    pr_points: (P, J, 2); pr_scores: (P, J); pr_valid: (P, J) bool.
    Returns (scores, labels) per joint plus per-joint GT counts.
    """
    J = NUM_JOINTS
    G = len(gt_points)
    P = len(pr_points)
    n_gt = (gt_points[..., 2] > 0).sum(0) if G else np.zeros(J, int)
    out_scores: List[List[float]] = [[] for _ in range(J)]
    out_labels: List[List[int]] = [[] for _ in range(J)]
    if P == 0:
        return out_scores, out_labels, n_gt

    if G == 0:
        for p in range(P):
            for j in range(J):
                if pr_valid[p, j]:
                    out_scores[j].append(float(pr_scores[p, j]))
                    out_labels[j].append(0)
        return out_scores, out_labels, n_gt

    head = gt_head_boxes
    head_size = 0.6 * np.linalg.norm(head[:, 2:4] - head[:, 0:2], axis=1)
    head_size = np.maximum(head_size, 1e-6)                   # (G,)
    has_gt = gt_points[..., 2] > 0                            # (G, J)
    dist = np.linalg.norm(
        pr_points[:, None, :, :] - gt_points[None, :, :, :2], axis=-1)
    dist = dist / head_size[None, :, None]                    # (P, G, J)
    feasible = pr_valid[:, None, :] & has_gt[None, :, :]
    match = (dist <= dist_thresh) & feasible                  # (P, G, J)

    n_gt_per_pose = np.maximum(has_gt.sum(1), 1)              # (G,)
    pck = match.sum(2) / n_gt_per_pose[None, :]               # (P, G)
    # keep best GT per prediction
    best_gt = pck.argmax(1)
    only_best = np.zeros_like(pck)
    only_best[np.arange(P), best_gt] = pck[np.arange(P), best_gt]
    # each GT takes its argmax prediction
    pr_to_gt = only_best.argmax(0)                            # (G,)
    pr_to_gt[only_best.max(0) == 0] = -1

    matched_pred = {int(p): int(g) for g, p in enumerate(pr_to_gt)
                    if p >= 0}
    for p in range(P):
        g = matched_pred.get(p, -1)
        for j in range(J):
            if pr_valid[p, j]:
                out_scores[j].append(float(pr_scores[p, j]))
                out_labels[j].append(
                    int(match[p, g, j]) if g >= 0 else 0)
    return out_scores, out_labels, n_gt


def evaluate_posetrack_ap(frames: Sequence[dict],
                          dist_thresh: float = 0.5) -> "OrderedDict":
    """frames: iterable of dicts with keys
    ``gt_points (G,J,3)``, ``gt_head_boxes (G,4)``,
    ``pr_points (P,J,2)``, ``pr_scores (P,J)``, ``pr_valid (P,J)``.

    Returns OrderedDict Head..Ankle, Mean (percentages), plus per-joint AP
    under key ``per_joint``.
    """
    J = NUM_JOINTS
    scores = [[] for _ in range(J)]
    labels = [[] for _ in range(J)]
    n_gt = np.zeros(J, int)
    for fr in frames:
        s, l, n = _match_frame(
            np.asarray(fr["gt_points"], np.float64).reshape(-1, J, 3),
            np.asarray(fr["gt_head_boxes"], np.float64).reshape(-1, 4),
            np.asarray(fr["pr_points"], np.float64).reshape(-1, J, 2),
            np.asarray(fr["pr_scores"], np.float64).reshape(-1, J),
            np.asarray(fr["pr_valid"], bool).reshape(-1, J),
            dist_thresh)
        for j in range(J):
            scores[j].extend(s[j])
            labels[j].extend(l[j])
        n_gt += n

    # edge semantics exactly as poseval ``computeMetrics``: no samples at
    # all -> AP stays 0 (counted in the mean); samples but zero GT ->
    # recall undefined -> NaN (excluded from the mean)
    ap = np.zeros(J)
    for j in range(J):
        sc = np.asarray(scores[j])
        lb = np.asarray(labels[j])
        if len(lb) == 0:
            continue
        if n_gt[j] == 0:
            ap[j] = np.nan
            continue
        order = np.argsort(-sc)
        lb = lb[order]
        tp = np.cumsum(lb == 1)
        recall = tp / n_gt[j]
        precision = tp / np.arange(1, len(lb) + 1)
        ap[j] = _voc_ap(recall, precision) * 100

    result = OrderedDict()
    for name, idxs in _GROUPS.items():
        vals = ap[list(idxs)]
        result[name] = float(np.nanmean(vals))
    result["Mean"] = float(np.nanmean(ap))
    result["per_joint"] = ap
    return result


def _points_in_polygon(pts: np.ndarray, poly: np.ndarray) -> np.ndarray:
    """Even-odd ray-casting point-in-polygon (interior only, matching
    shapely ``Polygon.contains`` as used by poseval's
    ``removeIgnoredPointsRects``, ``eval_helpers.py:320-341``).
    pts (N, 2), poly (V, 2) -> (N,) bool."""
    x, y = pts[:, 0], pts[:, 1]
    x0, y0 = poly[:, 0], poly[:, 1]
    x1 = np.roll(x0, -1)
    y1 = np.roll(y0, -1)
    inside = np.zeros(len(pts), bool)
    for xa, ya, xb, yb in zip(x0, y0, x1, y1):
        crosses = (ya > y) != (yb > y)
        with np.errstate(divide="ignore", invalid="ignore"):
            xint = xa + (y - ya) * (xb - xa) / (yb - ya)
        inside ^= crosses & (x < xint)
    return inside


def _ignore_polygons(info: dict) -> List[np.ndarray]:
    """PoseTrack COCO-style image records carry ignore regions as parallel
    ``ignore_regions_x`` / ``ignore_regions_y`` coordinate lists (the
    annolist GT the reference evaluates against exposes the same regions
    as ``ignore_regions``, consumed by ``removeIgnoredPoints``,
    ``eval_helpers.py:344``)."""
    xs = info.get("ignore_regions_x") or []
    ys = info.get("ignore_regions_y") or []
    polys = []
    for rx, ry in zip(xs, ys):
        if len(rx) >= 3:
            polys.append(np.stack([np.asarray(rx, np.float64),
                                   np.asarray(ry, np.float64)], -1))
    return polys


def frames_from_coco(gt_coco, detections: Sequence[dict],
                     score_thresh: float = -1e9,
                     max_dets: Optional[int] = 30) -> List[dict]:
    """Build eval frames from a COCO-PoseTrack GT index + detection dicts
    (detections: image_id, keypoints (J*3 with per-joint score in the v
    slot), score).

    Reproduces the official protocol composition the reference reaches
    through COCOeval + annolist files (``posetrack_video_pose.py:443-512``
    -> poseval ``load_data_dir``):

    - detections capped to the top ``max_dets`` per image by detection
      score (COCOeval ``maxDets=[30]``, ``posetrack_video_pose.py:449``);
    - frames whose GT has no annotated pose are dropped entirely —
      predictions there never count (poseval ``cleanupData``,
      ``eval_helpers.py:303-310``);
    - GT and predicted joints inside the GT ignore regions are removed,
      and poses left without joints are dropped (poseval
      ``removeIgnoredPoints``, ``eval_helpers.py:344``) — this runs
      *after* the empty-frame drop, so a frame whose GT vanishes into an
      ignore region still penalizes its predictions.
    """
    by_img: Dict[int, list] = {}
    for det in detections:
        by_img.setdefault(int(det["image_id"]), []).append(det)
    frames = []
    for img_id in gt_coco.get_img_ids():
        info = gt_coco.imgs[img_id]
        if not info.get("is_labeled", True):
            continue
        gts, heads, gt_tids = [], [], []
        for ann in gt_coco.img_to_anns.get(img_id, []):
            k = np.asarray(ann["keypoints"], np.float64).reshape(-1, 3)
            if (k[:, 2] > 0).sum() == 0:
                continue
            head = ann.get("bbox_head")
            if head is None:
                # fall back to an MPII-style head box from head keypoints
                top, bot = k[2], k[1]
                c = (top[:2] + bot[:2]) / 2
                r = max(np.linalg.norm(top[:2] - bot[:2]) / 2, 1.0)
                head = [c[0] - r, c[1] - r, 2 * r, 2 * r]
            x, y, w, h = head
            gts.append(k)
            heads.append([x, y, x + w, y + h])
            gt_tids.append(ann.get("track_id", len(gt_tids)))
        if not gts:      # cleanupData: frame without annotated GT dropped
            continue
        # COCOeval sorts detections by score (stable) and truncates to
        # maxDets; the ordering also fixes poseval's argmax tie-breaking
        # in ``assignGTmulti``, so it is part of the protocol
        dets = sorted(by_img.get(img_id, []),
                      key=lambda d: -d.get("score", 0.0))
        if max_dets is not None:
            dets = dets[:max_dets]
        prs, prs_s, pr_tids = [], [], []
        for det in dets:
            k = np.asarray(det["keypoints"], np.float64).reshape(-1, 3)
            prs.append(k[:, :2])
            prs_s.append(k[:, 2])
            pr_tids.append(det.get("track_id", len(pr_tids)))

        polys = _ignore_polygons(info)
        if polys:
            def ignored(pts2d):
                out = np.zeros(len(pts2d), bool)
                for poly in polys:
                    out |= _points_in_polygon(pts2d, poly)
                return out

            kept_g = []
            for g in range(len(gts)):
                vis = gts[g][:, 2] > 0
                drop = np.zeros(NUM_JOINTS, bool)
                drop[vis] = ignored(gts[g][vis, :2])
                gts[g] = gts[g].copy()
                gts[g][drop, 2] = 0
                if (gts[g][:, 2] > 0).any():
                    kept_g.append(g)
            gts = [gts[g] for g in kept_g]
            heads = [heads[g] for g in kept_g]
            gt_tids = [gt_tids[g] for g in kept_g]
            kept_p = []
            for p in range(len(prs)):
                valid = prs_s[p] > score_thresh
                drop = np.zeros(NUM_JOINTS, bool)
                drop[valid] = ignored(prs[p][valid])
                prs_s[p] = np.where(drop, score_thresh - 1.0, prs_s[p])
                if (prs_s[p] > score_thresh).any():
                    kept_p.append(p)
            prs = [prs[p] for p in kept_p]
            prs_s = [prs_s[p] for p in kept_p]
            pr_tids = [pr_tids[p] for p in kept_p]
        J = NUM_JOINTS
        frames.append(dict(
            gt_points=(np.stack(gts) if gts
                       else np.zeros((0, J, 3))),
            gt_head_boxes=(np.asarray(heads) if heads
                           else np.zeros((0, 4))),
            gt_track_ids=gt_tids,
            pr_points=(np.stack(prs) if prs else np.zeros((0, J, 2))),
            pr_scores=(np.stack(prs_s) if prs_s else np.zeros((0, J))),
            pr_valid=(np.stack(prs_s) > score_thresh if prs_s
                      else np.zeros((0, J), bool)),
            pr_track_ids=pr_tids,
            seq_id=info.get("vid_id", 0),
        ))
    return frames
