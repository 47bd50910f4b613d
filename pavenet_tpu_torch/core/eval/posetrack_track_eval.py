"""PoseTrack MOTA (as ``pavenet_tpu/core/eval/posetrack_track_eval.py``, a
port of poseval's ``evaluateTracking`` with the CLEAR-MOT accumulator of
``py-motmetrics``), in numpy.

Per frame and joint, poses pair by PCKh as in the AP metric (a pair is
feasible when the joint's distance over the GT head size is at most 0.5;
infeasible pairs cannot match). Per (sequence, joint) an accumulator keeps
the previous frame's track correspondences where they stay feasible,
Hungarian-matches the rest (scipy's ``linear_sum_assignment``) and counts
misses, false positives and identity switches. MOTA_j = 100 * (1 - (miss +
switch + fp) / objects); MOTP, precision and recall from the matches; each
total is the mean over joints.

Two quirks of the protocol, kept because they change the numbers: the
last frame of each sequence is dropped, and a frame without GT poses or
without predictions counts as one object and one hypothesis that cannot
pair, not as its real counts.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Sequence

import numpy as np
from scipy.optimize import linear_sum_assignment

from .posetrack_eval import NUM_JOINTS


class MotAccumulator:
    """CLEAR-MOT event counting for one (sequence, joint) stream."""

    def __init__(self):
        self.m: Dict = {}   # object track id -> hypothesis track id
        self.num_objects = 0
        self.num_misses = 0
        self.num_switches = 0
        self.num_false_positives = 0
        self.num_detections = 0
        self.sum_d = 0.0

    def update(self, oids: Sequence, hids: Sequence, dists):
        """dists (len(oids), len(hids)); NaN = cannot pair."""
        oids, hids = list(oids), list(hids)
        d = np.asarray(dists, float).reshape(len(oids), len(hids))
        self.num_objects += len(oids)
        o_free = set(range(len(oids)))
        h_free = set(range(len(hids)))

        # 1. carry forward established correspondences
        for i, o in enumerate(oids):
            if o not in self.m:
                continue
            hprev = self.m[o]
            for j in h_free:
                if hids[j] == hprev:
                    break
            else:
                continue
            if i in o_free and np.isfinite(d[i, j]):
                o_free.discard(i)
                h_free.discard(j)
                self.num_detections += 1
                self.sum_d += d[i, j]

        # 2. Hungarian on the remaining feasible pairs
        rows, cols = sorted(o_free), sorted(h_free)
        if rows and cols:
            sub = d[np.ix_(rows, cols)]
            finite = sub[np.isfinite(sub)]
            inv = 2.0 * finite.max() + 1.0 if finite.size else 1.0
            sub = np.where(np.isfinite(sub), sub, inv)
            for a, b in zip(*linear_sum_assignment(sub)):
                if sub[a, b] == inv:
                    continue
                o, h = oids[rows[a]], hids[cols[b]]
                if o in self.m and self.m[o] != h:
                    self.num_switches += 1
                self.num_detections += 1
                self.sum_d += sub[a, b]
                self.m[o] = h
                o_free.discard(rows[a])
                h_free.discard(cols[b])

        self.num_misses += len(o_free)
        self.num_false_positives += len(h_free)


def _joint_mot_inputs(fr, j, dist_thresh=0.5):
    """Per-joint MOT stream for one frame: (gt track ids, pr track ids,
    dist matrix with NaN where infeasible) — assignGTmulti's ``motAll``."""
    gt = np.asarray(fr["gt_points"], float).reshape(-1, NUM_JOINTS, 3)
    pr = np.asarray(fr["pr_points"], float).reshape(-1, NUM_JOINTS, 2)
    pv = np.asarray(fr["pr_valid"], bool).reshape(-1, NUM_JOINTS)
    gt_tids = list(fr["gt_track_ids"])
    pr_tids = list(fr["pr_track_ids"])
    if len(gt) == 0 or len(pr) == 0:
        # reference dummy pair for empty frames (see module docstring)
        return [0], [0], np.full((1, 1), np.nan)

    head = np.asarray(fr["gt_head_boxes"], float).reshape(-1, 4)
    head_size = np.maximum(
        0.6 * np.linalg.norm(head[:, 2:4] - head[:, 0:2], axis=1), 1e-6)
    has_gt = gt[:, j, 2] > 0
    ridxs_gt = np.where(has_gt)[0]
    ridxs_pr = np.where(pv[:, j])[0]
    dist = np.linalg.norm(
        pr[ridxs_pr][:, None, j, :] - gt[ridxs_gt][None, :, j, :2],
        axis=-1) / head_size[ridxs_gt][None, :]          # (P', G')
    dist = np.where(dist <= dist_thresh, dist, np.nan).T  # (G', P')
    return ([gt_tids[g] for g in ridxs_gt],
            [pr_tids[p] for p in ridxs_pr], dist)


def evaluate_posetrack_mota(frames: Sequence[dict],
                            seq_ids: Sequence,
                            dist_thresh: float = 0.5) -> "OrderedDict":
    """frames: as ``evaluate_posetrack_ap`` plus ``gt_track_ids (G,)`` and
    ``pr_track_ids (P,)``; seq_ids: per-frame sequence key (frames of a
    sequence must be contiguous and time-ordered).

    Returns OrderedDict with MOTA/MOTP/precision/recall totals and
    ``mota_per_joint``.
    """
    J = NUM_JOINTS
    counts = [MotAccumulator() for _ in range(J)]  # global per-joint sums

    # group contiguous frames per sequence
    seq_ids = list(seq_ids)
    groups: List[List[int]] = []
    for i, s in enumerate(seq_ids):
        if i == 0 or s != seq_ids[i - 1]:
            groups.append([])
        groups[-1].append(i)

    for idxs in groups:
        idxs = idxs[:-1]  # reference drops each sequence's last frame
        accs = [MotAccumulator() for _ in range(J)]
        for i in idxs:
            for j in range(J):
                oids, hids, dist = _joint_mot_inputs(
                    frames[i], j, dist_thresh)
                accs[j].update(oids, hids, dist)
        for j in range(J):
            for name in ("num_objects", "num_misses", "num_switches",
                         "num_false_positives", "num_detections"):
                setattr(counts[j], name,
                        getattr(counts[j], name) + getattr(accs[j], name))
            counts[j].sum_d += accs[j].sum_d

    mota = np.full(J, np.nan)
    motp = np.full(J, np.nan)
    pre = np.full(J, np.nan)
    rec = np.full(J, np.nan)
    for j, c in enumerate(counts):
        n_obj = c.num_objects if c.num_objects > 0 else np.nan
        mota[j] = 100.0 * (1.0 - (c.num_misses + c.num_switches
                                  + c.num_false_positives) / n_obj)
        motp[j] = (0.0 if c.num_detections == 0
                   else 100.0 * (1.0 - c.sum_d / c.num_detections))
        total_det = c.num_false_positives + c.num_detections
        pre[j] = (100.0 * c.num_detections / total_det if total_det > 0
                  else np.nan)
        rec[j] = 100.0 * c.num_detections / n_obj

    out = OrderedDict()
    out["MOTA"] = float(np.nanmean(mota))
    out["MOTP"] = float(np.nanmean(motp))
    out["Precision"] = float(np.nanmean(pre))
    out["Recall"] = float(np.nanmean(rec))
    out["mota_per_joint"] = mota
    return out
