"""The comparisons that decide ``correct``: what the timed path produced,
judged by the plain reference (``benchmark/reference``) run on the same
inputs and the same weights, both made from the seed by the benchmark.

The program's discrete choices are judged by how far they lie from the
reference's, as a served token is judged by the gap of its logit below the
reference's best, and the reference then follows them, so that a tie that
rounding breaks the other way does not read as a fault:

- the two-stage top-k: ``topk_gap``, how far (in logits) the weakest
  proposal the program chose lies below the reference's k-th best;
- the matching (training): ``assign_gap``, the reference's cost of the
  program's assignment over its optimum, per valid GT slot;
- the final ``max_per_img`` (serving): the program's scores against the
  reference's best ones, sorted (``score_gap``), and each detection
  against the reference's candidate of nearly the same score
  (``score_window``) that lies nearest: ``det_px``, the widest gap of its
  keypoints and box in the source frame's pixels, ``kpt_score_gap``, of
  its keypoint scores;
- OKS-NMS (serving): ``keep_miss``, the detections whose ``keep`` neither
  the reference's NMS at the threshold less ``nms_margin`` nor at the
  threshold plus it gives.

Training compares each mini-step's loss, and per parameter leaf the norm
of the first update's gradient as the optimizer got it (from AdamW's first
moment) and of the parameters' change by that update, each as the gap of
the two norms over the larger of the reference's norm of that leaf and of
the median leaf. Leaves whose reference gradient is under a thousandth of
the median leaf's are left out: AdamW moves them by round-off alone. Each
step's loss gap is held by the worst step (``loss_rel``) and the median
one (``loss_median``), the change by the worst leaf (``change_leaf``,
where its readings separate) and the median one (``change_median``). At
random weights the step is ill-conditioned (a 1e-7 move of the weights
moves the worst leaf's gradient by a fifth), so the gradient is held by
the median leaf (``grad_median``); the worst (``grad_leaf``) is printed.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from .reference.models.detectors.videopose import VideoPoseDetector
from .reference.ops.lap import hungarian_masked
from .reference.ops.nms import oks_nms_keep

# the port's OKS-NMS threshold (``ops/nms.py::oks_nms_keep``)
NMS_THRESH = 0.45


def topk_gap(ref_scores: torch.Tensor, prog_idx: torch.Tensor) -> float:
    """``ref_scores (B, N)``: what the reference's top-k ranks;
    ``prog_idx (B, k)``: the program's choice."""
    ref_scores = ref_scores.detach()
    kth = ref_scores.topk(prog_idx.shape[1], dim=1).values[:, -1:]
    chosen = ref_scores.gather(1, prog_idx.to(ref_scores.device))
    return float((kth - chosen).clamp(min=0).max())


def _areas(kpts):
    return ((kpts[..., 0].amax(-1) - kpts[..., 0].amin(-1))
            * (kpts[..., 1].amax(-1) - kpts[..., 1].amin(-1)))


@torch.no_grad()
def serve_numbers(ref: VideoPoseDetector, feed: Mapping, prog: Mapping,
                  prog_topk: torch.Tensor, limits: Mapping) -> dict:
    """The numbers of one served request: ``feed`` normalised on the
    device, ``prog`` the program's ``forward_test`` output on the host,
    ``prog_topk`` its top-k choice."""
    B, NQ = prog_topk.shape
    dev = feed["img"].device
    record = {}
    every = torch.arange(NQ, device=dev).expand(B, NQ)
    out = ref.forward_test(feed, topk_idx=prog_topk.to(dev),
                           with_nms=False, select=every, record=record)
    kpts_all = out["det_kpts"].double().cpu()              # (B, NQ, K, 3)
    boxes_all = out["det_bboxes"].double().cpu()           # (B, NQ, 5)
    sigmas = ref.oks_sigmas.double().cpu()
    p_kpts = prog["det_kpts"].double()
    p_boxes = prog["det_bboxes"].double()
    p_keep = prog["keep"].bool()
    M = p_kpts.shape[1]
    window = limits["score_window"]
    res = dict(topk_gap=topk_gap(record["topk_scores"], prog_topk),
               score_gap=0.0, det_px=0.0, kpt_score_gap=0.0, keep_miss=0)
    for b in range(B):
        r_scores = boxes_all[b, :, 4]
        best = r_scores.topk(M).values
        res["score_gap"] = max(res["score_gap"], float(
            (best - p_boxes[b, :, 4]).abs().max()))
        chosen = []
        for j in range(M):
            cand = torch.nonzero((r_scores - p_boxes[b, j, 4]).abs()
                                 <= window).flatten()
            if len(cand) == 0:
                res["det_px"] = float("inf")
                chosen.append(int((r_scores - p_boxes[b, j, 4]).abs()
                                  .argmin()))
                continue
            err = torch.maximum(
                (kpts_all[b, cand, :, :2] - p_kpts[b, j, :, :2]).abs()
                .flatten(1).amax(1),
                (boxes_all[b, cand, :4] - p_boxes[b, j, :4]).abs().amax(1))
            q = int(cand[err.argmin()])
            chosen.append(q)
            res["det_px"] = max(res["det_px"], float(err.min()))
            res["kpt_score_gap"] = max(res["kpt_score_gap"], float(
                (kpts_all[b, q, :, 2] - p_kpts[b, j, :, 2]).abs().max()))
        c_kpts = kpts_all[b, chosen]
        keeps = [oks_nms_keep(c_kpts[..., :2], p_boxes[b, :, 4],
                              _areas(c_kpts), sigmas, NMS_THRESH + d)
                 for d in (-limits["nms_margin"], limits["nms_margin"])]
        res["keep_miss"] += int(((p_keep[b] != keeps[0])
                                 & (p_keep[b] != keeps[1])).sum())
    return res


def assign_gap(costs: Sequence[torch.Tensor], prog_assign: Sequence,
               gt_valid: torch.Tensor) -> float:
    """Over the prediction sets: the reference's cost ``(B, Q, G)`` of the
    program's assignment ``(B, G)`` less that of the optimal one, per
    valid GT slot."""
    valid = gt_valid.cpu().numpy()
    worst = 0.0
    for cost, idx in zip(costs, prog_assign):
        c = cost.double().cpu().numpy()
        idx = idx.cpu().numpy()
        for b in range(c.shape[0]):
            rows = np.flatnonzero(valid[b])
            if not len(rows):
                continue
            best = hungarian_masked(c[b].T.astype(np.float32), valid[b])
            mine = c[b][idx[b, rows], rows].sum()
            opt = c[b][best[rows], rows].sum()
            worst = max(worst, (mine - opt) / len(rows))
    return float(worst)


def leaf_gaps(prog: np.ndarray, ref: np.ndarray,
              keep: np.ndarray) -> np.ndarray:
    """Per leaf: ``|prog - ref| / max(ref, median of ref)`` over the leaves
    ``keep``; -1 for the others."""
    floor = np.median(ref[keep])
    return np.where(keep, np.abs(prog - ref) / np.maximum(ref, floor), -1.0)


def moved_leaves(ref_grad: np.ndarray) -> np.ndarray:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    return ref_grad >= 1e-3 * np.median(ref_grad)


def verdict(numbers: Mapping, limits: Mapping) -> bool:
    """Every number within its limit (a number without a limit is not
    compared)."""
    return all(numbers[k] <= lim for k, lim in limits["numbers"].items()
               if k in numbers)
