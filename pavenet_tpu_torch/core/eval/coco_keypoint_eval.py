"""COCO-style keypoint (OKS) evaluation (as
``pavenet_tpu/core/eval/coco_keypoint_eval.py``): a numpy port of
pycocotools' ``COCOeval`` for ``iouType='keypoints'``.

Per image, OKS between the detections (by score, capped at ``max_dets``)
and the GT; greedy matching at each OKS threshold of [0.5:0.05:0.95];
crowd and keypoint-less GT ignored; 101-point interpolated precision.
``CrowdPoseKeypointEval`` is xtcocotools' CrowdPose protocol.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ...models.losses.oks_loss import OKS_SIGMAS


class COCOKeypointEval:
    def __init__(self, gt_coco, dt_coco, sigmas: Optional[np.ndarray] = None,
                 max_dets: int = 20, area_rngs: Optional[dict] = None,
                 use_area: bool = True):
        """gt_coco/dt_coco: ``datasets/coco_api.py::COCO``.

        ``use_area=False`` switches the OKS scale term from ``gt['area']``
        to ``bbox_w * bbox_h * 0.53`` (xtcocotools ``computeOks`` with
        ``use_area=False`` — the CrowdPose protocol)."""
        self.gt = gt_coco
        self.dt = dt_coco
        self.use_area = use_area
        first = next(iter(dt_coco.anns.values()), {}) if dt_coco.anns else {}
        num_k = (len(np.asarray(first["keypoints"]).reshape(-1, 3))
                 if "keypoints" in first else 17)
        self.sigmas = (np.asarray(sigmas) if sigmas is not None
                       else OKS_SIGMAS.get(num_k, OKS_SIGMAS[17]))
        self.max_dets = max_dets
        self.iou_thrs = np.linspace(0.5, 0.95, 10)
        self.area_rngs = area_rngs or {
            "all": (0.0, 1e10),
            "medium": (32 ** 2, 96 ** 2),
            "large": (96 ** 2, 1e10),
        }

    # ------------------------------------------------------------------
    def _oks(self, gts: List[dict], dts: List[dict]) -> np.ndarray:
        """OKS matrix (num_dt, num_gt), pycocotools ``computeOks``."""
        if not gts or not dts:
            return np.zeros((len(dts), len(gts)))
        var = (self.sigmas * 2) ** 2
        k = len(self.sigmas)
        ious = np.zeros((len(dts), len(gts)))
        for j, gt in enumerate(gts):
            g = np.asarray(gt["keypoints"]).reshape(-1, 3)
            xg, yg, vg = g[:, 0], g[:, 1], g[:, 2]
            k1 = int((vg > 0).sum())
            bb = gt.get("bbox", [0, 0, 0, 0])
            x0, x1 = bb[0] - bb[2], bb[0] + bb[2] * 2
            y0, y1 = bb[1] - bb[3], bb[1] + bb[3] * 2
            for i, dt in enumerate(dts):
                d = np.asarray(dt["keypoints"]).reshape(-1, 3)
                xd, yd = d[:, 0], d[:, 1]
                if k1 > 0:
                    dx = xd - xg
                    dy = yd - yg
                else:
                    # no visible gt keypoints: measure to the expanded bbox
                    z = np.zeros(k)
                    dx = np.maximum(z, x0 - xd) + np.maximum(z, xd - x1)
                    dy = np.maximum(z, y0 - yd) + np.maximum(z, yd - y1)
                scale = (gt.get("area", 1.0) if self.use_area
                         else bb[2] * bb[3] * 0.53)
                e = (dx ** 2 + dy ** 2) / var / (scale + np.spacing(1)) / 2
                if k1 > 0:
                    e = e[vg > 0]
                ious[i, j] = np.sum(np.exp(-e)) / e.shape[0]
        return ious

    def _gt_ignore(self, g: dict, area_rng) -> int:
        """Keypoint-eval GT ignore rule (crowd / no labeled keypoints /
        outside area range); detection eval overrides this."""
        return int(
            g.get("iscrowd", 0) or g.get("num_keypoints", 0) == 0
            or not (area_rng[0] <= g.get("area", 0) <= area_rng[1]))

    def _evaluate_img(self, img_id: int, area_rng) -> Optional[dict]:
        gts = [g for g in self.gt.img_to_anns.get(img_id, [])]
        dts = [d for d in self.dt.img_to_anns.get(img_id, [])]
        if not gts and not dts:
            return None
        for g in gts:
            g["_ignore"] = self._gt_ignore(g, area_rng)
        gts = sorted(gts, key=lambda g: g["_ignore"])
        dts = sorted(dts, key=lambda d: -d.get("score", 0))[:self.max_dets]
        ious = self._oks(gts, dts)

        T = len(self.iou_thrs)
        G, D = len(gts), len(dts)
        gt_matched = np.zeros((T, G), dtype=np.int64)
        dt_matched = np.zeros((T, D), dtype=np.int64)
        gt_ignore = np.asarray([g["_ignore"] for g in gts])
        dt_ignore = np.zeros((T, D))
        for t, thr in enumerate(self.iou_thrs):
            for i in range(D):
                best_iou = min(thr, 1 - 1e-10)
                best_j = -1
                for j in range(G):
                    if gt_matched[t, j] and not gts[j].get("iscrowd", 0):
                        continue
                    # stop at ignored gts once a real match was found
                    if (best_j > -1 and not gt_ignore[best_j]
                            and gt_ignore[j]):
                        break
                    if ious[i, j] < best_iou:
                        continue
                    best_iou = ious[i, j]
                    best_j = j
                if best_j == -1:
                    continue
                dt_ignore[t, i] = gt_ignore[best_j]
                dt_matched[t, i] = gts[best_j]["id"]
                gt_matched[t, best_j] = dts[i]["id"]
        # unmatched dts outside the area range are ignored
        a = np.asarray([
            not (area_rng[0] <= d.get("area", 0) <= area_rng[1])
            for d in dts]).reshape(1, -1)
        dt_ignore = np.logical_or(
            dt_ignore, np.logical_and(dt_matched == 0, np.repeat(a, T, 0)))
        return dict(
            dt_scores=[d.get("score", 0) for d in dts],
            dt_matched=dt_matched, dt_ignore=dt_ignore,
            num_gt=int((1 - gt_ignore).sum()))

    def _ap_ar(self, img_ids, area_rng):
        """Per-IoU-threshold (AP, AR) over an image subset + area band
        (the accumulate step of pycocotools, restricted to ``img_ids``)."""
        T = len(self.iou_thrs)
        evals = [self._evaluate_img(i, area_rng) for i in img_ids]
        evals = [e for e in evals if e is not None]
        if not evals:
            return np.full(T, -1.0), np.full(T, -1.0)
        scores = np.concatenate([e["dt_scores"] for e in evals])
        order = np.argsort(-scores, kind="mergesort")
        matched = np.concatenate(
            [e["dt_matched"] for e in evals], axis=1)[:, order]
        ignored = np.concatenate(
            [e["dt_ignore"] for e in evals], axis=1)[:, order]
        num_gt = sum(e["num_gt"] for e in evals)
        if num_gt == 0:
            return np.full(T, -1.0), np.full(T, -1.0)
        tps = np.logical_and(matched > 0, ~ignored.astype(bool))
        fps = np.logical_and(matched == 0, ~ignored.astype(bool))
        tp_sum = np.cumsum(tps, axis=1).astype(float)
        fp_sum = np.cumsum(fps, axis=1).astype(float)
        ap = np.zeros(T)
        ar = np.zeros(T)
        rec_thrs = np.linspace(0, 1, 101)
        for t in range(T):
            tp, fp = tp_sum[t], fp_sum[t]
            rc = tp / num_gt
            pr = tp / np.maximum(tp + fp, np.spacing(1))
            ar[t] = rc[-1] if len(rc) else 0
            # precision envelope + 101-point interpolation
            pr = pr.tolist()
            for i in range(len(pr) - 1, 0, -1):
                pr[i - 1] = max(pr[i - 1], pr[i])
            inds = np.searchsorted(rc, rec_thrs, side="left")
            q = [pr[i] if i < len(pr) else 0 for i in inds]
            ap[t] = np.mean(q)
        return ap, ar

    def evaluate(self) -> Dict[str, float]:
        img_ids = self.gt.get_img_ids()
        results = {}
        stats = {}
        for area_name, area_rng in self.area_rngs.items():
            stats[area_name] = self._ap_ar(img_ids, area_rng)

        ap_all, ar_all = stats["all"]
        results["AP"] = float(np.mean(ap_all))
        results["AP50"] = float(ap_all[0])
        results["AP75"] = float(ap_all[5])
        results["AR"] = float(np.mean(ar_all))
        for name in self.area_rngs:
            if name != "all":
                results[f"AP_{name[0].upper()}"] = float(
                    np.mean(stats[name][0]))
        return results


class CrowdPoseKeypointEval(COCOKeypointEval):
    """The CrowdPose protocol: xtcocotools ``COCOeval`` with
    ``iouType='keypoints_crowd'``, ``use_area=False`` (reference
    ``opera/datasets/crowd_pose.py:286-295``).

    Differences from plain COCO keypoints:

    - OKS scale = ``bbox_w * bbox_h * 0.53`` instead of ``gt['area']``;
    - a single 'all' area band;
    - three extra AP bands over images grouped by image-level
      ``crowdIndex``: easy (< 0.1), medium ([0.1, 0.8]), hard (> 0.8)
      (xtcocotools ``summarize_kps_crowd`` -> ``get_type_result(first=0.1,
      second=0.8)``), each band = mean AP over the IoU thresholds with the
      evaluation restricted to the band's images.

    Output keys mirror the reference's stats order: AP, AP50, AP75, AR,
    AR50, AR75, AP(E), AP(M), AP(H).
    """

    def __init__(self, gt_coco, dt_coco, sigmas: Optional[np.ndarray] = None,
                 max_dets: int = 20):
        if sigmas is None:
            sigmas = OKS_SIGMAS[14]
        super().__init__(gt_coco, dt_coco, sigmas=sigmas, max_dets=max_dets,
                         area_rngs={"all": (0.0, 1e10)}, use_area=False)

    def _crowd_bands(self):
        easy, mid, hard = [], [], []
        for img_id in self.gt.get_img_ids():
            info = self.gt.load_imgs([img_id])[0]
            ci = info.get("crowdIndex", 0.0)
            (easy if ci < 0.1 else hard if ci > 0.8 else mid).append(img_id)
        return easy, mid, hard

    def evaluate(self) -> Dict[str, float]:
        img_ids = self.gt.get_img_ids()
        ap, ar = self._ap_ar(img_ids, (0.0, 1e10))
        results = {
            "AP": float(np.mean(ap)),
            "AP50": float(ap[0]),
            "AP75": float(ap[5]),
            "AR": float(np.mean(ar)),
            "AR50": float(ar[0]),
            "AR75": float(ar[5]),
        }
        for name, band in zip(("AP(E)", "AP(M)", "AP(H)"),
                              self._crowd_bands()):
            band_ap, _ = self._ap_ar(band, (0.0, 1e10))
            valid = band_ap[band_ap > -1]
            results[name] = float(np.mean(valid)) if valid.size else -1.0
        return results
