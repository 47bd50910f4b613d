"""COCO box and mask AP (as ``pavenet_tpu/core/eval/coco_det_eval.py``): a
numpy port of pycocotools' ``COCOeval`` for ``iouType`` 'bbox' and 'segm',
on the greedy matching and 101-point accumulation of
``COCOKeypointEval``, per category (``useCats=1``) with COCO's area
ranges.

IoU as pycocotools' ``maskUtils.iou``: intersection over the detection's
own area for a crowd GT, over the union otherwise. Masks are dense binary
arrays; GT polygons are rasterised with cv2 ``fillPoly``.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from .coco_keypoint_eval import COCOKeypointEval


def polys_to_mask(polys, height: int, width: int) -> np.ndarray:
    """Rasterize COCO polygon segmentation to a binary mask."""
    import cv2
    mask = np.zeros((height, width), np.uint8)
    for poly in polys:
        pts = np.asarray(poly, np.float64).reshape(-1, 2)
        cv2.fillPoly(mask, [np.round(pts).astype(np.int32)], 1)
    return mask.astype(bool)


def _bbox_iou(dt_boxes, gt_boxes, gt_crowd):
    """pycocotools bbIou: xywh boxes; crowd GT -> inter / dt_area."""
    d = np.asarray(dt_boxes, float).reshape(-1, 4)
    g = np.asarray(gt_boxes, float).reshape(-1, 4)
    ious = np.zeros((len(d), len(g)))
    for j, gb in enumerate(g):
        gx1, gy1, gw, gh = gb
        garea = gw * gh
        for i, db in enumerate(d):
            dx1, dy1, dw, dh = db
            iw = min(dx1 + dw, gx1 + gw) - max(dx1, gx1)
            ih = min(dy1 + dh, gy1 + gh) - max(dy1, gy1)
            if iw <= 0 or ih <= 0:
                continue
            inter = iw * ih
            union = dw * dh if gt_crowd[j] else dw * dh + garea - inter
            ious[i, j] = inter / max(union, np.spacing(1))
    return ious


def _mask_iou(dt_masks, gt_masks, gt_crowd):
    ious = np.zeros((len(dt_masks), len(gt_masks)))
    for j, gm in enumerate(gt_masks):
        garea = gm.sum()
        for i, dm in enumerate(dt_masks):
            darea = dm.sum()
            inter = np.logical_and(dm, gm).sum()
            union = darea if gt_crowd[j] else darea + garea - inter
            ious[i, j] = inter / max(union, np.spacing(1))
    return ious


class COCODetEval(COCOKeypointEval):
    """``iou_type``: 'bbox' or 'segm'.  Detections need ``bbox`` (xywh) or
    ``segmentation`` (binary mask array or polygon list) + ``score`` +
    ``category_id``; matching is per-category as in pycocotools."""

    def __init__(self, gt_coco, dt_coco, iou_type: str = "bbox",
                 max_dets: int = 100, area_rngs: Optional[dict] = None):
        super().__init__(gt_coco, dt_coco, sigmas=np.ones(1),
                         max_dets=max_dets,
                         area_rngs=area_rngs or {
                             "all": (0.0, 1e10),
                             "small": (0.0, 32 ** 2),
                             "medium": (32 ** 2, 96 ** 2),
                             "large": (96 ** 2, 1e10),
                         })
        assert iou_type in ("bbox", "segm"), iou_type
        self.iou_type = iou_type

    def _gt_ignore(self, g, area_rng):
        return int(g.get("iscrowd", 0)
                   or g.get("ignore", 0)
                   or not (area_rng[0] <= g.get("area", 0) <= area_rng[1]))

    def _mask_of(self, ann, img_info):
        seg = ann["segmentation"]
        if isinstance(seg, np.ndarray):
            return seg.astype(bool)
        return polys_to_mask(seg, img_info.get("height"),
                             img_info.get("width"))

    def _oks(self, gts: List[dict], dts: List[dict]) -> np.ndarray:
        """IoU kernel hook (named after the keypoint base class)."""
        if not gts or not dts:
            return np.zeros((len(dts), len(gts)))
        crowd = [g.get("iscrowd", 0) for g in gts]
        if self.iou_type == "bbox":
            return _bbox_iou([d["bbox"] for d in dts],
                             [g["bbox"] for g in gts], crowd)
        info = self.gt.imgs[gts[0]["image_id"]]
        return _mask_iou([self._mask_of(d, info) for d in dts],
                         [self._mask_of(g, info) for g in gts], crowd)

    def _evaluate_img(self, img_id, area_rng, cat_id=None):
        if cat_id is None:
            return super()._evaluate_img(img_id, area_rng)
        gts = [g for g in self.gt.img_to_anns.get(img_id, [])
               if g.get("category_id") == cat_id]
        dts = [d for d in self.dt.img_to_anns.get(img_id, [])
               if d.get("category_id") == cat_id]
        if not gts and not dts:
            return None
        for g in gts:
            g["_ignore"] = self._gt_ignore(g, area_rng)
        saved_gt = self.gt.img_to_anns
        saved_dt = self.dt.img_to_anns
        try:
            self.gt.img_to_anns = {img_id: gts}
            self.dt.img_to_anns = {img_id: dts}
            return super()._evaluate_img(img_id, area_rng)
        finally:
            self.gt.img_to_anns = saved_gt
            self.dt.img_to_anns = saved_dt

    def evaluate(self):
        """Per-category evaluation, AP averaged over categories with GT
        (pycocotools ``useCats=1`` protocol)."""
        cat_ids = sorted({g.get("category_id", 1)
                          for anns in self.gt.img_to_anns.values()
                          for g in anns}) or [1]
        img_ids = self.gt.get_img_ids()
        T = len(self.iou_thrs)
        rec_thrs = np.linspace(0, 1, 101)
        results = {}
        per_area = {}
        self.per_cat_ap = {}   # cat_id -> mean AP at area 'all' (LVIS bands)
        for area_name, area_rng in self.area_rngs.items():
            ap_cats, ar_cats = [], []
            for cat in cat_ids:
                evals = [self._evaluate_img(i, area_rng, cat)
                         for i in img_ids]
                evals = [e for e in evals if e is not None]
                if not evals:
                    continue
                num_gt = sum(e["num_gt"] for e in evals)
                if num_gt == 0:
                    continue
                scores = np.concatenate([e["dt_scores"] for e in evals])
                order = np.argsort(-scores, kind="mergesort")
                matched = np.concatenate(
                    [e["dt_matched"] for e in evals], axis=1)[:, order]
                ignored = np.concatenate(
                    [e["dt_ignore"] for e in evals], axis=1)[:, order]
                tps = np.logical_and(matched > 0, ~ignored.astype(bool))
                fps = np.logical_and(matched == 0, ~ignored.astype(bool))
                tp_sum = np.cumsum(tps, axis=1).astype(float)
                fp_sum = np.cumsum(fps, axis=1).astype(float)
                ap = np.zeros(T)
                ar = np.zeros(T)
                for t in range(T):
                    tp, fp = tp_sum[t], fp_sum[t]
                    rc = tp / num_gt
                    pr = (tp / np.maximum(tp + fp, np.spacing(1))).tolist()
                    ar[t] = rc[-1] if len(rc) else 0
                    for i in range(len(pr) - 1, 0, -1):
                        pr[i - 1] = max(pr[i - 1], pr[i])
                    inds = np.searchsorted(rc, rec_thrs, side="left")
                    ap[t] = np.mean(
                        [pr[i] if i < len(pr) else 0 for i in inds])
                ap_cats.append(ap)
                ar_cats.append(ar)
                if area_name == "all":
                    self.per_cat_ap[cat] = float(np.mean(ap))
            if ap_cats:
                per_area[area_name] = (np.mean(ap_cats, 0),
                                       np.mean(ar_cats, 0))
            else:
                per_area[area_name] = (np.full(T, -1.0), np.full(T, -1.0))

        ap_all, ar_all = per_area["all"]
        results["AP"] = float(np.mean(ap_all))
        results["AP50"] = float(ap_all[0])
        results["AP75"] = float(ap_all[5])
        results["AR"] = float(np.mean(ar_all))
        for name in self.area_rngs:
            if name != "all":
                results[f"AP_{name[0].upper()}"] = float(
                    np.mean(per_area[name][0]))
        return results
