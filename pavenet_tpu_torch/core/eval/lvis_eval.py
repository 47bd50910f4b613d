"""LVIS v1 federated box and mask AP (as
``pavenet_tpu/core/eval/lvis_eval.py``), on ``COCODetEval``:

- ``maxDets=300``;
- federated gating: a detection of category ``c`` on image ``i`` counts
  only where ``c`` is in ``i``'s GT or its ``neg_category_ids``; elsewhere
  the image is not evaluated for ``c``;
- on an image's ``not_exhaustive_category_ids`` an unmatched detection is
  ignored, not a false positive;
- AP per frequency band, rare / common / frequent (``AP_r``, ``AP_c``,
  ``AP_f``), from the categories' ``frequency`` field ('r', 'c', 'f'), or
  from their image counts (<= 10, 11-100, > 100) where it is missing.
"""
from __future__ import annotations

import numpy as np

from .coco_det_eval import COCODetEval


class LVISDetEval(COCODetEval):
    def __init__(self, gt_coco, dt_coco, iou_type: str = "bbox",
                 max_dets: int = 300):
        super().__init__(gt_coco, dt_coco, iou_type=iou_type,
                         max_dets=max_dets)
        self._pos = {
            img_id: {a.get("category_id") for a in anns}
            for img_id, anns in gt_coco.img_to_anns.items()}

    def _evaluate_img(self, img_id, area_rng, cat_id=None):
        if cat_id is not None:
            info = self.gt.imgs.get(img_id, {})
            pos = self._pos.get(img_id, set())
            neg = set(info.get("neg_category_ids", ()))
            if cat_id not in pos and cat_id not in neg:
                return None
            e = super()._evaluate_img(img_id, area_rng, cat_id)
            if e is not None and cat_id in set(
                    info.get("not_exhaustive_category_ids", ())):
                e["dt_ignore"] = np.logical_or(
                    e["dt_ignore"], e["dt_matched"] == 0)
            return e
        return super()._evaluate_img(img_id, area_rng, cat_id)

    def _frequency_bands(self):
        """cat_id -> 'r' | 'c' | 'f' from the GT category records, with
        the official image-count thresholds as fallback."""
        bands = {}
        counts = {}
        for anns in self.gt.img_to_anns.values():
            seen = {a.get("category_id") for a in anns}
            for c in seen:
                counts[c] = counts.get(c, 0) + 1
        for cid, cat in self.gt.cats.items():
            f = cat.get("frequency")
            if f is None:
                n = counts.get(cid, 0)
                f = "r" if n <= 10 else ("c" if n <= 100 else "f")
            bands[cid] = f
        for cid in counts:
            if cid not in bands:
                n = counts[cid]
                bands[cid] = "r" if n <= 10 else ("c" if n <= 100 else "f")
        return bands

    def evaluate(self):
        results = super().evaluate()
        bands = self._frequency_bands()
        for key, band in (("AP_r", "r"), ("AP_c", "c"), ("AP_f", "f")):
            vals = [ap for cat, ap in self.per_cat_ap.items()
                    if bands.get(cat) == band]
            results[key] = float(np.mean(vals)) if vals else -1.0
        return results
