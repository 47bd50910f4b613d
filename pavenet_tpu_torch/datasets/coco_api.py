"""Minimal COCO-style annotation index (as
``pavenet_tpu/datasets/coco_api.py``): images, annotations and categories
by id, annotations by image, and ``load_res`` for detections."""
from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np


class COCO:
    def __init__(self, annotation_file: Optional[str] = None,
                 dataset: Optional[dict] = None):
        if dataset is None:
            with open(annotation_file, "r") as f:
                dataset = json.load(f)
        self.dataset = dataset
        self.imgs: Dict[int, dict] = {
            img["id"]: img for img in dataset.get("images", [])}
        self.anns: Dict[int, dict] = {
            ann["id"]: ann for ann in dataset.get("annotations", [])}
        self.cats: Dict[int, dict] = {
            cat["id"]: cat for cat in dataset.get("categories", [])}
        self.img_to_anns: Dict[int, List[dict]] = defaultdict(list)
        for ann in dataset.get("annotations", []):
            self.img_to_anns[ann["image_id"]].append(ann)

    def get_img_ids(self) -> List[int]:
        return list(self.imgs.keys())

    def get_cat_ids(self, cat_names=None) -> List[int]:
        if cat_names is None:
            return list(self.cats.keys())
        return [cid for cid, c in self.cats.items()
                if c.get("name") in cat_names]

    def load_imgs(self, ids) -> List[dict]:
        return [self.imgs[i] for i in ids]

    def get_ann_ids(self, img_ids=None, cat_ids=None) -> List[int]:
        if img_ids is None:
            anns = self.anns.values()
        else:
            anns = [a for i in img_ids for a in self.img_to_anns[i]]
        if cat_ids is not None:
            cat_ids = set(cat_ids)
            anns = [a for a in anns if a.get("category_id") in cat_ids]
        return [a["id"] for a in anns]

    def load_anns(self, ids) -> List[dict]:
        return [self.anns[i] for i in ids]

    def load_res(self, results: List[dict]) -> "COCO":
        """A result index from detection dicts (image_id, keypoints, score,
        category_id): ids from 1, and a missing ``area`` taken from the box
        of the visible keypoints."""
        dataset = dict(images=list(self.imgs.values()),
                       categories=list(self.cats.values()),
                       annotations=[])
        for i, det in enumerate(results):
            ann = dict(det)
            ann["id"] = i + 1
            if "area" not in ann and "keypoints" in ann:
                k = np.asarray(ann["keypoints"]).reshape(-1, 3)
                vis = k[:, 2] > 0
                if vis.any():
                    x0, y0 = k[vis, 0].min(), k[vis, 1].min()
                    x1, y1 = k[vis, 0].max(), k[vis, 1].max()
                    ann["area"] = float((x1 - x0) * (y1 - y0))
                else:
                    ann["area"] = 0.0
            dataset["annotations"].append(ann)
        return COCO(dataset=dataset)
