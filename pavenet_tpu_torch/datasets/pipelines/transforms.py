"""Host-side (numpy/cv2) test pipeline of one clip (as
``pavenet_tpu/datasets/pipelines/transforms.py``): load, keep-ratio resize,
normalise, pad to a static bucket, stack the frames.

Every transform takes and returns a ``results`` dict:
    imgs: list[T] of HxWx3 float32 (RGB)
    img_shape, scale_factor, pad_shape
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


class LoadClip:
    """Read the clip's frames as RGB float32."""

    def __init__(self, to_rgb: bool = True):
        self.to_rgb = to_rgb

    def _decode(self, path):
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(path)
        if self.to_rgb:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        return img

    def __call__(self, results):
        imgs = [self._decode(p).astype(np.float32)
                for p in results["frame_files"]]
        results["imgs"] = imgs
        results["img_shape"] = imgs[0].shape[:2]
        results["ori_shape"] = imgs[0].shape[:2]
        results["scale_factor"] = np.array([1.0, 1.0], np.float32)
        return results


class Resize:
    """Keep-ratio resize to one ``(long, short)`` cap, mm-style (the test
    pipeline's single-scale 'value' mode)."""

    def __init__(self, img_scale: Tuple[int, int]):
        self.img_scale = tuple(img_scale)

    def __call__(self, results):
        long_cap, short_cap = self.img_scale
        h, w = results["imgs"][0].shape[:2]
        sf = min(max(long_cap, short_cap) / max(h, w),
                 min(long_cap, short_cap) / min(h, w))
        new_w, new_h = int(w * sf + 0.5), int(h * sf + 0.5)
        if (new_w, new_h) != (w, h):
            results["imgs"] = [
                cv2.resize(img, (new_w, new_h),
                           interpolation=cv2.INTER_LINEAR)
                for img in results["imgs"]]
        results["img_shape"] = (new_h, new_w)
        results["scale_factor"] = results.get(
            "scale_factor", np.ones(2, np.float32)) * np.array(
                [new_w / w, new_h / h], np.float32)
        return results


class Normalize:
    def __init__(self, mean=(123.675, 116.28, 103.53),
                 std=(58.395, 57.12, 57.375)):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, results):
        results["imgs"] = [(img - self.mean) / self.std
                           for img in results["imgs"]]
        return results


DEFAULT_BUCKETS = ((256, 448), (384, 640), (512, 896), (640, 1088),
                   (736, 1280), (800, 1344), (896, 1472), (1024, 1664),
                   (1216, 1216), (1344, 1344))


class PadToBucket:
    """Pad bottom/right to the smallest static (H, W) bucket that fits; the
    model masks the padding from ``img_shape``."""

    def __init__(self, buckets: Sequence[Tuple[int, int]] = DEFAULT_BUCKETS):
        self.buckets = sorted(buckets, key=lambda b: b[0] * b[1])

    def __call__(self, results):
        h, w = results["imgs"][0].shape[:2]
        for bh, bw in self.buckets:
            if bh >= h and bw >= w:
                break
        else:
            raise ValueError(f"image {h}x{w} exceeds all buckets")
        results["imgs"] = [
            np.pad(img, ((0, bh - h), (0, bw - w), (0, 0)))
            for img in results["imgs"]]
        results["pad_shape"] = (bh, bw)
        return results


class FormatBatch:
    """Stack frames into the model's per-sample arrays: ``img (T,H,W,3)``
    float32, ``img_shape (2,)`` int32, ``scale_factor (2,)`` float32."""

    def __call__(self, results):
        return dict(
            img=np.stack(results["imgs"], 0).astype(np.float32),
            img_shape=np.asarray(results["img_shape"], np.int32),
            scale_factor=np.asarray(results["scale_factor"], np.float32),
        )
