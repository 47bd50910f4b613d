"""Keypoint utilities (as ``pavenet_tpu/core/keypoint.py``): decoding,
splitting by class, mapping back to the original image, and the CornerNet
gaussian radius and splat, in numpy."""
from __future__ import annotations

import numpy as np


def distance2keypoint(points, offsets, max_shape=None):
    """Decode keypoints from per-point offsets.

    points (N, 2) xy; offsets (N, K*2) -> (N, K, 2)
    (reference ``transforms.py:6``)."""
    k = offsets.shape[-1] // 2
    kpts = points[:, None, :] + offsets.reshape(-1, k, 2)
    if max_shape is not None:
        h, w = max_shape[:2]
        kpts[..., 0] = np.clip(kpts[..., 0], 0, w)
        kpts[..., 1] = np.clip(kpts[..., 1], 0, h)
    return kpts


def bbox_kpt2result(bboxes, labels, kpts, num_classes):
    """Split padded detections into per-class lists
    (reference ``transforms.py`` ``bbox_kpt2result``)."""
    bboxes = np.asarray(bboxes)
    labels = np.asarray(labels)
    kpts = np.asarray(kpts)
    return ([bboxes[labels == i] for i in range(num_classes)],
            [kpts[labels == i] for i in range(num_classes)])


def kpt_mapping_back(kpts, img_shape, scale_factor, flip,
                     flip_pairs=()):
    """Map augmented-image keypoints back to the original image
    (reference ``kpt_mapping_back``): undo flip then scaling."""
    kpts = np.array(kpts, dtype=np.float32)
    if flip:
        kpts[..., 0] = img_shape[1] - kpts[..., 0]
        for a, b in flip_pairs:
            kpts[:, [a, b]] = kpts[:, [b, a]]
    kpts[..., 0] = kpts[..., 0] / scale_factor[0]
    kpts[..., 1] = kpts[..., 1] / scale_factor[1]
    return kpts


def gaussian_radius(det_size, min_overlap=0.7):
    """CornerNet radius (reference ``transforms.py:39``; numpy version of
    the in-jit variant in ``models/detectors/videopose.py``)."""
    height, width = det_size
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + np.sqrt(max(b1 ** 2 - 4 * c1, 0))) / 2
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + np.sqrt(max(b2 ** 2 - 16 * c2, 0))) / 2
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + np.sqrt(max(b3 ** 2 - 16 * min_overlap * c3, 0))) / 2
    return min(r1, r2, r3)


def draw_umich_gaussian(heatmap, center, radius, k=1):
    """Max-overlay a truncated gaussian onto ``heatmap`` in place
    (reference ``transforms.py:76``)."""
    radius = int(radius)
    diameter = 2 * radius + 1
    sigma = diameter / 6.0
    y, x = np.ogrid[-radius:radius + 1, -radius:radius + 1]
    g = np.exp(-(x * x + y * y) / (2 * sigma * sigma))
    g[g < np.finfo(np.float32).eps * g.max()] = 0
    cx, cy = int(center[0]), int(center[1])
    h, w = heatmap.shape
    l, r = min(cx, radius), min(w - cx, radius + 1)
    t, b = min(cy, radius), min(h - cy, radius + 1)
    if l + r > 0 and t + b > 0:
        patch = g[radius - t:radius + b, radius - l:radius + r]
        region = heatmap[cy - t:cy + b, cx - l:cx + r]
        np.maximum(region, patch * k, out=region)
    return heatmap
