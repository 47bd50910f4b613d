"""Detection and pose rendering (as ``pavenet_tpu/utils/visualize.py``),
shared by ``demo/image_demo.py`` and ``tools/test.py --show-dir``: numpy
and cv2, no torch, so that both packages draw the same pixels from the
same detections.
"""
from __future__ import annotations

import numpy as np

# Edge tables per keypoint count: 14 = CrowdPose, 15 = PoseTrack,
# 17 = COCO.
SKELETONS = {
    14: [(0, 2), (2, 4), (1, 3), (3, 5),            # arms
         (0, 1), (0, 6), (1, 7),                    # body
         (6, 8), (8, 10), (7, 9), (9, 11),          # legs
         (12, 13)],                                 # neck
    15: [(0, 2), (0, 1), (1, 3), (1, 4), (3, 5), (4, 6), (3, 9), (4, 10),
         (5, 7), (6, 8), (9, 11), (10, 12), (11, 13), (12, 14)],
    17: [(0, 1), (0, 2), (1, 3), (2, 4),            # head
         (5, 7), (7, 9), (6, 8), (8, 10),           # arms
         (5, 6), (5, 11), (6, 12),                  # body
         (11, 13), (13, 15), (12, 14), (14, 16)],   # legs
}


def draw_poses(img, kpts, scores, score_thr: float = 0.3,
               line_color=(0, 255, 0), point_color=(0, 0, 255)):
    """Draw skeletons in place on a BGR uint8 image.

    ``kpts``: (N, K, 2/3) image-space keypoints; ``scores``: (N,).
    """
    import cv2
    kpts = np.asarray(kpts)
    skeleton = SKELETONS.get(kpts.shape[1] if kpts.ndim == 3 else 0, [])
    for person, s in zip(kpts, np.asarray(scores)):
        if s < score_thr:
            continue
        pts = person[:, :2].astype(int)
        for a, b in skeleton:
            cv2.line(img, tuple(pts[a]), tuple(pts[b]), line_color, 2)
        for x, y in pts:
            cv2.circle(img, (int(x), int(y)), 3, point_color, -1)
    return img


def draw_boxes(img, bboxes, scores, labels=None, masks=None,
               score_thr: float = 0.3, class_names=None,
               box_color=(0, 255, 0)):
    """Draw xyxy boxes (with optional binary masks and class labels) in
    place on a BGR uint8 image; mask colours from ``RandomState(42)``, one
    draw per drawn instance."""
    import cv2
    rng = np.random.RandomState(42)
    for i, (box, s) in enumerate(zip(np.asarray(bboxes),
                                     np.asarray(scores))):
        if s < score_thr:
            continue
        x1, y1, x2, y2 = box[:4].astype(int)
        cv2.rectangle(img, (x1, y1), (x2, y2), box_color, 2)
        label = int(labels[i]) if labels is not None else 0
        name = (class_names[label] if class_names is not None
                and label < len(class_names) else str(label))
        cv2.putText(img, f"{name} {s:.2f}", (x1, max(y1 - 3, 10)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, box_color, 1)
        if masks is not None:
            m = np.asarray(masks[i], bool)
            color = rng.randint(0, 255, 3)
            img[m] = img[m] * 0.5 + color * 0.5
    return img


def render_detections(img_file: str, dets, score_thr: float = 0.3,
                      out_file: str = None, class_names=None):
    """Render one image's COCO-style detection dicts (keypoints, or bbox
    with an optional binary ``segmentation``) onto the source image;
    returns the image and writes ``out_file`` where given. A missing image
    raises ``FileNotFoundError``."""
    import cv2
    img = cv2.imread(img_file)
    if img is None:
        raise FileNotFoundError(img_file)
    kp = [d for d in dets if "keypoints" in d]
    if kp:
        kpts = np.stack([np.asarray(d["keypoints"],
                                    np.float32).reshape(-1, 3)
                         for d in kp])
        draw_poses(img, kpts, [d["score"] for d in kp], score_thr)
    boxed = [d for d in dets if "bbox" in d and "keypoints" not in d]
    if boxed:
        xyxy = np.asarray([[d["bbox"][0], d["bbox"][1],
                            d["bbox"][0] + d["bbox"][2],
                            d["bbox"][1] + d["bbox"][3]] for d in boxed])
        masks = ([d.get("segmentation") for d in boxed]
                 if all("segmentation" in d for d in boxed) else None)
        draw_boxes(img, xyxy, [d["score"] for d in boxed],
                   labels=[d.get("category_id", 1) - 1 for d in boxed],
                   masks=masks, score_thr=score_thr,
                   class_names=class_names)
    if out_file:
        cv2.imwrite(out_file, img)
    return img
