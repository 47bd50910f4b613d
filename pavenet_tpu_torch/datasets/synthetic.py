"""Synthetic multi-person scenes written as a PoseTrack-format dataset (as
``pavenet_tpu/datasets/synthetic.py``, whose json it writes byte for byte
for the same arguments and seed).

Stick-figure people (limbs as thick coloured lines, the head a disc) whose
appearance follows from their keypoints, so a pose model can learn to
detect them; people move at a constant velocity per video with per-frame
articulation jitter. On disk: ``images/`` and a COCO-style json with
``is_labeled``, ``vid_id`` and ``frame_id``, which ``posetrack.py`` reads.
Everything derives from ``seed``; the images go through JPEG, so the json
is the exact record.

    python -m pavenet_tpu_torch.datasets.synthetic --root data/synth_sm \
        --height 448 --width 768 --train-videos 250 --val-videos 40
"""
from __future__ import annotations

import json
import os
import os.path as osp

import numpy as np

# PoseTrack 15-keypoint layout (posetrack.py POSETRACK_KEYPOINTS)
#  0 nose, 1 head_bottom, 2 head_top, 3/4 L/R shoulder, 5/6 L/R elbow,
#  7/8 L/R wrist, 9/10 L/R hip, 11/12 L/R knee, 13/14 L/R ankle
SKELETON_EDGES = (
    (2, 0), (0, 1),                    # head_top - nose - head_bottom
    (1, 3), (1, 4),                    # neck - shoulders
    (3, 5), (5, 7), (4, 6), (6, 8),    # arms
    (3, 9), (4, 10), (9, 10),          # trunk
    (9, 11), (11, 13), (10, 12), (12, 14))  # legs

# canonical standing pose in torso units, +y down, origin at neck
_CANONICAL = np.array([
    (0.00, -0.25),   # nose
    (0.00, 0.00),    # head_bottom (neck)
    (0.00, -0.50),   # head_top
    (-0.35, 0.05), (0.35, 0.05),     # shoulders
    (-0.45, 0.55), (0.45, 0.55),     # elbows
    (-0.50, 1.05), (0.50, 1.05),     # wrists
    (-0.25, 1.00), (0.25, 1.00),     # hips
    (-0.28, 1.60), (0.28, 1.60),     # knees
    (-0.30, 2.20), (0.30, 2.20),     # ankles
], np.float32)

# joints articulated relative to their parent (angle jitter propagates
# down the chain so limbs stay connected)
_CHAINS = ((3, 5, 7), (4, 6, 8), (9, 11, 13), (10, 12, 14))


def sample_pose(rng: np.random.RandomState, jitter: float = 0.35
                ) -> np.ndarray:
    """One articulated pose in torso units: canonical + chain rotations."""
    kpts = _CANONICAL.copy()
    for chain in _CHAINS:
        for i, j in enumerate(chain):
            if i == 0:
                continue
            parent = chain[i - 1]
            ang = rng.uniform(-jitter, jitter) * (1.0 + 0.5 * i)
            c, s = np.cos(ang), np.sin(ang)
            rot = np.array([[c, -s], [s, c]], np.float32)
            for k in chain[i:]:
                kpts[k] = kpts[parent] + rot @ (kpts[k] - kpts[parent])
    lean = rng.uniform(-0.15, 0.15)
    c, s = np.cos(lean), np.sin(lean)
    kpts = kpts @ np.array([[c, s], [-s, c]], np.float32)
    return kpts


def _person_color(rng: np.random.RandomState):
    hue = rng.randint(0, 6)
    base = np.roll(np.array([230, 80, 40]), hue % 3)
    if hue >= 3:
        base = 255 - base
    return tuple(int(v) for v in base)


def render_people(img: np.ndarray, people, thickness_scale: float = 1.0):
    """Draw stick figures onto ``img`` in place.

    ``people``: list of (kpts_px (15,2), color) tuples, back-to-front.
    """
    import cv2

    for kpts, color in people:
        torso = float(np.linalg.norm(kpts[1] - (kpts[9] + kpts[10]) / 2))
        thick = max(2, int(torso * 0.16 * thickness_scale))
        pts = np.round(kpts).astype(int)
        for a, b in SKELETON_EDGES:
            cv2.line(img, tuple(pts[a]), tuple(pts[b]), color, thick,
                     cv2.LINE_AA)
        head_r = max(3, int(torso * 0.22))
        center = np.round((kpts[0] + kpts[2]) / 2).astype(int)
        cv2.circle(img, tuple(center), head_r, color, -1, cv2.LINE_AA)
        dark = tuple(max(0, c - 90) for c in color)
        for p in pts:
            cv2.circle(img, tuple(p), max(1, thick // 3), dark, -1,
                       cv2.LINE_AA)


def _background(rng: np.random.RandomState, H: int, W: int) -> np.ndarray:
    yy = np.linspace(0, 1, H, dtype=np.float32)[:, None, None]
    xx = np.linspace(0, 1, W, dtype=np.float32)[None, :, None]
    c0 = rng.uniform(40, 200, 3).astype(np.float32)
    c1 = rng.uniform(40, 200, 3).astype(np.float32)
    c2 = rng.uniform(40, 200, 3).astype(np.float32)
    img = c0 + (c1 - c0) * yy + (c2 - c0) * xx
    img += rng.randn(H, W, 3).astype(np.float32) * rng.uniform(2, 10)
    return np.clip(img, 0, 255).astype(np.uint8)


def generate_posetrack_dataset(root: str, num_videos: int = 20,
                               frames_per_video: int = 4,
                               height: int = 800, width: int = 1344,
                               max_persons: int = 4, seed: int = 0,
                               first_frame_index: int = 1,
                               name: str = "train") -> str:
    """Write a synthetic PoseTrack-format dataset; returns the json path.

    Every frame is labeled (``is_labeled=True``), so each frame anchors a
    T-frame clip.  People move with per-video constant velocity plus
    per-frame articulation jitter, giving the temporal axis real signal.
    """
    import cv2

    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    images, annotations = [], []
    img_id, aid, track = 0, 1, 0
    for v in range(num_videos):
        vid = f"{v + 1:06d}"
        vdir = osp.join(root, "images", f"{vid}_synth")
        os.makedirs(vdir, exist_ok=True)
        n_people = rng.randint(1, max_persons + 1)
        people = []
        for _ in range(n_people):
            torso = rng.uniform(0.10, 0.28) * height
            people.append(dict(
                pose=sample_pose(rng),
                torso=torso,
                pos=np.array([rng.uniform(0.15, 0.85) * width,
                              rng.uniform(0.10, 0.45) * height]),
                vel=rng.uniform(-0.012, 0.012, 2) * np.array(
                    [width, height]),
                color=_person_color(rng),
                track=track + 1 + _,
            ))
        track += n_people
        bg = _background(rng, height, width)
        for f in range(frames_per_video):
            frame_idx = f + first_frame_index
            img = bg.copy()
            draw, labels = [], []
            for p in people:
                kpts = sample_pose(rng) * 0.25 + p["pose"] * 0.75
                pos = p["pos"] + p["vel"] * f * 10
                kpts_px = kpts * p["torso"] + pos
                draw.append((kpts_px, p["color"]))
                labels.append((kpts_px, p))
            draw.sort(key=lambda t: t[0][:, 1].max())
            render_people(img, draw)
            fname = f"images/{vid}_synth/{frame_idx:08d}.jpg"
            cv2.imwrite(osp.join(root, fname), img)
            img_id += 1
            images.append(dict(
                id=img_id, file_name=fname, width=width, height=height,
                nframes=frames_per_video, frame_id=frame_idx,
                is_labeled=True, vid_id=vid))
            for kpts_px, p in labels:
                vis = ((kpts_px[:, 0] >= 0) & (kpts_px[:, 0] < width)
                       & (kpts_px[:, 1] >= 0) & (kpts_px[:, 1] < height))
                if vis.sum() < 8:
                    continue
                k3 = np.concatenate(
                    [kpts_px, np.where(vis, 2.0, 0.0)[:, None]], 1)
                k3[~vis, :2] = 0
                x0, y0 = kpts_px[vis].min(0)
                x1, y1 = kpts_px[vis].max(0)
                annotations.append(dict(
                    id=aid, image_id=img_id, category_id=1,
                    keypoints=np.round(k3, 2).reshape(-1).tolist(),
                    bbox=[float(x0), float(y0),
                          float(x1 - x0), float(y1 - y0)],
                    bbox_head=[float(kpts_px[2, 0] - 10),
                               float(kpts_px[2, 1] - 10), 20.0, 20.0],
                    area=float((x1 - x0) * (y1 - y0)),
                    num_keypoints=int(vis.sum()), iscrowd=0,
                    track_id=p["track"]))
                aid += 1
    ann = dict(images=images, annotations=annotations,
               categories=[dict(id=1, name="person",
                                keypoints=list(range(15)))])
    ann_path = osp.join(root, f"{name}.json")
    with open(ann_path, "w") as fh:
        json.dump(ann, fh)
    return ann_path


def main(argv=None):
    """CLI: write a train + held-out val split in one call.

    python -m pavenet_tpu_torch.datasets.synthetic --root data/synthetic
    """
    import argparse

    p = argparse.ArgumentParser(description="Generate synthetic "
                                "PoseTrack-format scenes")
    p.add_argument("--root", required=True)
    p.add_argument("--train-videos", type=int, default=150)
    p.add_argument("--val-videos", type=int, default=40)
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--height", type=int, default=800)
    p.add_argument("--width", type=int, default=1344)
    p.add_argument("--max-persons", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    for name, n, seed in (("train", args.train_videos, args.seed),
                          ("val", args.val_videos, args.seed + 10_000)):
        path = generate_posetrack_dataset(
            osp.join(args.root, name), num_videos=n,
            frames_per_video=args.frames, height=args.height,
            width=args.width, max_persons=args.max_persons, seed=seed,
            name=name)
        final = osp.join(args.root, f"{name}.json")
        os.replace(path, final)
        with open(final) as fh:
            meta = json.load(fh)
        # img_prefix is the split dir: rewrite file_name relative to root
        for im in meta["images"]:
            im["file_name"] = f"{name}/{im['file_name']}"
        with open(final, "w") as fh:
            json.dump(meta, fh)
        print(f"{name}: {len(meta['images'])} frames, "
              f"{len(meta['annotations'])} annotations -> {final}")


if __name__ == "__main__":
    main()
