"""PoseTrack MOTA: the port's ``core/eval/posetrack_track_eval.py`` and the
``track_id`` branch of ``apis/test.py::evaluate_dataset`` against the JAX
package, on seeded synthetic frames (numpy only, no model).

Frames of three sequences with moving GT tracks; the predictions are the
GT jittered by a few pixels with joints dropped, tracks that swap ids
halfway, missed poses, false positives and frames without GT or without
predictions (the protocol's dummy pair). Every metric equal to 1e-12,
the per-joint MOTA arrays equal (NaN where a joint has no object). The
accumulator alone on hand-made event streams: equal counts.
"""
import json

import numpy as np
import pytest

from pavenet_tpu.apis import test as jtest
from pavenet_tpu.core.eval import posetrack_eval as jposetrack_eval
from pavenet_tpu.core.eval import posetrack_track_eval as jtrack
from pavenet_tpu_torch.apis import test as ttest
from pavenet_tpu_torch.core.eval import (MotAccumulator,
                                         evaluate_posetrack_mota,
                                         frames_from_coco)
from tests.test_torch_eval_cli import SCENES, assert_same_metrics, datasets

J = 15
COUNTS = ("num_objects", "num_misses", "num_switches", "num_false_positives",
          "num_detections", "sum_d")


def synthetic_frames(seed):
    """(frames, seq_ids): 3 sequences of 6 frames, 1-4 tracks each."""
    rng = np.random.RandomState(seed)
    frames, seq_ids = [], []
    for seq in range(3):
        n_tracks = rng.randint(1, 5)
        start = rng.rand(n_tracks, J, 2) * 200 + 20
        vel = rng.randn(n_tracks, 1, 2) * 3
        swap_at = rng.randint(2, 5)
        for f in range(6):
            pts = start + vel * f
            vis = (rng.rand(n_tracks, J) > 0.15).astype(float)
            gt = np.concatenate([pts, vis[..., None]], -1)
            heads = np.concatenate([pts[:, 0] - 15, pts[:, 0] + 15], -1)
            gt_tids = list(range(10 * seq, 10 * seq + n_tracks))
            pr = pts + rng.randn(n_tracks, J, 2) * 4
            pr_valid = rng.rand(n_tracks, J) > 0.1
            pr_tids = [100 + t for t in gt_tids]
            if f >= swap_at and n_tracks > 1:
                pr_tids[0], pr_tids[1] = pr_tids[1], pr_tids[0]
            keep = rng.rand(n_tracks) > 0.2           # missed poses
            pr, pr_valid = pr[keep], pr_valid[keep]
            pr_tids = [p for p, k in zip(pr_tids, keep) if k]
            if rng.rand() < 0.4:                      # a false positive
                pr = np.concatenate([pr, rng.rand(1, J, 2) * 240], 0)
                pr_valid = np.concatenate([pr_valid, np.ones((1, J), bool)])
                pr_tids.append(999)
            if f == 3 and seq == 1:                   # no GT
                gt, heads, gt_tids = gt[:0], heads[:0], []
            if f == 2 and seq == 2:                   # no predictions
                pr, pr_valid, pr_tids = pr[:0], pr_valid[:0], []
            frames.append(dict(gt_points=gt, gt_head_boxes=heads,
                               gt_track_ids=gt_tids, pr_points=pr,
                               pr_valid=pr_valid, pr_track_ids=pr_tids,
                               pr_scores=np.ones(len(pr))))
            seq_ids.append(seq)
    return frames, seq_ids


def assert_same_mota(got, want):
    np.testing.assert_array_equal(got.pop("mota_per_joint"),
                                  want.pop("mota_per_joint"))
    assert_same_metrics(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mota_matches_jax(seed):
    frames, seq_ids = synthetic_frames(seed)
    got = evaluate_posetrack_mota(frames, seq_ids)
    want = jtrack.evaluate_posetrack_mota(frames, seq_ids)
    assert list(got) == ["MOTA", "MOTP", "Precision", "Recall",
                         "mota_per_joint"]
    assert -100 < got["MOTA"] < 100 and got["Recall"] > 0
    assert_same_mota(got, want)


def test_accumulator_events_match_jax():
    """Carried correspondences, a switch, infeasible pairs, misses and
    false positives over four frames."""
    nan = np.nan
    stream = [([1, 2], ["a", "b"], [[0.1, 0.4], [0.3, 0.2]]),
              ([1, 2], ["a", "b"], [[0.1, nan], [nan, 0.2]]),
              ([1, 2, 3], ["b", "a"], [[0.1, 0.3], [0.2, nan], [nan, nan]]),
              ([2], ["c", "a"], [[nan, 0.05]])]
    got, want = MotAccumulator(), jtrack.MotAccumulator()
    for oids, hids, d in stream:
        got.update(oids, hids, d)
        want.update(oids, hids, d)
        assert ({k: getattr(got, k) for k in COUNTS}
                == {k: getattr(want, k) for k in COUNTS})
        assert got.m == want.m
    assert got.num_switches > 0 and got.num_misses > 0


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    from pavenet_tpu_torch.datasets import synthetic
    root = tmp_path_factory.mktemp("scenes")
    synthetic.main(["--root", str(root)] + SCENES)
    return root


def test_evaluate_dataset_track_branch_matches_jax(scenes):
    """GT with its track ids as detections, jittered, one track's id taken
    by another halfway through each video, one false positive per frame:
    ``evaluate_dataset`` adds MOTA beside the AP; without track ids it
    does not."""
    jds, ds = datasets(scenes)
    with open(scenes / "val.json") as f:
        ann = json.load(f)
    rng = np.random.RandomState(0)
    frame_of = {im["id"]: im.get("frame_id", 0) for im in ann["images"]}
    dets = []
    for a in ann["annotations"]:
        k = np.asarray(a["keypoints"], np.float64).reshape(-1, 3)
        k[:, :2] += rng.randn(len(k), 2) * 3.0
        k[:, 2] = rng.rand(len(k))
        tid = a["track_id"]
        if frame_of[a["image_id"]] >= 2 and tid % 2 == 0:
            tid += 1
        dets.append(dict(image_id=a["image_id"], category_id=1,
                         keypoints=k.reshape(-1).tolist(),
                         score=float(rng.rand()), track_id=tid))
    for im in ann["images"]:
        k = np.concatenate([rng.rand(15, 1) * 128, rng.rand(15, 1) * 96,
                            rng.rand(15, 1)], 1)
        dets.append(dict(image_id=im["id"], category_id=1,
                         keypoints=k.reshape(-1).tolist(),
                         score=float(rng.rand()), track_id=500 + im["id"]))
    got = ttest.evaluate_dataset(ds, dets)
    assert {"posetrack/MOTA", "posetrack/MOTP", "posetrack/Precision",
            "posetrack/Recall"} <= set(got)
    assert_same_metrics(got, jtest.evaluate_dataset(jds, dets))
    frames = frames_from_coco(ds.coco, dets)
    seq = [fr["seq_id"] for fr in frames]
    assert_same_mota(evaluate_posetrack_mota(frames, seq),
                     jtrack.evaluate_posetrack_mota(
                         jposetrack_eval.frames_from_coco(jds.coco, dets),
                         seq))
    plain = [{k: v for k, v in d.items() if k != "track_id"} for d in dets]
    assert not any("MOTA" in k for k in ttest.evaluate_dataset(ds, plain))
