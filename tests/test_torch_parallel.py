"""Data parallelism of the port over ``torch.distributed`` ranks, on the
CPU: two gloo processes (this file run as a script, a ``file://`` store
under ``tmp_path``, no TCP port) against one process on the same global
batch, as ``tests/test_parallel.py`` holds the JAX mesh against one
device.

- ``maybe_init_distributed`` is a no-op without a launcher's environment.
- ``ClipLoader``'s shards are disjoint, cover the dataset and equal the
  JAX loader's index for index; a shard whose rows fall into different
  buckets still yields exactly ``len(loader)`` batches.
- The train step at world size 2 (B=2 a rank) equals one process at B=4:
  the toy architecture of ``tests/test_parallel.py`` (R18, 32 dims, one
  layer each, 12 queries, dropout 0) with the from-scratch recipe's
  trainable BatchNorm (nothing frozen, backbone at the full lr) and
  ``accumulate_steps=2``. The losses of both mini-steps agree on both
  ranks and with the single process within ``1e-4 + 1e-4 |a|``; after the
  accumulation boundary the parameters and BatchNorm's running statistics
  agree within atol 5e-5, rtol 5e-4 (the JAX test's tolerances), and they
  moved. A tiny InsPose's losses and parameter gradients on each rank's
  rows add up to the single process's on the global batch (its
  normalisers: positives plus images, visible keypoints, offset and
  heatmap-offset counts, the AE terms' images are global sums). Both
  sides run in float64: the comparison is of the
  synchronisation, and float32 rounding through train-mode BatchNorm
  alone moves gradients by up to 3.9e-4 of a tensor's largest
  (``tests/test_torch_trainable_bn.py``), which AdamW's first step turns
  into sign flips of a whole lr. The single process's step on such a
  global batch is held against JAX by ``tests/test_torch_trainable_bn.py``
  and ``tests/test_torch_train.py``.
- A checkpoint written by rank 0 between the two mini-steps of an update
  (``TrainState.gather_accumulation`` first) and resumed on both ranks
  ends where the uninterrupted process ends.
- The distillation step at world size 2 equals one process (the MSE,
  ``rel``, the gradient norm, the student's weights after the update).
- ``run_inference`` and ``run_det_inference`` (DK-DETR, its text
  embeddings on every rank) over two ranks, after ``gather_detections``,
  equal one process by ``image_id``, a repeat-padded tail row dropped.
- ``tools.train`` at world size 2 on the tiny config's synthetic scenes
  (``--device cpu --dist-backend gloo``): both ranks take the same
  mini-steps with the same losses, and rank 0 alone writes the one
  checkpoint.

The two processes run every step scenario in one spawn, and the two CLI
ranks alongside them; each process has a time limit, and the group's
collectives time out after 120 s.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from pavenet_tpu_torch.apis import train as ttrain  # noqa: E402
from pavenet_tpu_torch.apis.distill import (create_distill_state,  # noqa
                                            distill_step)
from pavenet_tpu_torch.apis.test import (gather_detections,  # noqa: E402
                                         run_det_inference, run_inference)
from pavenet_tpu_torch.datasets import ClipLoader  # noqa: E402
from pavenet_tpu_torch.models import dummy_clip_batch  # noqa: E402
from pavenet_tpu_torch.models.detectors.inspose import (  # noqa: E402
    InsPoseDetector)
from pavenet_tpu_torch.models.zoo import (pavenet_r50_frames3,  # noqa: E402
                                          soit_r50_coco)
from pavenet_tpu_torch.parallel import dist  # noqa: E402

WORLD = 2
ROWS = 2                      # per rank; the global batch holds 4
PROC_TIMEOUT = 300            # seconds a spawned process may take
TOY = dict(backbone_depth=18, embed_dims=32, num_encoder_layers=1,
           num_decoder_layers=1, num_refine_layers=1, num_query=12,
           feedforward_channels=64, dropout=0.0)
DET_TOY = dict(num_classes=5, num_query=12, max_gt=4, backbone_depth=18,
               embed_dims=32, num_encoder_layers=1, num_decoder_layers=1,
               feedforward_channels=64, max_per_img=6, cls_emb_dim=16,
               dropout=0.0)
INSPOSE_TOY = dict(num_keypoints=17, backbone_depth=18,
                   feat_channels=32, feat_channels_kpt=32,
                   feat_channels_hm=32, shared_channels=32, stacked_convs=1,
                   stacked_convs_kpt=1, stacked_convs_hm=2, max_per_img=4)
F64 = torch.float64
LOSS_TOL = (1e-4, 1e-4)       # abs, rel
STATE_TOL = dict(atol=5e-5, rtol=5e-4)
CLI_SCENES = ["--train-videos", "2", "--val-videos", "1", "--frames", "4",
              "--height", "96", "--width", "128", "--seed", "0"]


# ---------------------------------------------------------------- models
def toy_pose(**kw):
    """The toy PAVE-Net in float64 (parameters too), seeded init."""
    model = pavenet_r50_frames3(**TOY, dtype=F64, **kw)
    model.init_weights(torch.Generator().manual_seed(0))
    return model.double()


def toy_det():
    model = soit_r50_coco(**DET_TOY, dtype=F64)
    model.init_weights(torch.Generator().manual_seed(0))
    return model.double().eval()


def train_batches():
    rng = np.random.RandomState(0)
    return [dummy_clip_batch(rng, batch_size=ROWS * WORLD, height=64,
                             width=96, max_gt=3, train=True)
            for _ in range(2)]


def pose_batch():
    """Four clips, the last a repeat-padded row."""
    batch = dummy_clip_batch(np.random.RandomState(1),
                             batch_size=ROWS * WORLD, height=96, width=128)
    batch["image_id"] = np.arange(ROWS * WORLD, dtype=np.int64)
    batch["_row_valid"] = np.arange(ROWS * WORLD) < ROWS * WORLD - 1
    return batch


def det_batch():
    rng = np.random.RandomState(2)
    B, H, W = ROWS * WORLD, 64, 96
    return dict(
        img=rng.randn(B, 1, H, W, 3).astype(np.float32),
        img_shape=np.tile(np.array([[H, W - 10]], np.int32), (B, 1)),
        scale_factor=np.ones((B, 2), np.float32),
        image_id=np.arange(B, dtype=np.int64),
        _row_valid=np.arange(B) < B - 1)


def inspose_batch():
    """Four images at 64x96 with 3 GT slots: boxes, keypoints inside them
    (a third invisible), 3, 2, 1 and 0 valid slots."""
    rng = np.random.RandomState(4)
    B, H, W, G, K = ROWS * WORLD, 64, 96, 3, 17
    x0, y0 = rng.uniform(0, 50, (B, G)), rng.uniform(0, 30, (B, G))
    bw, bh = rng.uniform(15, 45, (B, G)), rng.uniform(15, 30, (B, G))
    kpts = np.stack([x0[..., None] + rng.rand(B, G, K) * bw[..., None],
                     y0[..., None] + rng.rand(B, G, K) * bh[..., None],
                     (rng.rand(B, G, K) > 0.3) * 2.0], -1)
    return dict(img=rng.randn(B, H, W, 3),
                img_shape=np.tile(np.array([[H, W]], np.int32), (B, 1)),
                gt_boxes=np.stack([x0, y0, x0 + bw, y0 + bh], -1),
                gt_keypoints=kpts,
                gt_valid=np.arange(G)[None] < np.array([3, 2, 1, 0])[:, None])


def inspose_run(batch):
    """The tiny InsPose's losses and parameter gradients in float64 on
    ``batch``: on a rank, its share of the global batch's."""
    model = InsPoseDetector(**INSPOSE_TOY, dtype=F64)
    model.init_weights(torch.Generator().manual_seed(0))
    model.double()
    losses = model.forward_train({k: torch.from_numpy(np.asarray(v))
                                  for k, v in batch.items()})
    losses["loss"].backward()
    return dict(losses={k: v.item() for k, v in losses.items()},
                grads={n: p.grad.clone() for n, p in model.named_parameters()
                       if p.grad is not None})


def text_feats():
    return np.random.RandomState(3).randn(5, 16).astype(np.float32)


def rows(batch, rank):
    """Rank ``rank``'s rows of a global batch."""
    return {k: v[rank * ROWS:(rank + 1) * ROWS] for k, v in batch.items()}


# ------------------------------------------------------------- scenarios
def toy_state():
    """The trainable-BatchNorm toy's train state: two mini-steps an
    update."""
    model = toy_pose(norm_eval=False, frozen_stages=-1)
    return ttrain.TrainState(
        model=model, optimizer=ttrain.build_optimizer(
            model, backbone_lr_mult=1.0),
        schedule=lambda updates: 1e-4, grad_clip=0.1, accumulate_steps=2,
        generator=torch.Generator().manual_seed(dist.rank()), max_gt=3)


def train_run(batches):
    """Two mini-steps (one update) of the trainable-BatchNorm toy."""
    state = toy_state()
    losses = [{k: v.item() for k, v in ttrain.train_step(state, b).items()}
              for b in batches]
    return dict(losses=losses, updates=state.updates,
                state={k: v.clone()
                       for k, v in state.model.state_dict().items()})


def resume_run(batches, path):
    """The same two mini-steps with a checkpoint between them: rank 0
    saves after the first (the accumulation gathered onto it), and a
    fresh state on every rank resumes from that file for the second."""
    first = toy_state()
    ttrain.train_step(first, batches[0])
    first.gather_accumulation()
    if dist.rank() == 0:
        torch.save(first.state_dict(), path)
    dist.barrier()
    second = toy_state()
    second.load_state_dict(torch.load(path, weights_only=True))
    ttrain.train_step(second, batches[1])
    return {k: v.clone() for k, v in second.model.state_dict().items()}


def distill_run(batch):
    """One distillation step of a windowed toy student from the
    deformable toy teacher."""
    state = create_distill_state(toy_pose(encoder_mode="windowed"),
                                 toy_pose(), learning_rate=1e-4)
    logs = {k: v.item() for k, v in distill_step(state, batch).items()}
    return dict(logs=logs, student={k: v.clone() for k, v in
                                    state.student.state_dict().items()})


def inference_run(pose, det):
    dets = gather_detections(run_inference(toy_pose(max_per_img=4).eval(),
                                           [pose]))
    det_dets = gather_detections(run_det_inference(
        toy_det(), [det], score_thr=0.0, text_feats=text_feats()))
    return dict(pose=dets, det=det_dets)


def worker(mode, out, argv):
    """One rank: the step scenarios on its rows, or ``tools.train``."""
    torch.set_num_threads(1)
    sys.modules["tensorflow"] = None     # keeps the metric sink light
    if mode == "cli":
        from pavenet_tpu_torch.tools import train
        result = train.main(argv)
    else:
        assert dist.maybe_init_distributed(backend="gloo", device="cpu")
        r = dist.rank()
        mine = [rows(b, r) for b in train_batches()]
        result = dict(
            world=dist.world_size(), rank=r, train=train_run(mine),
            resumed=resume_run(mine, os.path.join(out, "mid_update.pt")),
            distill=distill_run(rows(train_batches()[0], r)),
            inspose=inspose_run(rows(inspose_batch(), r)),
            infer=inference_run(rows(pose_batch(), r),
                                rows(det_batch(), r)))
        dist.destroy()
    torch.save(result, os.path.join(out, f"{mode}{os.environ['RANK']}.pt"))


def spawn(mode, store, out, argv=()):
    """The ``WORLD`` ranks of ``mode`` as processes of this file."""
    procs = []
    for r in range(WORLD):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE=str(WORLD), PAVENET_DIST_INIT=f"file://{store}",
                   PAVENET_DIST_TIMEOUT="120", PYTHONPATH=REPO,
                   OMP_NUM_THREADS="1")
        env.pop("PAVENET_DISTRIBUTED", None)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), mode, str(out),
             *argv], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


def wait(procs):
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=PROC_TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results of the step scenarios and of ``tools.train``,
    and the single process's on the global batches."""
    from pavenet_tpu_torch.datasets import synthetic
    tmp = tmp_path_factory.mktemp("ddp")
    data, work = tmp / "data", tmp / "work"
    synthetic.main(["--root", str(data)] + CLI_SCENES)
    opts = ["--cfg-options", "data.samples_per_gpu=1"] + [
        f"data.{s}.{k}={data}/{v}" for s, j in (
            ("train", "train"), ("val", "val"), ("test", "val"))
        for k, v in (("ann_file", j + ".json"), ("img_prefix", ""))]
    procs = spawn("steps", tmp / "store_steps", tmp)
    cli = spawn("cli", tmp / "store_cli", tmp, [
        "configs/videopose/pavenet_tiny_debug.py", "--work-dir", str(work),
        "--device", "cpu", "--dist-backend", "gloo", "--max-steps", "2",
        "--no-validate", "--seed", "0"] + opts)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        single = dict(train=train_run(train_batches()),
                      distill=distill_run(train_batches()[0]),
                      inspose=inspose_run(inspose_batch()),
                      infer=inference_run(pose_batch(), det_batch()))
    finally:
        torch.set_num_threads(n)
        wait(procs + cli)
    load = [torch.load(tmp / f"{m}{r}.pt", weights_only=False)
            for m in ("steps", "cli") for r in range(WORLD)]
    return dict(single=single, steps=load[:WORLD], cli=load[WORLD:],
                work=work)


def close(a, b, atol, rtol):
    return abs(a - b) <= atol + rtol * abs(a)


# ----------------------------------------------------------------- tests
def test_maybe_init_distributed_is_a_noop_without_a_launcher(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "SLURM_NTASKS", "PAVENET_DISTRIBUTED"):
        monkeypatch.delenv(var, raising=False)
    assert dist.maybe_init_distributed(backend="gloo", device="cpu") is False
    assert (dist.active(), dist.rank(), dist.world_size()) == (False, 0, 1)
    t = torch.arange(3.0)
    assert dist.global_sum(t) is t and dist.global_sum_grad(t) is t
    scalars = {"a": t[0]}
    assert dist.all_reduce_scalars(scalars) is scalars


class _Clips:
    """A dataset of ``n`` clips whose bucket (image height) follows
    ``heights``; ``prepare`` for the port's loader, ``__getitem__`` for the
    JAX one."""

    def __init__(self, n, heights=(8,)):
        self.n, self.heights = n, heights

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        h = self.heights[i % len(self.heights)]
        return dict(img=np.zeros((1, h, 8, 3), np.float32),
                    img_shape=np.array([h, 8], np.int32),
                    scale_factor=np.ones(2, np.float32), image_id=i,
                    gt_keypoints=np.zeros((1, 15, 3), np.float32),
                    gt_areas=np.ones((1,), np.float32))

    def prepare(self, i, rng):
        return self[i]


def test_loader_shards_match_jax_and_fill_every_step():
    from pavenet_tpu.datasets.loader import ClipLoader as JClipLoader

    def ids(loader, epochs=2):
        """Each epoch's batches as (image ids, real-row flags)."""
        return [[(b["image_id"].tolist(), b["_row_valid"].tolist())
                 for b in loader] for _ in range(epochs)]

    for n, drop_last, shuffle in ((12, True, True), (11, False, False),
                                  (13, False, True)):
        seen = []
        for s in range(WORLD):
            kw = dict(batch_size=2, shuffle=shuffle, drop_last=drop_last,
                      num_shards=WORLD, shard_index=s, prefetch=0, seed=3)
            port, jax_loader = (ClipLoader(_Clips(n), **kw),
                                JClipLoader(_Clips(n), **kw))
            assert len(port) == len(jax_loader)
            got = ids(port)
            assert got == ids(jax_loader), (n, s)
            seen.append([i for batch, real in got[0]
                         for i, v in zip(batch, real) if v])
        assert not set(seen[0]) & set(seen[1])
        if not drop_last:
            assert sorted(seen[0] + seen[1]) == list(range(n))

    # shard 1 draws clips 1, 3, 5, 7 of buckets 8, 10, 12, 8: one full
    # batch of 2 in a pass where len() is 2. The JAX loader yields 1 (a
    # rank would wait for the other in a collective); the port's shard
    # wraps around its own clips to exactly len() batches
    heights = (8, 8, 8, 10, 8, 12, 8, 8)
    for s in range(WORLD):
        kw = dict(batch_size=2, shuffle=False, num_shards=WORLD,
                  shard_index=s, prefetch=0)
        port = ClipLoader(_Clips(8, heights), **kw)
        batches = [b["image_id"].tolist() for b in port]
        assert len(batches) == len(port) == 2, (s, batches)
        first = [b["image_id"].tolist()
                 for b in JClipLoader(_Clips(8, heights), **kw)]
        assert batches[:len(first)] == first
        assert all(len(b) == 2 for b in batches)
    assert len(first) == 1


def test_train_step_over_two_ranks_equals_one_process(ranks):
    single = ranks["single"]["train"]
    assert single["updates"] == 1
    for res in ranks["steps"]:
        assert res["world"] == WORLD
        got = res["train"]
        assert got["updates"] == 1
        for want_l, got_l in zip(single["losses"], got["losses"]):
            assert set(want_l) == set(got_l)
            for k, a in want_l.items():
                assert close(a, got_l[k], *LOSS_TOL), (res["rank"], k, a,
                                                       got_l[k])
        for k, want in single["state"].items():
            np.testing.assert_allclose(got["state"][k].numpy(), want.numpy(),
                                       err_msg=k, **STATE_TOL)
    # both ranks hold the same state, bit for bit (one update, the same
    # summed gradient), and it moved from the init: every parameter with a
    # gradient and every running statistic
    a, b = (r["train"]["state"] for r in ranks["steps"])
    assert all(torch.equal(a[k], b[k]) for k in a)
    init = toy_pose(norm_eval=False, frozen_stages=-1).state_dict()
    stats = [k for k in init if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 20
    assert all(not torch.equal(init[k], a[k]) for k in stats)
    assert sum(not torch.equal(init[k], a[k]) for k in init) > len(init) // 2

    # InsPose: the ranks' shares add up to the global batch's losses and
    # gradients
    want = ranks["single"]["inspose"]
    parts = [r["inspose"] for r in ranks["steps"]]
    assert len(want["losses"]) == 8
    for k, a in want["losses"].items():
        assert close(a, sum(p["losses"][k] for p in parts), *LOSS_TOL), k
    assert len(want["grads"]) > 100
    for n, g in want["grads"].items():
        got = sum(p["grads"].get(n, torch.zeros_like(g)) for p in parts)
        np.testing.assert_allclose(got.numpy(), g.numpy(), rtol=0,
                                   atol=1e-6 * g.abs().max().item() + 1e-12,
                                   err_msg=n)


def test_resume_over_two_ranks_mid_accumulation(ranks):
    """A checkpoint between the two mini-steps of an update: the resumed
    ranks end where the uninterrupted process does."""
    want = ranks["single"]["train"]["state"]
    for res in ranks["steps"]:
        for k, w in want.items():
            np.testing.assert_allclose(res["resumed"][k].numpy(), w.numpy(),
                                       err_msg=k, **STATE_TOL)


def test_distill_step_over_two_ranks_equals_one_process(ranks):
    want = ranks["single"]["distill"]
    for res in ranks["steps"]:
        got = res["distill"]
        for k, a in want["logs"].items():
            assert close(a, got["logs"][k], *LOSS_TOL), (k, a, got["logs"])
        for k, w in want["student"].items():
            np.testing.assert_allclose(got["student"][k].numpy(), w.numpy(),
                                       err_msg=k, **STATE_TOL)
    enc = [k for k in want["student"] if k.startswith("head.encoder_layer")
           and k.endswith("weight")]
    init = toy_pose(encoder_mode="windowed").state_dict()
    assert enc and all(not torch.equal(init[k], want["student"][k])
                       for k in enc)


def test_inference_over_two_ranks_equals_one_process(ranks):
    want = ranks["single"]["infer"]
    for res in ranks["steps"]:
        got = res["infer"]
        # the pose model: every valid clip's detections, none of the
        # repeat-padded row's
        assert len(got["pose"]) == len(want["pose"]) > 0
        assert {d["image_id"] for d in want["pose"]} == {0, 1, 2}
        for a, b in zip(want["pose"], got["pose"]):
            assert a["image_id"] == b["image_id"]
            assert a["score"] == pytest.approx(b["score"], rel=1e-5,
                                               abs=1e-6)
            np.testing.assert_allclose(a["keypoints"], b["keypoints"],
                                       rtol=1e-4, atol=1e-3)
        # DK-DETR, the text embeddings replicated on each rank
        assert len(got["det"]) == len(want["det"]) == 3 * 6
        for a, b in zip(want["det"], got["det"]):
            assert (a["image_id"], a["category_id"]) == (
                b["image_id"], b["category_id"])
            assert a["score"] == pytest.approx(b["score"], rel=1e-4,
                                               abs=1e-5)
            np.testing.assert_allclose(a["bbox"], b["bbox"], rtol=1e-4,
                                       atol=1e-3)
            assert (a["segmentation"] == b["segmentation"]).mean() > 0.999


def test_train_cli_over_two_ranks(ranks):
    a, b = ranks["cli"]
    assert a["steps"] == b["steps"] == 2 and a["steps_run"] == 2
    assert a["updates"] == b["updates"] == 1
    assert a["losses"] == b["losses"]
    assert all(np.isfinite(v) for v in a["losses"].values())
    ckpts = sorted(f for f in os.listdir(ranks["work"]) if f.endswith(".pt"))
    assert ckpts == ["step_2.pt"]
    assert a["checkpoint"] == b["checkpoint"] == str(
        ranks["work"] / "step_2.pt")
    logs = [f for f in os.listdir(ranks["work"]) if f.endswith(".log")]
    assert len(logs) == 1
    metrics = [json.loads(line) for line in open(
        ranks["work"] / "metrics.jsonl")]
    assert [m["step"] for m in metrics] == [1]     # rank 0's line alone


if __name__ == "__main__":
    worker(sys.argv[1], sys.argv[2], sys.argv[3:])
