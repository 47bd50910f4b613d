"""Distil a windowed-encoder student from a deformable-encoder teacher (as
``tools/distill.py`` of the JAX package).

    python -m pavenet_tpu_torch.tools.distill <windowed_config.py>
        <teacher_checkpoint.pt> [--work-dir D] [--steps N] [--lr LR]
        [--seed N] [--log-interval N] [--dtype f32|bf16]
        [--device cuda|cpu] [--dist-backend nccl|gloo]
        [--cfg-options k=v ...]

The config sets ``encoder.mode='windowed'`` (the student); the teacher is
the same config with the deformable encoder, its weights (parameters and
BatchNorm statistics) from a port checkpoint (``tools.train``). The
student copies every entry outside ``head.encoder_layer*`` from the
teacher (``apis/distill.py::create_distill_state``) and trains only its
encoder layers to reproduce the teacher's memory on ``data.train``
batches (``ClipLoader``, the uint8 feed normalised on the card). The
student's checkpoint, ``<work_dir>/step_<N>.pt``, evaluates with
``tools.test <windowed_config> <checkpoint>``. ``main(argv)`` returns a
summary (steps, last MSE, ms per step, checkpoint). The teacher may also
be a reference ``.pth`` (``apis/inference.py::load_checkpoint``).

Under a launcher (``parallel/dist.py``) each rank takes its shard of every
epoch with the teacher replicated, the MSE is the global batch's
(``apis/distill.py``), and rank 0 writes the log file and the
checkpoint.

Not here: ``--prebaked`` and ``--compile-cache`` (TPU-era options).
"""
from __future__ import annotations

import argparse
import copy
import os
import statistics
import time

from pavenet_tpu_torch.tools.train import add_dist_args


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Distil a windowed encoder from a deformable teacher",
        epilog="Left out (TPU-only): --prebaked, --compile-cache.")
    p.add_argument("config", help="windowed-encoder config (the student)")
    p.add_argument("teacher_checkpoint")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-interval", type=int, default=20)
    p.add_argument("--dtype", default="auto", choices=["auto", "f32", "bf16"],
                   help="activation dtype of teacher and student ('auto' "
                        "follows the config's act_dtype)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (under a launcher the rank's own card), "
                        "'cuda:N' or 'cpu'")
    add_dist_args(p)
    p.add_argument("--cfg-options", nargs="+", default=[])
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    import torch
    from pavenet_tpu_torch.parallel import dist
    from pavenet_tpu_torch.tools.train import load_config, start_ranks

    cfg = load_config(args.config, args.cfg_options)
    encoder = cfg.model.get("bbox_head", {}).get("transformer", {}).get(
        "encoder", {})
    if encoder.get("mode", "deformable") != "windowed":
        raise SystemExit("the config must set model.bbox_head.transformer."
                         "encoder.mode='windowed' (the student); got "
                         f"{encoder.get('mode', 'deformable')!r}")
    work_dir = args.work_dir or os.path.join(
        "work_dirs", os.path.splitext(os.path.basename(args.config))[0]
        + "_distill")
    if str(args.device).startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device (pass --device cpu "
                         "to distil on the CPU)")
    device, owns_group = start_ranks(args)
    try:
        return _distill(args, cfg, work_dir, device)
    finally:
        if owns_group:
            dist.destroy()


def _distill(args, cfg, work_dir, device) -> dict:
    from pavenet_tpu_torch.apis.distill import (create_distill_state,
                                                distill_step)
    from pavenet_tpu_torch.apis.inference import build_model, load_checkpoint
    from pavenet_tpu_torch.apis.prep import IMG_NORM_MEAN, IMG_NORM_STD
    from pavenet_tpu_torch.datasets import ClipLoader
    from pavenet_tpu_torch.datasets.pipelines import build_train_pipeline
    from pavenet_tpu_torch.parallel import dist
    from pavenet_tpu_torch.tools.train import build_dataset, rank_logger
    from pavenet_tpu_torch.utils.checkpoint import save_checkpoint
    from pavenet_tpu_torch.utils.seed import set_random_seed

    if dist.is_main():
        os.makedirs(work_dir, exist_ok=True)
    logger = rank_logger(
        os.path.join(work_dir, f"{time.strftime('%Y%m%d_%H%M%S')}.log"))
    rng = set_random_seed(args.seed)

    teacher_cfg = copy.deepcopy(cfg)
    teacher_cfg.model.bbox_head.transformer.encoder.mode = "deformable"
    teacher = build_model(teacher_cfg, args.seed, dtype=args.dtype)
    load_checkpoint(teacher, args.teacher_checkpoint)
    teacher.to(device)
    logger.info(f"teacher restored from {args.teacher_checkpoint}")

    pipe_kwargs = dict(cfg.get("train_pipeline_kwargs", {}) or {})
    img_norm = (tuple(pipe_kwargs.get("img_norm_mean", IMG_NORM_MEAN)),
                tuple(pipe_kwargs.get("img_norm_std", IMG_NORM_STD)))
    dataset = build_dataset(cfg, "train", build_train_pipeline(**pipe_kwargs))
    loader = ClipLoader(dataset,
                        batch_size=cfg.get("data", {}).get(
                            "samples_per_gpu", 1),
                        max_gt=cfg.get("max_gt", 30),
                        num_keypoints=dataset.NUM_KEYPOINTS, seed=args.seed,
                        num_shards=dist.world_size(),
                        shard_index=dist.rank(), rng=rng)
    if len(loader) == 0:
        raise SystemExit(f"{len(dataset)} training clips make no batch")
    state = create_distill_state(cfg, teacher, seed=args.seed,
                                 learning_rate=args.lr, img_norm=img_norm)

    step_s, mse = [], None
    t_iter = time.perf_counter()
    while state.step < args.steps:
        batches = iter(loader)
        for batch in batches:
            logs = distill_step(state, batch)
            mse = logs["distill_mse"].item()
            dt, t_iter = time.perf_counter() - t_iter, time.perf_counter()
            step_s.append(dt)
            if state.step % args.log_interval == 0 or state.step == 1:
                logger.info(f"step {state.step}/{args.steps} mse: {mse:.6f} "
                            f"rel: {logs['distill_rel'].item():.6f} "
                            f"({dt:.3f} s/it)")
            if state.step >= args.steps:
                break
        batches.close()
        loader.epoch += 1
    saved = os.path.join(work_dir, f"step_{state.step}.pt")
    if dist.is_main():
        saved = save_checkpoint(work_dir, state, state.step,
                                meta=dict(distilled_from=os.path.abspath(
                                    args.teacher_checkpoint)))
        logger.info(f"student checkpoint {saved}; evaluate with: python -m "
                    f"pavenet_tpu_torch.tools.test {args.config} {saved}")
    dist.barrier()
    return dict(steps=state.step, distill_mse=mse, checkpoint=saved,
                # the first step of a process includes its warm-up
                step_ms=statistics.median(step_s[1:] or step_s) * 1e3)


if __name__ == "__main__":
    main()
