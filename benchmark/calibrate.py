"""The readings that the limits of ``benchmark/limits/<cell>.json`` are set
from, in one process on the card:

    python3 benchmark/calibrate.py --workload <cell> --seeds S ...
        [--control-seeds S ...] [--seconds 3]

For each of ``--seeds`` a short run of the cell as ``run.py`` makes it
(set-up, a window of ``--seconds``, the check), and for each of
``--control-seeds`` the control: the reference put in the program's
place, its float32 products in TF32 (the next precision below the
configuration's), judged by the same check. Prints one JSON line a run
with every number compared. Not part of a benchmark run.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:] = [p for p in sys.path
               if Path(p or ".").resolve() != ROOT / "benchmark"]
sys.path.insert(0, str(ROOT))


def lower_precision(on: bool):
    """Matrix products in TF32 (the configurations state float32 for
    them; their convolutions are TF32 already)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = on


def control_serve(cell, seed: int, device, clips: int) -> dict:
    """The reference in TF32 serves ``clips`` clips of the pool; the
    reference in the configuration's precision judges them."""
    import torch
    from benchmark import program, serve, traffic
    from benchmark.reference.train import normalise
    program.set_math(cell.config)
    weights = program.seed_weights(cell.config, seed, device)
    ref = program.reference_model(cell.config, weights, device).eval()
    pool = traffic.serve_pool(cell.traffic, seed, ref.num_frames, device)
    kept = {}
    for i in range(min(clips, len(pool))):
        feed = {k: torch.as_tensor(pool[i][k]).to(device)
                for k in serve.KEYS}
        feed = normalise(feed, *program.img_norm(cell.config))
        record = {}
        lower_precision(True)
        with torch.no_grad():
            out = ref.forward_test(feed, record=record)
        lower_precision(False)
        kept[i] = ({k: v.cpu() for k, v in out.items()},
                   record["topk_idx"].cpu())
    return serve.judge(cell, weights, device, pool, kept, ref=ref)


def control_train(cell, seed: int, device) -> dict:
    """The reference in TF32 takes the first accumulation cycle; a fresh
    reference in the configuration's precision follows and judges it."""
    import numpy as np
    import torch
    from benchmark import program, train, traffic
    from benchmark.reference.train import BETAS, Trainer, normalise
    program.set_math(cell.config)
    weights = program.on_host(program.seed_weights(cell.config, seed,
                                                   device))
    model = program.reference_model(cell.config, weights, device)
    gen = torch.Generator(device=device).manual_seed(
        program.dropout_seed(seed))
    trainer = Trainer(model, cell.config["config"], gen,
                      cell.config["steps_per_epoch"])
    cycle = trainer.accumulate_steps
    pool = traffic.train_pool(cell.traffic, seed, model.num_frames,
                              model.num_keypoints, device)[:cycle]
    params0 = [p.detach().clone() for p in model.parameters()]
    first = dict(losses=[], topk=[], assign=[])
    lower_precision(True)
    for batch in pool:
        feed = {k: torch.as_tensor(batch[k]).to(device)
                for k in ("img", "img_shape", "scale_factor",
                          "gt_keypoints", "gt_areas", "gt_valid")}
        record = {}
        losses = trainer.step(normalise(feed, *program.img_norm(
            cell.config)), record=record)
        first["losses"].append(float(losses["loss"]))
        first["topk"].append(record["topk_idx"].cpu())
        first["assign"].append([a.cpu() for a in record["assign"]])
    lower_precision(False)
    grads = np.array([
        float(torch.linalg.vector_norm(trainer.exp_avg[i].double()))
        / (1 - BETAS[0]) if i in trainer.exp_avg else float("nan")
        for i in range(len(params0))])
    changes = np.array([float(torch.linalg.vector_norm((p - p0).double()))
                        for p, p0 in zip(model.parameters(), params0)])
    del trainer, model, params0
    program.free(device)
    return train.judge(cell, seed, weights, device, pool, first, grads,
                       changes)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--spec", default=None)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    from benchmark import check, harness, program
    from benchmark.run import parse_args
    cell = harness.lookup(a.workload, a.spec)
    kind = cell.traffic["kind"]
    driver = importlib.import_module(f"benchmark.{kind}")
    if a.device == "cuda":
        from pavenet_tpu_torch.ops import _ext
        _ext.build_all()
    for seed in a.seeds:
        t = time.perf_counter()
        args = parse_args(["--workload", a.workload, "--seed", str(seed),
                           "--seconds", str(a.seconds)])
        res = driver.run(cell, args, t, a.device)
        program.free(a.device)
        print(json.dumps(dict(side="program", seed=seed,
                              correct=check.verdict(res["numbers"],
                                                    cell.limits),
                              numbers=res["numbers"],
                              seconds=time.perf_counter() - t)), flush=True)
    for seed in a.control_seeds:
        t = time.perf_counter()
        nums = (control_serve(cell, seed, a.device,
                              cell.traffic["check_requests"])
                if kind == "serve" else control_train(cell, seed, a.device))
        program.free(a.device)
        print(json.dumps(dict(side="control", seed=seed,
                              correct=check.verdict(nums, cell.limits),
                              numbers=nums,
                              seconds=time.perf_counter() - t)), flush=True)


if __name__ == "__main__":
    main()
