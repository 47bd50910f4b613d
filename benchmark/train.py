"""Training cells: the recipe's mini-steps (``apis.train.train_step``:
forward, Hungarian matching on the host, losses, backward, the running
mean of ``cumulative_iters`` gradients, clipping and AdamW, the EMA where
the recipe has one) over a pool of batches, the uint8 clip copied to the
card each mini-step.

Set-up drives the train state through its first accumulation cycle, one
applied update, on batches that all differ; those mini-steps are the
warm-up and what the reference follows after the window. The window then
goes on with the same state. The traced run measures the same window,
then one cycle under ``torch.profiler``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from . import check, program
from . import devtrace
from .cost.model import clip_cost
from .cost.msda import bound_s
from .cost.peaks import FLOPS
from .harness import log, machine_drift, machine_state


def run(cell, args, t0: float, device) -> dict:
    import pavenet_tpu_torch.models.detectors.videopose as vp
    from pavenet_tpu_torch.apis.train import train_step
    from pavenet_tpu_torch.core.assigner import hungarian_assign
    from . import traffic as gen

    mix, config = cell.traffic, cell.config
    program.set_math(config)
    weights = program.seed_weights(config, args.seed, device)
    state = program.train_state(config, weights, args.seed, device)
    weights = program.on_host(weights)
    model = state.model
    cycle = state.accumulate_steps
    pool = gen.train_pool(mix, args.seed, model.num_frames,
                          model.num_keypoints, device)
    if len(pool) < cycle:
        raise ValueError("the pool must hold a whole accumulation cycle")

    # the first cycle, recorded for the check: losses, top-k, matching
    first = dict(losses=[], topk=[], assign=[])
    hook = model.head.register_forward_hook(
        lambda m, i, o: first["topk"].append(o["topk_idx"].cpu()))
    solve = vp.hungarian_assign

    def recording(costs, gt_valid):
        out = solve(costs, gt_valid)
        first["assign"].append([q.cpu() for q in out])
        return out

    vp.hungarian_assign = recording
    params0 = [p.detach().clone() for p in model.parameters()]
    try:
        for i in range(cycle):
            first["losses"].append(float(train_step(state, pool[i])["loss"]))
    finally:
        vp.hungarian_assign = solve
        hook.remove()
    prog_grad, prog_change = leaf_norms(state, params0)
    del params0
    program.sync(device)
    setup_s = time.perf_counter() - t0
    setup_peak = program.peak(device)
    program.reset_peak(device)
    machine0 = machine_state()

    seconds0 = hungarian_assign.seconds
    n = 0
    start = time.perf_counter()
    while True:
        train_step(state, pool[(cycle + n) % len(pool)])
        n += 1
        if time.perf_counter() - start >= args.seconds:
            program.sync(device)
            break
    window_s = time.perf_counter() - start
    log("machine over the window: "
        + machine_drift(machine0, machine_state()))
    clips = n * mix["clips_per_request"]
    match_s = hungarian_assign.seconds - seconds0
    window_peak = program.peak(device)
    e2e = dict(train_clips_per_s=clips / window_s,
               peak_mem_gib=window_peak / 2 ** 30, setup_s=setup_s)
    log(f"window: {n} mini-steps ({state.updates} updates so far) in "
        f"{window_s:.3f} s, matching {match_s * 1e3 / n:.3f} ms a "
        f"mini-step")

    run_info = None
    if args.trace:
        offset = cycle + n
        traced = devtrace.trace(
            lambda: [train_step(state, pool[(offset + i) % len(pool)])
                     for i in range(cycle)],
            lambda: [train_step(state, pool[(offset + i) % len(pool)])
                     for i in range(cycle)])
        tclips = cycle * mix["clips_per_request"]
        cost = clip_cost(config["config"]["model"], mix["height"],
                         mix["width"], mix["img_shape"], train=True,
                         max_gt=mix["gt_slots"],
                         batch=mix["clips_per_request"])
        log(f"traced rate {tclips / traced['window_s']:.4f} clips/s against "
            f"{e2e['train_clips_per_s']:.4f} untraced")
        run_info = dict(
            kind="train", clips_per_s=e2e["train_clips_per_s"],
            flops_per_clip=cost["flops"] / mix["clips_per_request"],
            peak_flops=FLOPS[config["peak"]],
            matching_s_per_clip=match_s / clips,
            trace=traced, trace_clips=tclips,
            msda_bwd_bound_s_per_clip=sum(
                bound_s(v, loc, backward=True)
                for v, loc in cost["msda_calls"])
            / mix["clips_per_request"])
    del state, model
    program.free(device)
    numbers = judge(cell, args.seed, weights, device, pool[:cycle], first,
                    prog_grad, prog_change)
    return dict(e2e=e2e, run=run_info, numbers=numbers, attempted=n,
                failed=0, memory_peak=max(setup_peak, window_peak),
                traced=run_info and run_info["trace"])


@torch.no_grad()
def leaf_norms(state, params0):
    """Per parameter leaf, after the first applied update: the gradient
    AdamW got (its first moment over ``1 - beta1``; NaN for a leaf it does
    not hold) and the norm of the change from ``params0``."""
    grads, changes = [], []
    beta1 = state.optimizer.defaults["betas"][0]
    for p, p0 in zip(state.model.parameters(), params0):
        st = state.optimizer.state.get(p, {})
        if "exp_avg" in st:
            grads.append(torch.linalg.vector_norm(st["exp_avg"].double())
                         / (1 - beta1))
        else:
            grads.append(torch.tensor(float("nan"), dtype=torch.float64,
                                      device=p.device))
        changes.append(torch.linalg.vector_norm((p - p0).double()))
    return (torch.stack(grads).cpu().numpy(),
            torch.stack(changes).cpu().numpy())


def judge(cell, seed, weights, device, batches, first, prog_grad,
          prog_change) -> dict:
    """The reference follows the program's first cycle on the same
    batches, dropout masks, top-k and matching (each judged), and the
    numbers of ``check`` compare the two."""
    from .reference.train import Trainer, normalise
    program.set_math(cell.config)
    model = program.reference_model(cell.config, weights, device)
    gen = torch.Generator(device=device).manual_seed(
        program.dropout_seed(seed))
    trainer = Trainer(model, cell.config["config"], gen,
                      cell.config["steps_per_epoch"])
    params0 = [p.detach().clone() for p in model.parameters()]
    keys = ("img", "img_shape", "scale_factor", "gt_keypoints", "gt_areas",
            "gt_valid")
    loss_gaps, topk, assign = [], 0.0, 0.0
    for i, batch in enumerate(batches):
        feed = {k: torch.as_tensor(batch[k]).to(device) for k in keys}
        feed = normalise(feed, *program.img_norm(cell.config))
        record = {}
        losses = trainer.step(feed, first["topk"][i].to(device),
                              first["assign"][i], record)
        ref_loss = float(losses["loss"])
        loss_gaps.append(abs(first["losses"][i] - ref_loss) / abs(ref_loss))
        topk = max(topk, check.topk_gap(record["topk_scores"],
                                        first["topk"][i]))
        assign = max(assign, check.assign_gap(
            record["costs"], first["assign"][i], feed["gt_valid"]))
    ref_grad = np.array(trainer.grad_norms)
    ref_change = np.array([
        float(torch.linalg.vector_norm((p.detach() - p0).double()))
        for p, p0 in zip(model.parameters(), params0)])
    moved = check.moved_leaves(ref_grad)
    # the leaves AdamW holds in the reference; where the program's holds
    # none, its gradient reads 0
    held = moved & np.array([i in trainer.exp_avg
                             for i in range(len(ref_grad))])
    prog_grad = np.nan_to_num(prog_grad, nan=0.0)
    names = [n for n, _ in model.named_parameters()]
    out = dict(loss_rel=max(loss_gaps), loss_median=float(np.median(
        loss_gaps)), topk_gap=topk, assign_gap=assign)
    for what, prog, ref, keep in (("grad", prog_grad, ref_grad, held),
                                  ("change", prog_change, ref_change, moved)):
        gaps = check.leaf_gaps(prog, ref, keep)
        i = int(gaps.argmax())
        log(f"worst {what} leaf {names[i]}: program {prog[i]!r}, reference "
            f"{ref[i]!r}, median leaf {np.median(ref[keep])!r}")
        out[f"{what}_leaf"] = float(gaps[i])
        out[f"{what}_median"] = float(np.median(gaps[keep]))
    return out
