"""The msda kernels' plan and work partition
(``pavenet_tpu_torch/ops/_ext.py::msda_plan``, ``csrc/msda_fwd.cu``,
``csrc/msda_bwd.cu``) on the CPU.

The kernels run only on the card (``chip_smoke.py`` holds them against the
plain version there). Here the plan is checked at the main-path shapes,
and a numpy emulation of the kernels' partition (per-(b, h) query chunks,
staged levels gathered from or accumulated into a per-block table that is
flushed once, the other levels read and added directly) is held against
``ms_deform_attn_torch`` and its autograd on seeded inputs.
"""
import numpy as np
import pytest
import torch

from pavenet_tpu_torch.ops import _ext
from pavenet_tpu_torch.ops.ms_deform_attn import ms_deform_attn_torch

FLAGSHIP = ((100, 168), (50, 84), (25, 42), (13, 21))
EDGE = ((6, 9), (3, 5), (1, 3), (2, 1))
SMALL = ((5, 7), (1, 1), (3, 2))
# SOIT's and DK-DETR's dynamic mask call: one level (the 800x1344 bucket's
# level 0), 4 heads of 2 channels, 4 points, M instances x 16800 queries;
# MASK_SMALL is its one-level shape at a test's size
MASK = ((100, 168),)
MASK_SMALL = ((6, 9),)
# heads of the partition cases: the mask call's 4, else 2
HEADS = {MASK_SMALL: 4}


@pytest.mark.parametrize("backward, dtype, chunk, threads, smem", [
    (False, torch.float32, 1015, 1024, 169344),
    (True, torch.float32, 508, 1024, 169344),
    (False, torch.bfloat16, 1015, 512, 84672),
    (True, torch.bfloat16, 508, 1024, 169344),
])
def test_plan_flagship_encoder(backward, dtype, chunk, threads, smem):
    """The encoder call (3, 22323, 8, 4, 4, 32): 22 chunks of 1015 queries
    per (b, h) forward, 44 of 508 backward; levels 3 and 2 staged (the
    block's 4060 or 2032 taps outnumber their 273 and 1050 rows, not level
    1's 4200), level 3 first."""
    plan = _ext.msda_plan(FLAGSHIP, 3, 22323, 8, 4, 32, dtype, backward)
    assert plan.chunk == chunk
    assert plan.levels == ((100, 168, -1), (50, 84, -1), (25, 42, 273),
                           (13, 21, 0))
    assert (plan.threads, plan.smem) == (threads, smem)


@pytest.mark.parametrize("Q, P, fwd_threads, bwd_threads", [
    (300, 15, 64, 64), (300, 4, 64, 64), (450, 4, 96, 96)])
def test_plan_decoders_stage_nothing(Q, P, fwd_threads, bwd_threads):
    """The pose-decoder (P=15) and joint-decoder calls: chunks of 14 or 21
    queries forward, 7 or 11 backward, give no level more taps than rows,
    and the block takes only the lanes its chunk needs (4 per query
    forward, 8 backward)."""
    for backward, threads in ((False, fwd_threads), (True, bwd_threads)):
        plan = _ext.msda_plan(FLAGSHIP, 3, Q, 8, P, 32, torch.float32,
                              backward)
        assert plan.smem == 0 and plan.threads == threads
        assert all(r == -1 for _, _, r in plan.levels)


def test_plan_edge_levels():
    """One query per block, 15 taps per level: the 2x1 and 1x3 levels
    (coarsest first) are staged, the 3x5 level (15 rows) is not."""
    plan = _ext.msda_plan(EDGE, 2, 7, 2, 15, 4, torch.float32, True)
    assert plan.chunk == 1 and plan.threads == 32
    assert plan.levels == ((6, 9, -1), (3, 5, -1), (1, 3, 2), (2, 1, 0))
    assert plan.smem == 5 * 4 * 4


@pytest.mark.parametrize("B, M, backward, dtype, chunk", [
    (1, 100, False, torch.float32, 12728),        # SOIT serve
    (1, 100, False, torch.bfloat16, 12728),
    (1, 100, True, torch.float32, 6364),
    (1, 100, True, torch.bfloat16, 6364),
    (1, 300, False, torch.float32, 38182),        # DK-DETR serve
    (1, 300, True, torch.float32, 19091),
    (2, 30, False, torch.float32, 7637),          # SOIT train
    (2, 30, True, torch.float32, 3819),
    (1, 30, False, torch.float32, 3819),          # DK-DETR train
    (1, 30, True, torch.float32, 1910),
])
def test_plan_dynamic_mask_call(B, M, backward, dtype, chunk):
    """The mask call (B, M x 16800, 4, 1, 4, 2): one lane an item in both
    directions; its one level (16800 rows) is never staged forward (four
    blocks of 256 threads an SM) and always backward (its 134,400-byte f32
    gradient table, one block of 1024 threads an SM), whatever the
    chunk's taps."""
    plan = _ext.msda_plan(MASK, B, M * 16800, 4, 4, 2, dtype, backward)
    assert plan.chunk == chunk
    assert plan.levels == ((100, 168, 0 if backward else -1),)
    assert (plan.threads, plan.smem) == ((1024, 16800 * 8) if backward
                                         else (256, 0))


@pytest.mark.parametrize("dtype, threads, smem", [
    (torch.float32, 1024, 16800 * 8), (torch.bfloat16, 320, 16800 * 4)])
def test_partition_staging_the_mask_level(dtype, threads, smem):
    """The mask call's forward with its one level staged, as the chip run
    times it against the plan: the chunk kept, the block sized by its
    table (one block an SM in f32, three in bf16)."""
    plan = _ext.msda_plan(MASK, 1, 100 * 16800, 4, 4, 2, dtype)
    every = _ext.msda_partition(MASK, plan.chunk, (0,), 2, dtype)
    assert every.chunk == plan.chunk == 12728
    assert every.levels == ((100, 168, 0),)
    assert (every.threads, every.smem) == (threads, smem)


@pytest.mark.parametrize("shapes, Q, P, D, backward", [
    (FLAGSHIP, 22323, 4, 32, False), (FLAGSHIP, 22323, 4, 32, True),
    (EDGE, 9, 15, 4, True), (MASK, 504000, 4, 2, True)])
def test_plan_is_the_partition_of_its_staged_levels(shapes, Q, P, D,
                                                    backward):
    plan = _ext.msda_plan(shapes, 1, Q, 8, P, D, torch.float32, backward)
    staged = sorted((r, l) for l, (_, _, r) in enumerate(plan.levels)
                    if r >= 0)
    assert plan == _ext.msda_partition(shapes, plan.chunk,
                                       [l for _, l in staged], D,
                                       torch.float32, backward)


def test_plan_respects_the_shared_memory_budget():
    # a 40x200 level of f32 rows (1 MB a head) is never staged; the 20x20
    # level beside it is
    plan = _ext.msda_plan(((40, 200), (20, 20)), 1, 100000, 1, 8, 32,
                          torch.float32)
    assert plan.levels == ((40, 200, -1), (20, 20, 0))
    assert plan.smem == 400 * 128 <= _ext.MSDA_SMEM_BYTES
    # no budget, nothing staged
    plan = _ext.msda_plan(FLAGSHIP, 3, 22323, 8, 4, 32, torch.float32,
                          smem_bytes=0)
    assert plan.smem == 0 and plan.threads == 256
    with pytest.raises(ValueError, match="shared memory"):
        _ext.msda_plan(FLAGSHIP, 3, 22323, 8, 4, 32, torch.float32,
                       smem_bytes=_ext.MSDA_SMEM_BYTES + 1)


@pytest.mark.parametrize("shapes", [FLAGSHIP, EDGE, SMALL])
@pytest.mark.parametrize("B, Q, H, P, D", [(3, 22323, 8, 4, 32),
                                           (1, 1, 1, 1, 4), (2, 7, 2, 15, 8),
                                           (6, 4500, 8, 4, 32)])
def test_plan_covers_every_query(shapes, B, Q, H, P, D):
    for dtype in (torch.float32, torch.bfloat16):
        for backward in (False, True):
            plan = _ext.msda_plan(shapes, B, Q, H, P, D, dtype, backward)
            chunks = -(-Q // plan.chunk)
            assert (chunks - 1) * plan.chunk < Q <= chunks * plan.chunk
            assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
            assert plan.smem <= _ext.MSDA_SMEM_BYTES
            staged = sorted((r, h * w) for h, w, r in plan.levels if r >= 0)
            rows = 0
            for r, n in staged:          # rows packed, no overlap
                assert r == rows
                rows += n
            assert plan.smem == rows * D * (4 if backward or dtype ==
                                            torch.float32 else 2)


def test_plan_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="levels"):
        _ext.msda_plan(((2, 2),) * 9, 1, 4, 1, 4, 32, torch.float32)
    for D in (1, 12, 512):    # narrower than a head; not a power of two;
                              # wider than a head
        with pytest.raises(ValueError, match="head size"):
            _ext.msda_plan(SMALL, 1, 4, 1, 4, D, torch.float32)
    with pytest.raises(TypeError, match="dtype"):
        _ext.msda_plan(SMALL, 1, 4, 1, 4, 32, torch.float16)


def test_wrappers_refuse_misaligned_rows_and_cpu_tensors():
    n = sum(h * w for h, w in SMALL)
    value = torch.zeros(n * 2 * 4 + 1)[1:].view(1, n, 2, 4)
    loc = torch.zeros(1, 3, 2, 3, 4, 2)
    attn = torch.zeros(1, 3, 2, 3, 4)
    with pytest.raises(ValueError, match="16-byte aligned"):
        _ext.msda_fwd(value, SMALL, loc, attn)
    with pytest.raises(ValueError, match="16-byte aligned"):
        _ext.msda_bwd(torch.zeros(1, n, 2, 4), SMALL, loc, attn,
                      torch.zeros(1 * 3 * 8 + 1)[1:].view(1, 3, 8))
    with pytest.raises(ValueError, match="CUDA"):
        _ext.msda_fwd(torch.zeros(1, n, 2, 4), SMALL, loc, attn)


# ---- numpy emulation of the kernels' work partition ---------------------

def emulate(value, shapes, loc, attn, plan, g=None):
    """The kernels' arithmetic in numpy f32, block by block as ``plan``
    partitions it. Forward (``g`` None): the output ``(B, Q, H*D)``.
    Backward: ``(grad_value, grad_loc, grad_attn)``."""
    f32 = np.float32
    B, N, H, D = value.shape
    _, Q, _, L, P, _ = loc.shape
    starts = np.cumsum([0] + [h * w for h, w in shapes])[:-1]
    rows = max([r + h * w for h, w, r in plan.levels if r >= 0] + [0])
    out = np.zeros((B, Q, H, D), f32)
    gv = np.zeros((B, N, H, D), f32)
    gl = np.zeros_like(loc)
    ga = np.zeros_like(attn)
    for b in range(B):
        for h in range(H):
            for q0 in range(0, Q, plan.chunk):          # one block
                table = np.zeros((rows, D), f32)
                for (hl, wl, r), s in zip(plan.levels, starts):
                    if r >= 0 and g is None:
                        table[r:r + hl * wl] = value[b, s:s + hl * wl, h]
                for q in range(q0, min(q0 + plan.chunk, Q)):
                    acc = np.zeros(D, f32)
                    for l, ((hl, wl, r), s) in enumerate(zip(plan.levels,
                                                             starts)):
                        for p in range(P):
                            x = loc[b, q, h, l, p, 0] * f32(wl) - f32(0.5)
                            y = loc[b, q, h, l, p, 1] * f32(hl) - f32(0.5)
                            if not (x > -1 and y > -1 and x < wl and y < hl):
                                continue
                            x0, y0 = int(np.floor(x)), int(np.floor(y))
                            lx, ly = x - f32(x0), y - f32(y0)
                            hx, hy = f32(1) - lx, f32(1) - ly
                            a = attn[b, q, h, l, p]
                            dots = []
                            for yy, xx, w in ((y0, x0, hy * hx),
                                              (y0, x0 + 1, hy * lx),
                                              (y0 + 1, x0, ly * hx),
                                              (y0 + 1, x0 + 1, ly * lx)):
                                if not (0 <= yy < hl and 0 <= xx < wl):
                                    dots.append(f32(0))
                                    continue
                                cell = yy * wl + xx
                                if g is None:
                                    src = (table[r + cell] if r >= 0
                                           else value[b, s + cell, h])
                                    acc += (a * w) * src
                                    continue
                                dots.append(g[b, q, h] @ value[b, s + cell, h])
                                add = (a * w) * g[b, q, h]
                                if r >= 0:
                                    table[r + cell] += add
                                else:
                                    gv[b, s + cell, h] += add
                            if g is not None:
                                d = dots
                                ga[b, q, h, l, p] = (
                                    hy * (hx * d[0] + lx * d[1])
                                    + ly * (hx * d[2] + lx * d[3]))
                                gl[b, q, h, l, p, 0] = a * wl * (
                                    hy * (d[1] - d[0]) + ly * (d[3] - d[2]))
                                gl[b, q, h, l, p, 1] = a * hl * (
                                    hx * (d[2] - d[0]) + lx * (d[3] - d[1]))
                    out[b, q, h] = acc
                if g is not None:                       # flush the table
                    for (hl, wl, r), s in zip(plan.levels, starts):
                        if r >= 0:
                            gv[b, s:s + hl * wl, h] += table[r:r + hl * wl]
    if g is None:
        return out.reshape(B, Q, H * D)
    return gv, gl, ga


def partition_plans(shapes, B, Q, H, P, D, backward):
    """The planner's plan, one that stages every level in chunks of 3
    queries, and one that stages nothing in a single chunk."""
    planned = _ext.msda_plan(shapes, B, Q, H, P, D, torch.float32, backward)
    return {"planned": planned,
            "all_staged": _ext.msda_partition(shapes, 3, range(len(shapes)),
                                              D, torch.float32, backward),
            "direct": _ext.msda_partition(shapes, Q, (), D, torch.float32,
                                          backward)}


def seeded(shapes, P, D, seed, B=2, Q=7, H=2):
    rng = np.random.RandomState(seed)
    n, L = sum(h * w for h, w in shapes), len(shapes)
    value = rng.randn(B, n, H, D).astype(np.float32)
    loc = (rng.rand(B, Q, H, L, P, 2) * 1.2 - 0.1).astype(np.float32)
    w = rng.rand(B, Q, H, L * P).astype(np.float32)
    w = (w / w.sum(-1, keepdims=True)).reshape(B, Q, H, L, P)
    g = rng.randn(B, Q, H, D).astype(np.float32)
    return value, loc, w, g


@pytest.mark.parametrize("plan_name", ["planned", "all_staged", "direct"])
@pytest.mark.parametrize("shapes, P, D", [(EDGE, 15, 4), (SMALL, 4, 8),
                                          (SMALL, 4, 2), (MASK_SMALL, 4, 2)])
def test_partition_forward_matches_plain(shapes, P, D, plan_name):
    H = HEADS.get(shapes, 2)
    value, loc, w, _ = seeded(shapes, P, D, seed=P + D, H=H)
    plan = partition_plans(shapes, 2, 7, H, P, D, False)[plan_name]
    got = emulate(value, shapes, loc, w, plan)
    want = ms_deform_attn_torch(torch.from_numpy(value), shapes,
                                torch.from_numpy(loc), torch.from_numpy(w))
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("plan_name", ["planned", "all_staged", "direct"])
@pytest.mark.parametrize("shapes, P, D", [(EDGE, 15, 4), (SMALL, 4, 8),
                                          (SMALL, 4, 2), (MASK_SMALL, 4, 2)])
def test_partition_backward_matches_autograd(shapes, P, D, plan_name):
    """grad_value, grad_loc and grad_attn of the emulated partition against
    autograd of the plain version (no seeded location lies within 1e-3 px
    of an integer coordinate, where grad_loc jumps)."""
    H = HEADS.get(shapes, 2)
    value, loc, w, g = seeded(shapes, P, D, seed=P + D + 1, H=H)
    plan = partition_plans(shapes, 2, 7, H, P, D, True)[plan_name]
    got = emulate(value, shapes, loc, w, plan, g)
    inputs = [torch.from_numpy(a).requires_grad_() for a in (value, loc, w)]
    out = ms_deform_attn_torch(inputs[0], shapes, *inputs[1:])
    out.backward(torch.from_numpy(g).reshape(out.shape))
    for name, a, x in zip(("value", "loc", "attn"), got, inputs):
        np.testing.assert_allclose(a, x.grad.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
