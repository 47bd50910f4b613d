"""The frozen cost arithmetic of ``benchmark/cost``."""
import json
from pathlib import Path

import pytest

from benchmark.cost import msda
from benchmark.cost.model import clip_cost
from benchmark.cost.peaks import FLOPS, HBM_BYTES_PER_S

HERE = Path(__file__).resolve().parents[1]


def test_msda_counts_by_hand():
    # two levels (2x3, 2x2): N = 10 tokens, 2 heads of 4 channels, 5
    # queries, 3 points: 1 * 5 * 2 * 2 * 3 = 60 taps
    value, loc = (1, 10, 2, 4), (1, 5, 2, 2, 3, 2)
    assert msda.flops(value, loc) == 60 * 4 * 10
    assert msda.flops(value, loc, backward=True) == 60 * 4 * 34
    # value 320 B, locations and weights 60 * 3 * 4 = 720 B, output 160 B
    assert msda.nbytes(value, loc) == 320 + 720 + 160
    assert msda.nbytes(value, loc, backward=True) == 2 * 320 + 2 * 720 + 160
    assert msda.bound_s(value, loc) == pytest.approx(
        max(1200 / HBM_BYTES_PER_S, 2400 / FLOPS["float32"]))


def test_flagship_clip_flops_match_get_flops():
    # the port's tools/get_flops.py at 800x1344, as PERF.md records it:
    # 1.27161e12 operations in one forward_test, msda 1.69467e10 of them
    cfg = json.loads((HERE / "configs" / "pavenet_r50_t3.json").read_text())
    cost = clip_cost(cfg["config"]["model"], 800, 1344, (800, 1333),
                     train=False)
    assert cost["flops"] == pytest.approx(1.27161e12, rel=1e-2)
    assert len(cost["msda_calls"]) == 11
    kernel = sum(msda.flops(v, loc) for v, loc in cost["msda_calls"])
    assert kernel == pytest.approx(1.69467e10, rel=1e-2)
