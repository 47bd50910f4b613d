"""The harness on the CPU at the tiny debug size: a cell added as files
only, whole runs with the look for a chip skipped, and the check failing
on each fault a cell of this benchmark can have (an answer altered where
it is produced; a step that leaves the state unchanged). Half a batch
and the exchange between chips do not apply: one clip a request, one
chip a cell."""
import json

import pytest
import torch

from benchmark import harness
from benchmark.run import main
from benchmark.tests.tiny import make_spec

SEED = 2 ** 31 + 7


def run(spec, workload, capsys):
    rc = main(["--workload", workload, "--seed", str(SEED), "--seconds",
               "1", "--trace", "0"], spec_path=spec, device="cpu")
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_a_cell_from_files_only(tmp_path):
    """A spec whose cells, configuration, mixes, limits and readers are all
    new files is found by name, readers included."""
    spec = make_spec(tmp_path)
    cell = harness.lookup("tiny.serve", spec)
    assert cell.traffic["kind"] == "serve" and cell.chips == 1
    assert cell.config["config"]["model"]["backbone"]["depth"] == 18
    assert {m["name"] for m in cell.end_to_end} == {
        "clips_per_s", "clip_latency_p95_ms", "peak_mem_gib", "setup_s"}
    names = {m["name"] for m in cell.per_layer}
    assert "prep_ms.serve" in names and "mfu.train" not in names
    read = harness.reader(cell, "mfu.serve")
    assert read(dict(flops_per_clip=1e12, clips_per_s=10.0,
                     peak_flops=1e15)) == pytest.approx(1.0)
    assert read({}) is None
    train = harness.lookup("tiny.train", spec)
    assert {m["name"] for m in train.per_layer} >= {"matching_ms.train"}


@pytest.mark.parametrize("workload", ["tiny.serve", "tiny.train"])
def test_a_run_is_correct(tmp_path, capsys, workload):
    out = run(make_spec(tmp_path), workload, capsys)
    assert out["correct"] is True and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in out["checks"].values()
               if c["limit"] is not None)
    assert "setup_s" in out["metrics"]


def test_an_altered_answer_is_caught(tmp_path, capsys, monkeypatch):
    from pavenet_tpu_torch.models.detectors.videopose import \
        VideoPoseDetector
    served = VideoPoseDetector.forward_test

    def altered(self, batch, *a, **k):
        out = served(self, batch, *a, **k)
        out["det_kpts"][:, 0, 0, 0] += 1.0       # one keypoint, 1 px
        return out

    monkeypatch.setattr(VideoPoseDetector, "forward_test", altered)
    out = run(make_spec(tmp_path), "tiny.serve", capsys)
    assert out["correct"] is False
    assert out["checks"]["det_px"]["value"] > out["checks"]["det_px"][
        "limit"]


def test_an_unchanged_state_is_caught(tmp_path, capsys, monkeypatch):
    import pavenet_tpu_torch.apis.train as api

    def no_update(state):
        for p in state.model.parameters():
            p.grad = None
        state.acc = None
        state.updates += 1

    monkeypatch.setattr(api, "apply_update", no_update)
    out = run(make_spec(tmp_path), "tiny.train", capsys)
    assert out["correct"] is False
    assert out["checks"]["change_leaf"]["value"] == pytest.approx(1.0)


@pytest.mark.cuda
def test_the_control_fails_at_the_flagship_size(cuda_device):
    """The reference in TF32 in the program's place, at the flagship cells'
    own size, one seed each: not correct."""
    from benchmark import calibrate
    for workload in ("pavenet_r50_t3.serve", "pavenet_r50_t3.train"):
        cell = harness.lookup(workload)
        nums = (calibrate.control_serve(cell, SEED, cuda_device, 4)
                if cell.traffic["kind"] == "serve"
                else calibrate.control_train(cell, SEED, cuda_device))
        from benchmark.check import verdict
        assert not verdict(nums, cell.limits), nums
        torch.cuda.empty_cache()
