"""A benchmark spec of the same files at a size the CPU runs in seconds:
the port's tiny debug configuration (ResNet-18, 64-wide, 20 queries) and
96x128 clips, in a folder of its own, with the real readers."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
CONFIG = ROOT / "configs" / "videopose" / "pavenet_tiny_debug.py"
SERVE = dict(kind="serve", clients=1, clips_per_request=1, height=96,
             width=128, img_shape=[90, 120], scale_factor=1.0, pool=4,
             check_requests=3)
TRAIN = dict(kind="train", clips_per_request=1, height=96, width=128,
             img_shape=[96, 120], scale_factor=1.0, pool=2, gt_slots=10,
             valid_share=0.25)


def tiny_config() -> dict:
    from pavenet_tpu_torch.config import Config
    d = Config.fromfile(str(CONFIG)).to_dict()
    return dict(name="tiny", act_dtype="float32",
                math=dict(matmul_tf32=False, cudnn_tf32=True), peak="tf32",
                steps_per_epoch=20,
                config={k: d[k] for k in ("model", "optimizer",
                                          "optimizer_config", "lr_config",
                                          "runner", "custom_hooks")})


def make_spec(tmp: Path) -> Path:
    """``tmp/BENCHMARK.json`` with cells ``tiny.serve`` and ``tiny.train``
    and their files under ``tmp/benchmark``; the metrics and limits of the
    real flagship cells."""
    b = tmp / "benchmark"
    for d in ("configs", "traffic", "limits", "metrics"):
        (b / d).mkdir(parents=True, exist_ok=True)
    (b / "configs" / "tiny.json").write_text(json.dumps(tiny_config()))
    (b / "traffic" / "tserve.json").write_text(json.dumps(SERVE))
    (b / "traffic" / "ttrain.json").write_text(json.dumps(TRAIN))
    for kind in ("serve", "train"):
        shutil.copy(HERE / "limits" / f"pavenet_r50_t3.{kind}.json",
                    b / "limits" / f"tiny.{kind}.json")
    for f in (HERE / "metrics").glob("*.py"):
        shutil.copy(f, b / "metrics" / f.name)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"] = [dict(name="tiny", source="configs/videopose/"
                            "pavenet_tiny_debug.py",
                            file="benchmark/configs/tiny.json", reduced=[],
                            why="tests")]
    spec["workloads"] = [
        dict(name="tiny.serve", config="tiny", traffic="tserve", chips=1,
             why="tests"),
        dict(name="tiny.train", config="tiny", traffic="ttrain", chips=1,
             why="tests")]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = sorted({"tiny." + w.rsplit(".", 1)[1]
                                     for w in m["workloads"]})
    path = tmp / "BENCHMARK.json"
    path.write_text(json.dumps(spec))
    return path
