"""The distillation CLI end to end on the CPU, in a fresh interpreter that
loads no JAX module: synthetic scenes, the tiny debug teacher trained for
2 mini-steps by ``tools.train``, ``tools.distill`` on the tiny windowed
student for 3 steps from its checkpoint, then ``tools.test`` on the
student's checkpoint with ``--flip-test --aug-scales 1.0 0.75``. The
student's checkpoint holds every teacher entry outside
``head.encoder_layer*`` bit for bit, and every encoder weight moved from
the student's seeded init.
"""
from tests.test_torch_eval_cli import SCENES
from tests.test_torch_videopose import run_without_jax


def test_distill_cli_runs_without_jax(tmp_path):
    assert run_without_jax(f"""
        import sys
        sys.modules["tensorflow"] = None
        import torch
        torch.set_num_threads(1)
        from pavenet_tpu_torch.apis.inference import build_model
        from pavenet_tpu_torch.datasets import synthetic
        from pavenet_tpu_torch.tools import distill, test, train
        from pavenet_tpu_torch.utils.checkpoint import restore_variables
        root, work = {str(tmp_path / 'data')!r}, {str(tmp_path / 'work')!r}
        synthetic.main(["--root", root] + {SCENES!r})
        opts = ["--cfg-options"] + [
            f"data.{{s}}.{{k}}={{root}}/{{v}}" for s, j in (
                ("train", "train"), ("val", "val"), ("test", "val"))
            for k, v in (("ann_file", j + ".json"), ("img_prefix", ""))]
        teacher = train.main(["configs/videopose/pavenet_tiny_debug.py",
                              "--work-dir", work, "--device", "cpu",
                              "--max-steps", "2", "--no-validate"] + opts)
        student_cfg = "configs/videopose/pavenet_tiny_debug_windowed.py"
        res = distill.main([student_cfg, teacher["checkpoint"],
                            "--work-dir", work + "/distill", "--steps", "3",
                            "--device", "cpu", "--log-interval", "1"] + opts)
        assert res["steps"] == 3, res
        assert res["checkpoint"].endswith("step_3.pt"), res
        assert res["distill_mse"] > 0, res
        t_sd = restore_variables(teacher["checkpoint"])
        s_sd = restore_variables(res["checkpoint"])
        init = build_model(student_cfg, seed=0).state_dict()
        enc = [k for k in s_sd if k.startswith("head.encoder_layer")]
        assert all(torch.equal(v, t_sd[k]) for k, v in s_sd.items()
                   if k not in enc)
        moved = [k for k in enc if k.endswith("weight")
                 and not torch.equal(s_sd[k], init[k])]
        assert moved and len(moved) == sum(k.endswith("weight")
                                           for k in enc), moved
        out = test.main([student_cfg, res["checkpoint"], "--device", "cpu",
                         "--flip-test", "--aug-scales", "1.0", "0.75"]
                        + opts)
        assert out["clips"] == 8 and out["detections"] > 0, out
        assert "posetrack/Mean" in out["metrics"], out
    """, timeout=300) == "[]"
