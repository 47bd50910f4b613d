"""The plain reference of ``benchmark/reference`` against the port, on one
state dict made from the seed, at the tiny debug widths on the CPU; and
what the benchmark and its reference import."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import program, traffic
from benchmark.reference.train import Trainer, normalise
from benchmark.tests.tiny import SERVE, TRAIN, tiny_config

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "pavenet_tpu"}
SEED = 2 ** 31 + 12345


def test_reference_serves_as_the_port():
    config = tiny_config()
    weights = program.seed_weights(config, SEED, "cpu")
    port = program.build_model(config, weights, "cpu").eval()
    ref = program.reference_model(config, weights, "cpu").eval()
    clip = traffic.serve_pool(dict(SERVE, pool=1), SEED, 3, "cpu")[0]
    feed = normalise({k: torch.as_tensor(v) for k, v in clip.items()})
    with torch.no_grad():
        a = port.forward_test(feed)
        b = ref.forward_test(feed)
    for k in ("det_kpts", "det_bboxes", "keep"):
        torch.testing.assert_close(a[k], b[k], rtol=1e-5, atol=1e-4)


def test_reference_trains_as_the_port():
    """One accumulation cycle (two mini-steps, one applied update): the
    losses and every parameter after the update."""
    from pavenet_tpu_torch.apis.train import train_step
    config = tiny_config()
    weights = program.seed_weights(config, SEED, "cpu")
    state = program.train_state(config, weights, SEED, "cpu")
    ref = program.reference_model(config, weights, "cpu")
    trainer = Trainer(ref, config["config"], torch.Generator().manual_seed(
        program.dropout_seed(SEED)), config["steps_per_epoch"])
    pool = traffic.train_pool(TRAIN, SEED, 3, 15, "cpu")
    assert state.accumulate_steps == trainer.accumulate_steps == len(pool)
    for batch in pool:
        a = train_step(state, batch)["loss"]
        b = trainer.step(normalise({k: torch.as_tensor(v)
                                    for k, v in batch.items()}))["loss"]
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert state.updates == trainer.updates == 1
    fresh = program.reference_model(config, weights, "cpu")
    moved = 0
    for (name, p), q, q0 in zip(state.model.named_parameters(),
                                ref.parameters(), fresh.parameters()):
        torch.testing.assert_close(p, q, rtol=1e-5, atol=1e-6, msg=name)
        moved += not torch.equal(q, q0)
    assert moved > 100


def test_one_draw_loads_into_both():
    """The seed's one dict, keyed by the reference's state dict, is every
    floating entry of the port's and of the reference's, name by name."""
    config = tiny_config()
    weights = program.seed_weights(config, SEED, "cpu")
    port = program.build_model(config, weights, "cpu")
    ref = program.reference_model(config, weights, "cpu")
    for model in (port, ref):
        floating = {k: v for k, v in model.state_dict().items()
                    if v.dtype.is_floating_point}
        assert floating.keys() == weights.keys()
        for k, v in floating.items():
            assert torch.equal(v, weights[k]), k


def test_train_state_follows_init_trainer():
    """``program.train_state`` assembles what the port's ``init_trainer``
    does, around a model built on the device: the same optimizer groups
    and settings, schedule, clip, accumulation, EMA and feed."""
    from pavenet_tpu_torch.apis.train import init_trainer
    config = tiny_config()
    weights = program.seed_weights(config, SEED, "cpu")
    mine = program.train_state(config, weights, SEED, "cpu")
    port = init_trainer(config["config"], "cpu", seed=SEED,
                        steps_per_epoch=config["steps_per_epoch"])
    names = {id(p): n for n, p in mine.model.named_parameters()}
    port_names = {id(p): n for n, p in port.model.named_parameters()}
    groups = [({k: v for k, v in g.items() if k != "params"},
               [names[id(p)] for p in g["params"]])
              for g in mine.optimizer.param_groups]
    port_groups = [({k: v for k, v in g.items() if k != "params"},
                    [port_names[id(p)] for p in g["params"]])
                   for g in port.optimizer.param_groups]
    assert groups == port_groups
    assert mine.optimizer.defaults == port.optimizer.defaults
    assert type(mine.optimizer) is type(port.optimizer)
    assert [mine.schedule(i) for i in range(0, 400, 7)] == [
        port.schedule(i) for i in range(0, 400, 7)]
    for field in ("grad_clip", "accumulate_steps", "max_gt", "img_norm",
                  "ema_decay", "updates"):
        assert getattr(mine, field) == getattr(port, field), field
    assert (mine.ema is None) == (port.ema is None)
    assert mine.model.training and port.model.training


@pytest.mark.parametrize("config, where, key, value", [
    ("pavenet_swin_l_t3", "backbone", "drop_path_rate", 0.3),
    ("pavenet_r50_t3", "backbone", "norm_eval", False),
    ("pavenet_r50_t3", "bbox_head", "loss_oks",
     {"type": "opera.OKSLoss", "loss_weight": 1.0}),
    ("pavenet_r50_t3", "bbox_head", "loss_kpt",
     {"type": "mmdet.L1Loss", "loss_weight": 1.0}),
    ("pavenet_r50_t3", None, "type", "opera.PETR"),
])
def test_reference_refuses_what_it_lacks(config, where, key, value):
    """A configuration that asks for mathematics the reference leaves out
    is refused, never run without it."""
    from benchmark.reference.models.builder import build_detector
    cfg = json.loads((HERE / "configs" / f"{config}.json").read_text())[
        "config"]["model"]
    with torch.device("meta"):
        build_detector(cfg)
        (cfg[where] if where else cfg)[key] = value
        with pytest.raises(KeyError):
            build_detector(cfg)


def _imports(path: Path):
    """Top-level names of every absolute import in ``path``, inside
    functions too."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node.module.split(".")[0]


def test_nothing_imports_jax():
    files = [p for p in HERE.rglob("*.py")]
    assert len(files) > 20
    for path in files:
        names = set(_imports(path))
        assert not names & FORBIDDEN, path
        if "reference" in path.relative_to(HERE).parts:
            assert "pavenet_tpu_torch" not in names, path


def test_reference_loads_nothing_of_the_program():
    """Every module of the reference, imported in a fresh interpreter,
    leaves neither the port nor JAX in ``sys.modules``."""
    mods = sorted(".".join(p.relative_to(HERE.parent).with_suffix("")
                           .parts).removesuffix(".__init__")
                  for p in (HERE / "reference").rglob("*.py"))
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "print(' '.join(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=HERE.parent,
                         capture_output=True, text=True, check=True)
    loaded = set(out.stdout.split())
    assert "benchmark" in loaded
    assert not loaded & (FORBIDDEN | {"pavenet_tpu_torch"})


def test_weights_repeat_from_the_seed():
    shapes = {"a.weight": ((4, 3), torch.float32),
              "a.bias": ((4,), torch.float32),
              "bn.running_var": ((4,), torch.float32),
              "bn.num_batches_tracked": ((), torch.int64)}
    from benchmark.weights import make_state_dict
    x = make_state_dict(shapes, SEED, "cpu")
    y = make_state_dict(shapes, SEED, "cpu")
    assert set(x) == {"a.weight", "a.bias", "bn.running_var"}
    for k in x:
        assert torch.equal(x[k], y[k])
    assert (x["bn.running_var"] > 0).all()
    z = make_state_dict(shapes, SEED + 1, "cpu")
    assert not np.allclose(x["a.weight"], z["a.weight"])
