"""Trainable BatchNorm and the from-scratch recipe's train step: the port
against the JAX package on the CPU.

The tiny model (ResNet-18, ``embed_dims=64``, one encoder, two decoder and
one joint-decoder layer, B=2 clips of T=3 at 64x96) with
``norm_eval=False, frozen_stages=-1`` (the synthetic recipes: nothing
frozen, every norm trainable): one train step, and VideoPoseV2 beside it.
The cheap checks of the same parts are in ``tests/test_torch_bn_config.py``:
this file keeps few test items, since pytest-xdist's ``loadfile`` queue
takes files with more tests first and this one's JAX compile should not
delay the suite's longest files. Weights: the port's seeded init laid
onto the JAX parameter tree (``jax.eval_shape`` of the JAX init: the tree
costs no compile), noised with seeded numpy, then carried to the port by
``utils/weight_convert.py`` and a strict load. The JAX side runs its msda
through the XLA gather (the Pallas kernels' plain reference), in one
jitted ``value_and_grad`` with ``mutable=['batch_stats']``, then its optax
chain (``optax_by_label``).

The port's train step runs in float32 and is held against JAX's in
float64 (``jax.enable_x64``): with every BatchNorm in train mode the JAX
side's own float32 gradients are up to 2.65e-2 of a tensor's largest away
from the float64 ones (``backbone.layer1_1.conv2``), the port's float32
ones at most 3.9e-4 (the encoder's FFN), and the two float64 sides agree
to 8.0e-7 (``gradient_accuracy_report`` below, both sides in both dtypes,
the same weights). So JAX in float64 is the reference and the tolerances
are of float32 order: losses rtol 1e-5; gradients 1e-3 of each tensor's
largest (deep f32 sums, 3.9e-4 seen); running statistics 1e-5 of their
scale; the parameters after one AdamW step (lr 1e-3, weight decay 0.1, so
that the no-decay group shows) 1e-6 where the clipped gradient is above
1e-6 (100 times Adam's epsilon) and above 1e-3 of its tensor's largest,
and twice the learning rate elsewhere (AdamW's first step moves a
parameter by the learning rate times g / (|g| + eps): about the sign of
g, and where g is that small its sign or its size against eps may
differ).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
# torch imports torch._dynamo lazily, at a process's first optimizer; the
# reference-oracle tests of this suite stub ``tabulate`` in sys.modules
# without a module spec, after which that import fails. Imported here,
# while each worker collects the files and before any test runs, so that
# the optimizer tests do not depend on which files a worker ran first.
import torch._dynamo  # noqa: F401

from pavenet_tpu.apis import train as jtrain
from pavenet_tpu.models.detectors import VideoPoseDetector as JDetector
from pavenet_tpu.models.zoo import dummy_clip_batch as j_dummy_clip_batch
from pavenet_tpu_torch.apis import train as ttrain
from pavenet_tpu_torch.models import VideoPoseDetector
from pavenet_tpu_torch.utils import weight_convert
from pavenet_tpu_torch.utils.weight_convert import (
    batch_stats_to_numpy, jax_variables_to_state_dict)

TINY = dict(num_frames=3, num_keypoints=15, num_query=12, backbone_depth=18,
            embed_dims=64, num_encoder_layers=1, num_decoder_layers=2,
            num_refine_layers=1, max_per_img=5)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR, WD = 1e-3, 0.1
t = torch.from_numpy


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's small tensors: the suite runs six
    workers on one shared CPU, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_weights_on_jax_tree(model, shapes, seed=0, scale=0.02):
    """The port model's state dict laid onto the JAX variable tree of
    ``shapes`` (the inverse of the converter's layout rules, found by
    converting an index array), plus seeded noise."""
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        collection = path[0].key
        out = jax_layout(sd, path[1:], s.shape, collection == "batch_stats")
        noise = scale * rng.randn(*s.shape).astype(np.float32)
        if path[-1].key == "var":          # keep variances positive
            noise = np.abs(noise) * 10
        return out + noise

    return jax.device_get(jax.tree_util.tree_map_with_path(leaf, shapes))


def jax_layout(port_arrays, path, shape, stats=False):
    """The port array of a JAX leaf (``path`` within its collection) in the
    leaf's layout: the converter's rules inverted, by converting an index
    array."""
    keys = [getattr(p, "key", p) for p in path]
    size = int(np.prod(shape))
    idx = np.arange(size).reshape(shape)
    if stats:
        name, fwd = weight_convert.STATS[keys[-1]], idx
    else:
        name, fwd = weight_convert._param(tuple(keys), idx)
    out = np.empty(size, np.float32)
    out[np.asarray(fwd).ravel()] = np.asarray(
        port_arrays[".".join(keys[:-1] + [name])]).ravel()
    return out.reshape(shape)


def jax_tree_shapes(model, batch):
    return jax.eval_shape(lambda b: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        b, train=True), batch)


@pytest.fixture(scope="module")
def tree_shapes():
    """The tiny model's JAX variable tree (shapes only); the norm and
    freezing flags do not change it."""
    return jax_tree_shapes(JDetector(max_gt=8, norm_eval=False, **TINY),
                           train_batch())


def port_step(model, batch):
    """One port train step (no accumulation, lr ``LR``, weight decay
    ``WD``, backbone lr_mult 1.0); returns the losses and each parameter's
    gradient (numpy, zeros where none)."""
    state = ttrain.TrainState(
        model=model, optimizer=ttrain.build_optimizer(
            model, weight_decay=WD, backbone_lr_mult=1.0),
        schedule=lambda step: LR, grad_clip=0.1, accumulate_steps=1,
        generator=torch.Generator(), max_gt=8)
    model.train()
    losses = model.forward_train({k: t(v) for k, v in batch.items()})
    losses["loss"].backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             .numpy().copy() for n, p in model.named_parameters()}
    ttrain.accumulate(state)
    assert state.updates == 1
    return losses, grads


def f32_state_dict(tree):
    """A (float64) JAX params tree as a float32 port state dict of numpy
    arrays."""
    return {k: v.numpy() for k, v in jax_variables_to_state_dict(
        {"params": jax.tree.map(lambda x: np.asarray(x, np.float32),
                                tree)}).items()}


def optax_by_label(params, grads, **flags):
    """One step of the JAX package's optax chain (``build_optimizer``: lr
    ``LR``, weight decay ``WD``, clip 0.1, backbone lr_mult 1.0) with its
    own parameter labels, on the tree folded into one flat leaf per label
    (each at a path of that label): AdamW acts element by element and the
    clip on the norm of all leaves, so the step equals the chain's on the
    whole tree, while the folded tree compiles in about a second instead
    of about twenty. Returns the new parameter tree."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    labels = [jtrain._param_label(path, flags.get("freeze_backbone_neck",
                                                  False),
                                  flags["trainable_bn"],
                                  flags["frozen_stages"])
              for path, _ in flat]
    order = sorted(set(labels))
    where = {lab: next(path for (path, _), l in zip(flat, labels)
                       if l == lab) for lab in order}

    def fold(leaves):
        tree = {}
        for lab in order:
            node = tree
            *head, last = [p.key for p in where[lab]]
            for k in head:
                node = node.setdefault(k, {})
            node[last] = np.concatenate(
                [np.ravel(x) for x, l in zip(leaves, labels) if l == lab])
        return tree

    leaves = [x for _, x in flat]
    folded = fold(leaves)
    tx = jtrain.build_optimizer(
        folded, learning_rate=LR, weight_decay=WD, grad_clip=0.1,
        accumulate_steps=1, backbone_lr_mult=1.0, **flags)
    gfold = fold(jax.tree.leaves(grads))
    new = jax.jit(lambda p, g: optax.apply_updates(
        p, tx.update(g, tx.init(p), p)[0]))(folded, gfold)
    out, offsets = [], dict.fromkeys(order, 0)
    for x, lab in zip(leaves, labels):
        vec = new
        for p in where[lab]:
            vec = vec[p.key]
        out.append(np.asarray(vec[offsets[lab]:offsets[lab] + np.size(x)])
                   .reshape(np.shape(x)))
        offsets[lab] += np.size(x)
    return jax.tree_util.tree_unflatten(treedef, out)


def train_batch():
    return j_dummy_clip_batch(np.random.RandomState(1), batch_size=2,
                              height=64, width=96, max_gt=8, train=True)


def leaves_by_port_name(tree):
    """{dotted port name: numpy leaf} of a JAX params or batch_stats
    tree."""
    out = {}
    for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [p.key for p in path]
        out[".".join(keys)] = np.asarray(x)
    return out


# ----------------------------------------------------------------------
# the train step with trainable BatchNorm
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def bn_step(tree_shapes):
    """One train step of the tiny model with every norm trainable: the
    port in float32, JAX in float64; AdamW at lr 1e-3 (backbone lr_mult
    1.0, as the synthetic recipes), clip 0.1, no accumulation."""
    kw = dict(dropout=0.0, norm_eval=False, frozen_stages=-1, **TINY)
    batch = train_batch()
    model = VideoPoseDetector(**kw)
    model.init_weights(torch.Generator().manual_seed(0))
    variables = port_weights_on_jax_tree(model, tree_shapes)
    model.load_state_dict(jax_variables_to_state_dict(variables),
                          strict=True)
    losses, grads = port_step(model, batch)

    with jax.enable_x64(True):
        jmodel = JDetector(max_gt=8, dtype=jnp.float64, **kw)
        v64 = jax.tree.map(lambda x: np.asarray(x, np.float64), variables)
        b64 = dict(batch, img=batch["img"].astype(np.float64))

        @jax.jit
        def step(params, stats):
            def loss_fn(p):
                out, mutated = jmodel.apply(
                    {"params": p, "batch_stats": stats}, b64, train=True,
                    mutable=["batch_stats"])
                return out["loss"], (out, mutated["batch_stats"])
            (_, (out, new_stats)), g = jax.value_and_grad(
                loss_fn, has_aux=True)(params)
            return new_stats, out, g

        jstats, jlosses, jgrads = jax.device_get(step(v64["params"],
                                                      v64["batch_stats"]))
        jparams = optax_by_label(v64["params"], jgrads, trainable_bn=True,
                                 frozen_stages=-1)
    return dict(variables=variables, jparams=f32_state_dict(jparams),
                jstats=jstats, jlosses=jlosses,
                jgrads=f32_state_dict(jgrads), model=model, losses=losses,
                grads=grads)


def test_trainable_bn_losses_and_gradients_match(bn_step):
    want, got = bn_step["jlosses"], bn_step["losses"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), want[k], rtol=1e-5,
                                   err_msg=k)
    want, got = bn_step["jgrads"], bn_step["grads"]
    assert set(want) == set(got)
    for name, g in got.items():
        w = want[name]
        # + 1e-7: the key biases' gradient is 0 in exact arithmetic (the
        # softmax ignores a shift), f32 rounding noise of 1e-9 here
        np.testing.assert_allclose(g, w, atol=1e-3 * np.abs(w).max() + 1e-7,
                                   rtol=0, err_msg=name)


def test_trainable_bn_params_and_running_stats_after_step_match(bn_step):
    """Parameters after the port's train step against after JAX's, the
    no-decay ``backbone_norm`` group included, every tensor moved
    (``frozen_stages=-1``: nothing frozen); every BatchNorm's running mean
    and (biased) variance: momentum 0.9 over the B*T = 6 frames, padding
    included."""
    want, jgrads = bn_step["jparams"], bn_step["jgrads"]
    before = jax_variables_to_state_dict(bn_step["variables"])
    norm = np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                       for g in jgrads.values()))
    clip = min(1.0, 0.1 / norm)
    moved = 0
    for name, p in bn_step["model"].named_parameters():
        got = p.detach().numpy()
        g = np.abs(jgrads[name])
        sure = (g > 1e-3 * g.max()) & (g * clip > 1e-6)
        tol = np.where(sure, 1e-6, 2 * LR)
        assert (np.abs(got - want[name]) <= tol).all(), name
        moved += not np.array_equal(got, before[name].numpy())
    assert moved == len(want)

    want = leaves_by_port_name(bn_step["jstats"])
    old = leaves_by_port_name(bn_step["variables"]["batch_stats"])
    got = leaves_by_port_name(batch_stats_to_numpy(bn_step["model"]))
    assert set(got) == set(want) and len(want) == 2 * (1 + 8 * 2 + 3)
    for k, b in want.items():
        np.testing.assert_allclose(got[k], b, atol=1e-5 * np.abs(b).max(),
                                   rtol=0, err_msg=k)
        assert not np.array_equal(b, old[k]), k


# ----------------------------------------------------------------------
# VideoPoseV2
# ----------------------------------------------------------------------
def test_videopose_v2_leaves_backbone_and_neck_alone(bn_step):
    """VideoPoseV2 (with trainable BatchNorm): a port train step gives the
    backbone and neck no gradient and no update (the JAX labels above put
    them in optax's ``set_to_zero`` group, and JAX stops their gradient at
    the neck's output), and moves the rest."""
    kw = dict(dropout=0.0, norm_eval=False, frozen_stages=-1,
              freeze_backbone_neck=True, **TINY)
    model = VideoPoseDetector(**kw)
    model.load_state_dict(jax_variables_to_state_dict(bn_step["variables"]),
                          strict=True)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    _, grads = port_step(model, train_batch())
    labels = ttrain.param_labels(model)
    for name, p in model.named_parameters():
        if name.startswith(("backbone.", "neck.")):
            assert labels[name] == "frozen" and not grads[name].any(), name
            assert torch.equal(before[name], p), name
        elif grads[name].any():
            assert not torch.equal(before[name], p), name


def gradient_accuracy_report():
    """The measurement behind the float64 reference above (not a test:
    four compiles, about two minutes): the train-mode gradients of the
    tiny model in f32 and f64 on both sides, each tensor's largest error
    over its largest float64 port gradient. Run
    ``JAX_PLATFORMS=cpu python tests/test_torch_trainable_bn.py``."""
    kw = dict(dropout=0.0, norm_eval=False, frozen_stages=-1, **TINY)
    batch = train_batch()
    model = VideoPoseDetector(**kw)
    model.init_weights(torch.Generator().manual_seed(0))
    variables = port_weights_on_jax_tree(
        model, jax_tree_shapes(JDetector(max_gt=8, **kw), batch))
    sd = jax_variables_to_state_dict(variables)
    grads = {}
    for name, jdt, tdt in (("f32", jnp.float32, torch.float32),
                           ("f64", jnp.float64, torch.float64)):
        with jax.enable_x64(name == "f64"):
            jmodel = JDetector(max_gt=8, dtype=jdt, **kw)
            v = jax.tree.map(lambda x: np.asarray(x, jdt), variables)
            b = dict(batch, img=batch["img"].astype(jdt))

            def loss_fn(p):
                out, _ = jmodel.apply({"params": p, "batch_stats":
                                       v["batch_stats"]}, b, train=True,
                                      mutable=["batch_stats"])
                return out["loss"]
            g = jax.device_get(jax.jit(jax.grad(loss_fn))(v["params"]))
        grads["jax_" + name] = {k: x.astype(np.float64) for k, x in
                                f32_state_dict(g).items()}
        m = VideoPoseDetector(dtype=tdt, **kw)
        m.load_state_dict(sd)
        m = m.to(tdt).train()
        tb = {k: t(x) for k, x in batch.items()}
        tb["img"] = tb["img"].to(tdt)
        m.forward_train(tb)["loss"].backward()
        grads["port_" + name] = {
            n: (p.grad if p.grad is not None else torch.zeros_like(p))
            .double().numpy() for n, p in m.named_parameters()}
    ref = grads["port_f64"]
    rows = sorted(((np.abs(grads[k][n] - ref[n]).max()
                    / (np.abs(ref[n]).max() + 1e-30), k, n)
                   for k in ("jax_f32", "port_f32", "jax_f64")
                   for n in ref if np.abs(ref[n]).max() > 1e-6),
                  reverse=True)
    for k in ("jax_f32", "port_f32", "jax_f64"):
        err, _, n = max(r for r in rows if r[1] == k)
        print(f"{k} against port_f64: largest error {err:.2e} of the "
              f"tensor's largest gradient, at {n}")


if __name__ == "__main__":
    jax.config.update("jax_default_matmul_precision", "highest")  # conftest
    gradient_accuracy_report()
