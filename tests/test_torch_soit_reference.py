"""The port's SOIT against the benchmark's plain SOIT reference
(``benchmark/reference/models/detectors/soit.py``), f32 on the CPU, and
the counters of the mask path and of the gradient all-reduce; on the card,
the port's outputs served to pinned host memory.

A tiny SOIT (ResNet-18, 32 wide, one encoder and one decoder layer, 12
queries, 5 classes, 6 detections) on a 64x96 image with padding, one
state dict drawn from a seed by ``benchmark/weights.py`` and loaded into
both; no JAX on either side.
"""
from pathlib import Path

import pytest
import torch

from benchmark import program
from benchmark.reference.models.det_builder import build_detector as ref_build
from benchmark.weights import make_state_dict, shapes_of
from pavenet_tpu_torch.config import Config

SEED = 2 ** 31 + 19
CONFIG = (Path(__file__).resolve().parents[1] / "configs" / "soit"
          / "soit_r50_16x2_50e_coco.py")


def tiny_cfg() -> dict:
    cfg = Config.fromfile(str(CONFIG)).to_dict()
    model = cfg["model"]
    model["backbone"]["depth"] = 18
    head = model["bbox_head"]
    head.update(num_query=12, num_classes=5)
    tr = head["transformer"]
    tr["encoder"]["num_layers"] = 1
    tr["decoder"]["num_layers"] = 1
    tr["encoder"]["transformerlayers"].update(
        attn_cfgs=dict(embed_dims=32), feedforward_channels=64)
    model["test_cfg"] = dict(max_per_img=6)
    return model


def built(cfg):
    with torch.device("meta"):
        shapes = shapes_of(ref_build(cfg))
    weights = make_state_dict(shapes, SEED, "cpu")
    config = dict(config=dict(model=cfg), act_dtype="float32")
    port = program.build_model(config, weights, "cpu").eval()
    ref = program.load_weights(ref_build(cfg), weights).eval()
    return port, ref


def image(seed=SEED):
    gen = torch.Generator().manual_seed(seed)
    img = torch.randn(1, 64, 96, 3, generator=gen)
    img[:, 60:] = 0
    img[:, :, 90:] = 0
    return dict(img=img, img_shape=torch.tensor([[60, 90]]),
                scale_factor=torch.tensor([[1.25, 1.2]]))


def test_port_serves_as_the_reference():
    from pavenet_tpu_torch.models.detectors import soit
    port, ref = built(tiny_cfg())
    batch = image()
    calls, queries = (soit.dynamic_mask_attention.calls,
                      soit.dynamic_mask_attention.queries)
    with torch.no_grad():
        a = port.forward_test(batch)
        record = {}
        b = ref.forward_test(batch, record=record)
    # one mask call of 6 instances over the 8x12 mask grid
    assert soit.dynamic_mask_attention.calls == calls + 1
    assert soit.dynamic_mask_attention.queries == queries + 6 * 96
    assert a["det_masks"].shape == b["det_masks"].shape == (1, 6, 32, 48)
    assert torch.equal(a["det_labels"], b["det_labels"])
    torch.testing.assert_close(a["det_bboxes"], b["det_bboxes"], rtol=1e-5,
                               atol=1e-4)
    torch.testing.assert_close(a["det_masks"], b["det_masks"], rtol=0,
                               atol=1e-5)
    # the masks are not flat: the comparison sees the dynamic attention
    assert float(b["det_masks"].std()) > 1e-3
    # the hooks: the reference follows given selections exactly
    with torch.no_grad():
        c = ref.forward_test(batch, topk_idx=record["topk_idx"],
                             det_idx=record["det_idx"])
    for k in b:
        assert torch.equal(b[k], c[k]), k


@pytest.mark.cuda
def test_port_serves_its_outputs_to_pinned_host_memory_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from pavenet_tpu_torch.utils.host_copy import to_host
    cfg = tiny_cfg()
    with torch.device("meta"):
        shapes = shapes_of(ref_build(cfg))
    weights = make_state_dict(shapes, SEED, "cuda")
    config = dict(config=dict(model=cfg), act_dtype="float32")
    port = program.build_model(config, weights, "cuda").eval()
    batch = {k: v.cuda() for k, v in image().items()}
    copies, nbytes = to_host.copies, to_host.bytes
    with torch.inference_mode():
        out = port.forward_test(batch)
    assert to_host.copies == copies + 1
    assert to_host.bytes == nbytes + sum(v.nbytes for v in out.values())
    assert out["det_masks"].shape == (1, 6, 32, 48)
    for k, v in out.items():
        assert v.device.type == "cpu" and v.is_pinned(), k


def test_reference_refuses_dk_detr_and_trainable_bn():
    cfg = tiny_cfg()
    with torch.device("meta"):
        for change in (dict(type="opera.DKDETR"),
                       dict(text_encoder=dict(text_dim=512))):
            with pytest.raises(KeyError, match="cls_emb_dim"):
                ref_build(dict(cfg, **change))
        bad = dict(cfg, bbox_head=dict(cfg["bbox_head"], cls_emb_dim=512))
        with pytest.raises(KeyError, match="cls_emb_dim"):
            ref_build(bad)
        bad = dict(cfg, backbone=dict(cfg["backbone"], norm_eval=False))
        with pytest.raises(KeyError, match="BatchNorm"):
            ref_build(bad)


def test_all_reduce_grads_counts_its_buffers(tmp_path):
    import torch.distributed as tdist
    from pavenet_tpu_torch.parallel import dist
    ts = [torch.ones(3, 4), torch.full((5,), 2.0)]
    calls, nbytes = dist.all_reduce_grads.calls, dist.all_reduce_grads.bytes
    dist.all_reduce_grads(ts)             # no group: no collective, no count
    assert dist.all_reduce_grads.calls == calls
    tdist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                             rank=0, world_size=1)
    try:
        dist.all_reduce_grads(ts)
        dist.all_reduce_grads(ts)
    finally:
        tdist.destroy_process_group()
    assert dist.all_reduce_grads.calls == calls + 2
    assert dist.all_reduce_grads.bytes == nbytes + 2 * 17 * 4
    assert torch.equal(ts[1], torch.full((5,), 2.0))
