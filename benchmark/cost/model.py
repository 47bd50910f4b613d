"""Operations of one clip through the model, counted on the ``meta``
device from the configuration's shapes alone (the benchmark's frozen
reference model, ``benchmark/reference``; the port's
``tools/get_flops.py`` counts the same way: ``torch.utils.flop_counter``
for the torch operations, msda from its calls' shapes).

- serving: backbone, neck, encoder, two-stage proposals and pose decoder
  (``forward_outputs``), then the joint decoder over the ``max_per_img``
  candidates (``forward_refine``); rescoring and NMS are elementwise;
- training: the same in train mode with the joint decoder over the
  ``max_gt`` GT slots, as ``forward_train`` runs it, and the backward of
  every output into every parameter (the recipe takes the gradient of
  each parameter, frozen ones included, for its clip norm); the losses,
  the flows and the optimizer are elementwise and left out.
"""
from __future__ import annotations

from typing import Mapping

import torch
from torch.utils.flop_counter import FlopCounterMode

from . import msda
from ..reference.models.builder import build_detector
from ..reference.ops.ms_deform_attn import record_calls


def clip_cost(model_cfg: Mapping, height: int, width: int, img_shape,
              train: bool, max_gt: int = 30, batch: int = 1) -> dict:
    """``flops`` of one request of ``batch`` clips (forward, and backward
    in ``train``), with ``msda_calls`` ``[(value_shape, loc_shape), ...]``
    of its forward."""
    with torch.device("meta"):
        model = build_detector(model_cfg).to("meta")
        model.train(train).requires_grad_(train)
        T, K = model.num_frames, model.num_keypoints
        img = torch.zeros(batch, T, height, width, 3)
        shape = torch.tensor([list(img_shape)] * batch)
        M = max_gt if train else model.max_per_img
        with record_calls() as calls, FlopCounterMode(
                display=False) as counter:
            with torch.set_grad_enabled(train):
                outs = model.forward_outputs(img, shape)
                refine = model.head.forward_refine(
                    outs["memory"], outs["mask_flatten"],
                    outs["valid_ratios"],
                    torch.zeros(batch, M, T, 2 * K), outs["spatial_shapes"])
                if train:
                    total = sum(t.float().sum() for t in (
                        outs["all_cls_scores"], outs["all_kpt_preds"],
                        outs["all_sigma_preds"], outs["enc_cls_scores"],
                        outs["enc_kpt_preds"], outs["enc_sigma_preds"],
                        *refine))
                    total.backward()
    kernel = sum(msda.flops(v, loc) for v, loc in calls)
    if train:
        kernel += sum(msda.flops(v, loc, backward=True) for v, loc in calls)
    return dict(flops=counter.get_total_flops() + kernel,
                msda_calls=list(calls))
