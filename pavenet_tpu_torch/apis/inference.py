"""Clip inference API (as ``pavenet_tpu/apis/inference.py``).

``init_detector(config, device, dtype=None, checkpoint=None)`` -> model on
the device, eval mode, in the activation dtype of ``dtype`` or the
config's ``act_dtype``, with the weights of a reference ``.pth`` or a port
checkpoint where given;
``inference_detector(model, imgs)`` -> detections for one clip, or for one
image of a single-image model (SOIT; DK-DETR with its ``text_feats``;
InsPose). The host
pipeline (``datasets/pipelines/transforms.py``) is the port's own copy of
the JAX package's, so both packages see the same batch.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence, Union

import numpy as np
import torch

from ..config import Config, resolve_act_dtype
from ..datasets.pipelines.transforms import (
    DEFAULT_BUCKETS, FormatBatch, LoadClip, Normalize, PadToBucket, Resize)
from ..models.builder import build_detector
from ..models.detectors.inspose import InsPoseDetector
from ..models.detectors.soit import SOITDetector
from ..utils import weight_convert
from ..utils.checkpoint import restore_variables
from ..utils.reference_convert import (load_reference_state_dict,
                                       load_torch_checkpoint)


def build_model(config: Union[str, Mapping], seed: int = 0,
                variables: Optional[Mapping] = None, impl: str = "auto",
                dtype: Optional[str] = None) -> torch.nn.Module:
    """Build the detector from a config file or ``Config``, on the CPU.

    Weights: ``variables`` (a JAX ``{'params', 'batch_stats'}`` tree of numpy
    arrays) when given, else a random init from ``torch.Generator(seed)``
    that follows the JAX initialisers' fixed values. ``dtype`` ('f32',
    'bf16', their long names or a ``torch.dtype``; None follows the config's
    ``act_dtype``, then float32) is the activation dtype; the parameters
    stay float32.
    """
    if isinstance(config, str):
        config = Config.fromfile(config)
    if not isinstance(dtype, torch.dtype):
        dtype = resolve_act_dtype(config, dtype)
    model = build_detector(config["model"], impl=impl, dtype=dtype)
    model.init_weights(torch.Generator().manual_seed(seed))
    if variables is not None:
        weight_convert.load_jax_variables(model, variables)
    return model


def load_checkpoint(model: torch.nn.Module, checkpoint: str):
    """Load ``checkpoint`` into ``model``: a reference ``.pth`` through
    ``utils/reference_convert.py`` (every family the JAX converter covers;
    the keys the reference tree lacks keep the model's init only for PETR,
    and the reference's unconverted keys are ignored, as the JAX
    ``init_detector`` ignores them), else a port checkpoint
    (``step_N.pt``, ``utils/checkpoint.py``), loaded strictly."""
    if checkpoint.endswith(".pth"):
        load_reference_state_dict(model, load_torch_checkpoint(checkpoint))
    else:
        model.load_state_dict(restore_variables(checkpoint), strict=True)
    return model


def init_detector(config: Union[str, Mapping], device="cuda", seed: int = 0,
                  variables: Optional[Mapping] = None, impl: str = "auto",
                  dtype: Optional[str] = None,
                  checkpoint: Optional[str] = None) -> torch.nn.Module:
    """``build_model`` on ``device``, in eval mode, with the weights of
    ``checkpoint`` where given (``load_checkpoint``)."""
    model = build_model(config, seed, variables, impl, dtype)
    if checkpoint is not None:
        load_checkpoint(model, checkpoint)
    return model.to(device).eval()


def host_batch(imgs, num_frames: int, img_scale=(1333, 800)) -> dict:
    """One clip (frame paths or RGB arrays) through the test pipeline:
    numpy ``img (1,T,H,W,3)``, ``img_shape (1,2)``, ``scale_factor (1,2)``."""
    if isinstance(imgs, (str, np.ndarray)):
        imgs = [imgs] * num_frames
    if isinstance(imgs[0], str):
        results = LoadClip()({"frame_files": list(imgs)})
    else:
        results = {
            "imgs": [np.asarray(im, np.float32) for im in imgs],
            "img_shape": np.asarray(imgs[0]).shape[:2],
            "scale_factor": np.array([1.0, 1.0], np.float32),
        }
    for t in (Resize(img_scale), Normalize(), PadToBucket(DEFAULT_BUCKETS),
              FormatBatch()):
        results = t(results)
    return {k: np.asarray(results[k])[None]
            for k in ("img", "img_shape", "scale_factor")}


def inference_detector(model: torch.nn.Module,
                       imgs: Union[str, np.ndarray, Sequence],
                       img_scale=(1333, 800), text_feats=None) -> dict:
    """Run one clip (frame paths or RGB arrays) through the model.

    Returns numpy det_kpts (M, K, 3), det_bboxes (M, 5), det_labels (M,),
    keep (M,) (InsPose: of one image, the soft-NMS score in det_bboxes);
    for a detection model (one image) det_bboxes, det_labels and det_masks
    (M, h, w), DK-DETR's classes the rows of ``text_feats``.
    """
    device = next(model.parameters()).device
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in host_batch(imgs, model.num_frames,
                                     img_scale).items()}
    if isinstance(model, (SOITDetector, InsPoseDetector)):
        batch["img"] = batch["img"][:, 0]
        if text_feats is not None:
            batch["text_feats"] = torch.as_tensor(text_feats,
                                                  device=device).float()
    with torch.inference_mode():
        out = model.forward_test(batch)
    return {k: v[0].cpu().numpy() for k, v in out.items()}
