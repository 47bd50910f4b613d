"""Class-text embeddings for DK-DETR (as ``pavenet_tpu/models/
text_encoder.py``): ``PseudoTextEncoder`` reads precomputed
``(num_classes, text_dim)`` embeddings from a ``.npy`` file;
``CLIPTextEncoder`` does the prompt assembly and the prompt-ensemble mean
over an injected ``embed_fn(prompts) -> (P, D)``. The port has no
download path: the JAX package's default embed function, a HuggingFace
CLIP text tower, is not ported."""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

# ViLD's prompt ensemble, CLIPTextEncoder's default templates
VILD_TEMPLATES = (
    'There is a {} in the scene.',
    'There is the {} in the scene.',
    'a photo of a {} in the scene.',
    'a photo of the {} in the scene.',
    'a photo of one {} in the scene.',
    'itap of a {}.',
    'itap of my {}.',
    'itap of the {}.',
    'a photo of a {}.',
    'a photo of my {}.',
    'a photo of the {}.',
    'a photo of one {}.',
    'a photo of many {}.',
    'a good photo of a {}.',
    'a good photo of the {}.',
    'a bad photo of a {}.',
    'a bad photo of the {}.',
    'a photo of a nice {}.',
    'a photo of the nice {}.',
    'a photo of a cool {}.',
    'a photo of the cool {}.',
    'a photo of a weird {}.',
    'a photo of the weird {}.',
    'a photo of a small {}.',
    'a photo of the small {}.',
    'a photo of a large {}.',
    'a photo of the large {}.',
    'a photo of a clean {}.',
    'a photo of the clean {}.',
    'a photo of a dirty {}.',
    'a photo of the dirty {}.',
    'a bright photo of a {}.',
    'a bright photo of the {}.',
    'a dark photo of a {}.',
    'a dark photo of the {}.',
    'a photo of a hard to see {}.',
    'a photo of the hard to see {}.',
    'a low resolution photo of a {}.',
    'a low resolution photo of the {}.',
    'a cropped photo of a {}.',
    'a cropped photo of the {}.',
    'a close-up photo of a {}.',
    'a close-up photo of the {}.',
    'a jpeg corrupted photo of a {}.',
    'a jpeg corrupted photo of the {}.',
    'a blurry photo of a {}.',
    'a blurry photo of the {}.',
    'a pixelated photo of a {}.',
    'a pixelated photo of the {}.',
    'a black and white photo of the {}.',
    'a black and white photo of a {}.',
    'a plastic {}.',
    'the plastic {}.',
    'a toy {}.',
    'the toy {}.',
    'a plushie {}.',
    'the plushie {}.',
    'a cartoon {}.',
    'the cartoon {}.',
    'an embroidered {}.',
    'the embroidered {}.',
    'a painting of the {}.',
    'a painting of a {}.',
)


def build_prompts(class_names: Sequence[str],
                  templates: Sequence[str]) -> list:
    """Prompt-major flat list: index = template_idx * num_classes +
    class_idx."""
    return [t.format(name) for t in templates for name in class_names]


def ensemble_prompt_embeddings(embeddings: np.ndarray, num_templates: int,
                               num_classes: int) -> np.ndarray:
    """(num_templates * num_classes, D) prompt-major embeddings ->
    (num_classes, D): the mean over the templates of the raw, unnormalised
    embeddings (the detector normalises them)."""
    embeddings = np.asarray(embeddings, np.float32)
    if embeddings.shape[0] != num_templates * num_classes:
        raise ValueError(f"{embeddings.shape[0]} embeddings for "
                         f"{num_templates} templates x {num_classes} "
                         "classes")
    return embeddings.reshape(num_templates, num_classes, -1).mean(0)


class PseudoTextEncoder:
    """Precomputed (num_classes, text_dim) embeddings from a .npy file."""

    def __init__(self, text_feat_path: str = "", text_dim: int = 512):
        self.text_dim = text_dim
        self.text_feat_path = text_feat_path
        self._feats = None

    def get_text_feat(self) -> np.ndarray:
        if self._feats is None:
            feats = np.load(self.text_feat_path).astype(np.float32)
            if feats.ndim != 2 or feats.shape[-1] != self.text_dim:
                raise ValueError(f"{self.text_feat_path}: embeddings of "
                                 f"shape {feats.shape}, expected (C, "
                                 f"{self.text_dim})")
            self._feats = feats
        return self._feats


class CLIPTextEncoder:
    """Prompt-templated class embeddings from ``embed_fn(prompts) -> (P,
    D)``, averaged over the templates (ViLD's by default)."""

    def __init__(self, class_names: Sequence[str], embed_fn: Callable,
                 templates: Sequence[str] = None):
        self.class_names = list(class_names)
        self.embed_fn = embed_fn
        self.templates = list(templates or VILD_TEMPLATES)
        self._feats = None

    def get_text_feat(self) -> np.ndarray:
        if self._feats is None:
            prompts = build_prompts(self.class_names, self.templates)
            emb = np.asarray(self.embed_fn(prompts), np.float32)
            self._feats = ensemble_prompt_embeddings(
                emb, len(self.templates), len(self.class_names))
        return self._feats
