"""Seeded generators (as ``pavenet_tpu/utils/seed.py``), returned rather
than installed: the JAX package seeds Python's and numpy's global streams,
the port hands its host pipeline its own generators.

``set_random_seed(seed)`` gives ``random.Random(seed)`` and
``np.random.RandomState(seed)``, whose streams equal those of
``random.seed(seed)`` and ``np.random.seed(seed)``: the host pipeline and
the loader's resample draw from them in the JAX package's order (see
``datasets/pipelines/transforms.py``). The model's two torch streams, its
init and its dropout masks, are seeded from the same seed by
``apis/inference.py::build_model`` and ``apis/train.py::init_trainer``.
"""
from __future__ import annotations

import dataclasses
import random

import numpy as np


@dataclasses.dataclass
class Generators:
    py: random.Random
    np: np.random.RandomState


def set_random_seed(seed: int) -> Generators:
    return Generators(py=random.Random(seed), np=np.random.RandomState(seed))
