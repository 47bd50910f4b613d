"""Logging and metric averaging (as ``pavenet_tpu/utils/logging.py``)."""
from __future__ import annotations

import json
import logging
import os
from collections import OrderedDict, defaultdict

import numpy as np

_LOGGERS = {}


def get_root_logger(log_file=None, log_level=logging.INFO,
                    name="pavenet_tpu_torch"):
    """The package's logger: to stderr and, the first time a file is given,
    appended to ``log_file``."""
    if name in _LOGGERS:
        return _LOGGERS[name]
    logger = logging.getLogger(name)
    logger.setLevel(log_level)
    logger.propagate = False
    fmt = logging.Formatter(
        "%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file is not None:
        fh = logging.FileHandler(log_file, "a")
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    _LOGGERS[name] = logger
    return logger


class MetricSinks:
    """Scalar metric sinks: ``<work_dir>/metrics.jsonl``, and TensorBoard
    (``<work_dir>/tf_logs``) when it imports."""

    def __init__(self, work_dir):
        self._jsonl = open(os.path.join(work_dir, "metrics.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self._tb = None
        else:
            self._tb = SummaryWriter(log_dir=f"{work_dir}/tf_logs")

    def log(self, step: int, scalars: dict):
        self._jsonl.write(json.dumps(
            dict(step=int(step), **{k: float(v)
                                    for k, v in scalars.items()})) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), int(step))

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class LogBuffer:
    """Windowed scalar averaging for train-loop logging."""

    def __init__(self):
        self.val_history = defaultdict(list)
        self.n_history = defaultdict(list)
        self.output = OrderedDict()

    def update(self, vars_dict, count=1):
        for key, var in vars_dict.items():
            self.val_history[key].append(float(var))
            self.n_history[key].append(count)

    def average(self, n=0):
        """Average the latest ``n`` values (all if ``n == 0``) into
        ``output``."""
        for key in self.val_history:
            values = np.array(self.val_history[key][-n or None:])
            nums = np.array(self.n_history[key][-n or None:])
            self.output[key] = float((values * nums).sum() / nums.sum())
