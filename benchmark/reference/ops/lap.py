"""Linear assignment on the host (as ``pavenet_tpu/ops/lap.py::
hungarian_masked``).

The JAX package solves the assignment on the device with the shortest
augmenting path algorithm that scipy implements; the port hands the same
padded matrix to ``scipy.optimize.linear_sum_assignment``, as the reference
did.
"""
from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment


def hungarian_masked(cost: np.ndarray, row_valid: np.ndarray,
                     pad_cost: float = 1e4) -> np.ndarray:
    """Min-cost assignment of the rows of ``cost (R, C)``, ``R <= C``;
    returns the column of each row (int64 ``(R,)``), -1 for invalid rows.

    Invalid rows are replaced by a constant ``pad_cost`` row, so they soak
    up leftover columns without moving the optimum of the valid rows.
    """
    cost = np.where(row_valid[:, None], cost, np.float32(pad_cost))
    rows, cols = linear_sum_assignment(cost)
    col4row = np.full(cost.shape[0], -1, np.int64)
    col4row[rows] = cols
    return np.where(row_valid, col4row, -1)
