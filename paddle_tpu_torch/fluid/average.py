"""fluid.average: a host-side weighted average of fetched values
(counterpart of paddle_tpu/fluid/average.py; reference:
python/paddle/fluid/average.py WeightedAverage)."""
from __future__ import annotations

import numpy as np

__all__ = ["WeightedAverage"]


def _is_number_or_matrix(var):
    return isinstance(var, (int, float, np.ndarray)) or np.isscalar(var)


class WeightedAverage:
    """Accumulates value*weight sums for cheap running averages of fetched
    losses/metrics (reference average.py:45)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.numerator = None
        self.denominator = None

    def add(self, value, weight):
        if not _is_number_or_matrix(value):
            raise ValueError("add() expects a number or ndarray value")
        if not np.isscalar(weight):
            raise ValueError("weight must be a number")
        value = np.mean(value)
        if self.numerator is None:
            self.numerator = value * weight
            self.denominator = weight
        else:
            self.numerator += value * weight
            self.denominator += weight

    def eval(self):
        if self.numerator is None or self.denominator == 0:
            raise ValueError("eval() before any add()")
        return self.numerator / self.denominator
