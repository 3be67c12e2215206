"""Metric math of the auc op (counterpart of paddle_tpu/utils/metrics.py;
reference formula: operators/metrics/auc_op.h's trapezoid sweep), as the
TPU package's host loop and in its device form."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["auc_from_histograms", "auc_from_histograms_device"]


def auc_from_histograms(stat_pos, stat_neg) -> float:
    """ROC AUC from per-threshold-bucket positive and negative counts: a
    descending-threshold trapezoid sweep in (FP, TP) space, each bucket
    contributing width neg[i] at mean height TP_before + pos[i]/2. 0.0
    when either class is empty."""
    pos = np.asarray(stat_pos, np.float64).reshape(-1)
    neg = np.asarray(stat_neg, np.float64).reshape(-1)
    tot_pos = tot_neg = area = 0.0
    for i in range(len(pos) - 1, -1, -1):
        area += neg[i] * (tot_pos + pos[i] / 2.0)
        tot_pos += pos[i]
        tot_neg += neg[i]
    if tot_pos * tot_neg == 0:
        return 0.0
    return float(area / (tot_pos * tot_neg))


def auc_from_histograms_device(stat_pos: torch.Tensor,
                               stat_neg: torch.Tensor) -> torch.Tensor:
    """``auc_from_histograms`` on the counts' device, a float64 scalar:
    TP_before of bucket i is the reverse cumulative sum of the positives
    above it. Every term and partial sum is a half-integer no larger
    than the area, itself at most tot_pos · tot_neg: below 2**52 (over
    6e7 samples of each class) each is exact, so the result is the host
    loop's to the bit, whatever the order of summation."""
    pos = stat_pos.reshape(-1).to(torch.float64)
    neg = stat_neg.reshape(-1).to(torch.float64)
    above = pos.flip(0).cumsum(0).flip(0) - pos
    area = (neg * (above + pos / 2.0)).sum()
    denom = pos.sum() * neg.sum()
    empty = denom == 0
    return torch.where(empty, torch.zeros_like(area),
                       area / torch.where(empty, torch.ones_like(denom),
                                          denom))
