"""Importance-sampling moment estimators (reference
smcnuts/estimate/estimate.py:38-95), per run: x is (..., N, D) and wn
(..., N). Sums over particles take the fixed order of `ops.reduce`, over the
ranks of a particle group where one is given (x and wn then hold the rank's
shard)."""

from __future__ import annotations

import torch

from .reduce import row_sum


def weighted_moments(x, wn, group=None):
    """Weighted mean wn^T x and raw (uncorrected) variance wn^T (x - mean)^2."""
    xt = x.transpose(-1, -2)  # (..., D, N)
    w = wn[..., None, :]
    mean = row_sum(w * xt, group)
    var = row_sum(w * torch.square(xt - mean[..., None]), group)
    return mean, var


def estimate(model, x, wn, group=None):
    """Moments in constrained space."""
    cx = model.constrain(x.reshape(-1, x.shape[-1]))
    return weighted_moments(cx.reshape(x.shape[:-1] + cx.shape[-1:]), wn, group)
