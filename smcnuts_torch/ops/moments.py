"""Importance-sampling moment estimators (reference
smcnuts/estimate/estimate.py:38-95)."""

from __future__ import annotations

import torch


def weighted_moments(x, wn):
    """Weighted mean wn^T x and raw (uncorrected) variance wn^T (x - mean)^2."""
    mean = wn @ x
    var = wn @ torch.square(x - mean)
    return mean, var


def estimate(model, x, wn):
    """Moments in constrained space."""
    return weighted_moments(model.constrain(x), wn)
