"""Log-weight normalisation and effective sample size.

The reference masks out -inf log-weights before the logsumexp (reference
smcnuts/samples/samples.py:96-102); here the mask is a `torch.where`, so the
same code runs on any device without a host sync.
"""

from __future__ import annotations

import torch


def normalise_weights(logw):
    """Return (wn, log_likelihood).

    wn: normalised weights, exactly 0 where logw = -inf (or NaN).
    log_likelihood: logsumexp over the finite entries; -inf when every
    entry is -inf or NaN.
    """
    finite = logw > float("-inf")  # False for -inf and NaN
    neg_inf = torch.full_like(logw, float("-inf"))
    masked = torch.where(finite, logw, neg_inf)
    m = torch.max(masked)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    sumexp = torch.sum(
        torch.where(finite, torch.exp(masked - m_safe), torch.zeros_like(logw))
    )
    log_likelihood = torch.where(torch.isfinite(m), m_safe + torch.log(sumexp), m)
    wn = torch.where(
        finite, torch.exp(masked - log_likelihood), torch.zeros_like(logw)
    )
    return wn, log_likelihood


def ess(wn):
    """Effective sample size 1 / sum(wn^2); +inf when every weight is 0."""
    return 1.0 / torch.sum(torch.square(wn))
