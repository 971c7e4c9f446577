"""Log-weight normalisation and effective sample size, per run.

Every function works on the last axis: logw is (N,) for one run or (B, N)
for B runs. The reference masks out -inf log-weights before the logsumexp
(reference smcnuts/samples/samples.py:96-102); here the mask is a
`torch.where`, so the same code runs on any device without a host sync. Sums
over particles take the fixed order of `ops.reduce`.
"""

from __future__ import annotations

import torch

from .reduce import row_sum


def normalise_weights(logw, group=None):
    """Return (wn, log_likelihood), per run.

    wn: normalised weights, exactly 0 where logw = -inf (or NaN).
    log_likelihood: logsumexp over the finite entries; -inf when every
    entry is -inf or NaN.
    """
    finite = logw > float("-inf")  # False for -inf and NaN
    neg_inf = torch.full_like(logw, float("-inf"))
    masked = torch.where(finite, logw, neg_inf)
    m = torch.amax(masked, dim=-1, keepdim=True)
    if group is not None:
        m = group.max(m)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    sumexp = row_sum(
        torch.where(finite, torch.exp(masked - m_safe), torch.zeros_like(logw)),
        group,
    )[..., None]
    log_likelihood = torch.where(torch.isfinite(m), m_safe + torch.log(sumexp), m)
    wn = torch.where(
        finite, torch.exp(masked - log_likelihood), torch.zeros_like(logw)
    )
    return wn, log_likelihood[..., 0]


def ess(wn, group=None):
    """Effective sample size 1 / sum(wn^2) per run; +inf when every weight
    is 0."""
    return 1.0 / row_sum(torch.square(wn), group)
