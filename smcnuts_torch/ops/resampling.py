"""Multinomial resampling when the ESS falls below a threshold, per run.

The reference resamples multinomially when ESS < N/2 (reference
smcnuts/samples/samples.py:116-146) and resets the log-weights to
log_likelihood - log(N), which keeps the normalising-constant accumulator.

Ancestors come from inverting each run's weight CDF at N uniforms with
`torch.searchsorted(..., right=True)`: idx[i] = #{j : cdf[j] <= u[i]}. The
uniforms are an argument, so a test can hand in the JAX package's draws and
compare ancestors exactly. Shapes: wn and uniforms (N,) or (B, N), x
(..., N, D); every run decides and resamples on its own, with no host sync
and no loop over runs.
"""

from __future__ import annotations

import math

import torch

from .reduce import row_cumsum


def multinomial_ancestors(wn, uniforms):
    """IID multinomial ancestors from raw uniforms in [0, 1), per run."""
    cdf = row_cumsum(wn).contiguous()
    u = uniforms.to(wn.dtype) * cdf[..., -1:]
    idx = torch.searchsorted(cdf, u, right=True)
    # u < cdf[-1] keeps idx < N; the clamp covers u rounding up onto cdf[-1].
    return torch.clamp(idx, max=wn.shape[-1] - 1)


def resample_if_required(uniforms, x, logw, wn, log_likelihood, ess_val,
                         threshold_frac=0.5):
    """Resample the runs whose ess_val < N * threshold_frac, without a host
    sync. The resampled state is computed for every run and selected with
    `torch.where`; returns (x, logw, did_resample)."""
    n = x.shape[-2]
    ancestors = multinomial_ancestors(wn, uniforms)
    x_res = torch.gather(x, -2, ancestors[..., None].expand(x.shape))
    logw_res = (log_likelihood - math.log(n))[..., None].expand(logw.shape)
    do = ess_val < n * threshold_frac
    x_out = torch.where(do[..., None, None], x_res, x)
    logw_out = torch.where(do[..., None], logw_res.to(logw.dtype), logw)
    return x_out, logw_out, do
