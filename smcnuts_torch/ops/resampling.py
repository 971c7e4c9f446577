"""Resampling when the ESS falls below a threshold, per run: multinomial (the
reference's scheme) and systematic.

The reference resamples multinomially when ESS < N/2 (reference
smcnuts/samples/samples.py:116-146) and resets the log-weights to
log_likelihood - log(N), which keeps the normalising-constant accumulator.
Systematic resampling inverts the CDF at the positions (i + u) / N for one
shared u per run: lower variance at the same cost.

Ancestors come from inverting each run's weight CDF with
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

SCHEMES = ("multinomial", "systematic")


def _invert_cdf(cdf, u):
    idx = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    # u < cdf[-1] keeps idx < N; the clamp covers u rounding up onto cdf[-1].
    return torch.clamp(idx, max=cdf.shape[-1] - 1)


def multinomial_ancestors(wn, uniforms):
    """IID multinomial ancestors from raw uniforms in [0, 1), per run."""
    cdf = row_cumsum(wn)
    return _invert_cdf(cdf, uniforms.to(wn.dtype) * cdf[..., -1:])


def systematic_ancestors(wn, u):
    """Systematic ancestors: the positions (i + u) / N for one shared uniform
    u per run (a number, or a tensor of wn's leading shape), inverted through
    the normalised CDF."""
    n = wn.shape[-1]
    u = torch.as_tensor(u, dtype=wn.dtype, device=wn.device)[..., None]
    positions = (torch.arange(n, dtype=wn.dtype, device=wn.device) + u) / n
    cdf = row_cumsum(wn)
    return _invert_cdf(cdf / cdf[..., -1:], positions.expand(wn.shape))


def ancestors(scheme, wn, uniforms):
    """The ancestors of `scheme` from a run's N resampling uniforms; the
    systematic scheme uses the first of them as its shared u."""
    if scheme == "multinomial":
        return multinomial_ancestors(wn, uniforms)
    if scheme == "systematic":
        return systematic_ancestors(wn, uniforms[..., 0])
    raise ValueError(f"Unknown resampling scheme '{scheme}'; expected one of {SCHEMES}")


def take_rows(idx, arrays):
    """Each array of `arrays`, (..., N) or (..., N, D), gathered along its
    particle axis by the one index tensor idx (..., N)."""
    out = []
    for a in arrays:
        if a.dim() == idx.dim():
            out.append(torch.gather(a, -1, idx))
        else:
            out.append(torch.gather(a, -2, idx[..., None].expand(a.shape)))
    return out


def multinomial_take_rows(wn, uniforms, arrays):
    """Resample every array by one shared multinomial ancestor draw."""
    return take_rows(multinomial_ancestors(wn, uniforms), arrays)


def resample_if_required(uniforms, x, logw, wn, log_likelihood, ess_val,
                         threshold_frac=0.5, scheme="multinomial"):
    """Resample the runs whose ess_val < N * threshold_frac, without a host
    sync. The resampled state is computed for every run and selected with
    `torch.where`; returns (x, logw, did_resample)."""
    n = x.shape[-2]
    (x_res,) = take_rows(ancestors(scheme, wn, uniforms), [x])
    logw_res = (log_likelihood - math.log(n))[..., None].expand(logw.shape)
    do = ess_val < n * threshold_frac
    x_out = torch.where(do[..., None, None], x_res, x)
    logw_out = torch.where(do[..., None], logw_res.to(logw.dtype), logw)
    return x_out, logw_out, do
