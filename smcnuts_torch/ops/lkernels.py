"""L-kernel (backward-kernel) strategies of the SMC weight update, keyed by
the reference's strings (reference smcnuts/samples/samples.py:39-48):

- "forwardsLKernel": L(-r_new | x_new) = momentum_logpdf(-r_new), the
  near-optimal L-kernel of Devlin et al. (forward_lkernel.py:22-35).
- "GaussianApproxLKernel": the Gaussian approximation of the optimal L-kernel,
  estimated from the particle population (gaussian_lkernel.py:24-84).
- "asymptoticLKernel": no density at all, but an accept-reject forward kernel
  and a tempered reweight in the sampler (samples.py:45-46, :169-180).

Every function is per run: r_new and x_new are (N, D) for one run or
(B, N, D) for B runs, and run b of a batch gives what the run gives alone,
bit for bit. The population moments therefore take the fixed-order sums of
`ops.reduce`, the small (D, D) products are summed in sequence over the
contraction index (a library matmul picks its algorithm, TF32 or split-K
included, from the shape), and the three small factorisations (pseudo-inverse,
Cholesky, triangular solve), which are library calls, are made once per run on
that run's own matrices: a batched factorisation routine is another algorithm
than the single-matrix one.
"""

from __future__ import annotations

import math

import torch

from .reduce import row_sum

RIDGE = 1e-6  # reference gaussian_lkernel.py:68


def forward_lkernel_logpdf(momentum_logpdf, r_new):
    """Forwards-proposal L-kernel (forward_lkernel.py:35)."""
    return momentum_logpdf(-r_new)


def _matmul(a, b):
    """a (..., m, k) @ b (..., k, n), summed in sequence over k."""
    acc = a[..., :, 0, None] * b[..., None, 0, :]
    for k in range(1, a.shape[-1]):
        acc = acc + a[..., :, k, None] * b[..., None, k, :]
    return acc


def _per_run(fn, *mats):
    """fn on each run's matrices alone, stacked back (no batched routine)."""
    lead = mats[0].shape[:-2]
    flat = [m.reshape((-1,) + m.shape[-2:]) for m in mats]
    out = torch.stack([fn(*(m[i] for m in flat)) for i in range(flat[0].shape[0])])
    return out.reshape(lead + out.shape[1:])


def _cholesky(a):
    """The lower Cholesky factor, NaN where the matrix is not positive
    definite, without a host sync."""
    chol, info = torch.linalg.cholesky_ex(a)
    return torch.where(info == 0, chol, torch.full_like(chol, float("nan")))


def gaussian_lkernel_logpdf(r_new, x_new):
    """Gaussian approximation of the optimal L-kernel.

    Stacks X = [-r_new, x_new] (N, 2D); estimates the joint mean and
    covariance over the population (ddof = 1, as np.cov); conditions the
    Gaussian on x_new by the block decomposition, with a pseudo-inverse and a
    1e-6 ridge on the conditional covariance (gaussian_lkernel.py:45-68);
    returns log N(-r_new_i | mu_i, cov) for every particle."""
    N, D = x_new.shape[-2:]
    dtype = x_new.dtype
    Xt = torch.cat([-r_new, x_new], dim=-1).transpose(-1, -2)  # (..., 2D, N)
    mu_X = row_sum(Xt) / N  # (..., 2D)
    Xc = Xt - mu_X[..., None]
    cov_X = row_sum(Xc[..., :, None, :] * Xc[..., None, :, :]) / (N - 1)

    mu_r, mu_x = mu_X[..., :D], mu_X[..., D:]
    c_rr = cov_X[..., :D, :D]
    c_rx = cov_X[..., :D, D:]
    c_xr = cov_X[..., D:, :D]
    c_xx = cov_X[..., D:, D:]

    gain = _matmul(c_rx, _per_run(torch.linalg.pinv, c_xx))  # (..., D, D)
    cov = c_rr - _matmul(gain, c_xr) + RIDGE * torch.eye(
        D, dtype=dtype, device=x_new.device)

    # Conditional means mu_i = mu_r + gain (x_i - mu_x), kept transposed.
    resid_t = -r_new.transpose(-1, -2) - (
        mu_r[..., None] + _matmul(gain, Xc[..., D:, :]))  # (..., D, N)
    chol = _per_run(_cholesky, cov)
    z = _per_run(
        lambda c, rt: torch.linalg.solve_triangular(c, rt, upper=False),
        chol, resid_t,
    )  # (..., D, N) whitened residuals
    maha = z[..., 0, :] * z[..., 0, :]
    log_diag = torch.log(chol[..., 0, 0])
    for d in range(1, D):
        maha = maha + z[..., d, :] * z[..., d, :]
        log_diag = log_diag + torch.log(chol[..., d, d])
    logdet = 2.0 * log_diag
    return -0.5 * (maha + logdet[..., None] + D * math.log(2.0 * math.pi))
