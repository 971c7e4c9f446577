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
included, from the shape), the two small factorisations (pseudo-inverse,
Cholesky), which are library calls, are made once per run on that run's own
matrices (a batched factorisation routine is another algorithm than the
single-matrix one), and the whitening of the N residuals is a forward
substitution summed in sequence, each particle's on its own (a library
triangular solve picks its blocking from the number of right-hand sides).

With a particle group (`parallel.sharding`) r_new and x_new hold the rank's
shard: the population's mean and (2D x 2D) moments are summed over the
ranks by the group's fold, every rank factorises the same matrices, and each
particle's log-density is the unsharded one to the bit.
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


def _forward_substitution(chol, b):
    """z with chol z = b for the lower-triangular chol (..., D, D) and
    b (..., D, N), a column of chol at a time: z_j = b_j / chol_jj, then
    chol_ij z_j taken off every later row i. Row i thus subtracts its terms
    in the order j = 0, 1, ..., each particle on its own, in 3 D - 1 ops."""
    z = b.clone()
    D = chol.shape[-1]
    for j in range(D):
        z[..., j, :] /= chol[..., j, j, None]
        if j + 1 < D:
            z[..., j + 1:, :] -= chol[..., j + 1:, j, None] * z[..., j, None, :]
    return z


def population_moments(r_new, x_new, group=None):
    """The mean (..., 2D) and covariance (..., 2D, 2D; ddof = 1, as np.cov)
    of X = [-r_new, x_new] over the population, and the centred X^T
    (..., 2D, N); with a group, over every rank's particles (the sums by the
    group's fold), the centred rows the rank's own."""
    N = x_new.shape[-2] * (1 if group is None else group.size)
    Xt = torch.cat([-r_new, x_new], dim=-1).transpose(-1, -2)  # (..., 2D, N)
    mu_X = row_sum(Xt, group) / N
    Xc = Xt - mu_X[..., None]
    cov_X = row_sum(Xc[..., :, None, :] * Xc[..., None, :, :], group) / (N - 1)
    return mu_X, cov_X, Xc


def gaussian_lkernel_logpdf(r_new, x_new, group=None):
    """Gaussian approximation of the optimal L-kernel.

    Stacks X = [-r_new, x_new] (N, 2D); estimates the joint mean and
    covariance over the population (ddof = 1, as np.cov); conditions the
    Gaussian on x_new by the block decomposition, with a pseudo-inverse and a
    1e-6 ridge on the conditional covariance (gaussian_lkernel.py:45-68);
    returns log N(-r_new_i | mu_i, cov) for every particle."""
    D = x_new.shape[-1]
    dtype = x_new.dtype
    mu_X, cov_X, Xc = population_moments(r_new, x_new, group)

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
    z = _forward_substitution(chol, resid_t)  # (..., D, N) whitened residuals
    maha = z[..., 0, :] * z[..., 0, :]
    log_diag = torch.log(chol[..., 0, 0])
    for d in range(1, D):
        maha = maha + z[..., d, :] * z[..., d, :]
        log_diag = log_diag + torch.log(chol[..., d, d])
    logdet = 2.0 * log_diag
    return -0.5 * (maha + logdet[..., None] + D * math.log(2.0 * math.pi))
