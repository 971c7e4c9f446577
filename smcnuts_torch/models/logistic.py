"""Bayesian logistic regression.

    beta ~ N(0, prior_scale^2 I)
    y_i ~ Bernoulli(sigmoid(x_i . beta)),  i = 1..n_obs

The default dataset is synthetic with a fixed seed (64 observations x 8
covariates), the same numbers as the JAX package's; pass (X, y) for real
data.
"""

from __future__ import annotations

import copy
import math

import numpy as np
import torch
from torch import nn

from .base import LOG_SQRT_2PI, check_group

# Lanes that evaluate one particle in the CUDA kernel (kLogisticGroup of
# csrc/nuts_tree.cu, a half warp; ops/nuts_cuda.py checks the two agree): the
# order in which logp_and_grad sums the observations by default. Threads a
# block of the logistic kernel (kLogisticBlock), and the blocks of it an H100
# SM holds at once (128 registers a thread cap an SM at 16 warps; the data
# and the trees' shared memory do not bind); ops/nuts_cuda.py checks both
# against the built kernel before it launches it, since the compaction
# threshold below rests on them.
GROUP = 16
BLOCK = 64
BLOCKS_PER_SM = 8


def _synthetic(n_obs=64, dim=8, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n_obs, dim)).astype(np.float32)
    beta_true = rng.normal(size=(dim,)).astype(np.float32)
    p = 1.0 / (1.0 + np.exp(-(X @ beta_true)))
    y = (rng.random(n_obs) < p).astype(np.float32)
    return X, y


class LogisticModel(nn.Module):
    """`X` (n_obs, D) and `y` (n_obs,) are float64 buffers holding float32
    values (the data are float32 in the JAX package too); they follow
    `.to(device)`."""

    name = "logistic"
    # `chip_smoke.py` phase 8 timed the group kernel's single dispatch and six
    # split tuples at 51,200 lanes (100 x 512, step 0.1, depth 6: the settings
    # of phase 9's logistic run) on an NVIDIA H100 80GB HBM3, 700 W, the device
    # alone: a split after doubling 2 took 0.5875 ms against the single
    # kernel's 0.6491 / 0.6486, the fastest; after doublings 1 and 2 0.6054,
    # 2 and 4 0.6037, every doubling 0.6228. (The one-thread-a-tree kernel
    # before it gained from no split: 1.40 ms single, the tuples 1.47-1.54.)
    # No adapted run was measured: no adapted hint.
    compaction_hint = (2,)
    compaction_hint_adapted = ()
    # The hint pays only past the trees the card holds at once in the logistic
    # kernel, counted in its blocks: the H100's 132 SMs x BLOCKS_PER_SM blocks
    # x BLOCK / GROUP trees a block, 4,224.
    compaction_min_lanes = 132 * BLOCKS_PER_SM * (BLOCK // GROUP)
    group = GROUP  # the group order of logp_and_grad's default (at_group)

    def __init__(self, X=None, y=None, prior_scale=2.5):
        super().__init__()
        if X is None or y is None:
            X, y = _synthetic()
        X = np.asarray(X, np.float32).astype(np.float64)
        y = np.asarray(y, np.float32).astype(np.float64)
        self.n_obs, self.dim = X.shape
        self.constrained_dim = self.dim
        self.param_names = tuple(f"beta.{d + 1}" for d in range(self.dim))
        self.prior_scale = float(prior_scale)
        # Constants of logp_and_grad, in float64: 1 / prior_scale^2 (a division
        # by a constant is a multiplication by its reciprocal on both sides)
        # and the prior's normalising constant.
        self.inv_ps2 = 1.0 / self.prior_scale ** 2
        self.prior_const = -self.dim * (math.log(self.prior_scale) + LOG_SQRT_2PI)
        self.register_buffer("X", torch.as_tensor(X))
        self.register_buffer("y", torch.as_tensor(y))

    def logprior(self, x):
        ps = self.prior_scale
        return torch.sum(
            -0.5 * (x / ps) ** 2 - math.log(ps) - LOG_SQRT_2PI, dim=1)

    def loglik(self, x):
        X, y = self.X.to(x.dtype), self.y.to(x.dtype)
        eta = x @ X.T
        return torch.sum(y * eta - torch.nn.functional.softplus(eta), dim=1)

    def logp(self, x, phi=1.0):
        return self.logprior(x) + phi * self.loglik(x)

    def logp_and_grad(self, x, phi=1.0, group=None):
        """Tempered logp and its gradient in closed form, written op for op
        as the kernel's device function (`csrc/logistic_model.cuh`) at group
        width W = `group` (None: the model's, `GROUP` unless `at_group` set
        another), so the two round alike. Per observation i, as the JAX tile
        density: eta_i by ordered multiply-adds over the covariates, the
        terms y_i eta_i - (max(eta_i, 0) + log1p(exp(-|eta_i|))) and
        (y_i - sigmoid(eta_i)) X_id. Lane l of W sums observations l, l + W,
        l + 2W, ... in that order on a stacked accumulator [ll, s_1..s_D]
        (every lane from zero): each step adds up_i = [y_i eta_i,
        resid_i X_i] and subtracts down_i = [softplus_i, 0, ..], and
        x - 0 = x, so every column rounds as the kernel's scalar sums do.
        Then the W partials are reduced by the kernel's xor butterfly,
        v = v + v[lane ^ o] for o = W/2, ..., 1, and lane 0's sums are
        taken. W = 1 is the sequential order of the JAX tile density. The
        prior's terms are summed over d in order and added after the
        butterfly, by every lane alike. The sigmoid is 1 / (1 + e) for
        eta >= 0 and e / (1 + e) below, e = exp(-|eta|) <= 1, which cannot
        overflow. No matmul or reduction op: their summation order differs
        from the kernel's."""
        W = check_group(self.group if group is None else group)
        X, y = self.X.to(x.dtype), self.y.to(x.dtype)
        n_obs, D = X.shape
        zero = x[:, 0] * 0.0
        lp = zero
        q = ((0.5 * x) * x) * self.inv_ps2
        for d in range(D):
            lp = lp - q[:, d]
        lp = lp + self.prior_const

        eta = x[:, 0:1] * X[:, 0]  # (P, n_obs)
        for d in range(1, D):
            eta = eta + X[:, d] * x[:, d:d + 1]
        e = torch.exp(-torch.abs(eta))
        softplus = torch.where(eta > 0, eta, torch.zeros_like(eta)) + torch.log1p(e)
        one_e = 1.0 + e
        resid = y - torch.where(eta >= 0, 1.0 / one_e, e / one_e)
        up = torch.cat([(y * eta)[..., None], resid[..., None] * X], dim=2)
        down = torch.cat(
            [softplus[..., None],
             torch.zeros_like(softplus)[..., None].expand(-1, -1, D)], dim=2)
        # acc[:, l] holds lane l's [ll, s_1..s_D].
        acc = torch.stack([zero] * (1 + D), dim=1)[:, None].expand(-1, W, -1)
        for lo in range(0, n_obs, W):
            n = min(W, n_obs - lo)  # lanes that have observation lo + l
            stepped = (acc[:, :n] + up[:, lo:lo + n]) - down[:, lo:lo + n]
            acc = torch.cat([stepped, acc[:, n:]], dim=1)
        lanes = torch.arange(W, device=x.device)
        o = W // 2
        while o:
            acc = acc + acc[:, lanes ^ o]
            o //= 2
        ll, s = acc[:, 0, 0], acc[:, 0, 1:]
        phi_col = phi[:, None] if isinstance(phi, torch.Tensor) else phi
        return lp + phi * ll, -x * self.inv_ps2 + phi_col * s

    def at_group(self, group):
        """The same model (its buffers shared) whose `logp_and_grad` sums at
        group width `group` by default: the plain version, for
        `ops.nuts_cuda.nuts_tree_plain` or the eager SMC loop, of a kernel
        entry of that width (`ops.nuts_cuda.nuts_tree_variant`). The main
        kernel runs GROUP lanes only and refuses another width."""
        view = copy.copy(self)
        view.group = check_group(group)
        return view

    def constrain(self, x):
        return x

    def kernel_data(self):
        """The block of floats the CUDA kernel stages: the rows [X_i, y_i],
        row-major at a stride of D + 1 (odd for the instantiated D = 8, so
        the lanes of a group read distinct shared-memory banks)."""
        return torch.cat([self.X, self.y[:, None]], dim=1).reshape(-1).to(torch.float32)

    def kernel_scalars(self) -> tuple:
        """1 / prior_scale^2 and the prior's normalising constant."""
        return (self.inv_ps2, self.prior_const)


def make_logistic(X=None, y=None, prior_scale=2.5) -> LogisticModel:
    return LogisticModel(X, y, prior_scale)
