"""Poisson regression with a kernel design matrix and a bridge (EP) prior
(reference stan_models/PRMwCD/PRMwCD.stan).

Unconstrained parameters x = [Beta_1..Beta_M, log_Gamma] with M = Clength + 1
(12 for the asset's 11 covariates, so D = 13); Gamma = exp(log_Gamma), its
Jacobian folded into the prior. Priors: Gamma ~ InvGamma(2, 1.3); for the
M - 1 non-intercept betas, log p += -log(Gamma) - |Beta_i / Gamma|^q; the
intercept is flat. Likelihood: y_i ~ Poisson(exp(eta_i)) with
eta = Beta_1 + X @ Beta_2..M, scaled by the temperature phi.

The data and the ground truth come from the port's own copy of the JAX
package's asset file (`smcnuts_torch/assets/`, the same bytes).
"""

from __future__ import annotations

import functools
import math
import os
import types

import numpy as np
import torch
from torch import nn

from .base import EVERY_DEPTH, check_group, inv_gamma_lpdf, poisson_lpmf

# Lanes that evaluate one particle in the CUDA kernel (kPrmwcdGroup of
# csrc/nuts_tree.cu, a half warp; ops/nuts_cuda.py checks the two agree): the
# order in which logp_and_grad sums the observations by default.
GROUP = 16
# Threads a block of the PRMwCD kernel (kPrmwcdBlock of csrc/nuts_tree.cu), and
# the blocks of it an H100 SM holds at once (168 registers a thread cap an SM at
# 12 warps; the data and the trees' shared memory do not bind). ops/nuts_cuda.py
# checks both against the built kernel before it launches it, since the
# compaction threshold below rests on them.
BLOCK = 64
BLOCKS_PER_SM = 6

ASSET = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets", "prmwcd.npz")


def load_asset() -> dict:
    with np.load(ASSET) as data:
        return {k: np.asarray(data[k]) for k in data.files}


class PrmwcdModel(nn.Module):
    """PRMwCD target; `y` (n_obs,) and `X` (n_obs, n_cov) are float64 buffers
    that follow `.to(device)`. In float32 the model works on them rounded to
    float32, as the JAX package does with x64 off."""

    name = "prmwcd"
    compaction_hint = EVERY_DEPTH  # measured on an H100, see models/base.py
    compaction_hint_adapted = (5,)
    # The hints pay past the trees the card holds at once in the PRMwCD
    # kernel, counted in its blocks: the H100's 132 SMs x BLOCKS_PER_SM
    # blocks x BLOCK / GROUP trees a block.
    compaction_min_lanes = 132 * BLOCKS_PER_SM * (BLOCK // GROUP)

    def __init__(self, y=None, X=None, q=None):
        super().__init__()
        data = load_asset() if y is None or X is None or q is None else {}
        y = np.asarray(data["y"] if y is None else y, np.float64)
        X = np.asarray(data["X"] if X is None else X, np.float64)
        self.q = float(data["q"] if q is None else q)
        self.n_cov = X.shape[1]
        M = self.n_cov + 1  # betas, intercept included
        self.dim = self.constrained_dim = M + 1
        self.param_names = tuple(f"Beta.{i}" for i in range(1, M + 1)) + ("Gamma",)
        self.register_buffer("y", torch.as_tensor(y))
        self.register_buffer("X", torch.as_tensor(X))
        # Constants of logp_and_grad, in float64 as the JAX tile model computes
        # them: -sum_i lgamma(y_i + 1), and 2 log 1.3 of the inverse gamma
        # (lgamma(2) = 0).
        self.lgamma_const = -math.fsum(math.lgamma(v + 1.0) for v in y)
        self.ig_const = 2.0 * math.log(1.3)

    def _data(self, dtype):
        return self.y.to(dtype), self.X.to(dtype)

    def logprior(self, x):
        M = self.n_cov + 1
        log_gamma = x[:, M]
        gamma = torch.exp(log_gamma)
        lp = inv_gamma_lpdf(gamma, 2.0, 1.3) + log_gamma  # + exp Jacobian
        ep = -log_gamma[:, None] - torch.abs(x[:, 1:M] / gamma[:, None]) ** self.q
        return lp + torch.sum(ep, dim=1)

    def loglik(self, x):
        y, X = self._data(x.dtype)
        eta = x[:, 0:1] + x[:, 1:self.n_cov + 1] @ X.T
        return torch.sum(poisson_lpmf(y, eta), dim=1)

    def logp(self, x, phi=1.0):
        return self.logprior(x) + phi * self.loglik(x)

    def logp_and_grad(self, x, phi=1.0, group=None):
        """Tempered logp and its gradient in closed form.

        Written op for op as the kernel's device function
        (`csrc/prmwcd_model.cuh`) at group width W = `group` (None: the
        kernel's, `GROUP`), so the two round alike. Per observation i, as
        the JAX package's `prmwcd_tile_model`: eta by ordered multiply-adds
        over the covariates, mu = exp(eta), the terms y_i eta_i - mu_i,
        resid_i and resid_i X_ij. Lane l of W sums observations l, l + W,
        l + 2W, ... in that order on a stacked accumulator [ll, s_resid,
        s_cov_1..] (lane 0's ll starts from the lgamma constant, the rest
        from zero): each step adds up_i = [y_i eta_i, resid_i, resid_i X_i]
        and subtracts down_i = [mu_i, 0, ..], and x - 0 = x, so every column
        rounds as the kernel's scalar sums do. Then the W partials are
        reduced by the kernel's xor butterfly, v = v + v[lane ^ o] for
        o = W/2, ..., 1, and lane 0's sums are taken. W = 1 is the
        sequential order of the JAX tile model. No matmul or reduction op:
        their summation order differs from the kernel's."""
        y, X = self._data(x.dtype)
        n_obs, n_cov = X.shape
        M = n_cov + 1
        q = self.q
        W = check_group(GROUP if group is None else group)
        b, g = x[:, :M], x[:, M]
        zero = b[:, 0] * 0.0

        eta = b[:, 0:1].expand(-1, n_obs)
        for j in range(n_cov):
            eta = eta + X[:, j] * b[:, j + 1:j + 2]
        mu = torch.exp(eta)
        resid = y - mu
        up = torch.cat(
            [(y * eta)[..., None], resid[..., None], resid[..., None] * X], dim=2
        )
        down = torch.cat(
            [mu[..., None], torch.zeros_like(mu)[..., None].expand(-1, -1, M)],
            dim=2,
        )
        # acc[:, l] holds lane l's [ll, s_resid, s_cov_1..s_cov_n_cov].
        first = torch.stack([zero + self.lgamma_const] + [zero] * M, dim=1)
        acc = torch.stack([first] + [torch.stack([zero] * (M + 1), dim=1)] * (W - 1),
                          dim=1)
        for lo in range(0, n_obs, W):
            n = min(W, n_obs - lo)  # lanes that have observation lo + l
            stepped = (acc[:, :n] + up[:, lo:lo + n]) - down[:, lo:lo + n]
            acc = torch.cat([stepped, acc[:, n:]], dim=1)
        lanes = torch.arange(W, device=x.device)
        o = W // 2
        while o:
            acc = acc + acc[:, lanes ^ o]
            o //= 2
        ll, s_resid, s_cov = acc[:, 0, 0], acc[:, 0, 1], acc[:, 0, 2:]

        # Prior: inverse gamma on Gamma = exp(g) with its Jacobian, EP on the
        # non-intercept betas; |b / Gamma|^q as exp(q (log|b| - g)).
        inv_gamma = torch.exp(-g)
        lab = torch.log(torch.abs(b[:, 1:])) - g[:, None]
        pow_q = torch.exp(q * lab)
        gp_beta = (
            -q * torch.exp((q - 1.0) * lab) * torch.sign(b[:, 1:])
            * inv_gamma[:, None]
        )
        ep_sum = zero
        for j in range(n_cov):
            ep_sum = ep_sum + pow_q[:, j]
        lprior = (
            self.ig_const - 3.0 * g - 1.3 * inv_gamma + g
            - (M - 1) * g - ep_sum
        )
        gp_g = -3.0 + 1.3 * inv_gamma + 1.0 - (M - 1) + q * ep_sum

        phi_col = phi[:, None] if isinstance(phi, torch.Tensor) else phi
        logp = lprior + phi * ll
        grad = torch.cat(
            [(phi * s_resid)[:, None], gp_beta + phi_col * s_cov, gp_g[:, None]],
            dim=1,
        )
        return logp, grad

    def at_group(self, group):
        """A view whose `logp_and_grad` sums at group width `group`: the plain
        version, for `ops.nuts_cuda.nuts_tree_plain`, of a kernel entry of
        that width (`ops.nuts_cuda.nuts_tree_variant`)."""
        return types.SimpleNamespace(
            name=self.name, dim=self.dim,
            logp_and_grad=functools.partial(self.logp_and_grad, group=group))

    def constrain(self, x):
        M = self.n_cov + 1
        return torch.cat([x[:, :M], torch.exp(x[:, M:])], dim=1)

    def kernel_scalars(self) -> tuple:
        """The model's scalar constants as the CUDA kernel takes them (float64
        here, rounded to float32 at the call): q, q - 1, the lgamma sum and
        2 log 1.3."""
        return (self.q, self.q - 1.0, self.lgamma_const, self.ig_const)


def make_prmwcd(y=None, X=None, q=None) -> PrmwcdModel:
    return PrmwcdModel(y, X, q)


def ground_truth():
    """Posterior mean and VARIANCE from the reference's long Stan run; the
    asset's `gt_var` column is the posterior sd, squared here as in the JAX
    package."""
    data = load_asset()
    return data["gt_mean"], np.asarray(data["gt_var"]) ** 2


def default_step_size() -> float:
    return float(load_asset()["step_size"])
