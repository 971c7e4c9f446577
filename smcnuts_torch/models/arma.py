"""ARMA(1,1) time-series model (reference stan_models/arma/arma.stan).

Unconstrained parameters x = [mu, beta, theta_ma, log_sigma];
sigma = exp(log_sigma), with the +log_sigma Jacobian folded into the prior.
Priors: mu ~ N(0, 10), beta ~ N(0, 2), theta ~ N(0, 2), sigma ~ Cauchy(0, 2.5)
(half-Cauchy through the constraint). Likelihood: one-step-ahead errors
err_1 = y_1 - (mu + beta*mu), err_t = y_t - (mu + beta*y_{t-1} + theta*err_{t-1}),
err_t ~ N(0, sigma), scaled by the temperature phi.

The data and the ground truth come from the port's own copy of the JAX
package's asset file (`smcnuts_torch/assets/`, the same bytes).

`make_arma(fused=...)` takes the likelihood's value and gradient from the
fused function of `ops/arma_fused.py` (the JAX model's `loglik_vg`): "cuda"
the hand-written kernel, "plain" its plain version, None (the default) the
same recurrence inline. The eager NUTS tree then evaluates the tempered density
as the closed-form prior value and gradient + phi * loglik_vg, which is how
the JAX package's XLA backend composes it (`sampler.py:352-360`). The
whole-tree CUDA kernel ignores `fused`: it inlines `csrc/arma_model.cuh`.

Both kernels run the density on a group of `GROUP` lanes a particle, the
T - 1 steps of the recurrence split over the lanes by segments and a lane
scan (`csrc/arma_model.cuh`), and `logp_and_grad(group=W)` rounds in that
order; `group=1` is the sequential order of the JAX package's model.
"""

from __future__ import annotations

import copy
import math
import os

import numpy as np
import torch
from torch import nn

from ..ops.arma_fused import (
    GROUP, arma_ll_vg_plain, arma_loglik_grad, check_group, make_arma_loglik_vg)
from ..ops.generated import tile_model_from_logp_fwd
from .base import EVERY_DEPTH, LOG_SQRT_2PI, CallableModel, cauchy_lpdf, normal_lpdf

# Threads a block of the arma NUTS entry (kArmaBlock of csrc/nuts_tree.cu;
# GROUP, imported above, is its lanes a particle), and the blocks of it an
# H100 SM holds at once (80 registers a thread). ops/nuts_cuda.py checks all
# three against the built kernel before it launches it, since the compaction
# threshold below rests on them.
BLOCK = 64
BLOCKS_PER_SM = 12

ASSET = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets", "arma.npz")

_LOG_PI = float(math.log(math.pi))
_LOG_10 = float(math.log(10.0))
_LOG_2 = float(math.log(2.0))
_LOG_2_5 = float(math.log(2.5))


def load_asset() -> dict:
    with np.load(ASSET) as data:
        return {k: np.asarray(data[k]) for k in data.files}


class ArmaModel(nn.Module):
    """ARMA(1,1) target; `y` is a float64 buffer that follows `.to(device)`.

    In float32 the model works on y rounded to float32, as the JAX package
    does with x64 off. `fused`: None, "cuda" or "plain" (module docstring)."""

    name = "arma"
    dim = 4
    constrained_dim = 4
    param_names = ("mu", "beta", "theta", "sigma")
    compaction_hint = EVERY_DEPTH  # measured on an H100, see models/base.py
    compaction_hint_adapted = EVERY_DEPTH
    # The hints pay past twice the trees the card holds at once in the arma
    # kernel, counted in its blocks: 2 x the H100's 132 SMs x BLOCKS_PER_SM
    # blocks x BLOCK / GROUP trees a block (models/base.py keeps the
    # measurement).
    compaction_min_lanes = 2 * 132 * BLOCKS_PER_SM * (BLOCK // GROUP)
    group = GROUP  # the group order of logp_and_grad's default (at_group)

    def __init__(self, y=None, fused=None):
        super().__init__()
        if fused not in (None, "cuda", "plain"):
            raise ValueError(f"fused must be None, 'cuda' or 'plain', got {fused!r}")
        self.fused = fused
        if y is None:
            y = load_asset()["y"]
        y = np.asarray(y, np.float64)
        self.register_buffer("y", torch.as_tensor(y))
        self.register_buffer("y32", torch.as_tensor(y.astype(np.float32)),
                             persistent=False)
        # Host copies of the data as Python floats, per working dtype: the
        # recurrences take them as scalars, so no step reads device memory
        # for y and nothing syncs with the device.
        self._y_host = {
            torch.float32: [float(v) for v in y.astype(np.float32)],
            torch.float64: [float(v) for v in y],
        }

    @property
    def T(self) -> int:
        return len(self._y_host[torch.float64])

    def _y(self, dtype):
        return self.y32 if dtype == torch.float32 else self.y.to(dtype)

    def _loglik_vg(self, x, group=None):
        """(loglik (N,), grad (N, 4)) of x at group width `group` (None: the
        kernels', GROUP): the recurrence inline, or with `fused` the kernel
        ("cuda", at GROUP only) or its plain version ("plain")."""
        y = self._y(x.dtype)
        if self.fused is None:
            return arma_loglik_grad(x, y, group)
        if self.fused == "plain":
            return arma_ll_vg_plain(x, y, group)
        if check_group(group) != GROUP:
            raise ValueError(f"the fused ARMA kernel runs {GROUP} lanes a particle, "
                             f"not {group}")
        return make_arma_loglik_vg(y, self.fused)(x)

    def _data(self, x):
        """(y as Python floats, b_t = (y_t - mu) - beta*y_{t-1} for t >= 1)."""
        yl = self._y_host[x.dtype]
        y = self.y.to(x.dtype)
        mu, beta = x[:, 0:1], x[:, 1:2]
        b = (y[None, 1:] - mu) - beta * y[None, :-1]
        return yl, b

    def logprior(self, x):
        mu, beta, th, ls = x.unbind(-1)
        lp = normal_lpdf(mu, 0.0, 10.0)
        lp = lp + normal_lpdf(beta, 0.0, 2.0)
        lp = lp + normal_lpdf(th, 0.0, 2.0)
        lp = lp + cauchy_lpdf(torch.exp(ls), 0.0, 2.5)
        return lp + ls  # Jacobian of sigma = exp(log_sigma)

    def loglik(self, x):
        mu, beta, th, ls = x.unbind(-1)
        yl, b = self._data(x)
        err = (yl[0] - mu) - beta * mu
        s2 = err * err
        for t in range(1, self.T):
            err = b[:, t - 1] - th * err
            s2 = s2 + err * err
        return -self.T * (LOG_SQRT_2PI + ls) - 0.5 * s2 * torch.exp(-2.0 * ls)

    def logp(self, x, phi=1.0):
        return self.logprior(x) + phi * self.loglik(x)

    def logp_and_grad(self, x, phi=1.0, group=None):
        """Tempered logp and its gradient.

        The error recurrence and its three tangents (d err / d mu, beta,
        theta) run together with four running sums; the loglik, the priors
        and their gradients then follow in closed form. The arithmetic is
        written op for op as the kernel's device function
        (`csrc/arma_model.cuh`) at group width W = `group` (None: the
        model's, GROUP unless `at_group` set another), so the two round
        alike; W = 1 is the order of the JAX package's `arma_tile_model`. With `fused` the likelihood part is
        the fused value and gradient (`ops/arma_fused.py`)."""
        mu, beta, th, ls = x.unbind(-1)
        ll, gl = self._loglik_vg(x, self.group if group is None else group)
        gl_mu, gl_beta, gl_th, gl_ls = gl.unbind(1)

        z = torch.exp(ls) / 2.5
        lprior = (
            -0.5 * (mu / 10.0) ** 2 - _LOG_10 - LOG_SQRT_2PI
            - 0.5 * (beta / 2.0) ** 2 - _LOG_2 - LOG_SQRT_2PI
            - 0.5 * (th / 2.0) ** 2 - _LOG_2 - LOG_SQRT_2PI
            - _LOG_PI - _LOG_2_5 - torch.log1p(z * z)
            + ls
        )
        gp_mu = -mu / 100.0
        gp_beta = -beta / 4.0
        gp_th = -th / 4.0
        gp_ls = 1.0 - 2.0 * z * z / (1.0 + z * z)

        logp = lprior + phi * ll
        grad = torch.stack([
            gp_mu + phi * gl_mu,
            gp_beta + phi * gl_beta,
            gp_th + phi * gl_th,
            gp_ls + phi * gl_ls,
        ], dim=1)
        return logp, grad

    def at_group(self, group):
        """The same model (its buffers shared) whose `logp_and_grad` runs at
        group width `group` by default: the plain version, for
        `ops.nuts_cuda.nuts_tree_plain` or the eager SMC loop, of a kernel
        entry of that width (`ops.nuts_cuda.nuts_tree_variant`). The CUDA
        kernel runs GROUP lanes only and refuses another width."""
        view = copy.copy(self)
        view.group = check_group(group)
        return view

    def constrain(self, x):
        return torch.cat([x[:, :3], torch.exp(x[:, 3:4])], dim=1)


def make_arma(y=None, fused=None) -> ArmaModel:
    return ArmaModel(y, fused)


def arma_logprior_seq(coords):
    """The priors and the exp transform's Jacobian of one particle, its
    coordinates a sequence of four scalars (`arma_tile_model_fwd`'s form)."""
    mu, beta, th, ls = coords
    z = torch.exp(ls) / 2.5
    return (
        -0.5 * (mu / 10.0) ** 2 - _LOG_10 - LOG_SQRT_2PI
        - 0.5 * (beta / 2.0) ** 2 - _LOG_2 - LOG_SQRT_2PI
        - 0.5 * (th / 2.0) ** 2 - _LOG_2 - LOG_SQRT_2PI
        - _LOG_PI - _LOG_2_5 - torch.log1p(z * z)
        + ls
    )


def arma_loglik_seq(y):
    """loglik(coords) of the T observations y (Python floats), the error
    recurrence unrolled as `arma_tile_model_fwd` writes it."""
    yf = [float(v) for v in np.asarray(y, np.float64)]
    T = len(yf)

    def loglik(coords):
        mu, beta, th, ls = coords
        err = yf[0] - mu - beta * mu
        s2 = err * err
        for t in range(1, T):
            err = yf[t] - mu - beta * yf[t - 1] - th * err
            s2 = s2 + err * err
        return -T * (LOG_SQRT_2PI + ls) - 0.5 * s2 * torch.exp(-2.0 * ls)

    return loglik


def arma_model_fwd(y=None, order="primal", reroll=True) -> CallableModel:
    """arma as a user's torch density: a `CallableModel` whose logprior and
    loglik take one particle, with the generated forward-mode in-kernel model
    of the scalar density lprior + phi * loglik, emitted in `order`, its
    error recurrence as a loop over the observations unless `reroll` is
    False (`ops.generated.tile_model_from_logp_fwd`). The observations enter
    as Python floats (rounded to float32, as `arma_tile_model_fwd` rounds
    them): literals of the straight-line program, a column of the data block
    in the loop."""
    if y is None:
        y = load_asset()["y"]
    loglik = arma_loglik_seq(y)

    def logp_seq(coords, phi):
        return arma_logprior_seq(coords) + phi * loglik(coords)

    return CallableModel(
        "arma", 4, lambda t: arma_logprior_seq(t.unbind(0)),
        lambda t: loglik(t.unbind(0)),
        constrain=lambda t: torch.cat([t[:3], torch.exp(t[3:4])]),
        param_names=ArmaModel.param_names,
        tile_model=tile_model_from_logp_fwd(logp_seq, 4, name="arma", order=order,
                                            reroll=reroll),
    )


def ground_truth():
    """Posterior mean and VARIANCE from the reference's long Stan run.

    The asset's `gt_var` column is the posterior standard deviation (Stan
    summary format), so it is squared here, as in the JAX package."""
    data = load_asset()
    return data["gt_mean"], np.asarray(data["gt_var"]) ** 2


def default_step_size() -> float:
    return float(load_asset()["step_size"])
