"""Serial NumPy SMC-NUTS baseline (CPU oracle), the port's copy.

The JAX package's `baselines/numpy_smc.py`, kept here so that the port and
the card's machine (no jax there) have it: an independent, reference-
faithful re-derivation of the algorithm (reference smcnuts/smc_sampler.py,
samples.py, proposal/nuts.py): recursive-doubling NUTS per particle, serial
Python loops, scipy bisection tempering, the three L-kernel strategies. It
serves

1. statistical cross-validation of the port's sampler and kernels (same
   model, same algorithm, independent code path and RNG):
   `tests/test_torch_baseline.py` on the CPU, `chip_smoke.py`'s phase
   `oracle` against the card;
2. the measured CPU baseline of a bench's `vs_baseline` (`bench.py:110-155`
   times the JAX package's copy at N=64, K=5).

Everything but `NumpyModelAdapter` is the JAX file's code unchanged and
pure numpy/scipy (`tests/test_torch_baseline.py` holds `NumpyArmaModel` and
`run_numpy_smc` to it to the bit); `NumpyArmaModel` reads the port's copy
of the arma data (`smcnuts_torch/assets/arma.npz`). The adapter wraps a
port model in place of a JAX one. This is CPU code by nature: the
yardstick, never on the card's path.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from scipy.optimize import bisect
from scipy.special import logsumexp
from torch import nn

MAX_TREE_DEPTH = 10
DIVERGENCE = 100.0


class NumpyArmaModel:
    """Pure NumPy/SciPy ARMA(1,1) target (no JAX anywhere): the error
    recurrence and its tangent recurrences are constant-coefficient IIR
    filters evaluated with scipy.signal.lfilter (C speed), making this a fair
    stand-in for the reference's BridgeStan C++ evaluations when measuring
    the serial-baseline throughput."""

    def __init__(self, y=None):
        if y is None:
            import os

            asset = os.path.join(
                os.path.dirname(__file__), "..", "assets", "arma.npz"
            )
            y = np.load(asset)["y"]
        self.y = np.asarray(y, np.float64)
        self.T = len(self.y)
        self.dim = 4

    def _err_sums(self, theta):
        from scipy.signal import lfilter

        mu, beta, th, ls = theta
        y = self.y
        b = np.empty(self.T)
        b[0] = y[0] - mu - beta * mu
        b[1:] = y[1:] - mu - beta * y[:-1]
        err = lfilter([1.0], [1.0, th], b)
        dmu_in = np.full(self.T, -1.0)
        dmu_in[0] = -1.0 - beta
        emu = lfilter([1.0], [1.0, th], dmu_in)
        db_in = np.empty(self.T)
        db_in[0] = -mu
        db_in[1:] = -y[:-1]
        eb = lfilter([1.0], [1.0, th], db_in)
        eth_in = np.empty(self.T)
        eth_in[0] = 0.0
        eth_in[1:] = -err[:-1]
        eth = lfilter([1.0], [1.0, th], eth_in)
        return err, emu, eb, eth

    def _prior(self, theta):
        mu, beta, th, ls = theta
        sigma = np.exp(ls)
        lp = (
            -0.5 * (mu / 10.0) ** 2 - np.log(10.0) - 0.5 * np.log(2 * np.pi)
            - 0.5 * (beta / 2.0) ** 2 - np.log(2.0) - 0.5 * np.log(2 * np.pi)
            - 0.5 * (th / 2.0) ** 2 - np.log(2.0) - 0.5 * np.log(2 * np.pi)
            - np.log(np.pi * 2.5) - np.log1p((sigma / 2.5) ** 2)
            + ls
        )
        z = sigma / 2.5
        gp = np.array([
            -mu / 100.0,
            -beta / 4.0,
            -th / 4.0,
            1.0 - 2.0 * z * z / (1.0 + z * z),
        ])
        return lp, gp

    def _loglik_terms(self, theta):
        err, emu, eb, eth = self._err_sums(theta)
        ls = theta[3]
        inv_s2 = np.exp(-2.0 * ls)
        ll = -self.T * (0.5 * np.log(2 * np.pi) + ls) - 0.5 * inv_s2 * np.dot(
            err, err
        )
        gl = np.array([
            -inv_s2 * np.dot(err, emu),
            -inv_s2 * np.dot(err, eb),
            -inv_s2 * np.dot(err, eth),
            -self.T + inv_s2 * np.dot(err, err),
        ])
        return ll, gl

    def logpdf(self, x, phi=1.0):
        x = np.asarray(x, np.float64)
        if x.ndim == 1:
            lp, _ = self._prior(x)
            ll, _ = self._loglik_terms(x)
            return lp + phi * ll
        return np.array([self.logpdf(xi, phi) for xi in x])

    def logpdfgrad(self, x, phi=1.0):
        x = np.asarray(x, np.float64)
        _, gp = self._prior(x)
        _, gl = self._loglik_terms(x)
        return gp + phi * gl

    def loglik(self, x):
        x = np.asarray(x, np.float64)
        if x.ndim == 1:
            return self._loglik_terms(x)[0]
        return np.array([self._loglik_terms(xi)[0] for xi in x])

    def constrain(self, x):
        x = np.asarray(x, np.float64)
        out = x.copy()
        out[..., 3] = np.exp(out[..., 3])
        return out


class NumpyModelAdapter:
    """Expose a port model (the `Model` protocol, `models/base.py`) to numpy
    code as logpdf/grad callables, on CPU float32 tensors, the precision of
    the JAX package's adapter. Each method takes one row (D,) or rows
    (n, D) and is one call of the model's batched method on a (1, D) or
    (n, D) tensor. A model with tensors off the CPU is copied to it."""

    def __init__(self, model):
        tensors = list(model.buffers()) if isinstance(model, nn.Module) else []
        if any(t.device.type != "cpu" for t in tensors):
            model = copy.deepcopy(model).to("cpu")
        self.model = model
        self.dim = model.dim

    @staticmethod
    def _rows(x):
        x = np.asarray(x, np.float32)
        return x.ndim == 1, torch.from_numpy(np.ascontiguousarray(np.atleast_2d(x)))

    @staticmethod
    def _values(one, v):
        v = v.detach().numpy()
        # As the JAX adapter's: a Python float for one row, else float64.
        return float(v[0]) if one else v.astype(np.float64)

    def logpdf(self, x, phi=1.0):
        one, t = self._rows(x)
        with torch.no_grad():
            return self._values(one, self.model.logp(t, phi))

    def logpdfgrad(self, x, phi=1.0):
        one, t = self._rows(x)
        g = self.model.logp_and_grad(t, phi)[1].detach().numpy()
        return g[0] if one else g

    def loglik(self, x):
        one, t = self._rows(x)
        with torch.no_grad():
            return self._values(one, self.model.loglik(t))

    def constrain(self, x):
        one, t = self._rows(x)
        with torch.no_grad():
            c = self.model.constrain(t).numpy()
        return c[0] if one else c


def _leapfrog(model, x, r, grad, direction, eps, phi):
    r = r + (direction * eps / 2.0) * grad
    x = x + direction * eps * r
    grad = model.logpdfgrad(x, phi)
    r = r + (direction * eps / 2.0) * grad
    return x, r, grad


def _uturn(xm, xp, rm, rp):
    dx = xp - xm
    return (np.dot(dx, rm) < 0) or (np.dot(dx, rp) < 0)


def _build_tree(model, x, r, grad, logu, direction, depth, eps, phi, rng):
    if depth == 0:
        x1, r1, g1 = _leapfrog(model, x, r, grad, direction, eps, phi)
        joint = model.logpdf(x1, phi) - 0.5 * np.dot(r1, r1)
        n1 = int(logu < joint)
        s1 = int((logu - DIVERGENCE) >= joint)
        return x1, r1, g1, x1, r1, g1, x1, r1, n1, s1
    xm, rm, gm, xp, rp, gp, xc, rc, n1, s1 = _build_tree(
        model, x, r, grad, logu, direction, depth - 1, eps, phi, rng
    )
    if s1 == 0:
        if direction == -1:
            xm, rm, gm, _, _, _, xc2, rc2, n2, s2 = _build_tree(
                model, xm, rm, gm, logu, direction, depth - 1, eps, phi, rng
            )
        else:
            _, _, _, xp, rp, gp, xc2, rc2, n2, s2 = _build_tree(
                model, xp, rp, gp, logu, direction, depth - 1, eps, phi, rng
            )
        if rng.uniform() < n2 / max(n1 + n2, 1):
            xc, rc = xc2, rc2
        n1 += n2
        s1 = int(s1 or s2 or _uturn(xm, xp, rm, rp))
    return xm, rm, gm, xp, rp, gp, xc, rc, n1, s1


def nuts_one(model, x0, r0, eps, phi, rng, max_depth=MAX_TREE_DEPTH):
    logp0 = model.logpdf(x0, phi)
    h0 = logp0 - 0.5 * np.dot(r0, r0)
    logu = float(h0 - rng.exponential(1.0))
    grad = model.logpdfgrad(x0, phi)
    xm = xp = x = x0
    rm = rp = r = r0
    gm = gp = grad
    depth, n, stop = 0, 1, 0
    while stop == 0:
        direction = 1 if rng.uniform() < 0.5 else -1
        if direction == -1:
            xm, rm, gm, _, _, _, xc, rc, n1, s1 = _build_tree(
                model, xm, rm, gm, logu, direction, depth, eps, phi, rng
            )
        else:
            _, _, _, xp, rp, gp, xc, rc, n1, s1 = _build_tree(
                model, xp, rp, gp, logu, direction, depth, eps, phi, rng
            )
        if s1 == 0 and rng.uniform() < min(1.0, n1 / n):
            x, r = xc, rc
        n += n1
        stop = s1 or _uturn(xm, xp, rm, rp)
        depth += 1
        if depth > max_depth:
            break
    return x, r


def _gaussian_lkernel(r_new, x_new):
    D = x_new.shape[1]
    X = np.hstack([-r_new, x_new])
    mu_X = X.mean(axis=0)
    cov_X = np.cov(X.T)
    mu_r, mu_x = mu_X[:D], mu_X[D:]
    c_rr, c_rx = cov_X[:D, :D], cov_X[:D, D:]
    c_xr, c_xx = cov_X[D:, :D], cov_X[D:, D:]
    pinv = np.linalg.pinv(c_xx)
    cov = c_rr - c_rx @ pinv @ c_xr + 1e-6 * np.eye(D)
    cov_inv = np.linalg.inv(cov)
    _, logdet = np.linalg.slogdet(cov)
    out = np.zeros(len(x_new))
    for i in range(len(x_new)):
        mu = mu_r + c_rx @ pinv @ (x_new[i] - mu_x)
        resid = -r_new[i] - mu
        out[i] = -0.5 * (resid @ cov_inv @ resid + logdet + D * np.log(2 * np.pi))
    return out


def _std_normal_logpdf(x):
    return -0.5 * np.sum(x * x, axis=-1) - 0.5 * x.shape[-1] * np.log(2 * np.pi)


def _normalise(logw):
    finite = ~np.isneginf(logw)
    ll = logsumexp(logw[finite]) if finite.any() else -np.inf
    wn = np.zeros_like(logw)
    if finite.any():
        wn[finite] = np.exp(logw[finite] - ll)
    return wn, ll


def _next_phi(loglik, phi_old, n, alpha=0.5):
    def f(phi):
        logw = (phi - phi_old) * loglik
        wn, _ = _normalise(logw)
        return 1.0 / np.sum(wn**2) - n * alpha

    if f(1.0) >= 0:
        return 1.0
    return bisect(f, phi_old, 1.0)


def run_numpy_smc(model, n, k_iters, step_size, lkernel="forwardsLKernel",
                  tempering=False, seed=0, max_depth=MAX_TREE_DEPTH):
    """Run the serial baseline. Returns a dict of diagnostic series."""
    rng = np.random.RandomState(seed)
    dim = model.dim
    asymptotic = lkernel == "asymptoticLKernel"

    x = rng.normal(size=(n, dim))
    if tempering:
        phi = _next_phi(model.loglik(x), 0.0, n)
    else:
        phi = 1.0
    logw = model.logpdf(x, phi) - _std_normal_logpdf(x)

    means, variances, esses, phis, lls = [], [], [], [], []
    x_saved, logw_saved = [x.copy()], [logw.copy()]

    for _ in range(k_iters):
        phis.append(phi)
        wn, ll = _normalise(logw)
        cx = model.constrain(x)
        mean = wn @ cx
        var = wn @ (cx - mean) ** 2
        means.append(mean)
        variances.append(var)
        lls.append(ll)
        ess = 1.0 / np.sum(wn**2)
        esses.append(ess)

        if ess < n / 2:
            idx = rng.choice(np.arange(n), n, p=wn)
            x = x[idx]
            logw = np.full(n, ll - np.log(n))

        r = rng.normal(size=(n, dim))
        x_new = np.zeros_like(x)
        r_new = np.zeros_like(r)
        for i in range(n):
            x_new[i], r_new[i] = nuts_one(
                model, x[i], r[i], step_size, phi, rng, max_depth
            )
        if asymptotic:
            for i in range(n):
                h1 = model.logpdf(x_new[i], phi) - 0.5 * np.dot(r_new[i], r_new[i])
                h0 = model.logpdf(x[i], phi) - 0.5 * np.dot(r[i], r[i])
                with np.errstate(all="ignore"):
                    a = min(1.0, np.exp(h1 - h0))
                if rng.uniform() > a or np.any(np.isinf(x_new[i])):
                    x_new[i] = x[i]
                    r_new[i] = r[i]

        if tempering:
            phi_next = _next_phi(model.loglik(x_new), phi, n)
        else:
            phi_next = 1.0

        if asymptotic:
            logw_new = logw + (phi_next - phi) * model.loglik(x)
        else:
            if lkernel == "forwardsLKernel":
                lk = _std_normal_logpdf(-r_new)
            else:
                lk = _gaussian_lkernel(r_new, x_new)
            logw_new = (
                logw
                + model.logpdf(x_new, 1.0)
                - model.logpdf(x, 1.0)
                + lk
                - _std_normal_logpdf(r)
            )

        x, logw, phi = x_new, logw_new, phi_next
        x_saved.append(x.copy())
        logw_saved.append(logw.copy())

    phis.append(phi)
    wn, ll = _normalise(logw)
    cx = model.constrain(x)
    mean = wn @ cx
    means.append(mean)
    variances.append(wn @ (cx - mean) ** 2)
    lls.append(ll)
    esses.append(1.0 / np.sum(wn**2))

    out = {
        "mean_estimate": np.asarray(means),
        "variance_estimate": np.asarray(variances),
        "ess": np.asarray(esses),
        "phi": np.asarray(phis),
        "log_likelihood": np.asarray(lls),
    }

    if asymptotic:
        # Tempered-recycling post-pass (reference estimate_from_tempered.py).
        means_t, vars_t = [], []
        for kk in range(k_iters + 1):
            wn_k, _ = _normalise(logw_saved[kk])
            idx = rng.choice(np.arange(n), n, p=wn_k)
            xr = x_saved[kk][idx]
            logw_c = (1.0 - out["phi"][kk]) * model.loglik(xr)
            wn_c, _ = _normalise(logw_c)
            cx = model.constrain(xr)
            m = wn_c @ cx
            means_t.append(m)
            vars_t.append(wn_c @ (cx - m) ** 2)
        out["mean_estimate"] = np.asarray(means_t)
        out["variance_estimate"] = np.asarray(vars_t)

    return out
