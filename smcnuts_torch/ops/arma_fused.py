"""Fused ARMA(1,1) log-likelihood and its gradient: a hand-written CUDA kernel
and its plain version (the JAX package's `ops/arma_fused.py`).

Every leapfrog of the eager NUTS tree evaluates the tempered log-density and
its gradient for a block of particles. For the arma model the likelihood is a
linear error recurrence, and value and gradient come out of ONE forward pass
that carries the three tangent recurrences beside it, all with the
coefficient -theta:

    err_t           = ((y_t - mu) - beta y_{t-1}) - theta err_{t-1}
    d err_t/d mu    = -1       - theta d err_{t-1}/d mu
    d err_t/d beta  = -y_{t-1} - theta d err_{t-1}/d beta
    d err_t/d theta = -err_{t-1} - theta d err_{t-1}/d theta

    loglik        = -T (log sqrt(2 pi) + log_sigma) - (0.5 S2) / sigma^2
    d ll/d p      = -S_p / sigma^2          (p in mu, beta, theta)
    d ll/d lsigma = S2 / sigma^2 - T

with S2 = sum err^2 and S_p = sum err (d err/d p).

- `arma_ll_vg_plain(theta, y)`: plain PyTorch, the counterpart of the JAX
  package's `arma_ll_vg_scan` and `_assemble`; one step of tensor ops per
  observation (about six launches a step on the card).
- `arma_ll_vg(theta, y)`: for a CUDA tensor, one launch of the hand-written
  kernel `csrc/arma_fused.cu` (the port of `_arma_kernel`, launched by
  `arma_ll_vg_pallas`), built with the NUTS kernel by
  `ops.nuts_cuda.build_library`; a build or launch error raises, there is no
  fallback. For a CPU tensor, the plain version.
- `make_arma_loglik_vg(y, backend)`: theta -> (loglik, grad) on "cuda"
  (`arma_ll_vg`, but a CPU tensor raises) or "plain", the counterparts of the JAX
  package's "pallas" and "scan". No `custom_vmap` is needed: every function
  here is batched over particles already.

The kernel and the whole-tree NUTS kernel's arma model run one device
function (`arma_loglik_grad` of `csrc/arma_model.cuh`), written op for op as
the plain version, so on the card the three agree to the bit. theta is
(N, 4) [mu, beta, theta_ma, log_sigma]; y (T,) in theta's dtype (the plain
version rounds it so: float32 in float32, as the JAX package with x64 off).
"""

from __future__ import annotations

import math

import torch

LOG_SQRT_2PI = float(0.5 * math.log(2.0 * math.pi))


def arma_loglik_grad(theta, y):
    """loglik (N,) and its gradient (N, 4) of y (T,) at theta (N, 4), both in
    theta's dtype, y already in it. The recurrence and its tangents run as
    the columns of one (N, 4) tensor e = [err, emu, eb, eth]; per step
    e' = c - theta e with c = [b_t, -1, -y_{t-1}, -err], and the four sums
    [S2, S_mu, S_beta, S_theta] grow by err' e'."""
    mu, beta, th, ls = theta.unbind(-1)
    T = y.shape[0]
    err = (y[0] - mu) - beta * mu
    e = torch.stack([err, -1.0 - beta, -mu, torch.zeros_like(mu)], dim=1)
    acc = err[:, None] * e
    b = (y[None, 1:] - mu[:, None]) - beta[:, None] * y[None, :-1]
    const = torch.stack(
        [b, torch.full_like(b, -1.0), (-y[:-1]).expand_as(b)], dim=2)
    th_col = th[:, None]
    for t in range(1, T):
        c = torch.cat([const[:, t - 1], -e[:, 0:1]], dim=1)
        e = c - th_col * e
        acc = acc + e[:, 0:1] * e
    s2, smu, sb, sth = acc.unbind(1)

    inv_s2 = torch.exp(-2.0 * ls)
    ll = -T * (LOG_SQRT_2PI + ls) - 0.5 * s2 * inv_s2
    grad = torch.stack(
        [-smu * inv_s2, -sb * inv_s2, -sth * inv_s2, -T + s2 * inv_s2], dim=1)
    return ll, grad


def arma_ll_vg_plain(theta, y):
    """The plain version of the kernel: (loglik (N,), grad (N, 4)) at theta
    (N, 4), with y (T,) rounded to theta's dtype. Counts its calls."""
    arma_ll_vg_plain.calls += 1
    return arma_loglik_grad(theta, y.to(device=theta.device, dtype=theta.dtype))


arma_ll_vg_plain.calls = 0


def arma_ll_vg(theta, y):
    """(loglik (N,), grad (N, 4)) at theta (N, 4): for a CUDA tensor one
    launch of the kernel, counted in `arma_ll_vg.launches`; for a CPU tensor
    the plain version; any other device raises."""
    if theta.device.type == "cpu":
        return arma_ll_vg_plain(theta, y)
    if theta.device.type != "cuda":
        raise ValueError(f"arma_ll_vg runs on cpu or cuda tensors, got {theta.device}")
    from .nuts_cuda import build_library

    if theta.dtype != torch.float32:
        raise NotImplementedError(
            f"the fused ARMA kernel runs float32 only, got {theta.dtype}")
    if theta.dim() != 2 or theta.shape[1] != 4 or theta.shape[0] == 0:
        raise ValueError(f"theta must be (N, 4) with N >= 1, got {tuple(theta.shape)}")
    if not theta.is_contiguous() or theta.data_ptr() % 16:
        raise ValueError("theta must be contiguous and 16-byte aligned (one float4 a row)")
    if y.device != theta.device:
        raise ValueError(f"y is on {y.device}, theta on {theta.device}")
    lib = build_library().lib
    y32 = y.to(torch.float32).contiguous()
    if not 1 <= y32.numel() <= lib.smcnuts_arma_fused_max_t():
        raise ValueError(f"y holds {y32.numel()} observations; the kernel stages at "
                         f"most {lib.smcnuts_arma_fused_max_t()} in shared memory")
    n = theta.shape[0]
    ll = torch.empty(n, dtype=theta.dtype, device=theta.device)
    grad = torch.empty_like(theta)
    err = lib.smcnuts_arma_ll_vg(
        theta.data_ptr(), y32.data_ptr(), y32.numel(), n, ll.data_ptr(),
        grad.data_ptr(), torch.cuda.current_stream(theta.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"arma_ll_vg kernel launch failed: CUDA error {err}")
    arma_ll_vg.launches += 1
    return ll, grad


arma_ll_vg.launches = 0  # kernel launches, and nothing else


def make_arma_loglik_vg(y, backend="cuda"):
    """theta (N, 4) -> (loglik, grad) for the observations y: "cuda" is
    `arma_ll_vg` and raises for a tensor that is not on the card; "plain"
    runs the plain version on any device."""
    if backend == "plain":
        return lambda theta: arma_ll_vg_plain(theta, y)
    if backend != "cuda":
        raise ValueError(f"Unknown backend {backend!r}; expected 'cuda' or 'plain'")

    def loglik_vg(theta):
        if theta.device.type != "cuda":
            raise ValueError(
                f"the fused ARMA kernel ('cuda') needs a CUDA tensor, got "
                f"{theta.device}; use fused='plain' on the CPU")
        return arma_ll_vg(theta, y)

    return loglik_vg
