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

- `arma_loglik_grad(theta, y, group=W)`: the device function's arithmetic
  in plain PyTorch, in its group order: the T - 1 steps cut into W
  contiguous segments, a pass over each from a zero state, a scan of the
  segments' affine maps over the lanes, a second pass with the sums, and an
  xor butterfly over the lanes' partial sums (`csrc/arma_model.cuh` says
  how). `group=None` is the kernels' width, `GROUP`; `group=1` is the
  sequential order of the JAX package's `arma_ll_vg_scan` and `_assemble`.
- `arma_ll_vg_plain(theta, y, group=None)`: the plain version of the kernel,
  that function on y rounded to theta's dtype; a few tensor ops a step of
  each pass (about 600 launches a call on the card at W = 8).
- `arma_ll_vg(theta, y)`: for a CUDA tensor, one launch of the hand-written
  kernel `csrc/arma_fused.cu` (the port of `_arma_kernel`, launched by
  `arma_ll_vg_pallas`) at `GROUP` lanes a particle, built with the NUTS
  kernel by `ops.nuts_cuda.build_library`; a build or launch error raises,
  there is no fallback. For a CPU tensor, the plain version.
  `arma_ll_vg_variant(theta, y, variant)` launches a measurement entry of
  `FUSED_VARIANTS` (the one-thread witness), which the main path never
  launches.
- `make_arma_loglik_vg(y, backend)`: theta -> (loglik, grad) on "cuda"
  (`arma_ll_vg`, but a CPU tensor raises) or "plain", the counterparts of the JAX
  package's "pallas" and "scan". No `custom_vmap` is needed: every function
  here is batched over particles already.

The kernel and the whole-tree NUTS kernel's arma model run one device
function (`arma_loglik_grad<GROUP>` of `csrc/arma_model.cuh`), written op
for op as the plain version, so on the card the three agree to the bit.
theta is (N, 4) [mu, beta, theta_ma, log_sigma]; y (T,) in theta's dtype
(the plain version rounds it so: float32 in float32, as the JAX package with
x64 off).
"""

from __future__ import annotations

import math

import torch

LOG_SQRT_2PI = float(0.5 * math.log(2.0 * math.pi))
# Lanes a particle in both kernels that run the arma density (kArmaGroup of
# csrc/arma_model.cuh; ops/nuts_cuda.py checks the two agree): the order in
# which arma_loglik_grad runs the recurrence by default.
GROUP = 8
# The fused kernel's measurement entry: name -> (entry, lanes a particle);
# the one-thread-a-particle witness.
FUSED_VARIANTS = {"w1": ("smcnuts_arma_ll_vg_w1", 1)}


def check_group(group):
    """The group width W that `group` names (None: GROUP); W must be a power
    of two in 1..32."""
    W = GROUP if group is None else int(group)
    if W < 1 or W & (W - 1) or W > 32:
        raise ValueError(f"group must be a power of two in 1..32, got {group}")
    return W


def _shift_up(v, d):
    """v[:, l - d] at lane l >= d (lanes below d keep their own value): what
    __shfl_up_sync(mask, v, d, W) returns, lanes on dim 1."""
    return torch.cat([v[:, :d], v[:, :-d]], dim=1)


def arma_loglik_grad(theta, y, group=None):
    """loglik (N,) and its gradient (N, 4) of y (T,) at theta (N, 4), both in
    theta's dtype, y already in it, in the order of the device function at
    W = `group` lanes a particle.

    The recurrence and its tangents run as e = [err, emu, eb, eth], (N, W, 4)
    for the W lanes: per step e' = c - theta e with c = [b_t, -1, -y_{t-1},
    -err], and the sums [S2, S_mu, S_beta, S_theta] grow by err' e'. Lane l
    steps t = 1 + l L + k for k = 0..L-1, L = ceil((T - 1) / W); where t >= T
    it keeps its state (the kernel's loop has ended). Pass 1 runs from a zero
    state (lane 0 from the t = 0 state) and carries the map's p and q
    (q' = p - theta q, p' = -theta p); the scan composes lane l's map after
    lane l - d's for d = 1, 2, ...; pass 2 runs from lane l - 1's end state
    (lane 0: t = 0) with the sums (lane 0's start from err_0 e_0, the rest
    from zero); the butterfly adds lane l ^ o for o = W/2, ..., 1; lane 0's
    sums are taken. No reduction op, no cumsum: their order is not the
    kernel's."""
    W = check_group(group)
    mu, beta, th, ls = theta.unbind(-1)
    n, T = theta.shape[0], y.shape[0]
    L = (T - 1 + W - 1) // W
    dev = theta.device
    lanes = torch.arange(W, device=dev)
    t = 1 + lanes[:, None] * L + torch.arange(L, device=dev)[None, :]  # (W, L)
    valid = t < T
    tc = torch.clamp(t, max=T - 1)
    y_t, y_p = y[tc], y[tc - 1]
    b = (y_t[None] - mu[:, None, None]) - beta[:, None, None] * y_p[None]  # (N, W, L)
    minus_one = torch.full_like(b[..., 0:1], -1.0)
    th_col = th[:, None, None]
    th_lane = th[:, None]

    err0 = (y[0] - mu) - beta * mu
    e0 = torch.stack([err0, -1.0 - beta, -mu, torch.zeros_like(mu)], dim=1)  # (N, 4)

    def step(e, k):
        c = torch.cat([b[..., k:k + 1], minus_one, (-y_p[:, k:k + 1]).expand_as(minus_one),
                       -e[..., 0:1]], dim=2)
        return c - th_col * e

    if W > 1:
        first = lanes[None, :, None] == 0
        e = torch.where(first, e0[:, None, :], torch.zeros_like(e0)[:, None, :])
        p = torch.ones((n, W), dtype=theta.dtype, device=dev)
        q = torch.zeros_like(p)
        for k in range(L):
            live = valid[:, k]
            e = torch.where(live[None, :, None], step(e, k), e)
            q_n = p - th_lane * q
            p_n = -th_lane * p
            q = torch.where(live[None, :], q_n, q)
            p = torch.where(live[None, :], p_n, p)
        d = 1
        while d < W:
            pp, qq, o = _shift_up(p, d), _shift_up(q, d), _shift_up(e, d)
            pc = p[..., None]
            head = pc * o[..., :3] + e[..., :3]
            tail = (p * o[..., 3] - q * o[..., 0]) + e[..., 3]
            combined = torch.cat([head, tail[..., None]], dim=2)
            q_n = p * qq + q * pp
            p_n = p * pp
            on = (lanes >= d)[None, :]
            e = torch.where(on[..., None], combined, e)
            q = torch.where(on, q_n, q)
            p = torch.where(on, p_n, p)
            d *= 2
        e = torch.cat([e0[:, None, :], e[:, :-1]], dim=1)
    else:
        e = e0[:, None, :]

    acc = torch.where(lanes[None, :, None] == 0, e[..., 0:1] * e, torch.zeros_like(e))
    for k in range(L):
        live = valid[:, k][None, :, None]
        e_n = step(e, k)
        acc = torch.where(live, acc + e_n[..., 0:1] * e_n, acc)
        e = torch.where(live, e_n, e)
    o = W // 2
    while o:
        acc = acc + acc[:, lanes ^ o]
        o //= 2
    s2, smu, sb, sth = acc[:, 0].unbind(1)

    inv_s2 = torch.exp(-2.0 * ls)
    ll = -T * (LOG_SQRT_2PI + ls) - 0.5 * s2 * inv_s2
    grad = torch.stack(
        [-smu * inv_s2, -sb * inv_s2, -sth * inv_s2, -T + s2 * inv_s2], dim=1)
    return ll, grad


def arma_ll_vg_plain(theta, y, group=None):
    """The plain version of the kernel: (loglik (N,), grad (N, 4)) at theta
    (N, 4), with y (T,) rounded to theta's dtype, at group width `group`
    (None: the kernel's). Counts its calls."""
    arma_ll_vg_plain.calls += 1
    return arma_loglik_grad(theta, y.to(device=theta.device, dtype=theta.dtype), group)


arma_ll_vg_plain.calls = 0


def _launch(entry, theta, y):
    """Check the inputs and launch the kernel entry `entry` of the library on
    them; returns (ll, grad)."""
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
    err = getattr(lib, entry)(
        theta.data_ptr(), y32.data_ptr(), y32.numel(), n, ll.data_ptr(),
        grad.data_ptr(), torch.cuda.current_stream(theta.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")
    return ll, grad


def arma_ll_vg(theta, y):
    """(loglik (N,), grad (N, 4)) at theta (N, 4): for a CUDA tensor one
    launch of the kernel, counted in `arma_ll_vg.launches`; for a CPU tensor
    the plain version; any other device raises."""
    if theta.device.type == "cpu":
        return arma_ll_vg_plain(theta, y)
    if theta.device.type != "cuda":
        raise ValueError(f"arma_ll_vg runs on cpu or cuda tensors, got {theta.device}")
    out = _launch("smcnuts_arma_ll_vg", theta, y)
    arma_ll_vg.launches += 1
    return out


arma_ll_vg.launches = 0  # kernel launches, and nothing else


def arma_ll_vg_variant(theta, y, variant):
    """`arma_ll_vg` on CUDA tensors through the measurement entry `variant` of
    `FUSED_VARIANTS`; its plain version is `arma_ll_vg_plain(theta, y,
    group=W)` at the entry's width. Counted in
    `arma_ll_vg_variant.launches[variant]`, never in `arma_ll_vg.launches`."""
    if variant not in FUSED_VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; expected {sorted(FUSED_VARIANTS)}")
    if theta.device.type != "cuda":
        raise ValueError(f"arma_ll_vg_variant runs on cuda tensors, got {theta.device}")
    out = _launch(FUSED_VARIANTS[variant][0], theta, y)
    arma_ll_vg_variant.launches[variant] += 1
    return out


arma_ll_vg_variant.launches = dict.fromkeys(FUSED_VARIANTS, 0)


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
