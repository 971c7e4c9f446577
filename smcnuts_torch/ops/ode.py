"""ODE solvers of the Stan frontend, in torch ops: the port of
`jax.experimental.ode.odeint` (adaptive Dormand-Prince with its continuous
adjoint), which the JAX frontend's `_ode_solve` calls
(`smcnuts_tpu/stan/compiler.py:916`), and of its fixed-step RK4 extension
(`:998-1030`).

`odeint_dopri5(rhs, y0, ts, args, rtol, atol, mxstep)` follows JAX's
`_odeint` op for op (the source: `jax/experimental/ode.py` of JAX 0.9.0):
the Dormand-Prince tableau, `initial_step_size` (Hairer, Norsett and Wanner,
II.4), `mean_error_ratio`, `optimal_step_size` (safety 0.9, ifactor 10,
dfactor 0.2, order 5), each output time interpolated by the 4th-order
polynomial fitted to the step that passes it (`fit_4th_order_polynomial`),
not stepped to, and `_odeint_rev`'s continuous adjoint as its backward: the
augmented state (y, y_bar, t0_bar, args_bar), flattened in that order, solved
backwards between output times by the same controller. So the accepted steps
are JAX's sequence. `rhs(y, t, *args)` maps one lane's state (n,), time ()
and arguments to dy/dt (n,): the interpreter's user function.

Under `torch.func.vmap` (the interpreter runs one particle at a time inside
`vmap(grad_and_value)`, `models/base.CallableModel`) a Python loop on a
per-lane error ratio cannot run, so the solve is a `torch.autograd.Function`
whose `vmap` rule solves the whole batch at once: each lane its own step
size, time and counter, the lanes still short of the next output time
stepped together (gathered, their right-hand side under `torch.func.vmap`)
and written back, until none is left (a host check a step). Every operation
acts on each lane alone in a fixed order (sums over the state in index
order, never a reduction whose order follows the shape), so a lane's bits do
not depend on the others: a batched solve equals each lane solved alone. Its
backward is the adjoint, a second Function batched the same way, with the
right-hand side's VJP from `torch.func.vjp`. The step loop depends on the
data, so a program that reaches it is interpreted every call, never replayed
from a trace (`stan.compiler.StanModel`).

`odeint_rk4(rhs, y0, ts, args, steps)` is the JAX frontend's fixed-step
classical RK4, `steps` steps an output interval: plain tensor ops in a
Python loop, differentiated by autograd as JAX differentiates its scan, so a
trace replays it and a generated model (`ops/generated.py`) can lower it.

`solve_batched.steps` counts the RK steps taken, accepted and rejected,
lanes summed, in forward solves and adjoints alike (what chip_smoke.py
prints a particle).
"""

from __future__ import annotations

import torch

# The Dormand-Prince tableau (`runge_kutta_step`).
_ALPHA = (1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_BETA = (
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_C_SOL = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_C_ERROR = (
    35 / 384 - 1951 / 21600, 0.0, 500 / 1113 - 22642 / 50085, 125 / 192 - 451 / 720,
    -2187 / 6784 - -12231 / 42400, 11 / 84 - 649 / 6300, -1.0 / 60.0,
)
# The midpoint of a step for the interpolating polynomial (`interp_fit_dopri`).
_DPS_C_MID = (
    6025192743 / 30085553152 / 2, 0.0, 51252292925 / 65400821598 / 2,
    -2691868925 / 45128329728 / 2, 187940372067 / 1594534317056 / 2,
    -1776094331 / 19743644256 / 2, 11237099 / 235043384 / 2,
)
# Stan's rk45 defaults, as the JAX frontend takes them.
RTOL = ATOL = 1e-6
MXSTEP = 1_000_000


def _dot(coeffs, ks):
    """sum_j coeffs[j] * ks[j] over the stages, in stage order; zero
    coefficients skipped (their stages never reach the sum)."""
    acc = None
    for c, k in zip(coeffs, ks):
        if c != 0.0:
            term = c * k
            acc = term if acc is None else acc + term
    return acc


def _sumsq(v):
    """(b, n) -> (b,): the sum of squares over the state in index order."""
    acc = v[:, 0] * v[:, 0]
    for j in range(1, v.shape[1]):
        acc = acc + v[:, j] * v[:, j]
    return acc


def _norm(v):
    return torch.sqrt(_sumsq(v))


def _col(v):
    return v[:, None]


def _initial_step_size(fun, t0, y0, order, rtol, atol, f0, args):
    scale = atol + torch.abs(y0) * rtol
    d0 = _norm(y0 / scale)
    d1 = _norm(f0 / scale)
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), torch.full_like(d0, 1e-6), 0.01 * d0 / d1)
    y1 = y0 + _col(h0) * f0
    f1 = fun(y1, t0 + h0, *args)
    d2 = _norm((f1 - f0) / scale) / h0
    h1 = torch.where((d1 <= 1e-15) & (d2 <= 1e-15),
                     torch.maximum(torch.full_like(h0, 1e-6), h0 * 1e-3),
                     (0.01 / torch.maximum(d1, d2)) ** (1.0 / (order + 1.0)))
    return torch.minimum(100.0 * h0, h1)


def _runge_kutta_step(fun, y0, f0, t0, dt, args):
    ks = [f0]
    for i in range(1, 7):
        ti = t0 + dt * _ALPHA[i - 1]
        yi = y0 + _col(dt) * _dot(_BETA[i - 1], ks)
        ks.append(fun(yi, ti, *args))
    y1 = _col(dt) * _dot(_C_SOL, ks) + y0
    y1_error = _col(dt) * _dot(_C_ERROR, ks)
    return y1, ks[-1], y1_error, ks


def _mean_error_ratio(error, rtol, atol, y0, y1):
    err_tol = atol + rtol * torch.maximum(torch.abs(y0), torch.abs(y1))
    return torch.sqrt(_sumsq(error / err_tol) / error.shape[1])


def _optimal_step_size(last_step, ratio, safety=0.9, ifactor=10.0, dfactor=0.2, order=5.0):
    dfactor = torch.where(ratio < 1, torch.ones_like(ratio), torch.full_like(ratio, dfactor))
    factor = torch.minimum(torch.full_like(ratio, ifactor),
                           torch.maximum(ratio ** (-1.0 / order) * safety, dfactor))
    return torch.where(ratio == 0, last_step * ifactor, last_step * factor)


def _interp_fit(y0, y1, ks, dt):
    """The coefficients (a, b, c, d, e) of the step's 4th-order polynomial,
    stacked (b, 5, n)."""
    dt = _col(dt)
    y_mid = y0 + dt * _dot(_DPS_C_MID, ks)
    dy0, dy1 = ks[0], ks[-1]
    a = -2.0 * dt * dy0 + 2.0 * dt * dy1 - 8.0 * y0 - 8.0 * y1 + 16.0 * y_mid
    b = 5.0 * dt * dy0 - 3.0 * dt * dy1 + 18.0 * y0 + 14.0 * y1 - 32.0 * y_mid
    c = -4.0 * dt * dy0 + dt * dy1 - 11.0 * y0 - 5.0 * y1 + 16.0 * y_mid
    d = dt * dy0
    return torch.stack([a, b, c, d, y0], 1)


def _polyval(coeffs, s):
    """Horner on (b, 5, n) coefficients at s (b,), as jnp.polyval."""
    s = _col(s)
    y = coeffs[:, 0]
    for k in range(1, coeffs.shape[1]):
        y = y * s + coeffs[:, k]
    return y


def solve_batched(fun, y0, ts, args, rtol, atol, mxstep):
    """Solve B lanes at once: y0 (B, n), ts (B, T) strictly increasing, args
    a list of (B, ...) tensors, `fun(y (b, n), t (b,), *args (b, ...))` ->
    (b, n) on any b lanes. Returns (B, T, n), row 0 y0. Each lane runs JAX's
    controller alone; a step is computed for the lanes still short of the
    next output time (and under mxstep steps, with a positive step), which
    are gathered and written back."""
    B, n = y0.shape
    f = fun(y0, ts[:, 0], *args)
    dt = _initial_step_size(fun, ts[:, 0], y0, 4, rtol, atol, f, args)
    dt = torch.clamp(dt, min=0.0)
    y, t, last_t = y0, ts[:, 0], ts[:, 0]
    interp = torch.stack([y0] * 5, 1)
    out = [y0]
    for j in range(1, ts.shape[1]):
        target = ts[:, j]
        i = torch.zeros(B, dtype=torch.int64, device=y0.device)
        while True:
            active = (t < target) & (i < mxstep) & (dt > 0)
            lanes = torch.nonzero(active).squeeze(1)
            if lanes.numel() == 0:
                break
            solve_batched.steps += int(lanes.numel())
            every = lanes.numel() == B
            sel = (lambda v: v) if every else (lambda v: v.index_select(0, lanes))
            ya, fa, ta, dta = sel(y), sel(f), sel(t), sel(dt)
            aa = [sel(a) for a in args]
            next_y, next_f, err, ks = _runge_kutta_step(fun, ya, fa, ta, dta, aa)
            next_t = ta + dta
            ratio = _mean_error_ratio(err, rtol, atol, ya, next_y)
            new_interp = _interp_fit(ya, next_y, ks, dta)
            new_dt = torch.clamp(_optimal_step_size(dta, ratio), min=0.0)
            ok = ratio <= 1.0
            vals = (
                torch.where(_col(ok), next_y, ya), torch.where(_col(ok), next_f, fa),
                torch.where(ok, next_t, ta), new_dt, torch.where(ok, ta, sel(last_t)),
                torch.where(ok[:, None, None], new_interp, sel(interp)), sel(i) + 1,
            )
            if every:
                y, f, t, dt, last_t, interp, i = vals
            else:
                y, f, t, dt, last_t, interp, i = (
                    old.index_copy(0, lanes, new)
                    for old, new in zip((y, f, t, dt, last_t, interp, i), vals))
        out.append(_polyval(interp, (target - last_t) / (t - last_t)))
    return torch.stack(out, 1)


solve_batched.steps = 0  # RK steps taken, lanes summed (forward and adjoint)


def _expand(v, d, B):
    """An input of a vmap rule with its batch dimension first, B lanes."""
    if d is None:
        return v.unsqueeze(0).expand(B, *v.shape)
    return v.movedim(d, 0)


def _lanes(rhs):
    """rhs of one lane as a function of b lanes: its vmap."""
    return torch.func.vmap(rhs)


def _forward(rhs, rtol, atol, mxstep, y0, ts, args):
    return solve_batched(_lanes(rhs), y0, ts, args, rtol, atol, mxstep)


def _adjoint(rhs, rtol, atol, mxstep, ys, ts, g, args):
    """JAX's `_odeint_rev` on B lanes: (y0_bar (B, n), ts_bar (B, T),
    args_bar...). The augmented state (y, y_bar, t0_bar, args_bar) is one
    flat vector a lane, its dynamics (-f, the VJP of f at y_bar) at negated
    time."""
    B, T, n = ys.shape
    sizes = [a[0].numel() for a in args]

    def vjp_one(y, t, y_bar, *a):
        out, pull = torch.func.vjp(rhs, y, t, *a)
        return (out,) + tuple(pull(y_bar))

    vjp_lanes = torch.func.vmap(vjp_one)

    def aug_dynamics(state, s, *a):
        y, y_bar = state[:, :n], state[:, n:2 * n]
        out, y_cot, t_cot, *a_cot = vjp_lanes(y, -s, y_bar, *a)
        parts = [-out, y_cot, t_cot[:, None]] + [c.reshape(c.shape[0], -1) for c in a_cot]
        return torch.cat(parts, 1)

    fun = _lanes(rhs)
    y_bar = g[:, -1]
    t0_bar = torch.zeros(B, dtype=ys.dtype, device=ys.device)
    args_bar = [torch.zeros(B, k, dtype=ys.dtype, device=ys.device) for k in sizes]
    ts_bar = []
    for i in range(T - 1, 0, -1):
        f_i = fun(ys[:, i], ts[:, i], *args)
        t_bar = f_i[:, 0] * g[:, i, 0]
        for j in range(1, n):
            t_bar = t_bar + f_i[:, j] * g[:, i, j]
        t0_bar = t0_bar - t_bar
        state = torch.cat([ys[:, i], y_bar, t0_bar[:, None]] + args_bar, 1)
        back = torch.stack([-ts[:, i], -ts[:, i - 1]], 1)
        state = solve_batched(aug_dynamics, state, back, list(args), rtol, atol, mxstep)[:, 1]
        y_bar = state[:, n:2 * n] + g[:, i - 1]
        t0_bar = state[:, 2 * n]
        args_bar, o = [], 2 * n + 1
        for k in sizes:
            args_bar.append(state[:, o:o + k])
            o += k
        ts_bar.append(t_bar)
    ts_bar = torch.stack([t0_bar] + ts_bar[::-1], 1)
    return (y_bar, ts_bar) + tuple(ab.reshape(a.shape) for ab, a in zip(args_bar, args))


class _Dopri5(torch.autograd.Function):
    """ys = odeint(rhs, y0, ts, *args); its vmap rule solves the batch, its
    backward is `_Dopri5Adjoint`."""

    generate_vmap_rule = False

    @staticmethod
    def forward(rhs, rtol, atol, mxstep, y0, ts, *args):
        return _forward(rhs, rtol, atol, mxstep, y0[None], ts[None],
                        [a[None] for a in args])[0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        rhs, rtol, atol, mxstep, _, ts, *args = inputs
        ctx.solver = (rhs, rtol, atol, mxstep)
        ctx.save_for_backward(output, ts, *args)

    @staticmethod
    def backward(ctx, g):
        ys, ts, *args = ctx.saved_tensors
        grads = _Dopri5Adjoint.apply(*ctx.solver, ys, ts, g, *args)
        return (None, None, None, None) + tuple(grads)

    @staticmethod
    def vmap(info, in_dims, rhs, rtol, atol, mxstep, y0, ts, *args):
        B = info.batch_size
        _, _, _, _, dy, dt, *da = in_dims
        ys = _forward(rhs, rtol, atol, mxstep, _expand(y0, dy, B), _expand(ts, dt, B),
                      [_expand(a, d, B) for a, d in zip(args, da)])
        return ys, 0


class _Dopri5Adjoint(torch.autograd.Function):
    """(y0_bar, ts_bar, *args_bar) of `_Dopri5` by the continuous adjoint;
    batched by its vmap rule. It has no derivative of its own."""

    generate_vmap_rule = False

    @staticmethod
    def forward(rhs, rtol, atol, mxstep, ys, ts, g, *args):
        grads = _adjoint(rhs, rtol, atol, mxstep, ys[None], ts[None], g[None],
                         [a[None] for a in args])
        return tuple(v[0] for v in grads)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("the second derivative of an ODE solve is not supported")

    @staticmethod
    def vmap(info, in_dims, rhs, rtol, atol, mxstep, ys, ts, g, *args):
        B = info.batch_size
        _, _, _, _, dy, dt, dg, *da = in_dims
        grads = _adjoint(rhs, rtol, atol, mxstep, _expand(ys, dy, B), _expand(ts, dt, B),
                         _expand(g, dg, B), [_expand(a, d, B) for a, d in zip(args, da)])
        return grads, (0,) * len(grads)


def odeint_dopri5(rhs, y0, ts, args=(), rtol=RTOL, atol=ATOL, mxstep=MXSTEP):
    """The solution (T, n) at the times ts (T,), row 0 = y0 (n,), of
    dy/dt = rhs(y, t, *args) by adaptive Dormand-Prince, JAX's `odeint`;
    differentiable in y0, ts and args by the continuous adjoint, and under
    torch.func.vmap (one solve for the batch)."""
    return _Dopri5.apply(rhs, float(rtol), float(atol), int(mxstep), y0, ts, *args)


def odeint_rk4(rhs, y0, ts, args=(), steps=1):
    """The solution (T - 1, n) at ts[1:] of dy/dt = rhs(y, t, *args) by
    classical RK4, `steps` equal steps an interval (the JAX frontend's
    `ode_rk4`): plain tensor ops, differentiated by autograd."""
    out = []
    y = y0
    for j in range(1, ts.shape[0]):
        ta, tb = ts[j - 1], ts[j]
        h = (tb - ta) / steps
        tt = ta
        for _ in range(steps):
            k1 = rhs(y, tt, *args)
            k2 = rhs(y + 0.5 * h * k1, tt + 0.5 * h, *args)
            k3 = rhs(y + 0.5 * h * k2, tt + 0.5 * h, *args)
            k4 = rhs(y + h * k3, tt + h, *args)
            y = y + h / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
            tt = tt + h
        out.append(y)
    return torch.stack(out, 0)
