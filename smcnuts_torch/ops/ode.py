"""ODE solvers of the Stan frontend, in torch ops and on the card: the port
of `jax.experimental.ode.odeint` (adaptive Dormand-Prince with its continuous
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

The solve is one opaque op a solve, `torch.ops.smcnuts.ode_dopri5`, and its
adjoint another, `ode_dopri5_adjoint` (`torch.library` custom ops with fake
implementations and vmap rules), so a trace (`make_fx`) records each as one
node and a replay solves again at its new inputs: a Stan program that
reaches the solver is traced once and replayed like any other
(`stan.compiler.StanModel`). `_Dopri5` (a `torch.autograd.Function`) gives
the solve its backward, the adjoint op, and the ops' vmap rules solve the
batch of a vmap (the interpreter runs one particle at a time inside
`vmap(grad_and_value)`) in one call of the op. The ops take the right-hand
side by its key in a registry (`OdeRhs`), which carries its route in each real type, fixed at
its first solve in that type (the Stan frontend's compile-time probe, in
float32 and float64):

- "kernel": the right-hand side traced for one lane and lowered
  (`OdeProgram`, by `ops/generated.lower_function`: the function and its
  VJP as straight-line scalar code in the solve's real type). On the card
  the solve is one launch of `csrc/ode_dopri5.cuh` over that code, one
  thread a lane (`dopri5`, `dopri5_adjoint`); on the CPU its plain version,
  `solve_batched` / `_adjoint` over the program run as ATen ops, which the
  kernel equals to the bit;
- "host loop: <the op the lowering lacks>": `solve_batched` over the
  interpreted right-hand side under `torch.func.vmap`, on any device: a
  host check a step (this port's solve before the kernel).

`solve_batched` steps the lanes still short of the next output time
together (gathered, stepped and written back), each lane its own step size,
time and counter, until none is left. Every operation acts on each lane
alone in a fixed order (sums over the state in index order, never a
reduction whose order follows the shape), so a lane's bits do not depend on
the others: a batched solve equals each lane solved alone.

`odeint_rk4(rhs, y0, ts, args, steps)` is the JAX frontend's fixed-step
classical RK4, `steps` steps an output interval: plain tensor ops in a
Python loop, differentiated by autograd as JAX differentiates its scan, so a
trace replays it and a generated model (`ops/generated.py`) can lower it.

`solve_batched.steps` counts the RK steps taken, accepted and rejected,
lanes summed, in forward solves and adjoints alike, the host loop's and the
kernels' (each kernel writes its lanes' counts, summed on the device and
read when `steps` is read: what chip_smoke.py prints a particle).
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import itertools
import math
import os
import subprocess
import time
import types
import weakref

import torch

from .generated import Function, function_graph, function_lines, function_ops, lower_function

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
    """The root mean square of error / err_tol: the mean a product by 1 / n,
    so that every device rounds it alike (ATen's CUDA division by a Python
    scalar multiplies by its reciprocal, its CPU division divides)."""
    err_tol = atol + rtol * torch.maximum(torch.abs(y0), torch.abs(y1))
    return torch.sqrt(_sumsq(error / err_tol) * (1.0 / error.shape[1]))


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


class _SolveBatched:
    """`solve_batched(fun, y0, ts, args, rtol, atol, mxstep, lane_steps=None)`
    and its count of RK steps, `steps` (the host loop's, and the kernels'
    lane counts summed on the device until it is read)."""

    def __init__(self):
        self._host = 0
        self._device = {}

    @property
    def steps(self) -> int:
        return self._host + sum(int(v) for v in self._device.values())

    @steps.setter
    def steps(self, value):
        self._host, self._device = int(value), {}

    def add_lanes(self, counts):
        """Add a kernel's per-lane step counts, without a host sync."""
        total = counts.sum(dtype=torch.int64)
        acc = self._device.get(counts.device)
        self._device[counts.device] = total if acc is None else acc + total

    def __call__(self, fun, y0, ts, args, rtol, atol, mxstep, lane_steps=None):
        """Solve B lanes at once: y0 (B, n), ts (B, T) strictly increasing,
        args a list of (B, ...) tensors, `fun(y (b, n), t (b,), *args (b,
        ...))` -> (b, n) on any b lanes. Returns (B, T, n), row 0 y0. Each
        lane runs JAX's controller alone; a step is computed for the lanes
        still short of the next output time (and under mxstep steps, with a
        positive step), which are gathered and written back. `lane_steps`,
        an int tensor (B,), gets each lane's steps added."""
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
                self._host += int(lanes.numel())
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
            if lane_steps is not None:
                lane_steps += i
            out.append(_polyval(interp, (target - last_t) / (t - last_t)))
        return torch.stack(out, 1)


solve_batched = _SolveBatched()


def _expand(v, d, B):
    """An input of a vmap rule with its batch dimension first, B lanes."""
    if d is None:
        return v.unsqueeze(0).expand(B, *v.shape)
    return v.movedim(d, 0)


def _adjoint(fun, vjp, rtol, atol, mxstep, ys, ts, g, args, lane_steps=None):
    """JAX's `_odeint_rev` on B lanes: (y0_bar (B, n), ts_bar (B, T),
    args_bar (B, k) each, flat). `fun(y, t, *args)` is the right-hand side
    on lanes, `vjp(y, t, y_bar, *args)` -> (f, y_bar df/dy, y_bar df/dt
    (b,), y_bar df/dargs each). The augmented state (y, y_bar, t0_bar,
    args_bar) is one flat vector a lane, its dynamics (-f, the VJP of f at
    y_bar) at negated time."""
    B, T, n = ys.shape
    sizes = [a[0].numel() for a in args]

    def aug_dynamics(state, s, *a):
        y, y_bar = state[:, :n], state[:, n:2 * n]
        out, y_cot, t_cot, *a_cot = vjp(y, -s, y_bar, *a)
        parts = [-out, y_cot, t_cot[:, None]] + [c.reshape(c.shape[0], -1) for c in a_cot]
        return torch.cat(parts, 1)

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
        state = solve_batched(aug_dynamics, state, back, list(args), rtol, atol, mxstep,
                              lane_steps)[:, 1]
        y_bar = state[:, n:2 * n] + g[:, i - 1]
        t0_bar = state[:, 2 * n]
        args_bar, o = [], 2 * n + 1
        for k in sizes:
            args_bar.append(state[:, o:o + k])
            o += k
        ts_bar.append(t_bar)
    ts_bar = torch.stack([t0_bar] + ts_bar[::-1], 1)
    return (y_bar, ts_bar) + tuple(args_bar)


# ---------------------------------------------------------------------------
# The right-hand sides, their programs and their routes.
# ---------------------------------------------------------------------------

_RHS = weakref.WeakValueDictionary()  # key -> OdeRhs, while its owner holds it
_KEYS = itertools.count()
KERNEL = "kernel"


@contextlib.contextmanager
def _isolated():
    """Outside the transforms (vmap, grad) and the traces (an outer make_fx)
    that a solve may be called under: a right-hand side is lowered on plain
    tensors of its own."""
    from torch._functorch.pyfunctorch import temporarily_clear_interpreter_stack
    from torch.utils._python_dispatch import _disable_current_modes

    with (temporarily_clear_interpreter_stack(), _disable_current_modes(),
          torch.enable_grad()):
        yield


class OdeRhs:
    """A right-hand side `rhs(y (n,), t (), *args)` of one lane and the
    routes of its solves, `routes`: dtype -> KERNEL, or "host loop: <why>"
    (the op the lowering lacks), each fixed at the first solve in that
    dtype. `programs` holds its lowered programs by (dtype, n, the
    arguments' shapes); `fns` the callable by (dtype, device), None for one
    that serves every dtype (the Stan frontend's closures are made per
    evaluation context). The ops find it by `key` in a registry of weak
    references: whoever traces or replays its solves keeps it alive (a
    compiled Stan program its call sites, a Python function its own)."""

    def __init__(self, name, fn=None):
        self.name = name
        self.key = next(_KEYS)
        _RHS[self.key] = self
        self.fns = {} if fn is None else {None: fn}
        self.programs: dict = {}
        self.routes: dict = {}

    def set_fn(self, fn, dtype, device):
        self.fns[(dtype, torch.device(device))] = fn

    def fn(self, dtype, device):
        fn = self.fns.get((dtype, torch.device(device)), self.fns.get(None))
        if fn is None:
            raise RuntimeError(f"ODE right-hand side '{self.name}': no function for "
                               f"{dtype} on {device}")
        return fn

    def prepare(self, y0, args):
        """Fix the route of y0's dtype at its first solve and lower the
        program of these shapes (one lane's y0 and args) on the kernel
        route. A right-hand side that lowered once and fails at other
        shapes raises: the route does not change while the program runs."""
        route = self.routes.get(y0.dtype)
        if route is not None and route != KERNEL:
            return
        key = _program_key(y0.dtype, y0.shape[-1], [a.shape for a in args])
        if key in self.programs:
            return
        try:
            with _isolated():
                prog = OdeProgram.lower(self.fn(y0.dtype, y0.device), key, y0.device,
                                        self.name)
        except NotImplementedError as e:
            if route == KERNEL:
                raise
            self.routes[y0.dtype] = f"host loop: {e}"
            return
        self.routes[y0.dtype] = KERNEL
        self.programs[key] = prog

    def program(self, y0, args):
        """The program of a batched call's lanes (y0 (B, n), args (B, ...)),
        lowered by `prepare`."""
        key = _program_key(y0.dtype, y0.shape[-1], [a.shape[1:] for a in args])
        if key not in self.programs:
            raise RuntimeError(f"ODE right-hand side '{self.name}' has no program for "
                               f"{key}: odeint_dopri5 lowers it at its first solve")
        return self.programs[key]


def _program_key(dtype, n, shapes):
    return (dtype, int(n), tuple(tuple(int(d) for d in s) for s in shapes))


def _entry(key) -> OdeRhs:
    rhs = _RHS.get(key)
    if rhs is None:
        raise RuntimeError(f"ODE right-hand side {key} is gone: the program that solved "
                           "with it was freed")
    return rhs


def _rhs_of(fn) -> OdeRhs:
    """The registry entry of a plain callable, one for every dtype: kept on
    a Python function, so that it lives as long as the function; a new one
    a call for any other callable."""
    if not isinstance(fn, types.FunctionType):
        return OdeRhs(getattr(fn, "__name__", "rhs"), fn)
    rhs = fn.__dict__.get("_ode_rhs")
    if rhs is None:
        rhs = fn.__dict__["_ode_rhs"] = OdeRhs(fn.__name__, fn)
    return rhs


class OdeProgram:
    """A right-hand side lowered for one lane at one dtype and shape: `f`
    (inputs y, t, args flattened; n outputs) and `vjp` (inputs y, t, args,
    y_bar; outputs f, y_bar df/dy, y_bar df/dt, y_bar df/dargs), each a
    `generated.Function`; their plain versions `f_graph` / `vjp_graph`
    (ATen ops over lanes); `source`, the CUDA struct of both that
    `csrc/ode_dopri5.cuh` inlines, and its `hash`; `f_ops` / `vjp_ops`, the
    operations of one evaluation."""

    def __init__(self, f: Function, vjp: Function, n: int, n_args: int, name: str):
        self.f, self.vjp, self.n, self.n_args, self.name = f, vjp, n, n_args, name
        self.dtype = f.dtype
        self.f_ops, self.vjp_ops = function_ops(f), function_ops(vjp)
        self.f_graph, self.vjp_graph = function_graph(f), function_graph(vjp)
        self.source = _ode_source(self)
        self.hash = hashlib.sha256(self.source.encode()).hexdigest()[:16]

    @classmethod
    def lower(cls, fn, key, device, name):
        """Trace `fn` for one lane at `key`'s dtype and shapes (on `device`,
        where its closures make their constants) and lower it and its VJP.
        An op the lowering does not have raises NotImplementedError."""
        dtype, n, shapes = key

        def zeros(shape):
            return torch.zeros(shape, dtype=dtype, device=device)

        y, t, args = zeros((n,)), zeros(()), [zeros(s) for s in shapes]

        def vjp_one(y, t, *rest):
            *a, y_bar = rest
            out, pull = torch.func.vjp(fn, y, t, *a)
            return (out,) + tuple(pull(y_bar))

        f = lower_function(fn, [y, t, *args], name)
        if len(f.outs) != n:
            raise ValueError(f"ODE right-hand side '{name}' maps {n} states to "
                             f"{len(f.outs)} values")
        vjp = lower_function(vjp_one, [y, t, *args, zeros((n,))], name)
        return cls(f, vjp, n, sum(math.prod(s) for s in shapes), name)

    def lanes(self, y, t, a):
        """f on lanes: y (b, n), t (b,), a (b, A) -> (b, n), ATen op by op."""
        return self.f_graph(torch.cat([y, t[:, None], a], 1))

    def vjp_lanes(self, y, t, y_bar, a):
        """(f, y_bar df/dy, y_bar df/dt (b,), y_bar df/da (b, A)) on lanes."""
        out = self.vjp_graph(torch.cat([y, t[:, None], a, y_bar], 1))
        n = self.n
        return out[:, :n], out[:, n:2 * n], out[:, 2 * n], out[:, 2 * n + 1:]

    def step_ops(self, adjoint=False) -> int:
        """Floating-point operations of one RK step of the kernel, counted
        from csrc/ode_dopri5.cuh on a state of M values: six right-hand sides
        (the VJP, its negations and -s in the adjoint); the stages' sums
        (46 M) and times (12), the solution and its error (23 M), the error
        ratio (8 M + 2), the polynomial's fit (46 M), the step size and the
        loop's tests (13); a sqrt, pow or division one each."""
        M = 2 * self.n + 1 + self.n_args if adjoint else self.n
        dyn = self.vjp_ops + self.n + 1 if adjoint else self.f_ops
        return 6 * dyn + 123 * M + 27


def ode_struct(prog: OdeProgram) -> tuple:
    """(struct name, the CUDA struct of a program: `Real`, `N`, `A`, `f` and
    `vjp`), which `csrc/ode_dopri5.cuh` inlines; named by a hash of its
    code."""
    real = "double" if prog.dtype == torch.float64 else "float"
    n, A = prog.n, prog.n_args

    def leaf(d):
        if d < n:
            return f"y[{d}]"
        if d == n:
            return "t"
        if d < n + 1 + A:
            return f"a[{d - n - 1}]"
        return f"ybar[{d - n - 1 - A}]"

    f_body = "\n".join(function_lines(prog.f, leaf, "out"))
    vjp_body = "\n".join(function_lines(prog.vjp, leaf, "out"))
    tag = hashlib.sha256(f"{real} {n} {A}\n{f_body}\n{vjp_body}".encode()).hexdigest()[:16]
    struct = f"OdeRhs_{tag}"
    return struct, f"""// The ODE right-hand side '{prog.name}' ({real}, {n} states, {A} argument
// scalars; {prog.f_ops} operations a right-hand side, {prog.vjp_ops} its VJP).
struct {struct} {{
  using Real = {real};
  static constexpr int N = {n};
  static constexpr int A = {A};

  __device__ static __forceinline__ void f(const Real* y, Real t, const Real* a, Real* out) {{
{f_body}
  }}

  __device__ static __forceinline__ void vjp(const Real* y, Real t, const Real* a,
                                             const Real* ybar, Real* out) {{
{vjp_body}
  }}
}};
"""


def _ode_source(prog: OdeProgram) -> str:
    """The CUDA struct of a program and the two entries of
    `csrc/ode_dopri5.cuh` over it."""
    struct, body = ode_struct(prog)
    return f"""// Generated by smcnuts_torch/ops/ode.py: the Dormand-Prince solve and its
// adjoint of csrc/ode_dopri5.cuh with this right-hand side inlined.
#include "ode_dopri5.cuh"

namespace smcnuts {{

{body}
}}  // namespace smcnuts

extern "C" {{
SMCNUTS_ODE_ENTRIES(smcnuts::{struct})
}}
"""


# ---------------------------------------------------------------------------
# The kernels and their plain versions.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class OdeLibrary:
    lib: ctypes.CDLL
    forward: object  # smcnuts_ode_dopri5
    adjoint: object  # smcnuts_ode_dopri5_adjoint
    path: str
    build_seconds: float  # 0.0 when it was already built
    log: str  # nvcc's output (-Xptxas -v: registers, stack, spills)


_ODE_LIBS: dict = {}
_HEADER = "ode_dopri5.cuh"


def build_ode(prog: OdeProgram) -> OdeLibrary:
    """Build (once per hash of the generated source, the kernel template
    and the flags) and load the solve's library of one program into
    build/smcnuts_torch/ode/<hash>/, with `ops/nuts_cuda.NVCC_FLAGS`. A
    failed build raises with nvcc's output."""
    from .nuts_cuda import BUILD_ROOT, CSRC_DIR, NVCC_FLAGS, _nvcc

    if prog.hash in _ODE_LIBS:
        return _ODE_LIBS[prog.hash]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    digest.update(prog.source.encode())
    with open(os.path.join(CSRC_DIR, _HEADER), "rb") as f:
        digest.update(f.read())
    out_dir = os.path.join(BUILD_ROOT, "ode", digest.hexdigest()[:16])
    so_path = os.path.join(out_dir, "libsmcnuts_ode.so")
    log_path = os.path.join(out_dir, "nvcc.log")
    seconds = 0.0
    if not os.path.exists(so_path):
        os.makedirs(out_dir, exist_ok=True)
        tag = f"{os.getpid()}.tmp"
        src = os.path.join(out_dir, f"ode.{tag}.cu")
        with open(src, "w") as f:
            f.write(prog.source)
        tmp = f"{so_path}.{tag}"
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-I", CSRC_DIR, "-o", tmp, src],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the ODE right-hand side '{prog.name}' "
                               f"with exit code {proc.returncode}:\n{proc.stdout}")
        with open(log_path, "w") as f:
            f.write(proc.stdout)
        os.replace(src, os.path.join(out_dir, "ode.cu"))
        os.replace(tmp, so_path)  # atomic: concurrent builds agree
    lib = ctypes.CDLL(so_path)
    p, i, d, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_longlong
    forward, adjoint = lib.smcnuts_ode_dopri5, lib.smcnuts_ode_dopri5_adjoint
    forward.argtypes = [p] * 5 + [i, i, d, d, ll, p]
    adjoint.argtypes = [p] * 8 + [i, i, d, d, ll, p]
    forward.restype = adjoint.restype = ctypes.c_int
    with open(log_path) as f:
        log = f.read()
    _ODE_LIBS[prog.hash] = OdeLibrary(lib, forward, adjoint, so_path, seconds, log)
    return _ODE_LIBS[prog.hash]


def _check_lanes(prog: OdeProgram, tensors, what):
    """The kernel's inputs: contiguous, of the program's dtype, on ts's
    device, of the shapes its lanes read (ts (B, T))."""
    B, T = tensors["ts"].shape
    shapes = {"y0": (B, prog.n), "ys": (B, T, prog.n), "g": (B, T, prog.n), "ts": (B, T),
              "a": (B, prog.n_args)}
    for name, t in tensors.items():
        if (t.dtype != prog.dtype or not t.is_contiguous() or t.device != tensors["ts"].device
                or tuple(t.shape) != shapes[name]):
            raise ValueError(f"{what}: {name} must be a contiguous {prog.dtype} tensor of "
                             f"shape {shapes[name]} on {tensors['ts'].device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def dopri5_plain(prog, y0, ts, a, rtol=RTOL, atol=ATOL, mxstep=MXSTEP):
    """The plain version of `dopri5`: `solve_batched` over the program's
    ATen graph, on any device. Returns (ys (B, T, n), steps (B,) int32)."""
    steps = torch.zeros(y0.shape[0], dtype=torch.int64, device=y0.device)
    ys = solve_batched(prog.lanes, y0, ts, [a], rtol, atol, mxstep, steps)
    return ys, steps.to(torch.int32)


def dopri5_adjoint_plain(prog, ys, ts, g, a, rtol=RTOL, atol=ATOL, mxstep=MXSTEP):
    """The plain version of `dopri5_adjoint`: `_adjoint` over the
    program's ATen graphs. Returns ((y0_bar, ts_bar, a_bar), steps)."""
    steps = torch.zeros(ys.shape[0], dtype=torch.int64, device=ys.device)
    grads = _adjoint(prog.lanes, prog.vjp_lanes, rtol, atol, mxstep, ys, ts, g, [a], steps)
    return grads, steps.to(torch.int32)


def dopri5(prog, y0, ts, a, rtol=RTOL, atol=ATOL, mxstep=MXSTEP):
    """The solve of B lanes, one launch: y0 (B, n), ts (B, T) increasing, a
    (B, A) the arguments flattened -> (ys (B, T, n), steps (B,) int32, the
    RK steps of each lane). On CUDA tensors the kernel of
    `csrc/ode_dopri5.cuh` over the program (built at first use, raises on
    a failed build or launch); on CPU tensors `dopri5_plain`."""
    if y0.device.type == "cpu":
        return dopri5_plain(prog, y0, ts, a, rtol, atol, mxstep)
    if y0.device.type != "cuda":
        raise ValueError(f"dopri5 runs on cpu or cuda tensors, got {y0.device}")
    _check_lanes(prog, dict(y0=y0, ts=ts, a=a), "dopri5")
    B, T = ts.shape
    ys = torch.empty(B, T, prog.n, dtype=y0.dtype, device=y0.device)
    steps = torch.empty(B, dtype=torch.int32, device=y0.device)
    if B:
        err = build_ode(prog).forward(
            y0.data_ptr(), ts.data_ptr(), a.data_ptr(), ys.data_ptr(), steps.data_ptr(), B, T,
            float(rtol), float(atol), int(mxstep),
            torch.cuda.current_stream(y0.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"dopri5 kernel launch failed: CUDA error {err}")
        dopri5.launches += 1
        solve_batched.add_lanes(steps)
    return ys, steps


def dopri5_adjoint(prog, ys, ts, g, a, rtol=RTOL, atol=ATOL, mxstep=MXSTEP):
    """The continuous adjoint of `dopri5`, one launch: ys, g (B, T, n), ts
    (B, T), a (B, A) -> ((y0_bar (B, n), ts_bar (B, T), a_bar (B, A)),
    steps (B,) int32). The kernel on CUDA tensors, `dopri5_adjoint_plain`
    on CPU tensors."""
    if ys.device.type == "cpu":
        return dopri5_adjoint_plain(prog, ys, ts, g, a, rtol, atol, mxstep)
    if ys.device.type != "cuda":
        raise ValueError(f"dopri5_adjoint runs on cpu or cuda tensors, got {ys.device}")
    _check_lanes(prog, dict(ys=ys, ts=ts, g=g, a=a), "dopri5_adjoint")
    B, T = ts.shape
    y0_bar = torch.empty(B, prog.n, dtype=ys.dtype, device=ys.device)
    ts_bar = torch.empty(B, T, dtype=ys.dtype, device=ys.device)
    a_bar = torch.empty(B, prog.n_args, dtype=ys.dtype, device=ys.device)
    steps = torch.empty(B, dtype=torch.int32, device=ys.device)
    if B:
        err = build_ode(prog).adjoint(
            ys.data_ptr(), ts.data_ptr(), g.data_ptr(), a.data_ptr(), y0_bar.data_ptr(),
            ts_bar.data_ptr(), a_bar.data_ptr(), steps.data_ptr(), B, T, float(rtol),
            float(atol), int(mxstep), torch.cuda.current_stream(ys.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"dopri5_adjoint kernel launch failed: CUDA error {err}")
        dopri5_adjoint.launches += 1
        solve_batched.add_lanes(steps)
    return (y0_bar, ts_bar, a_bar), steps


dopri5.launches = 0  # kernel launches, and nothing else
dopri5_adjoint.launches = 0


# ---------------------------------------------------------------------------
# The ops: one node a solve in a trace.
# ---------------------------------------------------------------------------


def _flat_args(args, B, like):
    """The arguments of B lanes as one (B, A) tensor, in order."""
    if not args:
        return like.new_zeros(B, 0)
    return torch.cat([a.reshape(B, -1) for a in args], 1).contiguous()


# The dispatch keys a thread excludes outside any trace (the autocast keys).
_EAGER_EXCLUDE = torch._C._dispatch_tls_local_exclude_set()


@contextlib.contextmanager
def _untraced():
    """Inside an op's implementation, which a trace runs for real below the
    keys it excludes (functorch's among them): the host loop's own vmap and
    vjp run as they do eagerly, unseen by the trace."""
    with torch._C._ForceDispatchKeyGuard(torch._C._dispatch_tls_local_include_set(),
                                         _EAGER_EXCLUDE):
        yield


def _lanes_fn(rhs: OdeRhs, like):
    """The host loop's right-hand side and its VJP on lanes: the
    interpreted function under torch.func.vmap."""
    fn = rhs.fn(like.dtype, like.device)

    def vjp_one(y, t, y_bar, *a):
        out, pull = torch.func.vjp(fn, y, t, *a)
        return (out,) + tuple(pull(y_bar))

    return torch.func.vmap(fn), torch.func.vmap(vjp_one)


@torch.library.custom_op("smcnuts::ode_dopri5", mutates_args=())
def _solve_op(rhs: int, rtol: float, atol: float, mxstep: int, y0: torch.Tensor,
              ts: torch.Tensor, args: list[torch.Tensor]) -> torch.Tensor:
    """ys (B, T, n) of B lanes: y0 (B, n), ts (B, T), args (B, ...) each."""
    r = _entry(rhs)
    y0, ts = y0.contiguous(), ts.contiguous()
    args = [a.contiguous() for a in args]
    if r.routes.get(y0.dtype) == KERNEL:
        return dopri5(r.program(y0, args), y0, ts, _flat_args(args, y0.shape[0], y0),
                      rtol, atol, mxstep)[0]
    with _untraced():
        fun, _ = _lanes_fn(r, y0)
        return solve_batched(fun, y0, ts, args, rtol, atol, mxstep)


@_solve_op.register_fake
def _(rhs, rtol, atol, mxstep, y0, ts, args):
    return y0.new_empty(y0.shape[0], ts.shape[1], y0.shape[1])


@torch.library.custom_op("smcnuts::ode_dopri5_adjoint", mutates_args=())
def _adjoint_op(rhs: int, rtol: float, atol: float, mxstep: int, ys: torch.Tensor,
                ts: torch.Tensor, g: torch.Tensor, args: list[torch.Tensor]) -> list[torch.Tensor]:
    """[y0_bar (B, n), ts_bar (B, T), args_bar (B, ...) each] of B lanes."""
    r = _entry(rhs)
    ys, ts, g = ys.contiguous(), ts.contiguous(), g.contiguous()
    args = [a.contiguous() for a in args]
    B = ys.shape[0]
    if r.routes.get(ys.dtype) == KERNEL:
        (y0_bar, ts_bar, a_bar), _ = dopri5_adjoint(
            r.program(ys[:, 0], args), ys, ts, g, _flat_args(args, B, ys), rtol, atol, mxstep)
        bars, o = [], 0
        for a in args:
            k = a[0].numel()
            bars.append(a_bar[:, o:o + k].reshape(a.shape))
            o += k
        return [y0_bar, ts_bar, *bars]
    with _untraced():
        fun, vjp = _lanes_fn(r, ys)
        y0_bar, ts_bar, *bars = _adjoint(fun, vjp, rtol, atol, mxstep, ys, ts, g, args)
    return [y0_bar, ts_bar] + [b.reshape(a.shape) for b, a in zip(bars, args)]


@_adjoint_op.register_fake
def _(rhs, rtol, atol, mxstep, ys, ts, g, args):
    return [ys.new_empty(ys.shape[0], ys.shape[2]), torch.empty_like(ts),
            *[torch.empty_like(a) for a in args]]


def _solve_vmap(info, in_dims, rhs, rtol, atol, mxstep, y0, ts, args):
    """One solve for a vmap's batch of batches: the lanes of every batch."""
    V = info.batch_size
    _, _, _, _, dy, dt, da = in_dims
    y0, ts = _expand(y0, dy, V), _expand(ts, dt, V)
    args = [_expand(a, d, V) for a, d in zip(args, da)]
    B = y0.shape[1]
    ys = _solve_op(rhs, rtol, atol, mxstep, y0.reshape(V * B, -1), ts.reshape(V * B, -1),
                   [a.reshape(V * B, *a.shape[2:]) for a in args])
    return ys.reshape(V, B, *ys.shape[1:]), 0


def _adjoint_vmap(info, in_dims, rhs, rtol, atol, mxstep, ys, ts, g, args):
    V = info.batch_size
    _, _, _, _, dy, dt, dg, da = in_dims
    ys, ts, g = _expand(ys, dy, V), _expand(ts, dt, V), _expand(g, dg, V)
    args = [_expand(a, d, V) for a, d in zip(args, da)]
    B = ys.shape[1]
    out = _adjoint_op(rhs, rtol, atol, mxstep, ys.reshape(V * B, *ys.shape[2:]),
                      ts.reshape(V * B, -1), g.reshape(V * B, *g.shape[2:]),
                      [a.reshape(V * B, *a.shape[2:]) for a in args])
    return [o.reshape(V, B, *o.shape[1:]) for o in out], [0] * len(out)


_solve_op.register_vmap(_solve_vmap)
_adjoint_op.register_vmap(_adjoint_vmap)


class _Dopri5(torch.autograd.Function):
    """ys = odeint(rhs, y0, ts, *args) through the op; its backward is
    `_Dopri5Adjoint`. functorch batches both by the ops' own vmap rules: one
    solve for a vmap's batch. (The op's own `register_autograd` would not do:
    torch.func.grad refuses the autograd.Function that it makes.)"""

    generate_vmap_rule = True

    @staticmethod
    def forward(rhs, rtol, atol, mxstep, owner, y0, ts, *args):
        return _solve_op(rhs, rtol, atol, mxstep, y0[None], ts[None], [a[None] for a in args])[0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        rhs, rtol, atol, mxstep, owner, _, ts, *args = inputs
        ctx.solver = (rhs, rtol, atol, mxstep)
        ctx.owner = owner  # the entry of a plain callable, alive until the backward
        ctx.save_for_backward(output, ts, *args)

    @staticmethod
    def backward(ctx, g):
        ys, ts, *args = ctx.saved_tensors
        grads = _Dopri5Adjoint.apply(*ctx.solver, ys, ts, g, *args)
        return (None, None, None, None, None) + tuple(grads)


class _Dopri5Adjoint(torch.autograd.Function):
    """(y0_bar, ts_bar, *args_bar) of `_Dopri5` by the continuous adjoint
    op. It has no derivative of its own."""

    generate_vmap_rule = True

    @staticmethod
    def forward(rhs, rtol, atol, mxstep, ys, ts, g, *args):
        grads = _adjoint_op(rhs, rtol, atol, mxstep, ys[None], ts[None], g[None],
                            [a[None] for a in args])
        return tuple(v[0] for v in grads)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("the second derivative of an ODE solve is not supported")


def odeint_dopri5(rhs, y0, ts, args=(), rtol=RTOL, atol=ATOL, mxstep=MXSTEP):
    """The solution (T, n) at the times ts (T,), row 0 = y0 (n,), of
    dy/dt = rhs(y, t, *args) by adaptive Dormand-Prince, JAX's `odeint`;
    differentiable in y0, ts and args by the continuous adjoint, and under
    torch.func.vmap (one solve for the batch). `rhs` is a callable or an
    `OdeRhs`; its route in a real type is fixed at its first solve in that
    type (`OdeRhs.prepare`)."""
    r = rhs if isinstance(rhs, OdeRhs) else _rhs_of(rhs)
    r.prepare(y0, args)
    # The caller keeps an OdeRhs it passes (a Stan program keeps its call
    # sites); the backward keeps a plain callable's, which nothing else may.
    # (A Stan site kept there would close a cycle through the autograd graph
    # of the interpreter's tensors, which gc does not collect.)
    owner = None if r is rhs else r
    return _Dopri5.apply(r.key, float(rtol), float(atol), int(mxstep), owner, y0, ts, *args)


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
