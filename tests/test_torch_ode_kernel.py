"""The adaptive ODE solve as one kernel a solve (`csrc/ode_dopri5.cuh`,
`smcnuts_torch/ops/ode.py`), held on the CPU to what it must equal.

- The kernel's one-lane loop, emulated here in torch scalar ops in the
  order of the .cuh (as tests/test_torch_gaussian_pipelined.py holds the
  pipelined walk), equals `dopri5_plain` / `dopri5_adjoint_plain`
  (`solve_batched` and `_adjoint` over the generated right-hand side) to the
  bit, lane by lane, step counts included, on Lotka-Volterra and the decay
  ODE, lanes whose step counts differ; the .cuh's tableau literals are
  Python's doubles.
- The generated right-hand side and its VJP, replayed as ATen ops, equal
  the interpreted ones (the Stan frontend's closures) within 4 ulp of the
  largest value (float32 and float64): the lowering reassociates nothing
  but folds and cancels literals, so the two differ by a rounding or two.
- The forward and the gradient through the custom op equal JAX's `odeint`
  in float64 (JAX_ENABLE_X64 in a subprocess) at rtol 1e-10, which only the
  same accepted steps give (the solver's own tolerance is 1e-6).
- The op under `vmap(grad_and_value)` and `make_fx`: one node for the solve
  and one for its adjoint, and a replay at new inputs equal to a fresh run
  to the bit; the ops' own vmap rules and fake implementations.
- A right-hand side the lowering cannot take is routed to the host loop at
  its first solve, the route naming the op, in each real type apart (the
  Stan frontend fixes both at compile time); the registry lets a freed
  program's right-hand sides go; a failed build raises with nvcc's output.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from smcnuts_torch import stan as tstan
from smcnuts_torch.models.base import CallableModel
from smcnuts_torch.ops import ode
from smcnuts_torch.ops.generated import trace_fx

torch.set_num_threads(2)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LV_TRUTH = (0.55, 0.028, 0.80, 0.024)


def lv_rhs(y, t, th):
    return torch.stack([(th[0] - th[1] * y[1]) * y[0], (-th[2] + th[3] * y[0]) * y[1]])


def decay_rhs(y, t, k):
    return -k * y


def lv_lanes(b, dtype, seed=4):
    """b lanes of (y0, theta) around the case study's values, spread wide
    enough that their step counts differ."""
    rng = np.random.default_rng(seed)
    theta = np.abs(np.asarray(LV_TRUTH) * (1 + 0.5 * rng.normal(size=(b, 4))))
    y0 = np.exp(np.log([33.9, 5.9]) + 0.5 * rng.normal(size=(b, 2)))
    return torch.tensor(y0, dtype=dtype), torch.tensor(theta, dtype=dtype)


def decay_lanes(b, dtype, seed=5):
    rng = np.random.default_rng(seed)
    return (torch.tensor(2.0 + rng.random((b, 1)), dtype=dtype),
            torch.tensor(np.exp(rng.normal(size=(b,))), dtype=dtype))


def program(rhs, dtype, n, shapes):
    return ode.OdeProgram.lower(rhs, (dtype, n, tuple(shapes)), "cpu", rhs.__name__)


# ---- the kernel's one-lane loop, in the .cuh's order ----------------------


def _one(v, dtype):
    return torch.tensor(v, dtype=dtype)


def _sumsq_ratio(num, den):
    q = num[0] / den[0]
    acc = q * q
    for j in range(1, len(num)):
        q = num[j] / den[j]
        acc = acc + q * q
    return acc


def _comb(coeffs, k, j):
    """sum_s c_s k[s][j] over the nonzero coefficients, in stage order."""
    acc = None
    for s, c in enumerate(coeffs):
        if c != 0.0:
            term = k[s][j] * c
            acc = term if acc is None else acc + term
    return acc


def emu_initial_step_size(dyn, t0, y0, rtol, atol, f0):
    dtype, M = y0[0].dtype, len(y0)
    scale = [torch.abs(y0[j]) * rtol + atol for j in range(M)]
    d0 = torch.sqrt(_sumsq_ratio(y0, scale))
    d1 = torch.sqrt(_sumsq_ratio(f0, scale))
    h0 = _one(1e-6, dtype) if bool((d0 < 1e-5) | (d1 < 1e-5)) else d0 * 0.01 / d1
    y1 = [y0[j] + h0 * f0[j] for j in range(M)]
    f1 = dyn(y1, t0 + h0)
    df = [f1[j] - f0[j] for j in range(M)]
    d2 = torch.sqrt(_sumsq_ratio(df, scale)) / h0
    if bool((d1 <= 1e-15) & (d2 <= 1e-15)):
        h1 = torch.maximum(_one(1e-6, dtype), h0 * 1e-3)
    else:
        h1 = torch.pow(torch.reciprocal(torch.maximum(d1, d2)) * 0.01, 1.0 / 5.0)
    return torch.minimum(h0 * 100.0, h1)


def emu_runge_kutta_step(dyn, y0, t0, dt, k):
    M = len(y0)
    for i in range(1, 7):
        yi = [y0[j] + dt * _comb(ode._BETA[i - 1], k, j) for j in range(M)]
        k[i] = dyn(yi, t0 + dt * ode._ALPHA[i - 1])
    y1 = [dt * _comb(ode._C_SOL, k, j) + y0[j] for j in range(M)]
    err = [dt * _comb(ode._C_ERROR, k, j) for j in range(M)]
    return y1, err


def emu_mean_error_ratio(err, rtol, atol, y0, y1):
    M = len(err)
    tol = [torch.maximum(torch.abs(y0[j]), torch.abs(y1[j])) * rtol + atol for j in range(M)]
    return torch.sqrt(_sumsq_ratio(err, tol) * (1.0 / M))


def emu_optimal_step_size(dt, ratio):
    dtype = dt.dtype
    dfactor = _one(1.0, dtype) if bool(ratio < 1) else _one(0.2, dtype)
    factor = torch.minimum(_one(10.0, dtype),
                           torch.maximum(torch.pow(ratio, -1.0 / 5.0) * 0.9, dfactor))
    return dt * 10.0 if bool(ratio == 0) else dt * factor


def emu_interp_fit(y0, y1, k, dt):
    p = [[], [], [], [], []]
    for j in range(len(y0)):
        ym = y0[j] + dt * _comb(ode._DPS_C_MID, k, j)
        dy0, dy1 = k[0][j], k[6][j]
        p[0].append(dt * -2.0 * dy0 + dt * 2.0 * dy1 - y0[j] * 8.0 - y1[j] * 8.0 + ym * 16.0)
        p[1].append(dt * 5.0 * dy0 - dt * 3.0 * dy1 + y0[j] * 18.0 + y1[j] * 14.0 - ym * 32.0)
        p[2].append(dt * -4.0 * dy0 + dt * dy1 - y0[j] * 11.0 - y1[j] * 5.0 + ym * 16.0)
        p[3].append(dt * dy0)
        p[4].append(y0[j])
    return p


def emu_solve(dyn, y_start, t0, targets, rtol, atol, mxstep):
    """`solve` of the .cuh: (the rows at the targets, the steps)."""
    y = list(y_start)
    f = dyn(y, t0)
    dt = torch.clamp(emu_initial_step_size(dyn, t0, y, rtol, atol, f), min=0.0)
    t = last_t = t0
    p = [list(y) for _ in range(5)]
    steps, out = 0, []
    for target in targets:
        i = 0
        while bool(t < target) and i < mxstep and bool(dt > 0):
            steps += 1
            k = [f] + [None] * 6
            y1, err = emu_runge_kutta_step(dyn, y, t, dt, k)
            ratio = emu_mean_error_ratio(err, rtol, atol, y, y1)
            new_dt = torch.clamp(emu_optimal_step_size(dt, ratio), min=0.0)
            if bool(ratio <= 1):
                p = emu_interp_fit(y, y1, k, dt)
                y, f = y1, k[6]
                last_t, t = t, t + dt
            dt = new_dt
            i += 1
        s = (target - last_t) / (t - last_t)
        row = []
        for j in range(len(y)):
            v = p[0][j]
            for c in range(1, 5):
                v = v * s + p[c][j]
            row.append(v)
        out.append(row)
    return out, steps


def emu_forward(prog, y0, ts, a, rtol, atol, mxstep):
    """`dopri5_forward` for one lane: y0 (n,), ts (T,), a (A,)."""
    def dyn(y, t):
        return list(prog.lanes(torch.stack(y)[None], t[None], a[None])[0])

    rows, steps = emu_solve(dyn, list(y0), ts[0], list(ts[1:]), rtol, atol, mxstep)
    return torch.stack([y0] + [torch.stack(r) for r in rows]), steps


def emu_adjoint(prog, ys, ts, g, a, rtol, atol, mxstep):
    """`dopri5_adjoint` for one lane: (y0_bar, ts_bar, a_bar), steps."""
    n, A = prog.n, prog.n_args
    T = ts.shape[0]

    def aug(state, s):
        x = torch.cat([torch.stack(state[:n]), (-s)[None], a, torch.stack(state[n:2 * n])])
        out = list(prog.vjp_graph(x[None])[0])
        return [-v for v in out[:n]] + out[n:]

    ybar = list(g[T - 1])
    t0bar = _one(0.0, ys.dtype)
    abar = [_one(0.0, ys.dtype)] * A
    ts_bar = [None] * T
    count = 0
    for i in range(T - 1, 0, -1):
        fi = list(prog.lanes(ys[i][None], ts[i][None], a[None])[0])
        tbar = fi[0] * g[i, 0]
        for j in range(1, n):
            tbar = tbar + fi[j] * g[i, j]
        t0bar = t0bar - tbar
        state = list(ys[i]) + ybar + [t0bar] + abar
        (nxt,), steps = emu_solve(aug, state, -ts[i], [-ts[i - 1]], rtol, atol, mxstep)
        count += steps
        ybar = [nxt[n + j] + g[i - 1, j] for j in range(n)]
        t0bar = nxt[2 * n]
        abar = nxt[2 * n + 1:]
        ts_bar[i] = tbar
    ts_bar[0] = t0bar
    return (torch.stack(ybar), torch.stack(ts_bar),
            torch.stack(abar) if A else ys.new_zeros(0)), count


def _bits_equal(u, v):
    return u.shape == v.shape and torch.equal(u, v)


CASES = {
    "lotka_volterra": (lv_rhs, 2, [(4,)], lv_lanes, 6.0),
    "decay": (decay_rhs, 1, [()], decay_lanes, 3.0),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_emulation_equals_the_plain_solve_and_adjoint(case, dtype):
    """The .cuh's one-lane loop equals `solve_batched` and `_adjoint` over
    the generated right-hand side to the bit, lane by lane, with the lanes'
    step counts; the lanes take different numbers of steps."""
    rhs, n, shapes, lanes, horizon = CASES[case]
    prog = program(rhs, dtype, n, shapes)
    y0, args = lanes(3, dtype)
    a = args.reshape(3, -1).contiguous()
    ts = torch.linspace(0.0, horizon, 5, dtype=dtype).expand(3, 5).contiguous()
    ys, steps = ode.dopri5_plain(prog, y0, ts, a)
    g = torch.tensor(np.random.default_rng(6).normal(size=tuple(ys.shape)), dtype=dtype)
    (yb, tb, ab), adj_steps = ode.dopri5_adjoint_plain(prog, ys, ts, g, a)
    assert len(set(steps.tolist())) > 1 and len(set(adj_steps.tolist())) > 1
    for b in range(3):
        got, count = emu_forward(prog, y0[b], ts[b], a[b], ode.RTOL, ode.ATOL, ode.MXSTEP)
        assert _bits_equal(got, ys[b]) and count == int(steps[b])
        (gy, gt, ga), count = emu_adjoint(prog, ys[b], ts[b], g[b], a[b], ode.RTOL, ode.ATOL,
                                          ode.MXSTEP)
        assert _bits_equal(gy, yb[b]) and _bits_equal(gt, tb[b]) and _bits_equal(ga, ab[b])
        assert count == int(adj_steps[b])


def test_plain_solve_equals_the_op_and_counts_its_steps():
    """The op on the kernel route runs `dopri5` (its plain version on the
    CPU): the same bits, and `solve_batched.steps` counts the same steps."""
    y0, th = lv_lanes(4, torch.float64)
    ts = torch.arange(0.0, 6.0, dtype=torch.float64)
    rhs = ode._rhs_of(lv_rhs)
    ode.solve_batched.steps = 0
    ys = torch.func.vmap(lambda y, t: ode.odeint_dopri5(lv_rhs, y, ts, (t,)))(y0, th)
    op_steps = ode.solve_batched.steps
    prog = rhs.program(y0, [th])
    want, steps = ode.dopri5_plain(prog, y0, ts.expand(4, 6).contiguous(), th)
    assert rhs.routes == {torch.float64: ode.KERNEL} and torch.equal(ys, want)
    assert op_steps == int(steps.sum()) > 0


def test_cuh_tableau_is_pythons():
    """Every hex literal of csrc/ode_dopri5.cuh's tableau is the double
    ops/ode.py computes."""
    with open(os.path.join(_REPO, "smcnuts_torch", "csrc", "ode_dopri5.cuh")) as f:
        src = f.read()
    lits = {m[0]: float.fromhex(m[1]) for m in
            re.findall(r"constexpr double (k\w+) = (-?0x[0-9a-fp.+-]+);", src)}
    want = {f"kAlpha{i + 1}": v for i, v in enumerate(ode._ALPHA)}
    want.update({f"kBeta{i + 1}{j}": c for i, row in enumerate(ode._BETA)
                 for j, c in enumerate(row) if c != 0.0})
    want.update({f"kErr{j}": c for j, c in enumerate(ode._C_ERROR) if c != 0.0})
    want.update({f"kMid{j}": c for j, c in enumerate(ode._DPS_C_MID) if c != 0.0})
    assert lits == want
    assert ode._C_SOL == ode._BETA[5] + (0.0,)  # the kernel reuses kBeta6*


# ---- the generated right-hand side against the interpreted one -----------

LV_STAN = """
functions {
  vector dz_dt(real t, vector z, array[] real theta) {
    real u = z[1];
    real v = z[2];
    vector[2] dz;
    dz[1] = (theta[1] - theta[2] * v) * u;
    dz[2] = (-theta[3] + theta[4] * u) * v;
    return dz;
  }
}
data { int<lower=0> N; array[N] real ts; array[N, 2] real<lower=0> y; }
parameters { array[4] real<lower=0> theta; vector<lower=0>[2] z_init; real<lower=0> sigma; }
model {
  array[N] vector[2] z = ode_rk45(dz_dt, z_init, 0, ts, theta);
  theta ~ normal(0.5, 0.5);
  z_init ~ lognormal(log(10), 1);
  sigma ~ lognormal(-1, 1);
  for (k in 1:2) { y[:, k] ~ lognormal(log(z[:, k]), sigma); }
}
"""
DECAY_STAN = """
functions { vector decay(real t, vector y, real k) { return -k * y; } }
data { int<lower=1> N; array[N] real ts; vector[N] yobs; }
parameters { real<lower=0> k; real<lower=0> sigma; }
model {
  array[N] vector[1] mu = ode_rk45(decay, to_vector({2.0}), 0, ts, k);
  k ~ lognormal(0, 1);
  sigma ~ exponential(1);
  for (n in 1:N) { yobs[n] ~ normal(mu[n][1], sigma); }
}
"""


def lv_stan_data(n=6):
    rng = np.random.default_rng(3)
    return {"N": n, "ts": [float(t) for t in range(1, n + 1)],
            "y": (20.0 * np.exp(0.3 * rng.normal(size=(n, 2)))).tolist()}


DECAY_DATA = {"N": 3, "ts": [0.5, 1.0, 2.0], "yobs": [1.4, 0.9, 0.4]}


def stan_site(src, data, dtype):
    """The compiled program's one ODE call site, its interpreted function at
    dtype (made by an evaluation at that dtype) and its program."""
    m = tstan.compile_stan_program(src, data, name="ode")
    x = torch.zeros(2, m.dim, dtype=dtype)
    CallableModel.logp_and_grad(m, x)
    (site,) = m._ode_sites.values()
    return m, site, site.fn(dtype, torch.device("cpu"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("which", ["lotka_volterra", "decay"])
def test_generated_rhs_and_vjp_equal_the_interpreted(which, dtype):
    """The Stan frontend's right-hand side lowered (`OdeProgram`) and run as
    ATen ops on 64 lanes against the interpreted closure under vmap, its
    value and its VJP, within 4 ulp of each output's largest magnitude."""
    src, data = (LV_STAN, lv_stan_data()) if which == "lotka_volterra" else (DECAY_STAN,
                                                                              DECAY_DATA)
    m, site, fn = stan_site(src, data, dtype)
    assert m.ode_routes == {site.name: {"float32": "kernel", "float64": "kernel"}}
    (key, prog), = [(k, p) for k, p in site.programs.items() if k[0] == dtype]
    _, n, shapes = key
    rng = np.random.default_rng(8)

    def draw(*shape):
        return torch.tensor(np.exp(0.5 * rng.normal(size=shape)), dtype=dtype)

    y, t, y_bar = draw(64, n), draw(64), draw(64, n)
    args = [draw(64, *s) for s in shapes]
    a = torch.cat([v.reshape(64, -1) for v in args], 1)
    want = torch.func.vmap(fn)(y, t, *args)
    _, pull = torch.func.vjp(torch.func.vmap(fn), y, t, *args)
    want_bar = pull(y_bar)
    got = prog.lanes(y, t, a)
    out, y_cot, t_cot, a_cot = prog.vjp_lanes(y, t, y_bar, a)
    eps = torch.finfo(dtype).eps
    for u, v in [(got, want), (out, want), (y_cot, want_bar[0]), (t_cot, want_bar[1]),
                 (a_cot, torch.cat([c.reshape(64, -1) for c in want_bar[2:]], 1))]:
        scale = max(float(v.abs().max()), 1e-30)
        assert float((u - v).abs().max()) <= 4 * eps * scale


# ---- the op against JAX's odeint -------------------------------------------

_JAX_ODEINT = r"""
import json, sys
import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental.ode import odeint

assert jax.config.jax_enable_x64
cases = json.loads(sys.stdin.read())


def lv(y, t, th):
    return jnp.stack([(th[0] - th[1] * y[1]) * y[0], (-th[2] + th[3] * y[0]) * y[1]])


def decay(y, t, k):
    return -k * y


out = {}
for name, fn in (("lotka_volterra", lv), ("decay", decay)):
    y0, arg, ts, g = (jnp.asarray(v) for v in cases[name])

    def one(y, a, gg):
        ys, vjp = jax.vjp(lambda yy, aa: odeint(fn, yy, ts, aa, rtol=1e-6, atol=1e-6), y, a)
        return (ys,) + vjp(gg)

    out[name] = [np.asarray(v).tolist() for v in jax.vmap(one)(y0, arg, g)]
print(json.dumps(out))
"""


def test_op_forward_and_gradient_equal_jax_odeint_in_float64():
    """Through `odeint_dopri5` under vmap (the custom op, the kernel route's
    plain version here), the solution and the gradient of <g, ys> in y0 and
    the arguments equal jax.experimental.ode.odeint's at rtol 1e-10."""
    ts = np.linspace(0.0, 5.0, 6)
    inputs = {}
    for name, (rhs, n, shapes, lanes, _) in CASES.items():
        y0, arg = lanes(3, torch.float64)
        g = np.random.default_rng(9).normal(size=(3, 6, n))
        inputs[name] = (y0, arg, g)
    stdin = json.dumps({k: [v[0].tolist(), v[1].tolist(), ts.tolist(), v[2].tolist()]
                        for k, v in inputs.items()})
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1", PYTHONPATH=_REPO)
    run = subprocess.run([sys.executable, "-c", _JAX_ODEINT], input=stdin, capture_output=True,
                         text=True, env=env, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    want = json.loads(run.stdout)
    tt = torch.tensor(ts)
    for name, (rhs, *_rest) in CASES.items():
        y0, arg, g = inputs[name]
        gt = torch.tensor(g)

        def loss(y, a, gg):
            ys = ode.odeint_dopri5(rhs, y, tt, (a,))
            return (ys * gg).sum(), ys

        (gy, ga), ys = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1), has_aux=True))(
            y0, arg, gt)
        for got, w in zip((ys, gy, ga), want[name]):
            np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-10, atol=1e-300)


# ---- one node a solve ------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_op_is_one_node_under_vmap_grad_and_make_fx(dtype):
    """make_fx of vmap(grad_and_value) over a density that solves the LV
    system records the solve and its adjoint as one node each; the graph
    replayed at new inputs, whose lanes take other steps, equals a fresh run
    to the bit."""
    ts = torch.arange(0.0, 6.0, dtype=dtype)

    def logp(x):
        ys = ode.odeint_dopri5(lv_rhs, x[:2].exp(), ts, (x[2:].exp(),))
        return -0.5 * ((ys.log() - 2.5) ** 2).sum()

    def vg(x):
        return torch.func.vmap(torch.func.grad_and_value(logp))(x)

    base = torch.log(torch.tensor([33.9, 5.9, *LV_TRUTH], dtype=dtype))
    rng = np.random.default_rng(10)
    x1 = base + torch.tensor(0.1 * rng.normal(size=(5, 6)), dtype=dtype)
    x2 = base + torch.tensor(0.3 * rng.normal(size=(5, 6)), dtype=dtype)
    gm = trace_fx(vg, x1)
    ops = [str(n.target) for n in gm.graph.nodes if "smcnuts" in str(n.target)]
    assert ops == ["smcnuts.ode_dopri5.default", "smcnuts.ode_dopri5_adjoint.default"]
    ode.solve_batched.steps = 0
    got = gm(x2)
    replay_steps = ode.solve_batched.steps
    ode.solve_batched.steps = 0
    want = vg(x2)
    assert replay_steps == ode.solve_batched.steps > 0
    assert all(torch.equal(u, v) for u, v in zip(got, want))


def test_op_vmap_rules_and_fake_implementations():
    """The ops' registered vmap rules solve a vmap's batch of batches as one
    batch; their fake implementations give the output shapes."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    rhs = ode._rhs_of(lv_rhs)
    y0, th = lv_lanes(6, torch.float64)
    ts = torch.arange(0.0, 4.0, dtype=torch.float64).expand(6, 4).contiguous()
    ode.odeint_dopri5(lv_rhs, y0[0], ts[0], (th[0],))  # fixes the route, lowers
    solve, adjoint = torch.ops.smcnuts.ode_dopri5, torch.ops.smcnuts.ode_dopri5_adjoint
    flat = solve(rhs.key, 1e-6, 1e-6, 1000, y0, ts, [th])
    nested = torch.func.vmap(lambda y, t, a: solve(rhs.key, 1e-6, 1e-6, 1000, y, t, [a]))(
        y0.reshape(2, 3, 2), ts.reshape(2, 3, 4), th.reshape(2, 3, 4))
    assert torch.equal(nested.reshape(6, 4, 2), flat)
    g = torch.ones_like(flat)
    flat_bar = adjoint(rhs.key, 1e-6, 1e-6, 1000, flat, ts, g, [th])
    nested_bar = torch.func.vmap(
        lambda y, t, gg, a: adjoint(rhs.key, 1e-6, 1e-6, 1000, y, t, gg, [a]))(
        flat.reshape(2, 3, 4, 2), ts.reshape(2, 3, 4), g.reshape(2, 3, 4, 2),
        th.reshape(2, 3, 4))
    assert all(torch.equal(u.reshape(v.shape), v) for u, v in zip(nested_bar, flat_bar))
    with FakeTensorMode() as mode:
        fy, ft, fa = (mode.from_tensor(v) for v in (y0, ts, th))
        ys = solve(rhs.key, 1e-6, 1e-6, 1000, fy, ft, [fa])
        bars = adjoint(rhs.key, 1e-6, 1e-6, 1000, ys, ft, ys, [fa])
    assert tuple(ys.shape) == (6, 4, 2)
    assert [tuple(b.shape) for b in bars] == [(6, 2), (6, 4), (6, 4)]


# ---- routes and failures ----------------------------------------------------


def test_unlowerable_rhs_takes_the_host_loop_naming_the_op():
    """A right-hand side with an op the lowering lacks (fmod) is routed to
    the host loop at its first solve, the route naming the op; it solves
    and differentiates there; a Stan program with one reports it in
    `ode_routes`."""
    def spiral(y, t, k):
        return torch.stack([-k * y[0] + 0.01 * torch.fmod(y[1], 3.0), -k * y[1]])

    y0 = torch.tensor([1.0, 0.5], dtype=torch.float64, requires_grad=True)
    k = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
    ys = ode.odeint_dopri5(spiral, y0, torch.linspace(0, 2, 4, dtype=torch.float64), (k,))
    route = ode._rhs_of(spiral).routes[torch.float64]
    assert route.startswith("host loop:") and "fmod" in route
    gy, gk = torch.autograd.grad(ys.sum(), (y0, k))
    assert torch.isfinite(ys).all() and torch.isfinite(gy).all() and torch.isfinite(gk)
    src = DECAY_STAN.replace("return -k * y;", "return -k * y + 0.01 * fmod(y, 3.0);")
    m = tstan.compile_stan_program(src, DECAY_DATA, name="fmod")
    (routes,) = m.ode_routes.values()
    assert sorted(routes) == ["float32", "float64"]
    assert all(r.startswith("host loop:") and "fmod" in r for r in routes.values())
    lp, g = m.logp_and_grad(torch.zeros(2, 2))
    assert torch.isfinite(lp).all() and torch.isfinite(g).all()


def test_routes_are_fixed_in_each_real_type_at_compile_time():
    """A right-hand side with i0e (von_mises_lpdf), which the lowering has
    in float32 only: the compile-time probe fixes the kernel route in
    float32 and the host loop in float64, naming the op; both run, each
    replay equal to a fresh interpretation to the bit."""
    src = DECAY_STAN.replace("return -k * y;",
                             "return -k * y * exp(von_mises_lpdf(0.3 | 0, k));")
    m = tstan.compile_stan_program(src, DECAY_DATA, name="von_mises")
    (routes,) = m.ode_routes.values()
    assert routes["float32"] == "kernel"
    assert routes["float64"].startswith("host loop:") and "i0e" in routes["float64"]
    for dtype in (torch.float32, torch.float64):
        x1 = torch.tensor([[0.1, -0.5], [-0.4, 0.2]], dtype=dtype)
        x2 = torch.tensor([[1.2, 0.3], [-1.5, -0.1]], dtype=dtype)
        m.logp_and_grad(x1)
        got = m.logp_and_grad(x2)
        want = CallableModel.logp_and_grad(m, x2)
        assert torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_registry_lets_a_freed_program_go():
    """The ops' registry holds its right-hand sides weakly: a compiled
    program's go when the program goes (with its interpreter and data); a
    Python function keeps its own for every solve, and the backward of a
    solve keeps that of a callable dropped after it."""
    import gc

    m = tstan.compile_stan_program(DECAY_STAN, DECAY_DATA, name="decay")
    m.logp_and_grad(torch.zeros(2, 2))
    keys = [site.key for site in m._ode_sites.values()]
    assert keys and all(k in ode._RHS for k in keys)
    del m
    gc.collect()
    assert not any(k in ode._RHS for k in keys)
    assert ode._rhs_of(decay_rhs) is ode._rhs_of(decay_rhs)
    # A lambda dropped after its solve: its backward keeps its entry.
    y0 = torch.tensor([1.0], dtype=torch.float64, requires_grad=True)
    ts = torch.linspace(0.0, 1.0, 3, dtype=torch.float64)
    ys = ode.odeint_dopri5(lambda y, t: -0.5 * y, y0, ts)
    gc.collect()
    (gy,) = torch.autograd.grad(ys.sum(), (y0,))
    np.testing.assert_allclose(float(gy), float(torch.exp(-0.5 * ts).sum()), rtol=1e-5)


def test_failed_build_raises_with_nvccs_output(monkeypatch, tmp_path):
    """No fallback: a build that fails raises, with the compiler's log."""
    from smcnuts_torch.ops import nuts_cuda

    script = tmp_path / "nvcc"
    script.write_text("#!/bin/sh\necho 'error: no card here' >&2\nexit 3\n")
    script.chmod(0o755)
    monkeypatch.setattr(nuts_cuda, "_nvcc", lambda: str(script))
    monkeypatch.setattr(nuts_cuda, "BUILD_ROOT", str(tmp_path / "build"))
    prog = program(decay_rhs, torch.float64, 1, [()])
    with pytest.raises(RuntimeError, match="exit code 3:\nerror: no card here"):
        ode.build_ode(prog)
