"""The port's Stan solvers (`smcnuts_torch.stan`, `smcnuts_torch.ops.ode`)
against the JAX frontend's (`smcnuts_tpu/stan/compiler.py:909-1190`) and
against closed forms: the ODE interfaces (adaptive Dormand-Prince with its
adjoint, fixed-step RK4), integrate_1d and the algebra solvers, on the same
numpy-seeded points.

Tolerances, each the reason beside it:
- float32 values: rtol 1e-4, the JAX tests' own against closed forms
  (tests/test_stan_ode.py); the float32 adjoint gradient: 1e-4 of the
  gradient's largest entry (the solver's error, rtol = atol = 1e-6 a step,
  accumulated over the adjoint's steps, in both frontends);
- float64 (JAX with JAX_ENABLE_X64 in one subprocess, as tests/test_float64.py
  runs it): logp rtol 1e-8; `odeint_dopri5` against `jax.experimental.ode.
  odeint` called directly, the solution and its VJP, rtol 1e-10 (the same
  accepted steps); the Stan-level gradient 1e-6 of its largest entry (below);
- RK4, integrate_1d and Newton in float32: rtol 1e-5.

Why the Stan-level float64 gradient is held to its largest entry: the JAX
frontend's right-hand side adds the interpreter's `target` to the function's
own (a dead `add`), so `closure_convert` hoists that traced scalar into the
adjoint's augmented state as one more component, whose cotangent is zero.
The error norm then averages over 10 components, not 9, the adjoint takes
other steps, and the two gradients agree to the adjoint's tolerance (5e-7
of the largest entry; 3e-5 on a small entry), not to 1e-10. With such a
zero component in its own augmented state, the port's gradient equals
JAX's to 2e-12; the port does not carry it.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smcnuts_torch import stan as tstan
from smcnuts_torch.models.base import CallableModel
from smcnuts_torch.ops import ode
from smcnuts_tpu import stan as jstan

torch.set_num_threads(2)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The Stan case study's Lotka-Volterra model (N = 20 years, D = 8), in the
# new ODE interface; `{solver}` is the call (chip_smoke.py's STAN_PROGRAMS,
# lv_rk45 and lv_rk4, holds the same program).
LV = """
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
data {
  int<lower=0> N;
  array[N] real ts;
  array[2] real y_init;
  array[N, 2] real<lower=0> y;
}
parameters {
  array[4] real<lower=0> theta;
  vector<lower=0>[2] z_init;
  array[2] real<lower=0> sigma;
}
model {
  array[N] vector[2] z = {solver};
  theta[{1, 3}] ~ normal(1, 0.5);
  theta[{2, 4}] ~ normal(0.05, 0.05);
  sigma ~ lognormal(-1, 1);
  z_init ~ lognormal(log(10), 1);
  for (k in 1:2) {
    y_init[k] ~ lognormal(log(z_init[k]), sigma[k]);
    y[:, k] ~ lognormal(log(z[:, k]), sigma[k]);
  }
}
"""
LV_RK45 = "ode_rk45(dz_dt, z_init, 0, ts, theta)"
# The case study's posterior means, which the data are drawn around.
LV_TRUTH = (0.55, 0.028, 0.80, 0.024, 33.9, 5.9, 0.25, 0.25)


def lv_data(seed=0):
    """N = 20 yearly counts of both species and the initial state: the
    trajectory from LV_TRUTH by RK4 at 1,000 steps a year, times lognormal
    noise of sd 0.25 drawn from a numpy seed."""
    a, b, c, d, u0, v0 = LV_TRUTH[:6]
    z = np.array([u0, v0])

    def f(z):
        return np.array([(a - b * z[1]) * z[0], (-c + d * z[0]) * z[1]])

    h, zs = 1e-3, []
    for _ in range(20):
        for _ in range(1000):
            k1 = f(z)
            k2 = f(z + h / 2 * k1)
            k3 = f(z + h / 2 * k2)
            k4 = f(z + h * k3)
            z = z + h / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
        zs.append(z)
    rng = np.random.default_rng(seed)
    y = np.array(zs) * np.exp(0.25 * rng.normal(size=(20, 2)))
    y_init = np.array([u0, v0]) * np.exp(0.25 * rng.normal(size=2))
    return {"N": 20, "ts": [float(t) for t in range(1, 21)], "y_init": y_init.tolist(),
            "y": y.tolist()}


def lv_points(n, seed=1):
    """n unconstrained points around LV_TRUTH (every parameter is
    lower-bounded at 0: the log of the constrained value)."""
    rng = np.random.default_rng(seed)
    return np.log(np.asarray(LV_TRUTH)) + 0.1 * rng.normal(size=(n, 8))


def interpret(m, x):
    """logp and gradient by interpreting the program (StanModel replays a
    trace where it can; test_rk4_program_replays_* holds the two equal)."""
    return CallableModel.logp_and_grad(m, x)


def lv_rhs(y, t, th):
    return torch.stack([(th[0] - th[1] * y[1]) * y[0], (-th[2] + th[3] * y[0]) * y[1]])


_X64 = r"""
import json, sys
import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental.ode import odeint
from smcnuts_tpu.stan import compile_stan_program

assert jax.config.jax_enable_x64
src, data, th, y0, ts, theta, g = json.loads(sys.stdin.read())
m = compile_stan_program(src, data, name="lv")
lp, grad = jax.jit(jax.vmap(jax.value_and_grad(lambda t: m.logp(t, 1.0))))(jnp.asarray(th))


def f(y, t, th):
    return jnp.stack([(th[0] - th[1] * y[1]) * y[0], (-th[2] + th[3] * y[0]) * y[1]])


ys, vjp = jax.vjp(lambda y, p: odeint(f, y, jnp.asarray(ts), p, rtol=1e-6, atol=1e-6),
                  jnp.asarray(y0), jnp.asarray(theta))
gy, gp = vjp(jnp.asarray(g))
print(json.dumps({k: np.asarray(v).tolist() for k, v in dict(
    lp=lp, grad=grad, ys=ys, gy=gy, gp=gp).items()}))
"""


@pytest.fixture(scope="module")
def jax_x64():
    """The JAX references in float64: the LV model's logp and gradient at 8
    points, and odeint's solution and VJP on the LV system alone."""
    rng = np.random.default_rng(2)
    inputs = dict(th=lv_points(8), y0=[33.9, 5.9], ts=[float(t) for t in range(21)],
                  theta=[0.58, 0.027, 0.83, 0.025], g=rng.normal(size=(21, 2)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1", PYTHONPATH=_REPO)
    stdin = json.dumps([LV.replace("{solver}", LV_RK45), lv_data(),
                        *(np.asarray(inputs[k]).tolist()
                          for k in ("th", "y0", "ts", "theta", "g"))])
    out = subprocess.run([sys.executable, "-c", _X64], input=stdin, capture_output=True,
                         text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return inputs, {k: np.asarray(v) for k, v in json.loads(out.stdout).items()}


def test_dopri5_follows_jax_odeint_step_for_step(jax_x64):
    """float64: the solution and its VJP (the continuous adjoint) equal
    jax.experimental.ode.odeint's at rtol 1e-10, which only the same
    accepted steps give (the solver's own tolerance is 1e-6)."""
    inputs, want = jax_x64
    y0 = torch.tensor(inputs["y0"], dtype=torch.float64, requires_grad=True)
    theta = torch.tensor(inputs["theta"], dtype=torch.float64, requires_grad=True)
    ts = torch.tensor(inputs["ts"], dtype=torch.float64)
    ys = ode.odeint_dopri5(lv_rhs, y0, ts, (theta,))
    gy, gp = torch.autograd.grad(ys, (y0, theta), torch.tensor(inputs["g"]))
    np.testing.assert_allclose(ys.detach().numpy(), want["ys"], rtol=1e-10)
    np.testing.assert_allclose(gy.numpy(), want["gy"], rtol=1e-10)
    np.testing.assert_allclose(gp.numpy(), want["gp"], rtol=1e-10)


def test_lotka_volterra_float64_matches_jax_x64(jax_x64):
    inputs, want = jax_x64
    m = tstan.compile_stan_program(LV.replace("{solver}", LV_RK45), lv_data(), name="lv")
    assert m.dim == 8 and list(m.ode_routes.values()) == [{"float32": "kernel", "float64": "kernel"}]
    lp, g = m.logp_and_grad(torch.tensor(inputs["th"], dtype=torch.float64))
    assert lp.dtype == g.dtype == torch.float64
    np.testing.assert_allclose(lp.numpy(), want["lp"], rtol=1e-8)
    scale = np.abs(want["grad"]).max(1, keepdims=True)
    np.testing.assert_allclose(g.numpy() / scale, want["grad"] / scale, atol=1e-6)


def test_lotka_volterra_float32_matches_jax():
    src, data = LV.replace("{solver}", LV_RK45), lv_data()
    m = tstan.compile_stan_program(src, data, name="lv")
    jm = jstan.compile_stan_program(src, data, name="lv")
    th = lv_points(8).astype(np.float32)
    lp, g = m.logp_and_grad(torch.tensor(th))
    jl, jg = jax.jit(jax.vmap(jax.value_and_grad(lambda t: jm.logp(t, 1.0))))(jnp.asarray(th))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jl), rtol=1e-4)
    scale = np.abs(np.asarray(jg)).max(1, keepdims=True)
    np.testing.assert_allclose(g.numpy() / scale, np.asarray(jg) / scale, atol=1e-4)


# The decay ODE dy/dt = -k y, y(0) = 2, in four of the interfaces.
_DECAY_FNS = """
functions {
  vector decay(real t, vector y, real k) { return -k * y; }
  vector decay_old(real t, vector y, array[] real theta, array[] real x_r,
                   array[] int x_i) { return -theta[1] * y; }
}
"""
_DECAY_CALLS = {
    "ode_rk45": "ode_rk45(decay, to_vector({2.0}), 0, ts, k)",
    "ode_bdf_tol": "ode_bdf_tol(decay, to_vector({2.0}), 0, ts, 1e-8, 1e-8, 10000, k)",
    "integrate_ode_rk45": "integrate_ode_rk45(decay_old, to_vector({2.0}), 0, ts, {k}, "
                          "{0.0}, {0})",
    "ode_rk4": "ode_rk4(decay, to_vector({2.0}), 0, ts, 20, k)",
}


def _decay_source(call):
    return _DECAY_FNS + f"""
data {{ int<lower=1> N; array[N] real ts; vector[N] yobs; }}
parameters {{ real<lower=0> k; real<lower=0> sigma; }}
model {{
  array[N] vector[1] mu = {call};
  k ~ lognormal(0, 1);
  sigma ~ exponential(1);
  for (n in 1:N) {{ yobs[n] ~ normal(mu[n][1], sigma); }}
}}
"""


_DECAY_TS = [0.25, 0.5, 1.0, 2.0]
_DECAY_DATA = {"N": 4, "ts": _DECAY_TS,
               "yobs": (2.0 * np.exp(-0.8 * np.asarray(_DECAY_TS))).tolist()}


def _decay_closed_form(th):
    """logp of _decay_source at unconstrained th = (log k, log sigma)."""
    from scipy import stats

    k, sigma = np.exp(th)
    mu = 2.0 * np.exp(-k * np.asarray(_DECAY_TS))
    return (stats.lognorm(1, scale=1).logpdf(k) + stats.expon().logpdf(sigma) + th[0] + th[1]
            + stats.norm(mu, sigma).logpdf(_DECAY_DATA["yobs"]).sum())


@pytest.mark.parametrize("form", list(_DECAY_CALLS))
def test_decay_ode_closed_form_and_jax(form):
    """Each interface against the closed form (float32 rtol 1e-4) and the
    JAX frontend: the value (rtol 1e-4; RK4 1e-5) and the gradient (1e-4 of
    its largest entry; RK4 rtol 1e-5)."""
    src = _decay_source(_DECAY_CALLS[form])
    m = tstan.compile_stan_program(src, _DECAY_DATA, name=form)
    jm = jstan.compile_stan_program(src, _DECAY_DATA, name=form)
    assert bool(m.ode_routes) == (form != "ode_rk4")
    th = np.array([[np.log(0.8), np.log(0.3)], [0.1, -0.5], [-0.4, 0.2]], np.float32)
    lp, g = interpret(m, torch.tensor(th))
    want = [_decay_closed_form(t.astype(np.float64)) for t in th]
    np.testing.assert_allclose(lp.numpy(), want, rtol=1e-4)
    jl, jg = jax.vmap(jax.value_and_grad(lambda t: jm.logp(t, 1.0)))(jnp.asarray(th))
    if form == "ode_rk4":
        np.testing.assert_allclose(lp.numpy(), np.asarray(jl), rtol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(lp.numpy(), np.asarray(jl), rtol=1e-4)
        scale = np.abs(np.asarray(jg)).max(1, keepdims=True)
        np.testing.assert_allclose(g.numpy() / scale, np.asarray(jg) / scale, atol=1e-4)


def test_batched_dopri5_equals_each_lane_alone():
    """Lanes that need more steps do not change the lanes that need fewer:
    the solve of 6 lanes under vmap, and their gradients by the batched
    adjoint, equal each lane solved alone, to the bit (float32 and
    float64)."""
    rng = np.random.default_rng(4)
    theta = np.abs(np.array([0.55, 0.028, 0.80, 0.024]) * (1 + 0.6 * rng.normal(size=(6, 4))))
    y0 = np.exp(np.log([33.9, 5.9]) + 0.5 * rng.normal(size=(6, 2)))
    for dt in (torch.float32, torch.float64):
        ts = torch.arange(0, 11, dtype=dt)

        def solve(y, th):
            return ode.odeint_dopri5(lv_rhs, y, ts, (th,))

        def loss(y, th):
            return solve(y, th).sum()

        Y, TH = torch.tensor(y0, dtype=dt), torch.tensor(theta, dtype=dt)
        ode.solve_batched.steps = 0
        batched = torch.func.vmap(solve)(Y, TH)
        steps = ode.solve_batched.steps
        grads = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1)))(Y, TH)
        alone_steps = []
        for b in range(6):
            ode.solve_batched.steps = 0
            assert torch.equal(batched[b], solve(Y[b], TH[b]))
            alone_steps.append(ode.solve_batched.steps)
            gy, gt = torch.func.grad(loss, argnums=(0, 1))(Y[b], TH[b])
            assert torch.equal(grads[0][b], gy) and torch.equal(grads[1][b], gt)
        # The lanes took different numbers of steps; the batch took their sum.
        assert len(set(alone_steps)) > 1 and steps == sum(alone_steps)


def test_adaptive_program_replays_the_bits_of_a_fresh_interpretation():
    """A program with an adaptive solver is traced once a shape and
    replayed: the solve and its adjoint are one node each of the graph, and
    a second call at new inputs (whose solves take other steps) gives the
    bits of a fresh interpretation. Its call site takes the kernel route."""
    m = tstan.compile_stan_program(_decay_source(_DECAY_CALLS["ode_rk45"]), _DECAY_DATA,
                                   name="decay")
    assert list(m.ode_routes.values()) == [{"float32": "kernel", "float64": "kernel"}]
    x1 = torch.tensor([[0.1, -0.5], [-0.4, 0.2]])
    x2 = torch.tensor([[1.2, 0.3], [-1.5, -0.1]])
    m.logp_and_grad(x1)
    (graph,) = m._graphs.values()
    ops = [str(n.target) for n in graph.graph.nodes if "smcnuts" in str(n.target)]
    assert ops == ["smcnuts.ode_dopri5.default", "smcnuts.ode_dopri5_adjoint.default"]
    ode.solve_batched.steps = 0
    got = m.logp_and_grad(x2)
    replay_steps = ode.solve_batched.steps
    ode.solve_batched.steps = 0
    want = CallableModel.logp_and_grad(m, x2)
    assert replay_steps == ode.solve_batched.steps > 0
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


_DOSE_RHS = {
    "kernel": "return d - k * y;",
    # fmod: an op the lowering lacks, so this site takes the host loop.
    "host loop": "return d - k * y + 0.001 * fmod(y, 100.0);",
}
_DOSE_TS = [0.25, 0.5, 1.0, 2.0]
_DOSES = [0.5, 2.0, 4.0]


def _dose_source(body):
    return f"""
functions {{ vector inflow(real t, vector y, real k, real d) {{ {body} }} }}
data {{ int<lower=1> J; int<lower=1> N; array[N] real ts; array[J] real dose;
       array[J, N] real yobs; }}
parameters {{ real<lower=0> k; real<lower=0> sigma; }}
model {{
  for (j in 1:J) {{
    array[N] vector[1] mu = ode_rk45(inflow, to_vector({{1.0}}), 0, ts, k, dose[j]);
    for (n in 1:N) {{ yobs[j, n] ~ normal(mu[n][1], sigma); }}
  }}
  k ~ lognormal(0, 1);
  sigma ~ exponential(1);
}}
"""


def _dose_mean(k, d, ts):
    """y(t) of dy/dt = d - k y, y(0) = 1."""
    return d / k + (1.0 - d / k) * np.exp(-k * np.asarray(ts))


_DOSE_DATA = {"J": 3, "N": 4, "ts": _DOSE_TS, "dose": _DOSES,
              "yobs": [_dose_mean(0.8, d, _DOSE_TS).tolist() for d in _DOSES]}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("route", sorted(_DOSE_RHS))
def test_a_call_site_reached_with_other_data_solves_with_each(route, dtype):
    """One call site in a loop over subjects, each with its own dose (data):
    each reach is a right-hand side of its own, on its route; the replay at
    new inputs equals a fresh interpretation to the bit, and both the
    closed form (rtol 1e-4, as the decay ODE's) and, in float32, the JAX
    frontend (as test_decay_ode_closed_form_and_jax holds it)."""
    from scipy import stats

    src = _dose_source(_DOSE_RHS[route])
    m = tstan.compile_stan_program(src, _DOSE_DATA, name="dose")
    routes = [r for site in m.ode_routes.values() for r in site.values()]
    assert len(m.ode_routes) == len(_DOSES) and len(routes) == 2 * len(_DOSES)
    assert all(r == "kernel" if route == "kernel" else r.startswith("host loop:") and
               "fmod" in r for r in routes)
    x1 = torch.tensor([[0.1, -0.5], [-0.4, 0.2]], dtype=dtype)
    x2 = torch.tensor([[np.log(0.8), np.log(0.3)], [0.3, -1.0]], dtype=dtype)
    m.logp_and_grad(x1)
    got = m.logp_and_grad(x2)
    want = interpret(m, x2)
    assert len(m._graphs) == 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if route == "kernel":
        for (lk, ls), lp in zip(x2.double().numpy(), got[0].double().numpy()):
            k, sigma = np.exp(lk), np.exp(ls)
            closed = (stats.lognorm(1, scale=1).logpdf(k) + stats.expon().logpdf(sigma) + lk + ls
                      + sum(stats.norm(_dose_mean(k, d, _DOSE_TS), sigma).logpdf(obs).sum()
                            for d, obs in zip(_DOSES, _DOSE_DATA["yobs"])))
            np.testing.assert_allclose(lp, closed, rtol=1e-4)
    if dtype == torch.float32:
        jm = jstan.compile_stan_program(src, _DOSE_DATA, name="dose")
        jl, jg = jax.vmap(jax.value_and_grad(lambda t: jm.logp(t, 1.0)))(
            jnp.asarray(x2.numpy()))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(jl), rtol=1e-4)
        scale = np.abs(np.asarray(jg)).max(1, keepdims=True)
        np.testing.assert_allclose(got[1].numpy() / scale, np.asarray(jg) / scale, atol=1e-4)


def test_rk4_program_replays_the_bits_of_a_fresh_interpretation():
    """ode_rk4's loop is fixed by the data, so its program is traced once a
    shape and replayed: at inputs other than the traced ones the replay
    equals a fresh interpretation to the bit."""
    m = tstan.compile_stan_program(_decay_source(_DECAY_CALLS["ode_rk4"]), _DECAY_DATA,
                                   name="decay_rk4")
    assert not m.ode_routes
    m.logp_and_grad(torch.tensor([[0.1, -0.5], [-0.4, 0.2]]))
    assert len(m._graphs) == 1
    x2 = torch.tensor([[1.2, 0.3], [-1.5, -0.1]])
    got = m.logp_and_grad(x2)
    want = CallableModel.logp_and_grad(m, x2)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# integrate_1d: finite, half-infinite and infinite bounds (JAX
# tests/test_stan_orientation.py:346-418): at the exact integrals every
# penalty term is 0.
_INTEGRATE = """
functions {
  real decay(real x, real xc, array[] real theta, array[] real x_r, array[] int x_i) {
    return exp(-theta[1] * x);
  }
  real rising(real x, real xc, array[] real theta, array[] real x_r, array[] int x_i) {
    return exp(x);
  }
  real gauss(real x, real xc, array[] real theta, array[] real x_r, array[] int x_i) {
    return exp(-0.5 * square(x - theta[1])) / sqrt(2 * pi());
  }
}
data { real b; }
parameters { real<lower=0> lam; }
model {
  real I0 = integrate_1d(decay, 0.0, b, {lam}, {0.0}, {0});
  real I1 = integrate_1d(decay, 0.0, positive_infinity(), {lam}, {0.0}, {0});
  real I2 = integrate_1d(rising, negative_infinity(), 0.0, {lam}, {0.0}, {0});
  real I3 = integrate_1d(gauss, negative_infinity(), positive_infinity(), {lam}, {0.0}, {0});
  target += -0.5 * square(I0 * lam - (1 - exp(-lam * b))) - 0.5 * square(I1 * lam - 1)
            - 0.5 * square(I2 - 1) - 0.5 * square(I3 - 1);
  lam ~ normal(1, 1);
}
"""


def _normal_lpdf(x, mu=1.0, sd=1.0):
    return -0.5 * ((x - mu) / sd) ** 2 - np.log(sd) - 0.5 * np.log(2 * np.pi)


def test_integrate_1d_matches_closed_form_and_jax():
    m = tstan.compile_stan_program(_INTEGRATE, {"b": 2.0}, name="int1d")
    jm = jstan.compile_stan_program(_INTEGRATE, {"b": 2.0}, name="int1d")
    u = np.array([[0.3], [-0.2], [0.7]], np.float32)
    lp, g = interpret(m, torch.tensor(u))
    lam = np.exp(u[:, 0].astype(np.float64))
    # The penalties vanish: the prior and the log-Jacobian remain, and
    # their derivative -(lam - 1) lam + 1.
    np.testing.assert_allclose(lp.numpy(), _normal_lpdf(lam) + u[:, 0], rtol=1e-5)
    np.testing.assert_allclose(g[:, 0].numpy(), -(lam - 1.0) * lam + 1.0, rtol=1e-5,
                               atol=1e-5)
    jl, jg = jax.vmap(jax.value_and_grad(lambda t: jm.logp(t, 1.0)))(jnp.asarray(u))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jl), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)


def test_integrate_1d_bound_infinite_at_run_time():
    """A bound that depends on the parameters and is infinite at run time:
    the port takes the map of the infinite bound lane by lane, finite and
    right (int_0^inf exp(-lam x) = 1/lam); the JAX frontend takes a traced
    bound as finite (`_static_inf`, smcnuts_tpu/stan/compiler.py:1081-1094)
    and gives NaN."""
    src = """
    functions {
      real decay(real x, real xc, array[] real theta, array[] real x_r, array[] int x_i) {
        return exp(-theta[1] * x);
      }
    }
    parameters { real<lower=0> lam; real m; }
    model {
      real hi = m + positive_infinity();
      target += log(integrate_1d(decay, 0.0, hi, {lam}, {0.0}, {0}));
      m ~ normal(0, 1);
    }
    """
    u = np.array([[0.3, 0.1], [-0.5, 0.4]], np.float32)
    lp, g = interpret(tstan.compile_stan_program(src, {}, name="inf"), torch.tensor(u))
    # log(1 / lam) + log-Jacobian u cancel: logp = normal_lpdf(m | 0, 1).
    np.testing.assert_allclose(lp.numpy(), _normal_lpdf(u[:, 1].astype(np.float64), 0.0),
                               rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.stack([np.zeros(2), -u[:, 1]], 1), atol=1e-5)
    jm = jstan.compile_stan_program(src, {}, name="inf")
    jl, jg = jax.vmap(jax.value_and_grad(lambda t: jm.logp(t, 1.0)))(jnp.asarray(u))
    assert np.isnan(np.asarray(jl)).all() and np.isnan(np.asarray(jg)).all()


_ALGEBRA = """
functions {
  vector sq(vector y, array[] real theta, array[] real x_r, array[] int x_i) {
    vector[1] z;
    z[1] = y[1] * y[1] - theta[1];
    return z;
  }
  vector pair(vector y, real a, real b) {
    vector[2] z;
    z[1] = y[1] + y[2] - a;
    z[2] = y[1] * y[2] - b;
    return z;
  }
}
parameters { real<lower=0> a; real<lower=0> b; }
model {
  vector[1] root = algebra_solver(sq, [1.0]', {a}, {0.0}, {0});
  vector[2] r = solve_newton(pair, [3.0, 0.5]', a, b);
  target += -0.5 * square(root[1] - 2.0) - square(r[1] - 2) - square(r[2] - 1);
  a ~ normal(4, 2);
}
"""


def test_algebra_solvers_match_closed_form_and_jax():
    """algebra_solver: root sqrt(a); solve_newton: y1 + y2 = a, y1 y2 = b,
    the larger root (a + sqrt(a^2 - 4b)) / 2 first from the guess (3, 0.5)."""
    m = tstan.compile_stan_program(_ALGEBRA, {}, name="alg")
    jm = jstan.compile_stan_program(_ALGEBRA, {}, name="alg")
    u = np.array([[np.log(4.0), np.log(2.0)], [1.2, 0.5], [1.5, 0.2]], np.float32)
    lp, g = interpret(m, torch.tensor(u))
    a, b = np.exp(u[:, 0].astype(np.float64)), np.exp(u[:, 1].astype(np.float64))
    disc = np.sqrt(a * a - 4 * b)
    r1, r2 = (a + disc) / 2, (a - disc) / 2
    want = (-0.5 * (np.sqrt(a) - 2) ** 2 - (r1 - 2) ** 2 - (r2 - 1) ** 2
            + _normal_lpdf(a, 4.0, 2.0) + u[:, 0] + u[:, 1])
    np.testing.assert_allclose(lp.numpy(), want, rtol=1e-5)
    jl, jg = jax.vmap(jax.value_and_grad(lambda t: jm.logp(t, 1.0)))(jnp.asarray(u))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jl), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-5)


# Every interface the port once refused (ROADMAP Queue 1 item 11b), on the
# decay ODE, the integral int_0^2 exp(-k x) dx and the root sqrt(k):
# (the call, the closed form of the value it gives at k).
_DECAY_OLD = "integrate_ode_{}(decay_old, to_vector({{2.0}}), 0, ts, {{k}}, {{0.0}}, {{0}})"
_FORMER_REFUSALS = {
    **{f"ode_{s}": f"ode_{s}(decay, to_vector({{2.0}}), 0, ts, k)[1][1]"
       for s in ("rk45", "bdf", "adams", "ckrk")},
    **{f"ode_{s}_tol": f"ode_{s}_tol(decay, to_vector({{2.0}}), 0, ts, 1e-6, 1e-6, 1000, "
                        "k)[1][1]" for s in ("rk45", "bdf", "adams", "ckrk")},
    **{f"integrate_ode_{s}": _DECAY_OLD.format(s) + "[1][1]" for s in ("rk45", "bdf", "adams")},
    "integrate_ode": "integrate_ode(decay_old, to_vector({2.0}), 0, ts, {k}, {0.0}, {0})[1][1]",
    "ode_rk4": "ode_rk4(decay, to_vector({2.0}), 0, ts, 10, k)[1][1]",
    "integrate_1d": "integrate_1d(decay1d, 0.0, 2.0, {k}, {0.0}, {0})",
    "algebra_solver": "algebra_solver(sq, [1.0]', {k}, {0.0}, {0})[1]",
    "algebra_solver_newton": "algebra_solver_newton(sq, [1.0]', {k}, {0.0}, {0})[1]",
    "solve_newton": "solve_newton(sq_new, [1.0]', k)[1]",
    "solve_powell": "solve_powell(sq_new, [1.0]', k)[1]",
}


def _former_closed_form(name, k):
    if name.startswith(("ode", "integrate_ode")):
        return 2.0 * np.exp(-k * 0.7)
    if name == "integrate_1d":
        return (1 - np.exp(-2 * k)) / k
    return np.sqrt(k)


@pytest.mark.parametrize("name", sorted(_FORMER_REFUSALS))
def test_former_refusal_compiles_and_evaluates(name):
    """Each of the 18 names the port refused compiles and gives its closed
    form (float32, rtol 1e-4) with a finite gradient."""
    src = _DECAY_FNS[:-2] + """
  real decay1d(real x, real xc, array[] real theta, array[] real x_r, array[] int x_i) {
    return exp(-theta[1] * x);
  }
  vector sq(vector y, array[] real theta, array[] real x_r, array[] int x_i) {
    return [y[1] * y[1] - theta[1]]';
  }
  vector sq_new(vector y, real k) { return [y[1] * y[1] - k]'; }
}
data { array[1] real ts; }
parameters { real<lower=0> k; }
model { target += """ + _FORMER_REFUSALS[name] + "; }"
    m = tstan.compile_stan_program(src, {"ts": [0.7]}, name=name)
    u = torch.tensor([[0.2], [-0.3]])
    lp, g = interpret(m, u)
    k = np.exp(u[:, 0].double().numpy())
    np.testing.assert_allclose(lp.numpy(), _former_closed_form(name, k) + u[:, 0].numpy(),
                               rtol=1e-4)
    assert torch.isfinite(g).all()
