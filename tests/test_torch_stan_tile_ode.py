"""The adaptive ODE solve inside the generated NUTS kernel (K7r): Stan's
ode_rk45 under tile=True, the solve and its adjoint each one call node of
the program (`ops/generated.py`: `OdeCall`), in the kernel a call of
`forward_lane` / `adjoint_lane` of csrc/ode_dopri5.cuh in the particle's
thread, in the plain version `ode.dopri5_plain` / `dopri5_adjoint_plain`.

- The decay model of tests/test_stan_ode.py:17 and lv_rk45 (the Stan case
  study's Lotka-Volterra model): each generated model's plain version
  against the JAX frontend's `tile_fn` on (1, 8) tiles, eight lanes (its
  odeint and adjoint, vmapped), at logp rtol 1e-4 + atol 1e-3 and the
  gradient at 1e-4 of its largest component: two float32 solves of the
  same controller, whose accepted steps may part where an error ratio sits
  at 1 in float32.
- The inlined call emulated in torch in the .cuh's order
  (tests/test_torch_ode_kernel.py's emulation of `forward_lane` and
  `adjoint_lane`), on the inputs the emitted code gathers from the
  program's values and writing the outputs where it reads them, equals the
  plain program's call nodes to the bit, lane by lane.
- One call node for the solve and one for its adjoint, each a device
  function of the source over the call site's right-hand side; the RK step
  counter; the sites' routes as `StanModel.ode_routes` reports them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smcnuts_torch import stan as tstan
from smcnuts_torch.models.base import CallableModel
from smcnuts_torch.ops import generated, ode
from smcnuts_tpu import stan as jstan

from test_torch_ode_kernel import emu_adjoint, emu_forward
from test_torch_stan_solvers import LV, LV_RK45, lv_data, lv_points

torch.set_num_threads(2)

DECAY = """
functions { vector decay(real t, vector y, real k) { return -k * y; } }
data { int<lower=1> N; array[N] real ts; vector[N] yobs; real y0; }
parameters { real<lower=0> k; real<lower=0> sigma; }
model {
  array[N] vector[1] mu = ode_rk45(decay, to_vector({y0}), 0, ts, k);
  k ~ lognormal(0, 1);
  sigma ~ exponential(1);
  for (n in 1:N) { yobs[n] ~ normal(mu[n][1], sigma); }
}
"""
DECAY_TS = [0.25, 0.5, 1.0, 2.0]
DECAY_DATA = {"N": 4, "ts": DECAY_TS,
              "yobs": (2.0 * np.exp(-0.8 * np.asarray(DECAY_TS))).tolist(), "y0": 2.0}


def _program(name):
    if name == "decay":
        return DECAY, DECAY_DATA
    return LV.replace("{solver}", LV_RK45), lv_data()


def _points(name, k=8):
    """k unconstrained points around the data's generating values."""
    if name == "decay":
        return np.random.default_rng(2).normal(0, 0.5, (k, 2)) + np.log([0.8, 0.3])
    return lv_points(k, seed=3)


_MODELS = {}


def _tile_model(name):
    if name not in _MODELS:
        src, data = _program(name)
        _MODELS[name] = tstan.compile_stan_program(src, data, name=name, tile=True)
    return _MODELS[name]


@pytest.mark.parametrize("name", ["decay", "lv_rk45"])
def test_generated_model_matches_jax_tile_fn(name):
    src, data = _program(name)
    tm = _tile_model(name)
    jm = jstan.compile_stan_program(src, data, name=name, tile=True)
    assert tm.tile_model.autodiff == "reverse" and len(tm.tile_model.program.calls) == 2
    x = _points(name)
    tiles = [jnp.asarray(x[:, d].reshape(1, 8), jnp.float32) for d in range(jm.dim)]
    logp_j, grads_j = jax.jit(lambda ts, p: jm.tile_model.tile_fn((), ts, p))(
        tiles, jnp.full((1, 8), 0.7, jnp.float32))
    logp_j = np.asarray(logp_j).reshape(-1)
    g_j = np.stack([np.asarray(g).reshape(-1) for g in grads_j], axis=1)
    lp_t, g_t = tm.tile_model.logp_and_grad(torch.tensor(x, dtype=torch.float32), 0.7)
    assert np.isfinite(logp_j).all() and np.isfinite(lp_t.numpy()).all()
    np.testing.assert_allclose(lp_t.numpy(), logp_j, rtol=1e-4, atol=1e-3)
    scale = np.abs(g_j).max()
    np.testing.assert_allclose(g_t.numpy() / scale, g_j / scale, atol=1e-4)
    # The eager model (the ODE op's own route, by autograd) agrees too.
    lp_e, g_e = CallableModel.logp_and_grad(tm, torch.tensor(x, dtype=torch.float32), 0.7)
    np.testing.assert_allclose(lp_t.numpy(), lp_e.numpy(), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(g_t.numpy() / scale, g_e.numpy() / scale, atol=1e-5)


def _call_values(gm, x, phi=1.0):
    """The inputs and outputs of each call node of gm's program on lanes x,
    by the plain program's own ops: [(OdeCall, inputs (P, k), outputs (P,
    n_out))]."""
    prog = gm.program
    g = torch.fx.Graph()
    xs, ph = g.placeholder("x"), g.placeholder("phi")
    root = torch.nn.Module()
    out, call = generated._fx_ops(g, prog.ops, prog.data, xs, ph, prog.calls, root)
    calls, outs = [], []
    for i, (op, tag, *args) in enumerate(prog.ops):
        if op in ("ode", "ode_adj"):
            calls.append(prog.calls[int(tag[1:])])
            outs.append(tuple(out(a) if type(a) is int else a for a in args))
            outs.append(out(i))
    g.output(tuple(outs))
    fn = torch.fx.GraphModule(root, g)
    P = x.shape[0]
    vals = fn(x, torch.full((P,), phi))

    def lanes(vs):  # literals (data) broadcast to the lanes
        return torch.stack([v if isinstance(v, torch.Tensor) else torch.full((P,), v)
                            for v in vs], 1)

    return [(c, lanes(vals[2 * k]), vals[2 * k + 1]) for k, c in enumerate(calls)]


@pytest.mark.parametrize("name", ["decay", "lv_rk45"])
def test_inlined_call_emulation_equals_the_plain_program(name):
    """forward_lane / adjoint_lane, as the emitted code calls them (its
    inputs gathered in node order: y0, the times, the arguments; ys, the
    times, the cotangent, the arguments; its outputs read as ys (T, n), or
    y0_bar, ts_bar, a_bar), emulated in the .cuh's order, equal the plain
    program's call nodes to the bit, lane by lane, on 3 lanes whose step
    counts differ."""
    gm = _tile_model(name).tile_model
    x = torch.tensor(_points(name, 3), dtype=torch.float32)
    kinds = set()
    for desc, inputs, outputs in _call_values(gm, x):
        prog, n, A, T = desc.prog, desc.prog.n, desc.prog.n_args, desc.T
        kinds.add(desc.kind)
        for b in range(x.shape[0]):
            a = inputs[b]
            if desc.kind == "ode":
                ys, _ = emu_forward(prog, a[:n], a[n:n + T], a[n + T:], *desc.tol)
                assert torch.equal(ys.reshape(-1), outputs[b])
            else:
                ys, ts = a[:T * n].reshape(T, n), a[T * n:T * n + T]
                g, args = a[T * n + T:2 * T * n + T].reshape(T, n), a[2 * T * n + T:]
                (yb, tb, ab), _ = emu_adjoint(prog, ys, ts, g, args, *desc.tol)
                assert torch.equal(torch.cat([yb, tb, ab]), outputs[b])
    assert kinds == {"ode", "ode_adj"}


def test_one_call_node_each_and_the_source():
    """lv_rk45's program: one solve and one adjoint call node over one
    right-hand side (its struct emitted once, the ODE kernel's), the source
    calling `forward_lane` and `adjoint_lane` and counting their steps; the
    plain version on lanes counts its solves' steps in
    `solve_batched.steps`."""
    gm = _tile_model("lv_rk45").tile_model
    ops = [op for op, *_ in gm.program.ops]
    assert ops.count("ode") == 1 and ops.count("ode_adj") == 1
    (struct, _), = {ode.ode_struct(d.prog) for d in gm.program.calls}
    assert gm.source.count(f"struct {struct} ") == 1
    for text in ("smcnuts::ode::forward_lane<", "smcnuts::ode::adjoint_lane<",
                 "smcnuts_generated_ode_steps_count[2]", "int smcnuts_generated_ode_steps("):
        assert text in gm.source, text
    ode.solve_batched.steps = 0
    gm.logp_and_grad(torch.tensor(lv_points(4, seed=5), dtype=torch.float32), 1.0)
    assert ode.solve_batched.steps > 4 * 20
    with pytest.raises(ValueError, match="solves no ODE"):
        generated.ode_steps(_tile_model_plain())


def _tile_model_plain():
    return generated.tile_model_from_logp(lambda t, p: -0.5 * (t * t).sum(), 2)


def test_ode_routes_report_the_inlined_site():
    """A site the generated model inlines reports its float32 route as in
    the NUTS kernel; float64 keeps the ODE kernel's route; the program
    compiled without tile=True reports the ODE kernel in both."""
    from smcnuts_torch.stan.compiler import INLINED

    (routes,) = _tile_model("decay").ode_routes.values()
    assert routes == {"float32": INLINED, "float64": ode.KERNEL}
    (routes,) = tstan.compile_stan_program(DECAY, DECAY_DATA, name="decay").ode_routes.values()
    assert routes == {"float32": ode.KERNEL, "float64": ode.KERNEL}
