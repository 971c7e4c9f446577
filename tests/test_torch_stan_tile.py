"""Stan programs through the port's generated in-kernel models and sampler,
against the JAX package's frontend on the CPU.

- Each generated model's plain version (`GeneratedModel.logp_and_grad`, the
  program the CUDA kernel runs, op by op in torch) against the JAX tile
  model's `tile_fn` on (8, 128) tiles, at tests/test_stan_frontend.py:411's
  and :679's tolerances: the T=40 recurrence (reverse), the T=200 one
  (forward) and radon (reverse).
- tile_autodiff="auto" chooses as the JAX frontend does
  (tests/test_stan_frontend.py:654, :1133, :1159, :1825).
- An op the lowering lacks raises NotImplementedError naming it; nothing
  falls back to the eager path.
- Three SMC iterations of a compiled program on the port's plain tree
  (zero bits) against the JAX step with its Pallas kernel interpreted, as
  tests/test_torch_sampler.py:70 holds the hand models.
- The CLI's --stan / --data / --stan-tile on the CPU.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smcnuts_torch import SMCConfig
from smcnuts_torch import stan as tstan
from smcnuts_torch.__main__ import main as torch_main
from smcnuts_torch.interop import CARRY_FIELDS, carry_from_numpy, carry_to_numpy
from smcnuts_torch.models.base import CallableModel
from smcnuts_torch.ops.draws import ZERO_BITS
from smcnuts_torch.sampler import smc_step
from smcnuts_tpu import DiagNormalProposal as JaxDiagNormalProposal
from smcnuts_tpu import SMCConfig as JaxSMCConfig
from smcnuts_tpu import stan as jstan
from smcnuts_tpu.ops.adaptation import da_init
from smcnuts_tpu.sampler import _DIAG_FIELDS, SMCCarry as JaxSMCCarry
from smcnuts_tpu.sampler import _make_step

from test_torch_stan_frontend import RECURRENCE, recurrence_data

torch.set_num_threads(2)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_RADON = os.path.join(_REPO, "examples", "stan", "radon_intercepts")

def _program(name):
    if name == "radon":
        with open(_RADON + ".stan") as f:
            return f.read(), tstan.load_stan_data(_RADON + ".json")
    return RECURRENCE, recurrence_data(int(name[len("rec"):]))


@functools.lru_cache(maxsize=None)
def _port_tile_model(name):
    """The port's compile of `name` with tile=True, shared by the tests that
    read it (each compile traces the program)."""
    src, data = _program(name)
    return tstan.compile_stan_program(src, data, name=name, tile=True)


# (program, the mode "auto" picks, tolerances of logp (rtol, atol), of the
# gradient over its largest component, the points' spread).
_TILE_CASES = {
    "rec40": ("reverse", (1e-4, 1e-4), 1e-5, None),  # tests/test_stan_frontend.py:411
    "rec200": ("forward", (1e-4, 1e-3), 1e-5, "stationary"),  # :679
    "radon": ("reverse", (1e-4, 1e-3), 1e-5, None),
}


@pytest.mark.parametrize("name", list(_TILE_CASES))
def test_generated_model_matches_jax_tile_fn(name):
    mode, (rtol, atol), g_atol, spread = _TILE_CASES[name]
    src, data = _program(name)
    jm = jstan.compile_stan_program(src, data, name=name, tile=True)
    tm = _port_tile_model(name)
    assert tm.tile_model.autodiff == jm.tile_model.autodiff == mode
    assert tm.tile_model.dim == jm.dim
    rng = np.random.default_rng(5)
    x = rng.normal(0, 0.4, (1024, jm.dim))
    if spread == "stationary":
        # |a| < 1 keeps the T=200 recurrence finite in float32 (:687-690).
        x[:, 0] = rng.uniform(-0.9, 0.9, 1024)
    tiles = [jnp.asarray(x[:, d].reshape(8, 128), jnp.float32) for d in range(jm.dim)]
    logp_j, grads_j = jax.jit(lambda ts, p: jm.tile_model.tile_fn((), ts, p))(
        tiles, jnp.full((8, 128), 0.7, jnp.float32))
    logp_j = np.asarray(logp_j).reshape(-1)
    g_j = np.stack([np.asarray(g).reshape(-1) for g in grads_j], axis=1)
    lp_t, g_t = tm.tile_model.logp_and_grad(torch.tensor(x, dtype=torch.float32), 0.7)
    np.testing.assert_allclose(lp_t.numpy(), logp_j, rtol=rtol, atol=atol)
    scale = np.abs(g_j).max() + 1e-6
    np.testing.assert_allclose(g_t.numpy() / scale, g_j / scale, atol=g_atol)
    # The eager model's interpretation by autograd agrees with its generated model.
    lp_e, g_e = CallableModel.logp_and_grad(tm, torch.tensor(x, dtype=torch.float32), 0.7)
    np.testing.assert_allclose(lp_e.numpy(), lp_t.numpy(), rtol=rtol, atol=atol)
    np.testing.assert_allclose(g_e.numpy() / scale, g_t.numpy() / scale, atol=g_atol)


def test_irt_ar_forward_model_matches_jax():
    """irt_ar (D = 64, a T = 120 carried recurrence): "auto" picks forward
    mode; the generated model's plain version against the JAX model's logp
    and gradient (its D = 64 forward tile model is the chip's, phase 13)."""
    path = os.path.join(_REPO, "examples", "stan", "irt_ar")
    with open(path + ".stan") as f:
        src = f.read()
    data = tstan.load_stan_data(path + ".json")
    tm = tstan.compile_stan_program(src, data, name="irt_ar", tile=True)
    jm = jstan.compile_stan_program(src, data, name="irt_ar", scan_threshold=8)
    assert tm.tile_model.autodiff == "forward" and tm.dim == 64
    x = np.random.default_rng(2).normal(0, 0.3, (16, 64)).astype(np.float32)
    lp_j, g_j = jax.jit(jax.vmap(jax.value_and_grad(lambda t: jm.logp(t, 0.7))))(jnp.asarray(x))
    lp_t, g_t = tm.tile_model.logp_and_grad(torch.tensor(x), 0.7)
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=1e-4, atol=1e-3)
    scale = float(np.abs(np.asarray(g_j)).max())
    np.testing.assert_allclose(g_t.numpy() / scale, np.asarray(g_j) / scale, atol=1e-5)


_FN_RECURRENCE = """
functions {
  real recur(real a, vector y) {
    real e; real acc;
    e = y[1]; acc = 0;
    for (t in 2:200) { e = y[t] - a * e; acc += e * e; }
    return acc;
  }
}
data { int<lower=1> T; vector[T] y; real phi; }
parameters { real a; }
model { target += phi * (-0.5 * recur(a, y)); }
"""

_SUM_LOOP = """
data { int<lower=1> N; real x[N]; real phi; }
parameters { real b; }
model {
  real temp;
  for (i in 1:100) { temp = b * x[i]; target += phi * (-0.5 * temp * temp); }
}
"""


def test_tile_autodiff_auto_selection():
    """The JAX frontend's choice (tests/test_stan_frontend.py:654, :1133,
    :1159, there at T=200): forward for a carried loop of more than 48 steps
    (in the model or in a user function), reverse for short loops and long
    loops that carry nothing."""
    assert _port_tile_model("rec200").tile_model.autodiff == "forward"
    assert _port_tile_model("rec40").tile_model.autodiff == "reverse"
    forced = tstan.compile_stan_program(RECURRENCE, recurrence_data(40), tile=True,
                                        name="r40f", tile_autodiff="forward")
    assert forced.tile_model.autodiff == "forward"
    with pytest.raises(tstan.StanCompileError, match="tile_autodiff"):
        tstan.compile_stan_program(RECURRENCE, recurrence_data(10), tile=True,
                                   tile_autodiff="bogus")
    y = np.random.default_rng(0).normal(size=200)
    fn = tstan.compile_stan_program(_FN_RECURRENCE, {"T": 200, "y": y.tolist()},
                                    name="fnrec", tile=True)
    assert fn.tile_model.autodiff == "forward"
    x = np.random.default_rng(0).normal(size=100)
    loop = tstan.compile_stan_program(_SUM_LOOP, {"N": 100, "x": x.tolist()}, name="sumloop",
                                      tile=True)
    assert loop.tile_model.autodiff == "reverse"


def test_tile_autodiff_wide_recurrence_picks_forward():
    """tests/test_stan_frontend.py:1825: a D=61 model with a T=60
    recurrence picks forward mode (D <= 128), and its generated model agrees
    with the eager model."""
    T = 60
    src = f"""
    data {{ vector[{T}] y; real phi; }}
    parameters {{ vector[{T}] h_std; real m; }}
    transformed parameters {{
      vector[{T}] h;
      h[1] = m + h_std[1];
      for (t in 2:{T}) {{ h[t] = m + 0.9 * (h[t-1] - m) + 0.3 * h_std[t]; }}
    }}
    model {{
      h_std ~ std_normal();
      target += phi * normal_lpdf(y | 0, exp(h / 2));
    }}
    """
    y = np.random.default_rng(0).normal(size=T)
    m = tstan.compile_stan_program(src, {"y": y.tolist()}, name="sv", tile=True)
    assert m.tile_model.autodiff == "forward" and m.dim == T + 1
    x = torch.tensor(np.random.default_rng(1).normal(size=(8, m.dim)) * 0.2, dtype=torch.float32)
    lp_t, g_t = m.tile_model.logp_and_grad(x, 0.6)
    lp_e, g_e = CallableModel.logp_and_grad(m, x, 0.6)
    np.testing.assert_allclose(lp_t.numpy(), lp_e.numpy(), rtol=1e-5, atol=1e-3)
    scale = float(g_e.abs().max())
    np.testing.assert_allclose(g_t.numpy() / scale, g_e.numpy() / scale, atol=1e-5)


_ODE_DECAY = """
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
_DECAY_DATA = {"N": 4, "ts": [0.25, 0.5, 1.0, 2.0], "yobs": [1.6, 1.3, 0.9, 0.4], "y0": 2.0}


@pytest.mark.parametrize("expr,mode,op", [
    ("gamma_lcdf(1.0 | exp(x), 1.0)", "reverse", "igamma"),
    ("fmod(x, 2.0)", "reverse", "fmod"),
    ("logit(inv_logit(x))", "forward", "logit"),
    ("ode_rk45", "forward", "ode_rk45.*reverse mode only"),
])
def test_unlowered_op_raises_under_tile(expr, mode, op):
    """An op the generated lowering does not have raises NotImplementedError
    naming it (and the model, in reverse mode): no quiet fall back to the
    eager path. Without tile=True the eager model runs it. The incomplete
    gamma functions of a parameter wait for a later slice; fmod and logit
    are not lowered; an adaptive ODE solve has a reverse-mode derivative
    only (the continuous adjoint, as JAX's odeint)."""
    if expr == "ode_rk45":
        src, data = _ODE_DECAY, _DECAY_DATA
    else:
        src, data = (f"parameters {{ real x; }} model {{ x ~ normal(0, 1); target += {expr}; }}",
                     {})
    with pytest.raises(NotImplementedError, match=op):
        tstan.compile_stan_program(src, data, name="unlowered", tile=True, tile_autodiff=mode)
    eager = tstan.compile_stan_program(src, data, name="unlowered")
    assert eager.tile_model is None
    lp, g = eager.logp_and_grad(torch.full((1, eager.dim), 0.3))
    assert torch.isfinite(lp).all() and torch.isfinite(g).all()


def test_folded_truncation_normalizer():
    """radon's `T[0,]` on data bounds and parameters folds to a literal: the
    generated reverse model holds no atan2 and no erf."""
    tm = _port_tile_model("radon").tile_model
    assert "atan" not in tm.source and "erf" not in tm.source
    # The bounds' check of the truncated statements is a compare and a select.
    assert {op[0] for op in tm.program.ops} <= {
        "x", "phi", "data", "add", "sub", "mul", "div", "neg", "exp", "log", "log1p",
        "ge", "where"}


_CONJ = """
data { int<lower=1> N; array[N] real y; real phi; }
parameters { real mu; }
model { mu ~ normal(0, 1); target += phi * normal_lpdf(y | mu, 1); }
"""
N_PART, ITERS, MAX_DEPTH = 16, 3, 3


def test_step_of_compiled_program_matches_jax_step():
    """Three SMC iterations of a compiled program: the JAX step with its
    Pallas kernel interpreted on the CPU (zero bits) and the port's step on
    the plain tree with ZERO_BITS draws, from one state, the port handed the
    resampling uniforms the JAX step draws: at atol 1e-4 / rtol 1e-4, the
    resampling decisions exactly."""
    data = {"N": 8, "y": np.random.default_rng(0).normal(loc=1.5, size=8).tolist()}
    jm = jstan.compile_stan_program(_CONJ, data, name="conj", tile=True)
    tm = tstan.compile_stan_program(_CONJ, data, name="conj", tile=True)
    cfg_j = JaxSMCConfig(n_particles=N_PART, n_iterations=ITERS, step_size=0.3,
                         nuts_backend="pallas", max_tree_depth=MAX_DEPTH)
    step = jax.jit(_make_step(jm, cfg_j, JaxDiagNormalProposal(jm.dim)))
    rng = np.random.default_rng(0)
    x0 = (1.2 + rng.normal(0, 0.3, (N_PART, 1))).astype(np.float32)
    logw0 = rng.normal(0, 2.0, N_PART).astype(np.float32)
    step0 = jnp.float32(0.3)
    carry = JaxSMCCarry(x=jnp.asarray(x0), logw=jnp.asarray(logw0), phi=jnp.float32(1.0),
                        step_size=step0, inv_mass=jnp.ones(1, jnp.float32),
                        da=da_init(step0, jnp.float32), key=jax.random.key(3))
    start = {k: jax.tree.map(np.asarray, getattr(carry, k)) for k in CARRY_FIELDS}
    cfg = SMCConfig(n_particles=N_PART, n_iterations=ITERS, step_size=0.3,
                    max_tree_depth=MAX_DEPTH)
    tcarry = carry_from_numpy(**start, device="cpu")
    resampled = []
    for k in range(ITERS):
        k_res = jax.random.split(carry.key, 5)[1]
        uniforms = np.array(jax.random.uniform(k_res, (N_PART,), jnp.float32))
        carry, out = step(carry, jnp.int32(k))
        want = {f: jax.tree.map(np.asarray, getattr(carry, f)) for f in CARRY_FIELDS}
        d = np.asarray(out["diag"])
        diag_j = dict(zip(_DIAG_FIELDS, d[: len(_DIAG_FIELDS)]))
        tcarry, diag = smc_step(tm, cfg, tcarry, torch.as_tensor(uniforms)[None],
                                torch.zeros(1, dtype=torch.int32), "eager", ZERO_BITS)
        got = carry_to_numpy(tcarry, run_axis=False)
        for f in CARRY_FIELDS:
            np.testing.assert_allclose(got[f], want[f], rtol=1e-4, atol=1e-4,
                                       err_msg=f"iteration {k}: {f}")
        for f in ("ess", "log_likelihood", "acceptance", "tree_depth", "tree_leapfrogs"):
            np.testing.assert_allclose(diag[f][0].numpy(), diag_j[f], rtol=1e-4, atol=1e-4,
                                       err_msg=f"iteration {k}: {f}")
        assert bool(diag["resampled"][0]) == bool(diag_j["resampled"] > 0.5)
        resampled.append(bool(diag["resampled"][0]))


_KEYS = {"model", "lkernel", "N", "K", "mean", "variance", "ess", "log_likelihood",
         "phi_schedule"}


@pytest.mark.parametrize("tile", [False, True], ids=["eager", "stan-tile"])
def test_cli_runs_a_stan_program_on_the_cpu(tile, capsys):
    argv = ["--stan", _RADON + ".stan", "--data", _RADON + ".json", "--device", "cpu",
            "-N", "64", "-K", "3", "--max-tree-depth", "4"] + (["--stan-tile"] if tile else [])
    summary = torch_main(argv)
    assert set(summary) == _KEYS and summary["model"] == "radon_intercepts"
    assert len(summary["mean"]) == 9 and summary["phi_schedule"] == [1.0] * 4
    assert np.all(np.isfinite(summary["mean"] + summary["variance"]))
    assert '"phi_schedule"' in capsys.readouterr().out

