"""The five Stan programs of the special functions, through the port's
generated in-kernel models (`--stan-tile`), against the JAX frontend's tile
adapter on the CPU: von Mises with unknown mu and kappa (cos, sin, i0e,
i1e), skew-normal regression and exp-modified-normal reaction times
(log_ndtr of a parameter), student-t regression with unknown nu (lgamma of
a parameter, digamma), probit regression with K = 5 covariates (Phi of a
parameter, erf). chip_smoke.py's STAN_PROGRAMS holds the same programs and
data recipes at N = 200; here N = 24.

- Each generated model's plain version against the JAX tile model's
  `tile_fn` on (8, 128) tiles, at tests/test_stan_frontend.py:411's
  tolerances (logp rtol 1e-4, atol 1e-3; the gradient 1e-5 of its largest
  component), and against the eager model (autograd of the interpretation);
- the plain NUTS tree against the JAX Pallas kernel interpreted, depth 3,
  zero bits, as tests/test_torch_generated_group.py holds eight schools
  (x and r at rtol 1e-4, atol 1e-4; depth, leapfrogs and moved exactly; the
  densities, delta_h and accept_stat at rtol 1e-4 and an atol of 1e-4 +
  2e-5 of the largest |logp| in the tree: the frontends round a density of
  magnitude ~90 (student-t) to other float32 ulps, and 16 leapfrogs take
  that to ~8e-4 in delta_h). The JAX tile
  model's data constants are passed as its `extra` inputs (Pallas refuses a
  kernel that captures arrays).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smcnuts_torch import stan as tstan
from smcnuts_torch.models.base import CallableModel
from smcnuts_torch.ops.draws import ZERO_BITS
from smcnuts_torch.ops.nuts_cuda import STAT_KEYS, nuts_tree_plain
from smcnuts_tpu import stan as jstan
from smcnuts_tpu.ops.nuts_pallas import TileModel, nuts_batch_pallas_fused

torch.set_num_threads(2)

VON_MISES = """
data { int<lower=1> N; vector[N] y; }
parameters { real mu; real<lower=0> kappa; }
model {
  mu ~ normal(0, 1);
  kappa ~ gamma(2, 0.5);
  y ~ von_mises(mu, kappa);
}
"""
SKEW_NORMAL = """
data { int<lower=1> N; vector[N] x; vector[N] y; }
parameters { real a; real b; real<lower=0> omega; real alpha; }
model {
  a ~ normal(0, 5);
  b ~ normal(0, 5);
  omega ~ normal(0, 2);
  alpha ~ normal(0, 3);
  y ~ skew_normal(a + b * x, omega, alpha);
}
"""
STUDENT_T = """
data { int<lower=1> N; vector[N] x; vector[N] y; }
parameters { real a; real b; real<lower=0> sigma; real<lower=1> nu; }
model {
  a ~ normal(0, 5);
  b ~ normal(0, 5);
  sigma ~ normal(0, 2);
  nu ~ gamma(2, 0.1);
  y ~ student_t(nu, a + b * x, sigma);
}
"""
PROBIT = """
data { int<lower=1> N; int<lower=1> K; matrix[N, K] X; array[N] int<lower=0, upper=1> y; }
parameters { real alpha; vector[K] beta; }
model {
  alpha ~ normal(0, 2);
  beta ~ normal(0, 1);
  y ~ bernoulli(Phi(alpha + X * beta));
}
"""
EXP_MOD_NORMAL = """
data { int<lower=1> N; vector[N] rt; }
parameters { real mu; real<lower=0> sigma; real<lower=0> lambda; }
model {
  mu ~ normal(0.5, 0.5);
  sigma ~ normal(0, 0.5);
  lambda ~ gamma(2, 0.5);
  rt ~ exp_mod_normal(mu, sigma, lambda);
}
"""
N = 24  # chip_smoke.py's programs take 200

def von_mises_data(seed=0):
    rng = np.random.default_rng(seed)
    return {"N": N, "y": rng.vonmises(0.5, 4.0, N).tolist()}

def skew_normal_data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=N)
    delta = 3.0 / np.sqrt(1 + 3.0 ** 2)
    z = delta * np.abs(rng.normal(size=N)) + np.sqrt(1 - delta ** 2) * rng.normal(size=N)
    return {"N": N, "x": x.tolist(), "y": (0.3 + 0.8 * x + 0.7 * z).tolist()}

def student_t_data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=N)
    return {"N": N, "x": x.tolist(), "y": (0.3 + 0.8 * x + 0.5 * rng.standard_t(4.0, N)).tolist()}

def probit_data(seed=0, K=5):
    from math import erf, sqrt
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, K))
    eta = 0.2 + X @ np.array([0.5, -1.0, 0.3, 0.8, -0.4])
    p = 0.5 * (1 + np.vectorize(erf)(eta / sqrt(2)))
    return {"N": N, "K": K, "X": X.tolist(), "y": (rng.uniform(size=N) < p).astype(int).tolist()}

def exp_mod_normal_data(seed=0):
    rng = np.random.default_rng(seed)
    return {"N": N, "rt": (rng.normal(0.4, 0.05, N) + rng.exponential(1 / 5.0, N)).tolist()}

PROGRAMS = {
    "von_mises": (VON_MISES, von_mises_data, [0.5, np.log(4.0)]),
    "skew_normal": (SKEW_NORMAL, skew_normal_data, [0.3, 0.8, np.log(0.7), 3.0]),
    "student_t": (STUDENT_T, student_t_data, [0.3, 0.8, np.log(0.5), np.log(4.0 - 1.0)]),
    "probit": (PROBIT, probit_data, [0.2, 0.5, -1.0, 0.3, 0.8, -0.4]),
    "exp_mod_normal": (EXP_MOD_NORMAL, exp_mod_normal_data, [0.4, np.log(0.05), np.log(5.0)]),
}


INTEGER_STATS = ("depth", "leapfrogs", "moved")
# The spread of each program's points around its generating values
# (unconstrained): probit's eta reaches |5| at 0.3, where float32 Phi is 1
# and log1m(Phi) loses its digits in both frontends.
SPREAD = {"probit": 0.1}
# The tree's step, 0.02 where not named: at 0.05 student-t's trees take the
# frontends' float32 roundings to 2e-3 in delta_h, and exp-modified-
# normal's sd of 0.05 curves the density so that eight leapfrogs take them
# to 2e-3 in x. Probit's
# points (the generating values) lie where its N = 24 posterior's gradient
# is large: at 0.05 its trees reach an eta where float32 Phi is 1, where
# the JAX tile model's gradient is NaN from the untaken branch of its select
# (the port's bernoulli selects the probability first and stays finite:
# tests/test_torch_stan_bernoulli.py) and the trees part; at 0.01 eight
# leapfrogs still take float32 rounding past 1e-4.
TREE_STEP = {"exp_mod_normal": 0.01, "probit": 0.002}


def compiled(name):
    src, data_fn, truth = PROGRAMS[name]
    data = data_fn()
    tm = tstan.compile_stan_program(src, data, name=name, tile=True)
    jm = jstan.compile_stan_program(src, data, name=name, tile=True)
    return tm, jm, np.asarray(truth)


@pytest.fixture(scope="module", params=list(PROGRAMS))
def program(request):
    return (request.param,) + compiled(request.param)


def test_generated_model_matches_jax_tile_fn(program):
    name, tm, jm, truth = program
    assert tm.tile_model.autodiff == jm.tile_model.autodiff == "reverse"
    rng = np.random.default_rng(5)
    x = truth + SPREAD.get(name, 0.3) * rng.normal(size=(1024, truth.size))
    tiles = [jnp.asarray(x[:, d].reshape(8, 128), jnp.float32) for d in range(jm.dim)]
    logp_j, grads_j = jax.jit(lambda ts, p: jm.tile_model.tile_fn((), ts, p))(
        tiles, jnp.full((8, 128), 0.7, jnp.float32))
    logp_j = np.asarray(logp_j).reshape(-1)
    g_j = np.stack([np.asarray(g).reshape(-1) for g in grads_j], axis=1)
    xt = torch.tensor(x, dtype=torch.float32)
    lp_t, g_t = tm.tile_model.logp_and_grad(xt, 0.7)
    np.testing.assert_allclose(lp_t.numpy(), logp_j, rtol=1e-4, atol=1e-3)
    scale = np.abs(g_j).max() + 1e-6
    np.testing.assert_allclose(g_t.numpy() / scale, g_j / scale, atol=1e-5)
    lp_e, g_e = CallableModel.logp_and_grad(tm, xt, 0.7)
    np.testing.assert_allclose(lp_e.numpy(), lp_t.numpy(), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(g_e.numpy() / scale, g_t.numpy() / scale, atol=1e-5)


def pallas_tile_model(jm):
    """The JAX tile model with the arrays its tile function captures passed
    as the kernel's `extra` inputs."""
    jt = jm.tile_model
    zeros = jnp.zeros((8, 128), jnp.float32)
    closed = jax.make_jaxpr(lambda ts, p: jt.tile_fn((), ts, p))([zeros] * jt.dim, zeros)

    shapes = [np.shape(c) for c in closed.consts]

    def tile_fn(refs, ts, p):
        consts = [r[...].reshape(shape) for r, shape in zip(refs, shapes)]
        out = jax.core.eval_jaxpr(closed.jaxpr, consts, *ts, p)
        return out[0], list(out[1:])

    # Flat: the kernel's SMEM inputs are vectors.
    return TileModel(jt.dim, tuple(jnp.asarray(c).reshape(-1) for c in closed.consts),
                     tile_fn, jt.autodiff)


def test_plain_tree_matches_pallas_kernel(program):
    name, tm, jm, truth = program
    rng = np.random.default_rng(6)
    x = (truth + 0.5 * SPREAD.get(name, 0.3) * rng.normal(size=(40, truth.size))).astype(
        np.float32)
    im = np.linspace(0.5, 2.0, truth.size).astype(np.float32)
    step = TREE_STEP.get(name, 0.02)
    jt = pallas_tile_model(jm)
    x_j, r_j, st_j = jax.jit(lambda x, s, e, p, im: nuts_batch_pallas_fused(
        jt, x, s, e, p, im, max_depth=3, interpret=True))(
        jnp.asarray(x), jnp.int32(6), jnp.float32(step), jnp.float32(0.7), jnp.asarray(im))
    x_t, r_t, st_t = nuts_tree_plain(tm, torch.as_tensor(x)[None], 6, step, 0.7,
                                     torch.as_tensor(im), 3, ZERO_BITS)
    np.testing.assert_allclose(x_t[0].numpy(), np.asarray(x_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(r_t[0].numpy(), np.asarray(r_j), rtol=1e-4, atol=1e-4)
    scale = max(np.abs(np.asarray(st_j[k])).max() for k in ("logp0", "logp_prop"))
    for k in STAT_KEYS:
        got, want = st_t[k][0].numpy(), np.asarray(st_j[k])
        if k in INTEGER_STATS:
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 + 2e-5 * scale,
                                       err_msg=k)
    assert st_t["depth"].max() >= 2 and st_t["moved"].mean() > 0.5
