"""The Stan `bernoulli(p)` of the port's frontend where float32 p rounds to 1
(or 0): probit regression's Phi(eta) for eta above ~5.4 (below ~-5.4).

The JAX frontend computes log(p) and log1p(-p) for every element and
selects by y (smcnuts_tpu/stan/math.py:251), so the untaken branch is -inf
there and autograd's gradient of the select is NaN. The port selects the
probability before each logarithm: the taken values are the same, the
gradient is finite and agrees with a float64 evaluation.

- the old select's gradient is NaN at those points, the port's finite and
  within 1e-5 (relative) of float64 autograd;
- values and gradients in p against the JAX frontend's `_bernoulli` on the
  same float32 probabilities, wherever JAX's gradient is finite, at
  tests/test_torch_stan_special.py's tolerances (values rtol 1e-4 / atol
  1e-3; gradients 1e-5 of the largest);
- a probit program at a point whose linear predictor passes 5.4: the eager
  model's gradient (autograd of the interpretation) and the generated
  model's are finite, within 1e-4 (relative to the largest) of the float64
  eager model's, and the JAX tile model's is NaN there.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smcnuts_torch import stan as tstan
from smcnuts_torch.models.base import CallableModel
from smcnuts_torch.stan import math as tmath
from smcnuts_tpu import stan as jstan
from smcnuts_tpu.stan import math as jmath

torch.set_num_threads(2)

PROBIT = """
data { int<lower=1> N; int<lower=1> K; matrix[N, K] X; array[N] int<lower=0, upper=1> y; }
parameters { real alpha; vector[K] beta; }
model {
  alpha ~ normal(0, 2);
  beta ~ normal(0, 1);
  y ~ bernoulli(Phi(alpha + X * beta));
}
"""


def _phi(eta):
    return 0.5 * (1.0 + torch.erf(eta / math.sqrt(2.0)))


def _grad(fn, eta):
    eta = eta.clone().requires_grad_(True)
    fn(eta).sum().backward()
    return eta.grad


# (y, eta): float32 Phi(eta) is exactly 1 (y = 1) or 0 (y = 0).
EDGES = [(1.0, 5.5), (1.0, 6.0), (1.0, 9.0), (0.0, -5.5), (0.0, -6.0), (0.0, -9.0)]


@pytest.mark.parametrize("y,eta", EDGES)
def test_bernoulli_gradient_finite_where_phi_rounds_to_one(y, eta):
    e32 = torch.tensor([eta], dtype=torch.float32)
    yt = torch.tensor([y])
    assert float(_phi(e32)) in (0.0, 1.0)

    def old(e):  # the select of both logarithms, as the JAX frontend has it
        p = _phi(e)
        return torch.where(yt > 0.5, torch.log(p), torch.log1p(-p))

    assert torch.isnan(_grad(old, e32)).all()
    got = _grad(lambda e: tmath._bernoulli(yt, _phi(e)), e32)
    want = _grad(lambda e: tmath._bernoulli(yt.double(), _phi(e)), e32.double())
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5)
    # The value is the taken branch's.
    value = tmath._bernoulli(yt, _phi(e32))
    assert torch.equal(value, old(e32))


def test_bernoulli_matches_jax_frontend_where_jax_is_finite():
    """Both frontends' `_bernoulli` on the same float32 probabilities (0 and
    1 included), values and gradients in p."""
    p = np.concatenate([[0.0, 1e-30, 1e-7], np.linspace(0.01, 0.99, 50),
                        [1.0 - 2 ** -23, 1.0 - 2 ** -24, 1.0]]).astype(np.float32)
    for y in (0.0, 1.0):
        yv = np.full_like(p, y)
        want = np.asarray(jmath._bernoulli(jnp.asarray(yv), jnp.asarray(p)))
        want_g = np.asarray(jax.grad(
            lambda q: jnp.sum(jmath._bernoulli(jnp.asarray(yv), q)))(jnp.asarray(p)))
        pt = torch.tensor(p)
        got = tmath._bernoulli(torch.tensor(yv), pt)
        got_g = _grad(lambda q: tmath._bernoulli(torch.tensor(yv), q), pt)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)
        assert torch.isfinite(got_g[(pt > 0) & (pt < 1)]).all()
        finite = np.isfinite(want_g)
        assert not finite.all()  # JAX's gradient is NaN at p = 0 or 1
        scale = np.abs(want_g[finite]).max()
        np.testing.assert_allclose(got_g.numpy()[finite] / scale, want_g[finite] / scale,
                                   atol=1e-5)


def test_bernoulli_of_a_data_scalar_takes_one_branch():
    p = torch.tensor(0.25)
    assert torch.equal(tmath._bernoulli(1, p), torch.log(p))
    assert torch.equal(tmath._bernoulli(0.0, p), torch.log1p(-p))


def test_probit_program_gradient_finite_past_phi_one():
    X = np.array([[1.0, 0.5], [-1.0, 2.0], [-2.0, -1.5], [2.0, 1.0]])
    data = {"N": 4, "K": 2, "X": X.tolist(), "y": [1, 1, 0, 1]}
    tm = tstan.compile_stan_program(PROBIT, data, name="probit", tile=True)
    jm = jstan.compile_stan_program(PROBIT, data, name="probit", tile=True)
    # alpha = 4, beta = (1, 1.5): eta = 5.75, 6, -0.25, 7.5 (observations 0,
    # 1 and 3 past 5.4, where float32 Phi is 1; the y = 0 observation where
    # float32 keeps the digits of 1 - Phi, so float32 and float64 can agree
    # to 1e-4).
    point = np.array([[4.0, 1.0, 1.5]])
    eta = point[0, 0] + X @ point[0, 1:]
    assert (eta > 5.4).sum() == 3
    x32 = torch.tensor(point, dtype=torch.float32)
    _, g_eager = CallableModel.logp_and_grad(tm, x32, 1.0)
    _, g_gen = tm.tile_model.logp_and_grad(x32, 1.0)
    _, g_64 = CallableModel.logp_and_grad(tm, x32.double(), 1.0)
    scale = float(g_64.abs().max())
    for g in (g_eager, g_gen):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.double().numpy() / scale, g_64.numpy() / scale,
                                   atol=1e-4)
    # The JAX frontend's gradient is NaN there (the select of both logs).
    tiles = [jnp.full((8, 128), v, jnp.float32) for v in point[0]]
    _, grads_j = jm.tile_model.tile_fn((), tiles, jnp.ones((8, 128), jnp.float32))
    assert np.isnan(np.asarray(grads_j[0])).all()
