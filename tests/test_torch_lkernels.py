"""The L-kernel densities against the JAX package's, on the same inputs.

`gaussian_lkernel_logpdf` on well-conditioned clouds (positions and momenta
correlated, as after a NUTS move), D = 4 and 13: rtol 1e-3 of the JAX value
in float32 (the two sum the population moments and the small matrix products
in another order, and the conditional covariance is a difference of
covariances). In float64 the port is held to a numpy transcription of the
reference (np.cov, np.linalg.pinv, scipy-free Cholesky) at rtol 1e-8. The
forwards L-kernel is the momentum density at -r. The batched (B, N, D) form
equals each run alone, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smcnuts_torch import DiagNormalProposal
from smcnuts_torch.ops.lkernels import (
    RIDGE,
    _matmul,
    forward_lkernel_logpdf,
    gaussian_lkernel_logpdf,
)
from smcnuts_tpu import DiagNormalProposal as JaxDiagNormalProposal
from smcnuts_tpu.ops.lkernels import RIDGE as JAX_RIDGE
from smcnuts_tpu.ops.lkernels import forward_lkernel_logpdf as jax_forward_lkernel_logpdf
from smcnuts_tpu.ops.lkernels import gaussian_lkernel_logpdf as jax_gaussian_lkernel_logpdf

torch.set_num_threads(2)


def _cloud(n, d, seed, dtype=np.float32):
    """Positions with a non-trivial covariance and momenta that depend on
    them, plus noise: the joint the L-kernel conditions."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(d, d)) / np.sqrt(d) + np.eye(d)
    x = rng.normal(size=(n, d)) @ a.T + rng.normal(size=d)
    b = rng.normal(size=(d, d)) / np.sqrt(d)
    r = x @ b.T + rng.normal(size=(n, d))
    return r.astype(dtype), x.astype(dtype)


def _numpy_reference(r_new, x_new):
    """The reference's gaussian_lkernel.py:45-84 in float64 numpy."""
    n, d = x_new.shape
    X = np.concatenate([-r_new, x_new], axis=1)
    mu = X.mean(0)
    cov = np.cov(X.T, ddof=1)
    gain = cov[:d, d:] @ np.linalg.pinv(cov[d:, d:])
    c = cov[:d, :d] - gain @ cov[d:, :d] + RIDGE * np.eye(d)
    resid = -r_new - (mu[:d] + (x_new - mu[d:]) @ gain.T)
    maha = np.einsum("nd,nd->n", resid @ np.linalg.inv(c), resid)
    _, logdet = np.linalg.slogdet(c)
    return -0.5 * (maha + logdet + d * np.log(2 * np.pi))


@pytest.mark.parametrize("d", [4, 13])
@pytest.mark.parametrize("seed", [0, 1])
def test_gaussian_lkernel_matches_jax(d, seed):
    r, x = _cloud(512, d, seed)
    got = gaussian_lkernel_logpdf(torch.as_tensor(r), torch.as_tensor(x))
    want = jax_gaussian_lkernel_logpdf(jnp.asarray(r), jnp.asarray(x))
    assert got.shape == (512,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-3)
    assert RIDGE == JAX_RIDGE == 1e-6


@pytest.mark.parametrize("d", [4, 13])
def test_gaussian_lkernel_float64_matches_numpy_reference(d):
    r, x = _cloud(300, d, 2, np.float64)
    got = gaussian_lkernel_logpdf(torch.as_tensor(r), torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), _numpy_reference(r, x), rtol=1e-8)


@pytest.mark.parametrize("d", [4, 13])
def test_gaussian_lkernel_per_run_equals_each_run_alone(d):
    """(B, N, D): run b's density does not depend on the runs beside it."""
    clouds = [_cloud(128, d, s) for s in range(3)]
    r = torch.as_tensor(np.stack([c[0] for c in clouds]))
    x = torch.as_tensor(np.stack([c[1] for c in clouds]))
    got = gaussian_lkernel_logpdf(r, x)
    assert got.shape == (3, 128)
    for b in range(3):
        assert torch.equal(got[b], gaussian_lkernel_logpdf(r[b], x[b]))
        assert torch.equal(got[b:b + 1], gaussian_lkernel_logpdf(r[b:b + 1], x[b:b + 1]))


def test_gaussian_lkernel_is_a_density_of_the_conditional():
    """For jointly Gaussian (r, x) the L-kernel recovers the conditional of
    -r given x: its mean log-density is close to the true conditional's
    negative entropy."""
    rng = np.random.default_rng(5)
    n, d = 20000, 3
    x = rng.normal(size=(n, d))
    r = -(0.5 * x + 0.7 * rng.normal(size=(n, d)))  # -r | x ~ N(0.5 x, 0.49 I)
    got = gaussian_lkernel_logpdf(torch.as_tensor(r), torch.as_tensor(x))
    entropy = 0.5 * d * (1 + np.log(2 * np.pi * 0.49))
    np.testing.assert_allclose(float(got.mean()), -entropy, atol=0.02)


def test_degenerate_population_gives_nan_without_raising():
    """A conditional covariance that is not positive definite gives NaN (the
    JAX Cholesky's convention), with no exception and no host sync; the
    weights' masked logsumexp then drops the run's particles."""
    x = torch.randn(32, 2, generator=torch.Generator().manual_seed(0))
    r = torch.full((32, 2), float("nan"))
    out = gaussian_lkernel_logpdf(r, x)
    assert out.shape == (32,) and bool(torch.isnan(out).all())


def test_forward_lkernel_matches_jax():
    rng = np.random.default_rng(6)
    r = rng.normal(size=(20, 4)).astype(np.float32)
    var = (0.5, 1.0, 2.0, 4.0)
    got = forward_lkernel_logpdf(DiagNormalProposal(4, None, var).logpdf,
                                 torch.as_tensor(r))
    want = jax_forward_lkernel_logpdf(JaxDiagNormalProposal(4, None, var).logpdf,
                                      jnp.asarray(r))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_sequential_matmul_is_a_matmul():
    g = torch.Generator().manual_seed(1)
    a = torch.randn(3, 5, 7, dtype=torch.float64, generator=g)
    b = torch.randn(3, 7, 4, dtype=torch.float64, generator=g)
    torch.testing.assert_close(_matmul(a, b), a @ b, rtol=1e-12, atol=1e-12)
