"""The port's copy of the serial NumPy oracle (`smcnuts_torch.baselines.
numpy_smc`) against the JAX package's (`smcnuts_tpu/baselines/numpy_smc.py`).

- `NumpyArmaModel` and `run_numpy_smc` are the JAX file's code over the
  port's copy of the data: equal to the bit.
- `NumpyModelAdapter` over the port's models against the JAX adapter over
  the JAX models, at 64 points from a numpy seed, at the tolerances the
  port's model tests state against the JAX models (`tests/
  test_torch_models.py`, `tests/test_torch_prmwcd.py`).
- The cross-validation of `tests/test_oracle_crossval.py` with the port's
  sampler on the CPU: the port's `run_smc` and its oracle near the analytic
  truth and near each other, at that test's config and tolerances.
"""

import numpy as np
import pytest
import torch

from smcnuts_torch import SMCConfig, run_smc
from smcnuts_torch.baselines import numpy_smc
from smcnuts_torch.models import get_model, make_gaussian
from smcnuts_torch.models.prmwcd import ground_truth as prmwcd_ground_truth
from smcnuts_tpu.baselines import numpy_smc as jax_numpy_smc
from smcnuts_tpu.models import get_model as jax_get_model
from smcnuts_tpu.models import make_gaussian as jax_make_gaussian

torch.set_num_threads(2)

MEAN = np.array([1.0, -2.0])
VAR = np.array([0.5, 2.0])
PHI = 0.6


def _arma_points(n, seed):
    """Around the posterior and away from it, |theta| < 1 (the MA
    recurrence stable, as wherever the sampler spends time)."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.normal(0.0, 0.5, n), rng.uniform(-1.0, 1.5, n),
                     rng.uniform(-0.9, 0.9, n), rng.normal(np.log(0.2), 0.5, n)], axis=1)


def test_numpy_arma_model_equals_the_jax_copy():
    ours, theirs = numpy_smc.NumpyArmaModel(), jax_numpy_smc.NumpyArmaModel()
    assert np.array_equal(ours.y, theirs.y)
    x = _arma_points(32, seed=0)
    assert np.array_equal(ours.logpdf(x, PHI), theirs.logpdf(x, PHI))
    assert np.array_equal(ours.loglik(x), theirs.loglik(x))
    assert np.array_equal(ours.constrain(x), theirs.constrain(x))
    for row in x:
        assert np.array_equal(ours.logpdfgrad(row, PHI), theirs.logpdfgrad(row, PHI))
        assert ours.logpdf(row) == theirs.logpdf(row)


@pytest.mark.parametrize("lkernel", ["forwardsLKernel", "GaussianApproxLKernel",
                                     "asymptoticLKernel"])
def test_run_numpy_smc_equals_the_jax_copy(lkernel):
    tempering = lkernel == "asymptoticLKernel"
    ours = numpy_smc.run_numpy_smc(numpy_smc.NumpyArmaModel(), 8, 2, 0.01,
                                   lkernel=lkernel, tempering=tempering, seed=0)
    theirs = jax_numpy_smc.run_numpy_smc(jax_numpy_smc.NumpyArmaModel(), 8, 2, 0.01,
                                         lkernel=lkernel, tempering=tempering, seed=0)
    assert list(ours) == list(theirs)
    for key in theirs:
        assert ours[key].dtype == theirs[key].dtype, key
        assert np.array_equal(ours[key], theirs[key]), key


def _points(name, n=64, seed=3):
    rng = np.random.default_rng(seed)
    if name == "arma":
        return _arma_points(n, seed)
    if name == "prmwcd":
        # Half near the posterior, half from an early iteration's N(0, 0.3)
        # cloud (tests/test_torch_prmwcd.py).
        mean, var = prmwcd_ground_truth()
        centre = np.concatenate([mean[:12], np.log(mean[12:])])
        sd = np.sqrt(np.concatenate([var[:12], [0.1]]))
        near = centre + 0.5 * sd * rng.normal(size=(n // 2, 13))
        return np.concatenate([near, rng.normal(0.0, 0.3, (n - n // 2, 13))])
    return rng.normal(0.0, 2.0, (n, 2))


def _models(name):
    if name == "gaussian":
        return (make_gaussian(MEAN, VAR, prior_var=np.ones(2)),
                jax_make_gaussian(MEAN, VAR, prior_var=np.ones(2)))
    return get_model(name), jax_get_model(name)


@pytest.mark.parametrize("name", ["arma", "prmwcd", "gaussian"])
def test_adapter_matches_the_jax_adapter(name):
    """Values at rtol 1e-5 + atol 1e-4 and gradients at rtol 1e-4 + atol
    1e-3 (tests/test_torch_models.py: the two packages sum in other
    orders); PRMwCD's 100-term sums at rtol 1e-4 plus 32 float32 spacings
    of the value. Each method on one row and on all 64 rows at once."""
    ours, theirs = (a(m) for a, m in zip(
        (numpy_smc.NumpyModelAdapter, jax_numpy_smc.NumpyModelAdapter), _models(name)))
    x = _points(name)
    rtol, atol = (1e-4, 0.0) if name == "prmwcd" else (1e-5, 1e-4)
    for phi in (1.0, PHI):
        want = np.array([theirs.logpdf(row, phi) for row in x])
        spacing = 32 * np.spacing(np.abs(want).astype(np.float32)) if name == "prmwcd" else 0
        got_rows = np.array([ours.logpdf(row, phi) for row in x])
        for got in (got_rows, ours.logpdf(x, phi)):
            assert got.dtype == np.float64
            assert np.all(np.abs(got - want) <= atol + spacing + rtol * np.abs(want))
        want_g = np.stack([theirs.logpdfgrad(row, phi) for row in x])
        got_g = np.stack([ours.logpdfgrad(row, phi) for row in x])
        assert got_g.dtype == want_g.dtype == np.float32
        np.testing.assert_allclose(got_g, want_g, rtol=1e-4, atol=1e-3)
        np.testing.assert_array_equal(ours.logpdfgrad(x, phi), got_g)
    want = theirs.loglik(x)
    spacing = 32 * np.spacing(np.abs(want).astype(np.float32)) if name == "prmwcd" else 0
    for got in (np.array([ours.loglik(row) for row in x]), ours.loglik(x)):
        assert np.all(np.abs(got - want) <= atol + spacing + rtol * np.abs(want))
    want_c = theirs.constrain(x)
    for got in (np.stack([ours.constrain(row) for row in x]), ours.constrain(x)):
        assert got.dtype == want_c.dtype == np.float32
        np.testing.assert_allclose(got, want_c, rtol=1e-6)


@pytest.mark.parametrize(
    "lkernel,tempering",
    [
        ("forwardsLKernel", False),
        ("asymptoticLKernel", True),
    ],
)
def test_oracle_crossval(lkernel, tempering):
    """tests/test_oracle_crossval.py with the port's sampler and oracle."""
    model = make_gaussian(MEAN, VAR, prior_var=np.ones(2))
    n, k = 192, 8
    cfg = SMCConfig(n_particles=n, n_iterations=k, step_size=0.5,
                    lkernel=lkernel, tempering=tempering)
    torch_means = [run_smc(model, cfg, seed, "cpu").mean_estimate[-1].numpy()
                   for seed in range(3)]
    adapter = numpy_smc.NumpyModelAdapter(model)
    np_means = [
        numpy_smc.run_numpy_smc(adapter, n, k, 0.5, lkernel=lkernel,
                                tempering=tempering, seed=seed)["mean_estimate"][-1]
        for seed in range(3)
    ]
    tm, nm = np.mean(torch_means, axis=0), np.mean(np_means, axis=0)
    # Both estimators near the truth...
    np.testing.assert_allclose(tm, MEAN, atol=0.3)
    np.testing.assert_allclose(nm, MEAN, atol=0.3)
    # ...and near each other.
    np.testing.assert_allclose(tm, nm, atol=0.4)
