"""The port's arma model against the JAX package's, value for value.

float32: logp, logprior, loglik, constrain and the closed-form gradient
against `smcnuts_tpu.models.make_arma()` and `jax.grad`, at 64 random points.
float64: the closed-form gradient against torch.autograd of the port's own
logp (JAX's x64 mode is process-global, so the f64 check stays in torch).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smcnuts_torch.models import ArmaModel, get_model, make_gaussian
from smcnuts_torch.models.arma import default_step_size, ground_truth
from smcnuts_torch.ops.nuts_cuda import _model_data
from smcnuts_tpu.models import make_arma
from smcnuts_tpu.models.arma import default_step_size as jax_default_step_size
from smcnuts_tpu.models.arma import ground_truth as jax_ground_truth

torch.set_num_threads(2)

PHIS = [1.0, 0.4]


@pytest.fixture(scope="module")
def models():
    return ArmaModel(), make_arma()


def _points(n=64, seed=0):
    """Points around the posterior and well away from it; |theta| < 1 keeps
    the MA recurrence stable, as it is wherever the sampler spends time."""
    rng = np.random.default_rng(seed)
    x = np.stack([
        rng.normal(0.0, 0.5, n),
        rng.uniform(-1.0, 1.5, n),
        rng.uniform(-0.9, 0.9, n),
        rng.normal(np.log(0.2), 0.5, n),
    ], axis=1)
    return x.astype(np.float32)


@pytest.mark.parametrize("phi", PHIS)
def test_logp_matches_jax(models, phi):
    tm, jm = models
    x = _points()
    xt, xj = torch.as_tensor(x), jnp.asarray(x)
    np.testing.assert_allclose(
        tm.logp(xt, phi).numpy(), np.asarray(jm.logp_batch(xj, phi)),
        rtol=1e-5, atol=1e-4,
    )
    np.testing.assert_allclose(
        tm.logprior(xt).numpy(), np.asarray(jm.logprior_batch(xj)),
        rtol=1e-5, atol=1e-4,
    )
    np.testing.assert_allclose(
        tm.loglik(xt).numpy(), np.asarray(jm.loglik_batch(xj)),
        rtol=1e-5, atol=1e-4,
    )


@pytest.mark.parametrize("phi", PHIS)
def test_logp_and_grad_matches_jax_grad(models, phi):
    """Value at the logp tolerance. Gradient at rtol 1e-4: the JAX model
    sums 200 squared errors by an associative scan, the port in sequence,
    and the gradients' sums cancel across terms of both signs."""
    tm, jm = models
    x = _points(seed=1)
    lp, g = tm.logp_and_grad(torch.as_tensor(x), phi)
    lp_j, g_j = jax.vmap(jax.value_and_grad(lambda t: jm.logp(t, phi)))(
        jnp.asarray(x)
    )
    np.testing.assert_allclose(lp.numpy(), np.asarray(lp_j), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), rtol=1e-4, atol=1e-3)


def test_per_particle_phi(models):
    """phi may be one temperature per particle (runs sharing one call)."""
    tm, _ = models
    x = torch.as_tensor(_points(8, seed=2))
    phi = torch.linspace(0.1, 1.0, 8)
    lp, g = tm.logp_and_grad(x, phi)
    for i in range(8):
        lp_i, g_i = tm.logp_and_grad(x[i:i + 1], float(phi[i]))
        torch.testing.assert_close(lp[i:i + 1], lp_i, rtol=0, atol=0)
        torch.testing.assert_close(g[i:i + 1], g_i, rtol=0, atol=0)


def test_constrain_matches_jax(models):
    tm, jm = models
    x = _points(seed=3)
    np.testing.assert_allclose(
        tm.constrain(torch.as_tensor(x)).numpy(),
        np.asarray(jm.constrain_batch(jnp.asarray(x))), rtol=1e-6,
    )


@pytest.mark.parametrize("phi", PHIS)
def test_closed_form_grad_matches_autograd_f64(models, phi):
    tm, _ = models
    x = torch.as_tensor(_points(seed=4), dtype=torch.float64)
    lp, g = tm.logp_and_grad(x, phi)
    xr = x.clone().requires_grad_()
    lp_ref = tm.logp(xr, phi)
    (g_ref,) = torch.autograd.grad(lp_ref.sum(), xr)
    torch.testing.assert_close(lp, lp_ref.detach(), rtol=1e-10, atol=0)
    torch.testing.assert_close(g, g_ref, rtol=1e-10, atol=1e-10)


def test_ground_truth_and_step_size():
    mean, var = ground_truth()
    mean_j, var_j = jax_ground_truth()
    np.testing.assert_array_equal(mean, mean_j)
    np.testing.assert_array_equal(var, var_j)
    assert default_step_size() == jax_default_step_size()


def test_model_is_module_with_buffer():
    m = get_model("arma")
    assert isinstance(m, torch.nn.Module)
    assert dict(m.named_buffers())["y"].shape == (200,)
    assert m.dim == 4 and m.constrained_dim == 4


@pytest.mark.parametrize("name", ["gaussian", "eightschools", "logistic"])
def test_unported_models_raise(name):
    """The three models run; what still raises is a shape of them that the
    CUDA kernel is not instantiated for (ROADMAP Queue 2 item 6), and a name
    the registry does not know."""
    lib = SimpleNamespace(prmwcd_n_cov=11, eightschools_j=8, logistic_dim=8)
    model = {
        "gaussian": lambda: make_gaussian(np.zeros(4), np.ones(4)),
        "eightschools": lambda: get_model(name, y=np.zeros(5), sigma=np.ones(5)),
        "logistic": lambda: get_model(name, X=np.zeros((16, 3)), y=np.zeros(16)),
    }[name]()
    with pytest.raises(NotImplementedError, match="Queue 2 item 6"):
        _model_data(model, lib)
    with pytest.raises(KeyError, match="Unknown model"):
        get_model(name + "_")
