"""The Gaussian, eight-schools and logistic models against the JAX package.

The JAX package gets these models' in-kernel gradients from `jax.vjp` traced
inside its Pallas kernel (`elementwise_tile_model`); the port writes each out
by hand, as a CUDA device function and as the plain `logp_and_grad` tested
here.

float32: logprior, loglik, logp and constrain against the JAX model, and the
closed-form gradient against `jax.grad` and against the JAX tile model's
`tile_fn` (the in-kernel vjp), at random points, rtol 1e-5 (the gradient with
an atol of 1e-5 x the largest component, for components that cancel to near
zero). float64: the closed form against torch.autograd of the port's own
logp, rtol 1e-10 (JAX's x64 mode is process-global, so the f64 check stays in
torch).

The plain tree with each model inlined against the JAX kernel interpreted on
the CPU (zero bits): r given at depth 0, the one-leapfrog identity, at the
tolerances of tests/test_nuts_pallas.py:149-157 (x 1e-6, r 1e-5, logp0 rtol
1e-5); momenta drawn inside at depth 3 against `nuts_batch_pallas_fused`,
integers exactly and floats at 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smcnuts_torch.models import (
    EightSchoolsModel,
    GaussianModel,
    LogisticModel,
    get_model,
    make_gaussian,
    tempered_moments,
)
from smcnuts_torch.ops.draws import ZERO_BITS
from smcnuts_torch.ops.nuts_cuda import STAT_KEYS, nuts_tree_plain
from smcnuts_tpu.models import get_model as jax_get_model
from smcnuts_tpu.models import make_gaussian as jax_make_gaussian
from smcnuts_tpu.models import tempered_moments as jax_tempered_moments
from smcnuts_tpu.ops.nuts_pallas import nuts_batch_pallas, nuts_batch_pallas_fused

torch.set_num_threads(2)

PHIS = [1.0, 0.4]
MEAN = np.arange(1.0, 6.0)
VAR = np.array([0.5, 2.0, 1.0, 1.5, 0.8])
PRIOR_VAR = 4.0 * np.ones(5)
MODELS = ("gaussian", "gaussian_no_prior", "eightschools", "logistic")
KERNEL_MODELS = ("gaussian", "eightschools", "logistic")
INTEGER_STATS = ("depth", "leapfrogs", "moved")


def _pair(name):
    if name == "gaussian":
        return (make_gaussian(MEAN, VAR, PRIOR_VAR),
                jax_make_gaussian(MEAN, VAR, prior_var=PRIOR_VAR))
    if name == "gaussian_no_prior":
        return make_gaussian(MEAN[:2], VAR[:2]), jax_make_gaussian(MEAN[:2], VAR[:2])
    return get_model(name), jax_get_model(name)


@pytest.fixture(scope="module")
def models():
    return {name: _pair(name) for name in MODELS}


def _points(dim, n=64, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.normal(size=(n, dim))).astype(np.float32)


@pytest.mark.parametrize("phi", PHIS)
@pytest.mark.parametrize("name", MODELS)
def test_densities_match_jax(models, name, phi):
    tm, jm = models[name]
    x = _points(tm.dim)
    xt, xj = torch.as_tensor(x), jnp.asarray(x)
    for ours, theirs in ((tm.logp(xt, phi), jm.logp_batch(xj, phi)),
                         (tm.logprior(xt), jm.logprior_batch(xj)),
                         (tm.loglik(xt), jm.loglik_batch(xj))):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(
        tm.constrain(xt).numpy(), np.asarray(jm.constrain_batch(xj)), rtol=1e-6,
        atol=1e-6)  # atol: theta_j = mu + tau tt_j cancels


@pytest.mark.parametrize("phi", PHIS)
@pytest.mark.parametrize("name", MODELS)
def test_logp_and_grad_matches_jax_grad_and_tile_fn(models, name, phi):
    tm, jm = models[name]
    x = _points(tm.dim, seed=1)
    lp, g = tm.logp_and_grad(torch.as_tensor(x), phi)
    lp_j, g_j = jax.vmap(jax.value_and_grad(lambda t: jm.logp(t, phi)))(jnp.asarray(x))
    lp_t, g_t = jm.tile_model.tile_fn((), [jnp.asarray(c) for c in x.T],
                                      jnp.float32(phi))
    g_t = np.stack([np.asarray(c) for c in g_t], axis=1)
    for lp_ref, g_ref in ((lp_j, g_j), (lp_t, g_t)):
        g_ref = np.asarray(g_ref)
        np.testing.assert_allclose(lp.numpy(), np.asarray(lp_ref), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(g.numpy(), g_ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(g_ref).max())


@pytest.mark.parametrize("phi", PHIS)
@pytest.mark.parametrize("name", MODELS)
def test_closed_form_grad_matches_autograd_f64(models, name, phi):
    tm, _ = models[name]
    x = torch.as_tensor(_points(tm.dim, seed=2), dtype=torch.float64)
    lp, g = tm.logp_and_grad(x, phi)
    xr = x.clone().requires_grad_()
    lp_ref = tm.logp(xr, phi)
    (g_ref,) = torch.autograd.grad(lp_ref.sum(), xr)
    torch.testing.assert_close(lp, lp_ref.detach(), rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(g, g_ref, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("name", MODELS)
def test_per_particle_phi(models, name):
    """phi may be one temperature per particle (runs sharing one call)."""
    tm, _ = models[name]
    x = torch.as_tensor(_points(tm.dim, 8, seed=3))
    phi = torch.linspace(0.1, 1.0, 8)
    lp, g = tm.logp_and_grad(x, phi)
    for i in range(8):
        lp_i, g_i = tm.logp_and_grad(x[i:i + 1], float(phi[i]))
        torch.testing.assert_close(lp[i:i + 1], lp_i, rtol=0, atol=0)
        torch.testing.assert_close(g[i:i + 1], g_i, rtol=0, atol=0)


def test_logistic_gradient_does_not_overflow():
    """|eta| of thousands: the softplus and its derivative stay finite, and
    the gradient is that of y eta - max(eta, 0) in the limit."""
    tm = get_model("logistic")
    x = torch.full((2, 8), 500.0)
    x[1] = -500.0
    lp, g = tm.logp_and_grad(x, 1.0)
    assert torch.isfinite(lp).all() and torch.isfinite(g).all()
    xr = x.double().requires_grad_()
    (g_ref,) = torch.autograd.grad(tm.logp(xr, 1.0).sum(), xr)
    torch.testing.assert_close(g.double(), g_ref, rtol=1e-5, atol=1e-5)


def test_eightschools_overflow_is_left_to_the_divergence_guard():
    """A huge log_tau overflows tau: the density is -inf (the JAX tile
    density's is NaN: its log-likelihood is inf - inf), with no guard in the
    model; the tree treats a non-finite leaf as divergent."""
    tm, jm = _pair("eightschools")
    x = _points(10, 4, seed=4)
    x[0, 1] = 200.0
    lp, g = tm.logp_and_grad(torch.as_tensor(x), 1.0)
    lp_t, _ = jm.tile_model.tile_fn((), [jnp.asarray(c) for c in x.T], jnp.float32(1.0))
    assert lp[0] == -np.inf and not np.isfinite(np.asarray(lp_t)[0])
    assert not torch.isfinite(g[0]).all()
    x_new, _, st = nuts_tree_plain(tm, torch.as_tensor(x)[None], 0, 0.02, 1.0, None,
                                   3, ZERO_BITS)
    assert st["moved"][0, 0] == 0 and torch.equal(x_new[0, 0], torch.as_tensor(x[0]))
    assert torch.isfinite(lp[1:]).all()


@pytest.mark.parametrize("phi", [0.0, 0.3, 1.0])
def test_tempered_moments_match_jax(phi):
    m, v = tempered_moments(MEAN, VAR, PRIOR_VAR, phi)
    m_j, v_j = jax_tempered_moments(MEAN, VAR, PRIOR_VAR, phi)
    np.testing.assert_array_equal(m, m_j)
    np.testing.assert_array_equal(v, v_j)


def test_models_are_modules_with_buffers():
    for name, cls, dim in (("eightschools", EightSchoolsModel, 10),
                           ("logistic", LogisticModel, 8)):
        m, jm = get_model(name), jax_get_model(name)
        assert isinstance(m, cls) and isinstance(m, torch.nn.Module)
        assert m.dim == dim == jm.dim and m.constrained_dim == jm.constrained_dim
        assert m.param_names == jm.param_names and m.name == jm.name
    g, jg = _pair("gaussian")
    assert isinstance(g, GaussianModel) and g.param_names == jg.param_names
    assert set(dict(g.named_buffers())) == {"mean", "var", "prior_var"}
    assert dict(get_model("logistic").named_buffers())["X"].shape == (64, 8)
    with pytest.raises(KeyError, match="Unknown model"):
        get_model("gaussian")  # no registry name, as in the JAX package


def test_kernel_data_blocks():
    """What the CUDA kernel stages for each model, as float32."""
    g = make_gaussian(MEAN[:3], VAR[:3], PRIOR_VAR[:3])
    assert g.kernel_data().tolist() == [1, 2, 3, 0.5, 2, 1, 4, 4, 4]
    assert g.kernel_scalars()[2] == 1.0
    assert make_gaussian(MEAN[:3], VAR[:3]).kernel_data().numel() == 6
    assert make_gaussian(MEAN[:3], VAR[:3]).kernel_scalars()[2] == 0.0
    e = get_model("eightschools")
    assert e.kernel_data().shape == (24,) and e.kernel_scalars() == ()
    np.testing.assert_allclose(e.kernel_data()[16:].numpy(),
                               np.log(e.sigma.numpy()), rtol=1e-6)
    lg = get_model("logistic")
    assert lg.kernel_data().shape == (64 * 9,) and lg.kernel_data().dtype == torch.float32
    # The rows [X_i, y_i] at a stride of D + 1 = 9 (odd: a group's lanes read
    # distinct shared-memory banks).
    rows = lg.kernel_data().view(64, 9)
    assert torch.equal(rows[:, :8], lg.X.float()) and torch.equal(rows[:, 8], lg.y.float())
    np.testing.assert_allclose(lg.kernel_scalars(), (1 / 6.25, lg.prior_const))


@pytest.fixture(scope="module")
def pallas(models):
    """One jitted interpreted kernel per model and form."""
    out = {}
    for name in KERNEL_MODELS:
        tm = models[name][1].tile_model
        out[name] = (
            jax.jit(lambda x, s, e, p, im, tm=tm: nuts_batch_pallas_fused(
                tm, x, s, e, p, im, max_depth=3, interpret=True)),
            jax.jit(lambda x, r, e, p, im, tm=tm: nuts_batch_pallas(
                tm, x, r, 0, e, p, im, max_depth=0, interpret=True)),
        )
    return out


# A step size per model at which the zero-bits trees (every momentum 5.77)
# stay where float32 differences do not grow past 1e-4 in three doublings.
STEPS = {"gaussian": 0.05, "eightschools": 0.02, "logistic": 0.02}


@pytest.mark.parametrize("name", KERNEL_MODELS)
def test_r_given_depth0_is_one_leapfrog(models, pallas, name):
    tm, jm = models[name]
    D = tm.dim
    rng = np.random.default_rng(1)
    x = rng.normal(0, 0.3, (16, D)).astype(np.float32)
    r = rng.normal(size=(16, D)).astype(np.float32)
    phi, eps = 0.7, 0.05
    im = np.linspace(0.5, 2.0, D).astype(np.float32)
    x_t, r_t, st_t = nuts_tree_plain(
        tm, torch.as_tensor(x)[None], 0, eps, phi, torch.as_tensor(im), 0,
        ZERO_BITS, r=torch.as_tensor(r)[None])
    x_j, r_j, st_j = pallas[name][1](jnp.asarray(x), jnp.asarray(r),
                                     jnp.float32(eps), jnp.float32(phi),
                                     jnp.asarray(im))
    np.testing.assert_allclose(x_t[0].numpy(), np.asarray(x_j), atol=1e-6)
    np.testing.assert_allclose(r_t[0].numpy(), np.asarray(r_j), atol=1e-5)
    for k in ("logp0", "logp_prop"):
        np.testing.assert_allclose(st_t[k][0].numpy(), np.asarray(st_j[k]),
                                   rtol=1e-5, atol=1e-5)
    vg = jax.vmap(jax.value_and_grad(lambda t: jm.logp(t, phi)))
    lp0, g0 = vg(jnp.asarray(x))
    r_half = r + 0.5 * eps * np.asarray(g0)
    x_exp = x + eps * im * r_half
    _, g1 = vg(jnp.asarray(x_exp))
    r_exp = r_half + 0.5 * eps * np.asarray(g1)
    np.testing.assert_allclose(x_t[0].numpy(), x_exp, atol=1e-6)
    np.testing.assert_allclose(r_t[0].numpy(), r_exp, atol=1e-5)
    np.testing.assert_allclose(st_t["logp0"][0].numpy(), np.asarray(lp0),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("phi", PHIS)
@pytest.mark.parametrize("name", KERNEL_MODELS)
def test_plain_tree_matches_pallas_kernel_depth3(models, pallas, name, phi):
    tm, _ = models[name]
    D = tm.dim
    x = _points(D, 40, seed=5, scale=0.5)
    im = np.linspace(0.5, 2.0, D).astype(np.float32)
    eps = STEPS[name]
    x_j, r_j, st_j = pallas[name][0](jnp.asarray(x), jnp.int32(3), jnp.float32(eps),
                                     jnp.float32(phi), jnp.asarray(im))
    x_t, r_t, st_t = nuts_tree_plain(
        tm, torch.as_tensor(x)[None], 3, eps, phi, torch.as_tensor(im), 3,
        ZERO_BITS)
    np.testing.assert_allclose(x_t[0].numpy(), np.asarray(x_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(r_t[0].numpy(), np.asarray(r_j), rtol=1e-4, atol=1e-4)
    for k in STAT_KEYS:
        got, want = st_t[k][0].numpy(), np.asarray(st_j[k])
        if k in INTEGER_STATS:
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=k)
    assert st_t["depth"].max() >= 2 and st_t["moved"].mean() > 0.5
