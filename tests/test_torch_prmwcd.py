"""The port's PRMwCD model and its NUTS trees against the JAX package.

float32: logprior, loglik, logp, constrain and the closed-form gradient
against `smcnuts_tpu.models.make_prmwcd()` and `jax.grad` at random points,
and the closed form against the JAX tile model's `tile_fn` (the math of the
Pallas kernel the CUDA kernel replaces). float64: the closed form against
torch.autograd of the port's own logp.

The plain tree with PRMwCD inlined against `nuts_batch_pallas_fused` over
`prmwcd_tile_model`, interpreted with zero bits (one jitted kernel for the
module, N=40, max_depth 2, seed, phi and inverse mass as runtime values):
integer outputs exactly, floats at atol/rtol 1e-4 (delta_h: see
`_assert_outputs_match`); the plain tree sums in the kernel's group order
(W = 16 lanes a particle, tests/test_torch_prmwcd_group.py). Then the
r-given depth-0 tree, one leapfrog, against jax.grad, in the same order;
its accept_stat reads 1.8e-4 from JAX (an accept_stat near 1, inside
atol + rtol |value|; W = 32 reads 2.1e-4, past it, and
tests/test_torch_prmwcd_group.py holds that order to the sequential one
within the float32 summation bound). Under zero bits every momentum
component starts at 5.77 (Box-Muller of 2^-24), so the trajectories are
violent: at depth 3 the two implementations' last-bit differences grow past
1e-4 in the momenta.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smcnuts_torch.models import PrmwcdModel, get_model
from smcnuts_torch.models.prmwcd import default_step_size, ground_truth
from smcnuts_torch.ops.draws import ZERO_BITS
from smcnuts_torch.ops.nuts_cuda import STAT_KEYS, nuts_tree_plain
from smcnuts_tpu.models import make_prmwcd
from smcnuts_tpu.models.prmwcd import default_step_size as jax_default_step_size
from smcnuts_tpu.models.prmwcd import ground_truth as jax_ground_truth
from smcnuts_tpu.ops.nuts_pallas import nuts_batch_pallas, nuts_batch_pallas_fused

torch.set_num_threads(2)

PHIS = [1.0, 0.4]
D = 13
N, MAX_DEPTH = 40, 2
INTEGER_STATS = ("depth", "leapfrogs", "moved")
IM = [0.5, 2.0, 1.5, 0.25, 1.0, 0.8, 1.2, 0.6, 1.4, 0.9, 1.1, 0.7, 3.0]
CASES = {
    "phi1": (0, 1.0, [1.0] * D),
    "phi0.4": (1, 0.4, [1.0] * D),
    "inv_mass": (2, 1.0, IM),
}


@pytest.fixture(scope="module")
def models():
    return PrmwcdModel(), make_prmwcd()


def _points(n=64, seed=0):
    """Half near the posterior (ground-truth mean +- 0.5 sd), half from the
    N(0, 0.3) cloud of an early iteration."""
    rng = np.random.default_rng(seed)
    mean, var = jax_ground_truth()
    near = np.concatenate([mean[:12], np.log(mean[12:])]) + 0.5 * rng.normal(
        size=(n // 2, D)) * np.sqrt(np.concatenate([var[:12], [0.1]]))
    far = rng.normal(0.0, 0.3, (n - n // 2, D))
    return np.concatenate([near, far]).astype(np.float32)


def _tree_particles(n, seed):
    """Three quarters within 0.25 posterior sd of the posterior mean, one
    quarter within 1 sd, as a population at the main path's late iterations.
    (Far from the posterior the gradients reach 1e3, and XLA's and
    PyTorch's exp, a last bit apart, move the momenta by more than 1e-4
    within a few leapfrogs.)"""
    rng = np.random.default_rng(seed)
    mean, var = jax_ground_truth()
    centre = np.concatenate([mean[:12], np.log(mean[12:])])
    sd = np.sqrt(np.concatenate([var[:12], var[12:] / mean[12:] ** 2]))
    scale = np.where(np.arange(n) < n // 4, 1.0, 0.25)[:, None]
    return (centre + scale * sd * rng.normal(size=(n, D))).astype(np.float32)


@pytest.mark.parametrize("phi", PHIS)
def test_logp_matches_jax(models, phi):
    tm, jm = models
    x = _points()
    xt, xj = torch.as_tensor(x), jnp.asarray(x)
    for ours, theirs in ((tm.logp(xt, phi), jm.logp_batch(xj, phi)),
                         (tm.logprior(xt), jm.logprior_batch(xj)),
                         (tm.loglik(xt), jm.loglik_batch(xj))):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-4)


@pytest.mark.parametrize("phi", PHIS)
def test_logp_and_grad_matches_jax_grad(models, phi):
    """Value and gradient at rtol 1e-4; the gradient's atol 1e-3 covers
    components that cancel to near zero, summed in another order by
    JAX's matmul."""
    tm, jm = models
    x = _points(seed=1)
    lp, g = tm.logp_and_grad(torch.as_tensor(x), phi)
    lp_j, g_j = jax.vmap(jax.value_and_grad(lambda t: jm.logp(t, phi)))(
        jnp.asarray(x)
    )
    np.testing.assert_allclose(lp.numpy(), np.asarray(lp_j), rtol=1e-4)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("phi", PHIS)
def test_logp_and_grad_matches_tile_fn(models, phi):
    """The kernel's math (`prmwcd_tile_model(...).tile_fn`, evaluated on
    per-parameter rows as the Pallas kernel does) in the same order as the
    plain version: rtol 1e-5 (XLA's and PyTorch's exp/log differ in the
    last bits). A beta of exactly 0 gives a NaN gradient in both."""
    tm, jm = models
    x = _points(seed=2)
    x[3, 4] = 0.0
    lp, g = tm.logp_and_grad(torch.as_tensor(x), phi)
    lp_j, g_j = jm.tile_model.tile_fn((), [jnp.asarray(c) for c in x.T],
                                      jnp.float32(phi))
    g_j = np.stack([np.asarray(c) for c in g_j], axis=1)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lp_j), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), g_j, rtol=1e-5, atol=1e-5)
    assert np.isnan(g[3, 4].item()) and np.isnan(g_j[3, 4])


def test_per_particle_phi(models):
    tm, _ = models
    x = torch.as_tensor(_points(8, seed=3))
    phi = torch.linspace(0.1, 1.0, 8)
    lp, g = tm.logp_and_grad(x, phi)
    for i in range(8):
        lp_i, g_i = tm.logp_and_grad(x[i:i + 1], float(phi[i]))
        torch.testing.assert_close(lp[i:i + 1], lp_i, rtol=0, atol=0)
        torch.testing.assert_close(g[i:i + 1], g_i, rtol=0, atol=0)


def test_constrain_matches_jax(models):
    tm, jm = models
    x = _points(seed=4)
    np.testing.assert_allclose(
        tm.constrain(torch.as_tensor(x)).numpy(),
        np.asarray(jm.constrain_batch(jnp.asarray(x))), rtol=1e-6,
    )


@pytest.mark.parametrize("phi", PHIS)
def test_closed_form_grad_matches_autograd_f64(models, phi):
    tm, _ = models
    x = torch.as_tensor(_points(seed=5), dtype=torch.float64)
    lp, g = tm.logp_and_grad(x, phi)
    xr = x.clone().requires_grad_()
    (g_ref,) = torch.autograd.grad(tm.logp(xr, phi).sum(), xr)
    torch.testing.assert_close(lp, tm.logp(x, phi), rtol=1e-10, atol=0)
    torch.testing.assert_close(g, g_ref, rtol=1e-10, atol=1e-10)


def test_ground_truth_step_size_and_module():
    mean, var = ground_truth()
    mean_j, var_j = jax_ground_truth()
    np.testing.assert_array_equal(mean, mean_j)
    np.testing.assert_array_equal(var, var_j)
    assert default_step_size() == jax_default_step_size()
    for name in ("prmwcd", "PRMwCD"):
        m = get_model(name)
        assert isinstance(m, torch.nn.Module) and m.dim == D
        buffers = dict(m.named_buffers())
        assert buffers["y"].shape == (100,) and buffers["X"].shape == (100, 11)
        assert m.param_names == make_prmwcd().param_names


@pytest.fixture(scope="module")
def pallas(models):
    tm = models[1].tile_model
    fused = jax.jit(lambda x, s, e, p, im: nuts_batch_pallas_fused(
        tm, x, s, e, p, im, max_depth=MAX_DEPTH, interpret=True))
    given = jax.jit(lambda x, r, e, p, im: nuts_batch_pallas(
        tm, x, r, 0, e, p, im, max_depth=0, interpret=True))
    return fused, given


def _assert_outputs_match(x_t, r_t, st_t, x_j, r_j, st_j):
    """Integers exactly, floats at atol/rtol 1e-4. delta_h is a difference of
    log-densities of up to |1e4| (the lgamma constant alone is -1,500), whose
    100-term sums XLA's CPU code rounds differently from PyTorch (measured:
    up to 16 float32 spacings of logp0); delta_h is held to atol 1e-4 plus
    32 spacings of logp0."""
    np.testing.assert_allclose(x_t, x_j, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(r_t, r_j, rtol=1e-4, atol=1e-4)
    spacing = np.spacing(np.abs(st_j["logp0"]).astype(np.float32))
    for k in STAT_KEYS:
        if k in INTEGER_STATS:
            np.testing.assert_array_equal(st_t[k], st_j[k], err_msg=k)
        elif k == "delta_h":
            assert np.all(np.abs(st_t[k] - st_j[k]) <= 1e-4 + 32 * spacing), k
        else:
            np.testing.assert_allclose(st_t[k], st_j[k], rtol=1e-4, atol=1e-4,
                                       err_msg=k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_tree_matches_pallas_kernel(models, pallas, case):
    seed, phi, im = CASES[case]
    fused, _ = pallas
    x = _tree_particles(N, seed)
    x_j, r_j, st_j = fused(jnp.asarray(x), jnp.int32(seed), jnp.float32(0.01),
                           jnp.float32(phi), jnp.asarray(im, jnp.float32))
    x_t, r_t, st_t = nuts_tree_plain(
        models[0], torch.as_tensor(x)[None], seed, 0.01, phi,
        torch.tensor(im), MAX_DEPTH, ZERO_BITS,
    )
    _assert_outputs_match(
        x_t[0].numpy(), r_t[0].numpy(), {k: v[0].numpy() for k, v in st_t.items()},
        np.asarray(x_j), np.asarray(r_j), {k: np.asarray(v) for k, v in st_j.items()},
    )
    assert st_t["moved"].mean() > 0.5
    assert st_t["depth"].min() >= 1 and st_t["depth"].max() <= MAX_DEPTH + 1


@pytest.mark.parametrize("im", [[1.0] * D, IM], ids=["unit", "inv_mass"])
def test_r_given_depth0_is_one_leapfrog(models, pallas, im):
    _, given = pallas
    jm = models[1]
    rng = np.random.default_rng(4)
    x = rng.normal(0, 0.3, (16, D)).astype(np.float32)
    r = rng.normal(size=(16, D)).astype(np.float32)
    phi, eps = 0.7, 0.01
    im_np = np.asarray(im, np.float32)
    x_t, r_t, st_t = nuts_tree_plain(
        models[0], torch.as_tensor(x)[None], 0, eps, phi, torch.tensor(im),
        0, ZERO_BITS, r=torch.as_tensor(r)[None],
    )
    x_j, r_j, st_j = given(jnp.asarray(x), jnp.asarray(r), jnp.float32(eps),
                           jnp.float32(phi), jnp.asarray(im_np))
    _assert_outputs_match(
        x_t[0].numpy(), r_t[0].numpy(), {k: v[0].numpy() for k, v in st_t.items()},
        np.asarray(x_j), np.asarray(r_j), {k: np.asarray(v) for k, v in st_j.items()},
    )
    vg = jax.vmap(jax.value_and_grad(lambda t: jm.logp(t, phi)))
    _, g0 = vg(jnp.asarray(x))
    r_half = r + 0.5 * eps * np.asarray(g0)
    x_exp = x + eps * im_np * r_half
    _, g1 = vg(jnp.asarray(x_exp))
    r_exp = r_half + 0.5 * eps * np.asarray(g1)
    np.testing.assert_allclose(x_t[0].numpy(), x_exp, atol=1e-6)
    np.testing.assert_allclose(r_t[0].numpy(), r_exp, atol=1e-4)
