"""PRMwCD in the kernel's group order: W lanes a particle, the observations
split over them and the lane partials reduced by an xor butterfly
(`csrc/prmwcd_model.cuh`), and its plain version
`PrmwcdModel.logp_and_grad(x, phi, group=W)`.

- Emulation: a numpy float32 scalar emulation of the device function,
  written from the CUDA source (a loop over the lanes, each over its
  observations l, l + W, ...; then the butterfly; then the prior), equals
  `logp_and_grad(group=W)` to the bit for W in {1, 16, 32} at phi 1.0 and
  0.4. Every add and multiply is a numpy float32 operation in the kernel's
  order; exp and log are torch's float32 functions applied to the
  emulation's own arguments one scalar at a time (numpy's float32 exp and log
  differ from torch's in the last bit, and the point here is the order).
- W = 1 equals the sequential order, written out below as it stood before
  the group design (one stacked accumulator over the observations in order),
  to the bit.
- Against JAX, at the kernel's width (W = 16) and at W = 32:
  `logp_and_grad(group=W)` against `prmwcd_tile_model(...).tile_fn` at the
  tolerances of tests/test_torch_prmwcd.py; the plain tree at W against
  `nuts_batch_pallas_fused` interpreted with zero bits (N = 40, depth 2), by
  the contract of `_assert_outputs_match` there.
- W = 16 and 32 against W = 1: the one-leapfrog r-given tree of
  tests/test_torch_prmwcd.py runs at the kernel's width, W = 16, where its
  accept_stat reads 1.8e-4 from JAX, inside its atol + rtol |value|; at
  W = 32 it would read 2.1e-4, past it (a last-bit change of a logp near
  -1,500 moves exp(joint - H0) by ~1e-4), so here the group orders are held
  to the sequential one within the float32 summation bound.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smcnuts_torch.models import PrmwcdModel
from smcnuts_torch.models.prmwcd import GROUP, ground_truth
from smcnuts_torch.ops.draws import ZERO_BITS
from smcnuts_torch.ops.nuts_cuda import STAT_KEYS, nuts_tree_plain
from smcnuts_tpu.models import make_prmwcd
from smcnuts_tpu.ops.nuts_pallas import nuts_batch_pallas_fused

torch.set_num_threads(2)

D = 13
F = np.float32
U = 2.0 ** -24  # float32 unit roundoff
PHIS = [1.0, 0.4]
WIDTHS = [1, 16, 32]
INTEGER_STATS = ("depth", "leapfrogs", "moved")


@pytest.fixture(scope="module")
def model():
    return PrmwcdModel()


def _points(n, seed, spread=1.0):
    """Near the posterior: the ground-truth mean (Gamma on the log scale)
    plus `spread` posterior sd of noise, none exactly zero."""
    rng = np.random.default_rng(seed)
    mean, var = ground_truth()
    centre = np.concatenate([mean[:12], np.log(mean[12:])])
    sd = np.sqrt(np.concatenate([var[:12], var[12:] / mean[12:] ** 2]))
    return (centre + spread * sd * rng.normal(size=(n, D))).astype(np.float32)


def _texp(v):
    return F(torch.exp(torch.tensor(v, dtype=torch.float32)).item())


def _tlog(v):
    return F(torch.log(torch.tensor(v, dtype=torch.float32)).item())


def _emulate(model, x, phi, W):
    """logp_grad of csrc/prmwcd_model.cuh at group width W, one particle
    (row of x) at a time, every lane of the group in turn."""
    y = model.y.numpy().astype(F)
    X = model.X.numpy().astype(F)
    n_obs, n_cov = X.shape
    M = n_cov + 1
    q, qm1 = F(model.q), F(model.q - 1.0)
    lgamma_const, ig_const = F(model.lgamma_const), F(model.ig_const)
    phi = F(phi)
    lps, grads = [], []
    for row in x:
        b, g = row[:M], row[M]
        zero = b[0] * F(0.0)
        partials = []
        for lane in range(W):
            ll = zero + lgamma_const if lane == 0 else zero
            s_resid = zero
            s_cov = [zero] * n_cov
            for i in range(lane, n_obs, W):
                Xi = X[i]
                eta = b[0]
                for j in range(n_cov):
                    eta = eta + Xi[j] * b[j + 1]
                mu = _texp(eta)
                yi = y[i]
                ll = (ll + yi * eta) - mu
                resid = yi - mu
                s_resid = s_resid + resid
                for j in range(n_cov):
                    s_cov[j] = s_cov[j] + resid * Xi[j]
            partials.append([ll, s_resid] + s_cov)
        o = W // 2
        while o:  # v = v + __shfl_xor_sync(mask, v, o), every lane at once
            partials = [[a + c for a, c in zip(partials[lane], partials[lane ^ o])]
                        for lane in range(W)]
            o //= 2
        ll, s_resid, *s_cov = partials[0]

        inv_gamma = _texp(-g)
        ep_sum = zero
        grad = [None] * (M + 1)
        for j in range(1, M):
            bj = b[j]
            lab = _tlog(abs(bj)) - g
            ep_sum = ep_sum + _texp(q * lab)
            sign = F(1.0) if bj > 0 else (F(-1.0) if bj < 0 else bj)
            grad[j] = ((-q * _texp(qm1 * lab)) * sign) * inv_gamma
        lprior = ig_const - F(3.0) * g
        lprior = lprior - F(1.3) * inv_gamma
        lprior = lprior + g
        lprior = lprior - F(M - 1) * g
        lprior = lprior - ep_sum
        gp_g = F(-3.0) + F(1.3) * inv_gamma
        gp_g = gp_g + F(1.0)
        gp_g = gp_g - F(M - 1)
        gp_g = gp_g + q * ep_sum
        grad[0] = phi * s_resid
        for j in range(n_cov):
            grad[j + 1] = grad[j + 1] + phi * s_cov[j]
        grad[M] = gp_g
        lps.append(lprior + phi * ll)
        grads.append(grad)
    return np.array(lps, F), np.array(grads, F)


def _sequential(model, x, phi):
    """logp_and_grad as it was written before the group design: the sums over
    observations in sequence on one stacked (P, M + 1) accumulator."""
    y, X = model.y.float(), model.X.float()
    n_obs, n_cov = X.shape
    M = n_cov + 1
    q = model.q
    b, g = x[:, :M], x[:, M]
    zero = b[:, 0] * 0.0
    eta = b[:, 0:1].expand(-1, n_obs)
    for j in range(n_cov):
        eta = eta + X[:, j] * b[:, j + 1:j + 2]
    mu = torch.exp(eta)
    resid = y - mu
    up = torch.cat([(y * eta)[..., None], resid[..., None], resid[..., None] * X], dim=2)
    down = torch.cat([mu[..., None], torch.zeros_like(mu)[..., None].expand(-1, -1, M)],
                     dim=2)
    acc = torch.stack([zero + model.lgamma_const] + [zero] * M, dim=1)
    for i in range(n_obs):
        acc = (acc + up[:, i]) - down[:, i]
    ll, s_resid, s_cov = acc[:, 0], acc[:, 1], acc[:, 2:]
    inv_gamma = torch.exp(-g)
    lab = torch.log(torch.abs(b[:, 1:])) - g[:, None]
    pow_q = torch.exp(q * lab)
    gp_beta = -q * torch.exp((q - 1.0) * lab) * torch.sign(b[:, 1:]) * inv_gamma[:, None]
    ep_sum = zero
    for j in range(n_cov):
        ep_sum = ep_sum + pow_q[:, j]
    lprior = model.ig_const - 3.0 * g - 1.3 * inv_gamma + g - (M - 1) * g - ep_sum
    gp_g = -3.0 + 1.3 * inv_gamma + 1.0 - (M - 1) + q * ep_sum
    logp = lprior + phi * ll
    grad = torch.cat([(phi * s_resid)[:, None], gp_beta + phi * s_cov, gp_g[:, None]],
                     dim=1)
    return logp, grad


def test_the_kernel_width_is_a_half_warp():
    assert GROUP == 16


@pytest.mark.parametrize("phi", PHIS)
@pytest.mark.parametrize("W", WIDTHS)
def test_emulation_equals_plain_group_order_to_the_bit(model, W, phi):
    x = _points(3, seed=W)
    lp, g = model.logp_and_grad(torch.as_tensor(x), phi, group=W)
    lp_e, g_e = _emulate(model, x, phi, W)
    np.testing.assert_array_equal(lp.numpy().view(np.uint32), lp_e.view(np.uint32))
    np.testing.assert_array_equal(g.numpy().view(np.uint32), g_e.view(np.uint32))


@pytest.mark.parametrize("phi", PHIS)
def test_group_1_is_the_sequential_order_to_the_bit(model, phi):
    x = torch.as_tensor(_points(64, seed=5))
    lp, g = model.logp_and_grad(x, phi, group=1)
    lp_s, g_s = _sequential(model, x, phi)
    assert torch.equal(lp, lp_s) and torch.equal(g, g_s)


def test_default_group_is_the_kernel_width(model):
    x = torch.as_tensor(_points(16, seed=6))
    for got, want in zip(model.logp_and_grad(x, 0.7),
                         model.logp_and_grad(x, 0.7, group=GROUP)):
        assert torch.equal(got, want)
    view = model.at_group(1)
    for got, want in zip(view.logp_and_grad(x, 0.7), model.logp_and_grad(x, 0.7, group=1)):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="power of two"):
        model.logp_and_grad(x, 0.7, group=12)


@pytest.mark.parametrize("phi", PHIS)
@pytest.mark.parametrize("W", [16, 32])
def test_group_order_matches_tile_fn(model, W, phi):
    """As tests/test_torch_prmwcd.py::test_logp_and_grad_matches_tile_fn, in
    a group order: rtol 1e-5 on logp, rtol and atol 1e-5 on the gradient."""
    x = _points(64, seed=7, spread=0.5)
    lp, g = model.logp_and_grad(torch.as_tensor(x), phi, group=W)
    lp_j, g_j = make_prmwcd().tile_model.tile_fn((), [jnp.asarray(c) for c in x.T],
                                                 jnp.float32(phi))
    g_j = np.stack([np.asarray(c) for c in g_j], axis=1)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lp_j), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), g_j, rtol=1e-5, atol=1e-5)


def _gamma(n):
    return n * U / (1.0 - n * U)


@pytest.mark.parametrize("phi", PHIS)
@pytest.mark.parametrize("W", [16, 32])
def test_group_order_within_the_summation_bound_of_group_1(model, W, phi):
    """Each order sums the same float32 terms: ll the lgamma constant and,
    per observation, y_i eta_i and -mu_i (n = 201 terms); s_resid the 100
    resid_i; s_cov_j the 100 resid_i X_ij. Any order of n - 1 additions lies
    within gamma_{n-1} sum|terms| of the exact sum (gamma_k = k u / (1 - k u),
    u = 2^-24), so the two orders' sums differ by at most 2 gamma_{n-1}
    sum|terms|. Scaling by phi and adding the prior, which both orders compute
    alike, rounds twice more on each side: logp and every gradient
    component are held to 2 gamma_{n+1} |phi| sum|terms| + 2 gamma_2 |value|.
    The terms are computed here in float64 from the same float32 eta."""
    x = torch.as_tensor(_points(256, seed=8))
    lp1, g1 = model.logp_and_grad(x, phi, group=1)
    lp_w, g_w = model.logp_and_grad(x, phi, group=W)
    y, X = model.y, model.X  # float64
    xd = x.double()
    eta = xd[:, :1] + xd[:, 1:12] @ X.T
    mu = torch.exp(eta)
    resid = y - mu
    s_ll = abs(model.lgamma_const) + (y * eta).abs().sum(1) + mu.sum(1)
    s_resid = resid.abs().sum(1)
    s_cov = (resid.abs()[:, :, None] * X.abs()).sum(1)
    sums = torch.cat([s_resid[:, None], s_cov, torch.zeros_like(s_resid)[:, None]], 1)
    tol_lp = 2 * _gamma(202) * abs(phi) * s_ll + 2 * _gamma(2) * lp1.double().abs()
    tol_g = 2 * _gamma(101) * abs(phi) * sums + 2 * _gamma(2) * g1.double().abs()
    assert bool(((lp_w.double() - lp1.double()).abs() <= tol_lp).all())
    assert bool(((g_w.double() - g1.double()).abs() <= tol_g).all())
    assert not torch.equal(lp_w, lp1)  # the orders do differ


@pytest.fixture(scope="module")
def fused():
    import jax

    tm = make_prmwcd().tile_model
    return jax.jit(lambda x, s, e, p, im: nuts_batch_pallas_fused(
        tm, x, s, e, p, im, max_depth=2, interpret=True))


def _tree_particles(n, seed):
    """As tests/test_torch_prmwcd.py makes them: three quarters within 0.25
    posterior sd of the mean, one quarter within 1 sd."""
    rng = np.random.default_rng(seed)
    mean, var = ground_truth()
    centre = np.concatenate([mean[:12], np.log(mean[12:])])
    sd = np.sqrt(np.concatenate([var[:12], var[12:] / mean[12:] ** 2]))
    scale = np.where(np.arange(n) < n // 4, 1.0, 0.25)[:, None]
    return (centre + scale * sd * rng.normal(size=(n, D))).astype(np.float32)


@pytest.mark.parametrize("W,seed,phi", [(16, 0, 1.0), (16, 1, 0.4), (32, 0, 1.0)])
def test_plain_tree_in_group_order_matches_pallas_kernel(model, fused, W, seed, phi):
    """Integers exactly; floats at atol/rtol 1e-4, delta_h at 1e-4 plus 32
    float32 spacings of logp0 (tests/test_torch_prmwcd.py says why)."""
    x = _tree_particles(40, seed)
    ones = [1.0] * D
    x_j, r_j, st_j = fused(jnp.asarray(x), jnp.int32(seed), jnp.float32(0.01),
                           jnp.float32(phi), jnp.asarray(ones, jnp.float32))
    x_t, r_t, st_t = nuts_tree_plain(model.at_group(W), torch.as_tensor(x)[None], seed,
                                     0.01, phi, torch.tensor(ones), 2, ZERO_BITS)
    np.testing.assert_allclose(x_t[0].numpy(), np.asarray(x_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(r_t[0].numpy(), np.asarray(r_j), rtol=1e-4, atol=1e-4)
    spacing = np.spacing(np.abs(np.asarray(st_j["logp0"])).astype(np.float32))
    for k in STAT_KEYS:
        ours, theirs = st_t[k][0].numpy(), np.asarray(st_j[k])
        if k in INTEGER_STATS:
            np.testing.assert_array_equal(ours, theirs, err_msg=k)
        elif k == "delta_h":
            assert np.all(np.abs(ours - theirs) <= 1e-4 + 32 * spacing), k
        else:
            np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=1e-4, err_msg=k)
    assert st_t["moved"].mean() > 0.5
