"""Eight schools in the kernel's group order: W lanes a particle, the schools
split over them and the lane partials reduced by an xor butterfly
(`csrc/eightschools_model.cuh`), and its plain version
`EightSchoolsModel.logp_and_grad(x, phi, group=W)`.

- Emulation: a numpy float32 scalar emulation of the device function,
  written from the CUDA source (the prior of mu and tau; a loop over the
  lanes, each over its schools l, l + W, ... on four partials; then the
  butterfly; then the gradient, each school's from the lane that owns it),
  equals `logp_and_grad(group=W)` to the bit for W in {1, 2, 4, 8} at phi
  1.0 and 0.4, on dispersed points and on a lane at log_tau 200 (a density
  that is not finite). Every add, multiply and division is a numpy float32
  operation in the kernel's order; exp and log1p are torch's float32
  functions applied to the emulation's own arguments one scalar at a time.
- Against JAX: each group order against the JAX tile density's value and
  in-kernel gradient (`tile_fn`) within the float32 bound of two sums of
  the same terms in two orders, with the terms' own differences; the plain
  tree at the kernel's width against `nuts_batch_pallas_fused` interpreted
  with zero bits at depth 3, at the tolerance of
  tests/test_torch_elementwise_models.py (integers exactly, floats at
  atol/rtol 1e-4).
- The library load holds the built kernel's width and block to
  models/eightschools.py, and the main entry refuses a model at another
  width.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smcnuts_torch.models import EightSchoolsModel, get_model
from smcnuts_torch.models.eightschools import GROUP
from smcnuts_torch.ops.draws import ZERO_BITS
from smcnuts_torch.ops.nuts_cuda import STAT_KEYS, nuts_tree_plain
from smcnuts_tpu.models import get_model as jax_get_model
from smcnuts_tpu.ops.nuts_pallas import nuts_batch_pallas_fused

torch.set_num_threads(2)

J, D = 8, 10
F = np.float32
U = 2.0 ** -24  # float32 unit roundoff
PHIS = [1.0, 0.4]
WIDTHS = [1, 2, 4, 8]
INTEGER_STATS = ("depth", "leapfrogs", "moved")
C_MU = F(1.60943791243410037460 + 0.91893853320467274178)
C_TAU = F(-1.14472988584940017414 - 1.60943791243410037460)
LOG_SQRT_2PI = F(0.91893853320467274178)
LOG_2 = F(0.69314718055994530942)
INV_5 = F(0.2)


@pytest.fixture(scope="module")
def model():
    return EightSchoolsModel()


def _points(n, seed, spread=1.0):
    """Around mu 4.4, log tau 1.2, tt 0 (sd 3, 0.5, 1), scaled by spread."""
    rng = np.random.default_rng(seed)
    c = np.array([4.4, 1.2] + [0.0] * J)
    sd = spread * np.array([3.0, 0.5] + [1.0] * J)
    return (c + sd * rng.normal(size=(n, D))).astype(np.float32)


def _texp(v):
    return F(torch.exp(torch.tensor(v, dtype=torch.float32)).item())


def _tlog1p(v):
    return F(torch.log1p(torch.tensor(v, dtype=torch.float32)).item())


def _emulate(model, x, phi, W):
    """logp_grad of csrc/eightschools_model.cuh at group width W, one
    particle (row of x) at a time, every lane of the group in turn, reading
    y, sigma and log sigma from `kernel_data()` as the kernel stages them."""
    data = model.kernel_data().numpy()
    y, sigma, log_sigma = data[:J], data[J:2 * J], data[2 * J:]
    phi = F(phi)
    lps, grads = [], []
    with np.errstate(over="ignore", invalid="ignore"):
        for b in x:
            mu, log_tau = b[0], b[1]
            tau = _texp(log_tau)
            zmu = mu * INV_5
            lp = (F(-0.5) * zmu) * zmu - C_MU
            zt = tau * INV_5
            zt2 = zt * zt
            lp = lp + (((C_TAU - _tlog1p(zt2)) + LOG_2) + log_tau)
            g_mu_lp = -zmu * INV_5
            g_lt_lp = F(1.0) - (F(2.0) * zt2) / (F(1.0) + zt2)
            zero = mu * F(0.0)
            partials, g_tt = [], [None] * J
            for lane in range(W):
                pt = lp if W == 1 else zero
                ll = g_mu = g_lt = zero
                for j in range(lane, J, W):
                    t = b[2 + j]
                    pt = (pt - (F(0.5) * t) * t) - LOG_SQRT_2PI
                    z = ((y[j] - mu) - tau * t) / sigma[j]
                    ll = ((ll - (F(0.5) * z) * z) - log_sigma[j]) - LOG_SQRT_2PI
                    zs = z / sigma[j]
                    g_mu = g_mu + zs
                    g_lt = g_lt + zs * (tau * t)
                    g_tt[j] = -t + phi * (zs * tau)  # lane j % W's, shuffled to all
                partials.append([pt, ll, g_mu, g_lt])
            o = W // 2
            while o:  # v = v + __shfl_xor_sync(mask, v, o), every lane at once
                partials = [[a + c for a, c in zip(partials[lane], partials[lane ^ o])]
                            for lane in range(W)]
                o //= 2
            pt, ll, g_mu, g_lt = partials[0]
            lp = pt if W == 1 else lp + pt
            grads.append([g_mu_lp + phi * g_mu, g_lt_lp + phi * g_lt] + g_tt)
            lps.append(lp + phi * ll)
    return np.array(lps, F), np.array(grads, F)


def _same_bits(a, b):
    a, b = np.asarray(a, F), np.asarray(b, F)
    return np.all((a.view(np.uint32) == b.view(np.uint32)) | (np.isnan(a) & np.isnan(b)))


def test_the_kernel_width_is_a_power_of_two_in_a_warp():
    assert GROUP in (1, 2, 4, 8, 16, 32)


@pytest.mark.parametrize("phi", PHIS)
@pytest.mark.parametrize("W", WIDTHS)
def test_emulation_equals_plain_group_order_to_the_bit(model, W, phi):
    x = _points(12, seed=W)
    x[-1, 1] = 200.0  # tau = inf: lp = -inf, a NaN gradient
    lp, g = model.logp_and_grad(torch.as_tensor(x), phi, group=W)
    lp_e, g_e = _emulate(model, x, phi, W)
    assert _same_bits(lp.numpy(), lp_e) and _same_bits(g.numpy(), g_e)
    assert np.isfinite(lp_e[:-1]).all() and lp_e[-1] == -np.inf


def test_default_group_is_the_kernel_width(model):
    x = torch.as_tensor(_points(16, seed=6))
    for got, want in zip(model.logp_and_grad(x, 0.7),
                         model.logp_and_grad(x, 0.7, group=GROUP)):
        assert torch.equal(got, want)
    view = model.at_group(1)
    assert view.group == 1 and model.group == GROUP and view.y is model.y
    for got, want in zip(view.logp_and_grad(x, 0.7), model.logp_and_grad(x, 0.7, group=1)):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="power of two"):
        model.logp_and_grad(x, 0.7, group=3)


def _gamma(n):
    return n * U / (1.0 - n * U)


@pytest.mark.parametrize("phi", PHIS)
@pytest.mark.parametrize("W", WIDTHS)
def test_group_order_within_the_summation_bound_of_jax_tile_fn(model, W, phi):
    """Both sides sum the same float32 terms in two orders: logp the priors'
    terms, the 8 tt prior terms (0.5 tt_j^2 + c) and phi times the 8
    likelihood terms (0.5 z_j^2 + log sigma_j + c); d/d mu the prior's and
    phi zs_j; d/d log_tau the prior's and phi zs_j tau tt_j. Any order of k
    additions lies within gamma_k sum|terms| of the exact sum (gamma_k =
    k u / (1 - k u), u = 2^-24), so two orders differ by at most twice that.
    The terms themselves differ by a few roundings: JAX divides by 5 where
    this side multiplies by 0.2, the two libraries' exp and log1p, and the
    vjp's own order of each term's operations (allowed 16 u of each term's
    size). Logp is held to (2 gamma_{4J+12} + 16 u) S + 2 gamma_2 |value|
    with S the sum of |terms|, each gradient component likewise over its own
    terms (gamma_{J+4}); d/d tt_j has no sum, 16 u (|tt_j| + phi |zs_j tau|).
    The terms are computed here in float64 from the float32 points."""
    x = _points(256, seed=8)
    lp, g = model.logp_and_grad(torch.as_tensor(x), phi, group=W)
    lp_j, g_j = jax_get_model("eightschools").tile_model.tile_fn(
        (), [jnp.asarray(c) for c in x.T], jnp.float32(phi))
    lp_j = np.asarray(lp_j, np.float64)
    g_j = np.stack([np.asarray(c) for c in g_j], axis=1).astype(np.float64)

    y, sigma = model.y.numpy(), model.sigma.numpy()
    xd = x.astype(np.float64)
    mu, log_tau, tt = xd[:, 0], xd[:, 1], xd[:, 2:]
    tau = np.exp(log_tau)
    z = (y - mu[:, None] - tau[:, None] * tt) / sigma
    zs = z / sigma
    zt2 = (tau / 5.0) ** 2
    prior = (np.abs(0.5 * (mu / 5.0) ** 2) + abs(float(C_MU)) + abs(float(C_TAU))
             + np.log1p(zt2) + float(LOG_2) + np.abs(log_tau))
    s_lp = (prior + (0.5 * tt ** 2 + float(LOG_SQRT_2PI)).sum(1)
            + phi * (0.5 * z ** 2 + np.abs(np.log(sigma)) + float(LOG_SQRT_2PI)).sum(1))
    tol_lp = (2 * _gamma(4 * J + 12) + 16 * U) * s_lp + 2 * _gamma(2) * np.abs(lp_j)
    assert np.all(np.abs(lp.numpy() - lp_j) <= tol_lp)

    s_mu = np.abs(mu) / 25.0 + phi * np.abs(zs).sum(1)
    s_lt = 1.0 + 2.0 * zt2 / (1.0 + zt2) + phi * np.abs(zs * tau[:, None] * tt).sum(1)
    s_tt = np.abs(tt) + phi * np.abs(zs * tau[:, None])
    tol_g = np.concatenate([
        ((2 * _gamma(J + 4) + 16 * U) * s)[:, None] for s in (s_mu, s_lt)
    ] + [16 * U * s_tt], axis=1) + 2 * _gamma(2) * np.abs(g_j)
    assert np.all(np.abs(g.numpy() - g_j) <= tol_g)


@pytest.mark.parametrize("phi", PHIS)
def test_group_orders_differ_from_the_sequential_one(model, phi):
    """The widths are different sums, not one sum relabelled: the bound
    above has work to do."""
    x = torch.as_tensor(_points(256, seed=9))
    lp1, g1 = model.logp_and_grad(x, phi, group=1)
    for W in WIDTHS[1:]:
        lp, g = model.logp_and_grad(x, phi, group=W)
        assert not torch.equal(lp, lp1) and not torch.equal(g[:, :2], g1[:, :2])
        assert torch.equal(g[:, 2:], g1[:, 2:])  # no sum: the same bits


@pytest.fixture(scope="module")
def fused():
    import jax

    tm = jax_get_model("eightschools").tile_model
    return jax.jit(lambda x, s, e, p, im: nuts_batch_pallas_fused(
        tm, x, s, e, p, im, max_depth=3, interpret=True))


@pytest.mark.parametrize("seed,phi", [(6, 1.0), (7, 0.4)])
def test_plain_tree_at_the_kernel_width_matches_pallas_kernel(model, fused, seed, phi):
    """As tests/test_torch_elementwise_models.py::
    test_plain_tree_matches_pallas_kernel_depth3, on other particles and
    seeds, with the model at the kernel's width: integers exactly, floats at
    atol/rtol 1e-4."""
    x = _points(40, seed, spread=0.3)
    im = np.linspace(0.5, 2.0, D).astype(np.float32)
    x_j, r_j, st_j = fused(jnp.asarray(x), jnp.int32(seed), jnp.float32(0.02),
                           jnp.float32(phi), jnp.asarray(im))
    x_t, r_t, st_t = nuts_tree_plain(model.at_group(GROUP), torch.as_tensor(x)[None],
                                     seed, 0.02, phi, torch.as_tensor(im), 3, ZERO_BITS)
    np.testing.assert_allclose(x_t[0].numpy(), np.asarray(x_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(r_t[0].numpy(), np.asarray(r_j), rtol=1e-4, atol=1e-4)
    for k in STAT_KEYS:
        got, want = st_t[k][0].numpy(), np.asarray(st_j[k])
        if k in INTEGER_STATS:
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=k)
    assert st_t["depth"].max() >= 2 and st_t["moved"].mean() > 0.5


def test_library_load_refuses_another_width_or_block(monkeypatch):
    """ops/nuts_cuda.check_eightschools_build holds the built kernel's group
    width and block to models/eightschools.py."""
    from types import SimpleNamespace

    from smcnuts_torch.models import eightschools
    from smcnuts_torch.ops.nuts_cuda import check_eightschools_build

    block = eightschools.BLOCK
    lib = SimpleNamespace(smcnuts_eightschools_group=lambda: GROUP,
                          smcnuts_eightschools_block=lambda: block)
    check_eightschools_build(lib)
    monkeypatch.setattr(eightschools, "GROUP", 2 * GROUP if GROUP < 32 else 1)
    with pytest.raises(RuntimeError, match="groups of"):
        check_eightschools_build(lib)
    monkeypatch.setattr(eightschools, "GROUP", GROUP)
    monkeypatch.setattr(eightschools, "BLOCK", 2 * block)
    with pytest.raises(RuntimeError, match="blocks of"):
        check_eightschools_build(lib)


def test_compaction_threshold_counts_the_kernels_own_blocks():
    from smcnuts_torch.models import eightschools

    model = get_model("eightschools")
    assert model.compaction_min_lanes == (
        132 * eightschools.BLOCKS_PER_SM * (eightschools.BLOCK // GROUP))


def test_measurement_entries_refuse_cpu_tensors_and_the_kernel_other_widths():
    from types import SimpleNamespace

    from smcnuts_torch.ops.nuts_cuda import (
        EIGHTSCHOOLS_VARIANTS, _hand_model_data, nuts_tree_variant)

    model = get_model("eightschools")
    x = torch.as_tensor(_points(8, seed=3))[None]
    assert {w for _, w, _ in EIGHTSCHOOLS_VARIANTS.values()} >= {1}
    with pytest.raises(ValueError, match="cuda"):
        nuts_tree_variant("eightschools_w1", model, x, 0, 0.01)
    with pytest.raises(ValueError, match="unknown variant"):
        nuts_tree_variant("eightschools_w3", model, x, 0, 0.01)
    lib = SimpleNamespace(eightschools_j=J)
    with pytest.raises(NotImplementedError, match="lanes a particle"):
        _hand_model_data(model.at_group(1 if GROUP != 1 else 2), lib)
