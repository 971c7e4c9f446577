"""Logistic regression in the kernel's group order: W lanes a particle, the
64 observations split over them and the lane partials reduced by an xor
butterfly (`csrc/logistic_model.cuh`), and its plain version
`LogisticModel.logp_and_grad(x, phi, group=W)`.

- Emulation: a numpy float32 scalar emulation of the device function,
  written from the CUDA source (a loop over the lanes, each over its
  observations l, l + W, ... of the staged rows [X_i, y_i]; then the
  butterfly; then the prior and the gradient), equals
  `logp_and_grad(group=W)` to the bit for W in {1, the kernel's GROUP, 32}
  at phi 1.0 and 0.4, near the posterior mode and on the points where
  |eta| is in the thousands or a coordinate is 1e20 (a density that is not
  finite). Every add and multiply is a numpy float32 operation in the
  kernel's order; exp and log1p are torch's float32 functions applied to the
  emulation's own arguments one scalar at a time (numpy's differ from
  torch's in the last bit, and the point here is the order).
- Against JAX: each group order against the JAX tile density's value and
  in-kernel gradient (`tile_fn`) within the float32 bound of two sums of
  the same terms in two orders, with the terms' own library differences;
  the plain tree at the kernel's width against `nuts_batch_pallas_fused`
  interpreted with zero bits at depth 3, at the tolerance of
  tests/test_torch_elementwise_models.py (integers exactly, floats at
  atol/rtol 1e-4).
- The library load holds the built kernel's width and block to
  models/logistic.py, and the main entry refuses a model at another width.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smcnuts_torch.models import LogisticModel, get_model
from smcnuts_torch.models.logistic import GROUP
from smcnuts_torch.ops.draws import ZERO_BITS
from smcnuts_torch.ops.nuts_cuda import STAT_KEYS, nuts_tree_plain
from smcnuts_tpu.models import get_model as jax_get_model
from smcnuts_tpu.ops.nuts_pallas import nuts_batch_pallas_fused

torch.set_num_threads(2)

D = 8
F = np.float32
U = 2.0 ** -24  # float32 unit roundoff
PHIS = [1.0, 0.4]
WIDTHS = [1, GROUP, 32]
INTEGER_STATS = ("depth", "leapfrogs", "moved")


@pytest.fixture(scope="module")
def model():
    return LogisticModel()


def _mode(model):
    """The posterior mode at phi = 1, by Newton's method in float64."""
    X, y = model.X, model.y
    b = torch.zeros(D, dtype=torch.float64)
    for _ in range(25):
        p = torch.sigmoid(X @ b)
        g = X.T @ (y - p) - b * model.inv_ps2
        h = -(X.T * (p * (1 - p))) @ X - model.inv_ps2 * torch.eye(D, dtype=torch.float64)
        b = b - torch.linalg.solve(h, g)
    return b.numpy()


def _points(model, n, seed, spread=0.5):
    rng = np.random.default_rng(seed)
    return (_mode(model) + spread * rng.normal(size=(n, D))).astype(np.float32)


def _extreme():
    """|eta| in the thousands (test_logistic_gradient_does_not_overflow's
    points), and a coordinate of 1e20 in each sign, whose square overflows."""
    x = np.zeros((4, D), np.float32)
    x[0], x[1] = 500.0, -500.0
    x[2, 0], x[3, 3] = 1e20, -1e20
    return x


def _texp(v):
    return F(torch.exp(torch.tensor(v, dtype=torch.float32)).item())


def _tlog1p(v):
    return F(torch.log1p(torch.tensor(v, dtype=torch.float32)).item())


def _emulate(model, x, phi, W):
    """logp_grad of csrc/logistic_model.cuh at group width W, one particle
    (row of x) at a time, every lane of the group in turn, reading the rows
    of `kernel_data()` as the kernel stages them."""
    rows = model.kernel_data().numpy().reshape(-1, D + 1)
    inv_ps2, prior_const = (F(v) for v in model.kernel_scalars())
    phi = F(phi)
    lps, grads = [], []
    with np.errstate(over="ignore", invalid="ignore"):
        for b in x:
            zero = b[0] * F(0.0)
            lp = zero
            for d in range(D):
                lp = lp - ((F(0.5) * b[d]) * b[d]) * inv_ps2
            lp = lp + prior_const
            partials = []
            for lane in range(W):
                ll = zero
                s = [zero] * D
                for i in range(lane, len(rows), W):
                    Xi = rows[i]
                    eta = b[0] * Xi[0]
                    for d in range(1, D):
                        eta = eta + Xi[d] * b[d]
                    e = _texp(-abs(eta))
                    softplus = (eta if eta > 0 else F(0.0)) + _tlog1p(e)
                    yi = Xi[D]
                    ll = (ll + yi * eta) - softplus
                    one_e = F(1.0) + e
                    resid = yi - (F(1.0) / one_e if eta >= 0 else e / one_e)
                    for d in range(D):
                        s[d] = s[d] + resid * Xi[d]
                partials.append([ll] + s)
            o = W // 2
            while o:  # v = v + __shfl_xor_sync(mask, v, o), every lane at once
                partials = [[a + c for a, c in zip(partials[lane], partials[lane ^ o])]
                            for lane in range(W)]
                o //= 2
            ll, *s = partials[0]
            grads.append([-b[d] * inv_ps2 + phi * s[d] for d in range(D)])
            lps.append(lp + phi * ll)
    return np.array(lps, F), np.array(grads, F)


def _bits(a):
    return np.asarray(a, F).view(np.uint32)


def test_the_kernel_width_is_a_power_of_two_in_a_warp():
    assert GROUP in (2, 4, 8, 16, 32)


@pytest.mark.parametrize("phi", PHIS)
@pytest.mark.parametrize("W", WIDTHS)
def test_emulation_equals_plain_group_order_to_the_bit(model, W, phi):
    x = np.concatenate([_points(model, 4, seed=W), _extreme()])
    lp, g = model.logp_and_grad(torch.as_tensor(x), phi, group=W)
    lp_e, g_e = _emulate(model, x, phi, W)
    np.testing.assert_array_equal(_bits(lp.numpy()), _bits(lp_e))
    np.testing.assert_array_equal(_bits(g.numpy()), _bits(g_e))
    assert np.isfinite(lp_e[:6]).all() and not np.isfinite(lp_e[6:]).any()


def test_default_group_is_the_kernel_width(model):
    x = torch.as_tensor(_points(model, 16, seed=6))
    for got, want in zip(model.logp_and_grad(x, 0.7),
                         model.logp_and_grad(x, 0.7, group=GROUP)):
        assert torch.equal(got, want)
    view = model.at_group(1)
    assert view.group == 1 and model.group == GROUP and view.X is model.X
    for got, want in zip(view.logp_and_grad(x, 0.7), model.logp_and_grad(x, 0.7, group=1)):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="power of two"):
        model.logp_and_grad(x, 0.7, group=12)


def _gamma(n):
    return n * U / (1.0 - n * U)


@pytest.mark.parametrize("phi", PHIS)
@pytest.mark.parametrize("W", WIDTHS)
def test_group_order_within_the_summation_bound_of_jax_tile_fn(model, W, phi):
    """Both sides sum the same float32 terms of the n = 64 observations in
    two orders: ll the y_i eta_i and the softplus_i, s_d the resid_i X_id;
    any order of k additions lies within gamma_k sum|terms| of the exact sum
    (gamma_k = k u / (1 - k u), u = 2^-24), so two orders differ by at most
    twice that. The terms themselves differ by the two libraries' exp and
    log1p (allowed 4 u |softplus_i| each side) and by the JAX gradient's
    sigmoid, 1 - e / (1 + e) against 1 / (1 + e), and its phi multiplied into
    each term (allowed 8 u phi |X_id| a term); the prior by JAX's division by
    prior_scale^2 against this side's multiplication by its float32
    reciprocal (4 u |term|). Logp is held to 2 gamma_{2n+12} (prior terms +
    |prior constant| + phi sum|ll terms|) + 8 u phi sum softplus + 4 u sum
    prior terms, each gradient component to 2 gamma_{n+2} phi sum_i
    |resid_i X_id| + 8 u phi sum_i |X_id| + 4 u |b_d| / ps^2 + 2 gamma_2
    |value|. The terms are computed here in float64 from the float32 eta."""
    x = _points(model, 128, seed=8)
    lp, g = model.logp_and_grad(torch.as_tensor(x), phi, group=W)
    lp_j, g_j = jax_get_model("logistic").tile_model.tile_fn(
        (), [jnp.asarray(c) for c in x.T], jnp.float32(phi))
    lp_j = np.asarray(lp_j, np.float64)
    g_j = np.stack([np.asarray(c) for c in g_j], axis=1).astype(np.float64)

    X, y = model.X.numpy(), model.y.numpy()  # float64 holding float32 values
    xd = x.astype(np.float64)
    eta = xd @ X.T
    softplus = np.maximum(eta, 0.0) + np.log1p(np.exp(-np.abs(eta)))
    resid = y - 1.0 / (1.0 + np.exp(-eta))
    n = X.shape[0]
    prior = 0.5 * xd ** 2 * model.inv_ps2
    s_prior = prior.sum(1) + abs(model.prior_const)
    s_ll = (np.abs(y * eta) + softplus).sum(1)
    tol_lp = (2 * _gamma(2 * n + 12) * (s_prior + phi * s_ll)
              + 8 * U * phi * softplus.sum(1) + 4 * U * prior.sum(1)
              + 2 * _gamma(2) * np.abs(lp_j))
    s_g = (np.abs(resid)[:, :, None] * np.abs(X)).sum(1)
    tol_g = (2 * _gamma(n + 2) * phi * s_g + 8 * U * phi * np.abs(X).sum(0)
             + 4 * U * np.abs(xd) * model.inv_ps2 + 2 * _gamma(2) * np.abs(g_j))
    assert np.all(np.abs(lp.numpy() - lp_j) <= tol_lp)
    assert np.all(np.abs(g.numpy() - g_j) <= tol_g)


@pytest.mark.parametrize("phi", PHIS)
def test_group_orders_differ_from_the_sequential_one(model, phi):
    """The widths are different sums, not one sum relabelled: the bound
    above has work to do."""
    x = torch.as_tensor(_points(model, 128, seed=9))
    lp1, _ = model.logp_and_grad(x, phi, group=1)
    for W in WIDTHS[1:]:
        assert not torch.equal(model.logp_and_grad(x, phi, group=W)[0], lp1)


@pytest.fixture(scope="module")
def fused():
    import jax

    tm = jax_get_model("logistic").tile_model
    return jax.jit(lambda x, s, e, p, im: nuts_batch_pallas_fused(
        tm, x, s, e, p, im, max_depth=3, interpret=True))


@pytest.mark.parametrize("seed,phi", [(6, 1.0), (7, 0.4)])
def test_plain_tree_at_the_kernel_width_matches_pallas_kernel(model, fused, seed, phi):
    """As tests/test_torch_elementwise_models.py::
    test_plain_tree_matches_pallas_kernel_depth3, on other particles and
    seeds, with the model at the kernel's width: integers exactly, floats at
    atol/rtol 1e-4."""
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.normal(size=(40, D))).astype(np.float32)
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
    """ops/nuts_cuda.check_logistic_build holds the built kernel's group
    width and block to models/logistic.py."""
    from types import SimpleNamespace

    from smcnuts_torch.models import logistic
    from smcnuts_torch.ops.nuts_cuda import check_logistic_build

    block = logistic.BLOCK
    lib = SimpleNamespace(smcnuts_logistic_group=lambda: GROUP,
                          smcnuts_logistic_block=lambda: block)
    check_logistic_build(lib)
    monkeypatch.setattr(logistic, "GROUP", 2 * GROUP if GROUP < 32 else 1)
    with pytest.raises(RuntimeError, match="groups of"):
        check_logistic_build(lib)
    monkeypatch.setattr(logistic, "GROUP", GROUP)
    monkeypatch.setattr(logistic, "BLOCK", 2 * block)
    with pytest.raises(RuntimeError, match="blocks of"):
        check_logistic_build(lib)


def test_measurement_entries_refuse_cpu_tensors_and_the_kernel_other_widths():
    from types import SimpleNamespace

    from smcnuts_torch.ops.nuts_cuda import (
        LOGISTIC_VARIANTS, _hand_model_data, nuts_tree_variant)

    model = get_model("logistic")
    x = torch.as_tensor(_points(model, 8, seed=3))[None]
    assert {w for _, w, _ in LOGISTIC_VARIANTS.values()} >= {1}
    with pytest.raises(ValueError, match="cuda"):
        nuts_tree_variant("logistic_w1", model, x, 0, 0.01)
    with pytest.raises(ValueError, match="unknown variant"):
        nuts_tree_variant("logistic_w3", model, x, 0, 0.01)
    lib = SimpleNamespace(logistic_dim=D)
    with pytest.raises(NotImplementedError, match="lanes a particle"):
        _hand_model_data(model.at_group(1 if GROUP != 1 else 2), lib)
