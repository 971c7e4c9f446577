"""arma in the kernels' group order: W lanes a particle, the T - 1 steps of
the error recurrence cut into W segments, a pass over each from a zero
state, a scan of the segments' affine maps over the lanes, a second pass
with the sums and an xor butterfly over the lanes' partials
(`csrc/arma_model.cuh`), and its plain version
`ops.arma_fused.arma_loglik_grad(theta, y, group=W)`.

- Emulation: a numpy float32 scalar emulation of the device function,
  written from the CUDA source (every lane of the group in turn, the
  shuffles as reads of another lane's values from before the step), equals
  `arma_loglik_grad(group=W)` to the bit for W in {1, GROUP, 32}, lanes at
  |theta| >= 2 and log_sigma = +-20, +-60 included (NaN equal to NaN); and
  `ArmaModel.logp_and_grad(x, phi, group=W)` at phi 1.0 and 0.4 is the
  model's prior plus phi times the emulated likelihood, to the bit. Every
  add and multiply is a numpy float32 operation in the kernel's order; exp
  is torch's float32 function applied one scalar at a time (numpy's float32
  exp differs from torch's in the last bit, and the point here is the order).
- W = 1 equals the sequential order, written out below as it stood before
  the group design, to the bit.
- Against JAX at the kernels' width, GROUP, and at W = 32: the value and
  gradient against `arma_tile_model(y).tile_fn`, `arma_ll_vg_scan` and the
  interpreted `arma_ll_vg_pallas` (tolerances below); lanes that are not
  finite on one side are not finite on the other (a divergent leaf either
  way: the group order may make a NaN where the sequential order made an
  inf). The plain tree at W against `nuts_batch_pallas_fused` interpreted
  with zero bits (N = 40, depth 2) by the contract of
  tests/test_torch_nuts.py::_assert_outputs_match, delta_h with the
  allowance of tests/test_torch_prmwcd_group.py (its test says why).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smcnuts_torch.models import ArmaModel, make_arma
from smcnuts_torch.models.arma import GROUP
from smcnuts_torch.ops.arma_fused import LOG_SQRT_2PI, arma_ll_vg_plain, arma_loglik_grad
from smcnuts_torch.ops.draws import ZERO_BITS
from smcnuts_torch.ops.nuts_cuda import STAT_KEYS, nuts_tree_plain
from smcnuts_tpu.models.arma import _ASSET
from smcnuts_tpu.ops.arma_fused import arma_ll_vg_pallas, arma_ll_vg_scan
from smcnuts_tpu.ops.nuts_pallas import arma_tile_model, nuts_batch_pallas_fused

torch.set_num_threads(2)

F = np.float32
POST_MODE = np.array([0.007, 0.957, -0.034, np.log(0.166)])
PHIS = [1.0, 0.4]
WIDTHS = sorted({1, GROUP, 32})
INTEGER_STATS = ("depth", "leapfrogs", "moved")
# (column, value) of the lanes where the density is not finite, or nearly so:
# log_sigma +-20 and +-60 (inv_s2 of e^-40, e^40, 0 and inf), |theta| >= 2
# (the recurrence overflows).
EXTREME = ((3, 20.0), (3, -20.0), (3, 60.0), (3, -60.0),
           (2, 2.0), (2, -2.5), (2, 3.0), (2, -7.0))


def _y():
    return np.asarray(np.load(_ASSET)["y"], np.float32)


def _theta(n, seed, spread=0.3):
    """Three quarters near the posterior mode, one quarter dispersed, then
    the EXTREME lanes at the front."""
    rng = np.random.default_rng(seed)
    theta = POST_MODE + rng.normal(0, 0.05, (n, 4))
    theta[: n // 4] = POST_MODE + rng.normal(0, spread, (n // 4, 4))
    for i, (col, v) in enumerate(EXTREME[:n]):
        theta[i, col] = v
    return theta.astype(F)


def _texp(v):
    return F(torch.exp(torch.tensor(v, dtype=torch.float32)).item())


def _emulate(y, theta, W):
    """arma_loglik_grad<W> of csrc/arma_model.cuh, one particle (row of
    theta) at a time, every lane of the group in turn: (ll (n,), gl (n, 4))."""
    with np.errstate(all="ignore"):  # the EXTREME lanes overflow, as on the card
        return _emulate_lanes(y, theta, W)


def _emulate_lanes(y, theta, W):
    T = len(y)
    L = (T - 1 + W - 1) // W
    lls, gls = [], []
    for mu, beta, th, ls in theta:
        def step(t, v):
            err, emu, eb, eth = v
            yt, yp = y[t], y[t - 1]
            b = (yt - mu) - beta * yp
            return [b - th * err, F(-1.0) - th * emu, -yp - th * eb, -err - th * eth]

        err0 = (y[0] - mu) - beta * mu
        v0 = [err0, F(-1.0) - beta, -mu, F(0.0)]
        seg = [range(1 + l * L, min(T, 1 + l * L + L)) for l in range(W)]
        incoming = [v0] * W
        if W > 1:
            state = [list(v0) if l == 0 else [F(0.0)] * 4 for l in range(W)]
            p, q = [F(1.0)] * W, [F(0.0)] * W
            for l in range(W):
                for t in seg[l]:
                    state[l] = step(t, state[l])
                    q[l] = p[l] - th * q[l]
                    p[l] = -th * p[l]
            d = 1
            while d < W:
                old = [list(v) for v in state], list(p), list(q)
                for l in range(d, W):
                    o, pp, qq = old[0][l - d], old[1][l - d], old[2][l - d]
                    e = state[l]
                    state[l] = [p[l] * o[0] + e[0], p[l] * o[1] + e[1],
                                p[l] * o[2] + e[2], (p[l] * o[3] - q[l] * o[0]) + e[3]]
                    q[l] = p[l] * qq + q[l] * pp
                    p[l] = p[l] * pp
                d *= 2
            incoming = [v0] + state[:-1]
        partials = []
        for l in range(W):
            v = list(incoming[l])
            s = [v[0] * c for c in v] if l == 0 else [F(0.0)] * 4
            for t in seg[l]:
                v = step(t, v)
                s = [a + v[0] * c for a, c in zip(s, v)]
            partials.append(s)
        o = W // 2
        while o:  # v = v + __shfl_xor_sync(mask, v, o), every lane at once
            partials = [[a + c for a, c in zip(partials[l], partials[l ^ o])]
                        for l in range(W)]
            o //= 2
        s2, smu, sb, sth = partials[0]
        Tf = F(T)
        inv_s2 = _texp(F(-2.0) * ls)
        gls.append([-smu * inv_s2, -sb * inv_s2, -sth * inv_s2, s2 * inv_s2 + -Tf])
        lls.append(-Tf * (ls + F(LOG_SQRT_2PI)) - (F(0.5) * s2) * inv_s2)
    return np.array(lls, F), np.array(gls, F)


def _sequential(theta, y):
    """arma_loglik_grad as it was written before the group design: one
    (N, 4) state over the T observations in sequence."""
    mu, beta, th, ls = theta.unbind(-1)
    T = y.shape[0]
    err = (y[0] - mu) - beta * mu
    e = torch.stack([err, -1.0 - beta, -mu, torch.zeros_like(mu)], dim=1)
    acc = err[:, None] * e
    b = (y[None, 1:] - mu[:, None]) - beta[:, None] * y[None, :-1]
    const = torch.stack([b, torch.full_like(b, -1.0), (-y[:-1]).expand_as(b)], dim=2)
    th_col = th[:, None]
    for t in range(1, T):
        c = torch.cat([const[:, t - 1], -e[:, 0:1]], dim=1)
        e = c - th_col * e
        acc = acc + e[:, 0:1] * e
    s2, smu, sb, sth = acc.unbind(1)
    inv_s2 = torch.exp(-2.0 * ls)
    ll = -T * (LOG_SQRT_2PI + ls) - 0.5 * s2 * inv_s2
    grad = torch.stack([-smu * inv_s2, -sb * inv_s2, -sth * inv_s2, -T + s2 * inv_s2],
                       dim=1)
    return ll, grad


def _same_bits(a, b):
    """Equal to the bit, NaN equal to NaN (its payload aside)."""
    a, b = np.asarray(a), np.asarray(b)
    same = (a.view(np.uint32) == b.view(np.uint32)) | (np.isnan(a) & np.isnan(b))
    return bool(same.all())


def test_the_kernel_width_is_a_power_of_two_in_a_warp():
    assert GROUP in (1, 2, 4, 8, 16, 32)
    assert ArmaModel().group == GROUP


@pytest.mark.parametrize("W", WIDTHS)
def test_emulation_equals_plain_group_order_to_the_bit(W):
    y, theta = _y(), _theta(12, seed=W)
    ll, g = arma_loglik_grad(torch.as_tensor(theta), torch.as_tensor(y), group=W)
    ll_e, g_e = _emulate(y, theta, W)
    assert _same_bits(ll.numpy(), ll_e) and _same_bits(g.numpy(), g_e)
    assert not np.isfinite(ll_e).all() and np.isfinite(ll_e).any()


@pytest.mark.parametrize("phi", PHIS)
@pytest.mark.parametrize("W", WIDTHS)
def test_model_is_prior_plus_phi_times_emulated_likelihood(W, phi):
    """logp_and_grad(x, phi, group=W) = prior + phi * (the emulated ll, gl),
    the prior being the model's at phi = 0 (finite lanes: 0 * ll is 0)."""
    y, theta = _y(), _theta(16, seed=10 + W)[len(EXTREME):]
    x = torch.as_tensor(theta)
    model = ArmaModel()
    lp, g = model.logp_and_grad(x, phi, group=W)
    lprior, gp = model.logp_and_grad(x, 0.0, group=W)
    ll_e, g_e = _emulate(y, theta, W)
    want_lp = lprior.numpy() + F(phi) * ll_e
    want_g = gp.numpy() + F(phi) * g_e
    assert np.isfinite(ll_e).all()
    assert _same_bits(lp.numpy(), want_lp) and _same_bits(g.numpy(), want_g)


@pytest.mark.parametrize("phi", PHIS)
def test_group_1_is_the_sequential_order_to_the_bit(phi):
    x, y = torch.as_tensor(_theta(64, seed=5)), torch.as_tensor(_y())
    ll, g = arma_loglik_grad(x, y, group=1)
    ll_s, g_s = _sequential(x, y)
    assert _same_bits(ll.numpy(), ll_s.numpy()) and _same_bits(g.numpy(), g_s.numpy())
    lp, gm = ArmaModel().logp_and_grad(x, phi, group=1)
    lp_v, gm_v = ArmaModel().at_group(1).logp_and_grad(x, phi)
    assert _same_bits(lp.numpy(), lp_v.numpy()) and _same_bits(gm.numpy(), gm_v.numpy())


def test_default_group_is_the_kernel_width():
    x, y = torch.as_tensor(_theta(16, seed=6)), torch.as_tensor(_y())
    for got, want in zip(arma_loglik_grad(x, y), arma_loglik_grad(x, y, group=GROUP)):
        assert _same_bits(got.numpy(), want.numpy())
    for got, want in zip(ArmaModel().logp_and_grad(x, 0.7),
                         ArmaModel().logp_and_grad(x, 0.7, group=GROUP)):
        assert _same_bits(got.numpy(), want.numpy())
    # The fused plain version and the model without it run the same order.
    for got, want in zip(make_arma(fused="plain").logp_and_grad(x, 0.7),
                         ArmaModel().logp_and_grad(x, 0.7)):
        assert _same_bits(got.numpy(), want.numpy())
    with pytest.raises(ValueError, match="power of two"):
        arma_loglik_grad(x, y, group=12)
    with pytest.raises(ValueError, match="power of two"):
        ArmaModel().at_group(64)


def test_library_load_refuses_another_width_or_block(monkeypatch):
    """ops/nuts_cuda.check_arma_build holds the built kernels' group width
    and block to models/arma.py: a plain version at another width would not
    round as the kernels do."""
    from types import SimpleNamespace

    from smcnuts_torch.models import arma
    from smcnuts_torch.ops.nuts_cuda import check_arma_build

    block = arma.BLOCK
    lib = SimpleNamespace(smcnuts_arma_group=lambda: GROUP,
                          smcnuts_arma_block=lambda: block)
    check_arma_build(lib)
    monkeypatch.setattr(arma, "GROUP", 2 * GROUP if GROUP < 32 else 1)
    with pytest.raises(RuntimeError, match="groups of"):
        check_arma_build(lib)
    monkeypatch.setattr(arma, "GROUP", GROUP)
    monkeypatch.setattr(arma, "BLOCK", 2 * block)
    with pytest.raises(RuntimeError, match="blocks of"):
        check_arma_build(lib)


def test_measurement_entries_and_the_kernel_refuse_cpu_tensors_and_other_widths():
    from smcnuts_torch.ops.arma_fused import arma_ll_vg_variant
    from smcnuts_torch.ops.nuts_cuda import nuts_tree_variant

    x = torch.as_tensor(_theta(8, seed=3)[len(EXTREME):])
    with pytest.raises(ValueError, match="cuda"):
        arma_ll_vg_variant(torch.as_tensor(_theta(8, seed=3)), torch.as_tensor(_y()), "w1")
    with pytest.raises(ValueError, match="cuda"):
        nuts_tree_variant("arma_w1", ArmaModel(), x[None], 0, 0.01)
    with pytest.raises(ValueError, match="lanes a particle"):
        make_arma(fused="cuda").logp_and_grad(x, 1.0, group=1)


def _assert_close_to_jax(ll, g, ll_j, g_j):
    """tests/test_torch_arma_fused.py's tolerance, per lane where both sides
    are finite: |port - JAX| <= 1e-5 |JAX| + 1e-4 |loglik| (float32; the
    orders differ, and a gradient is a difference of sums of the loglik's
    scale); where either side is not finite, both are not."""
    ll, g = ll.numpy(), g.numpy()
    ll_j, g_j = np.asarray(ll_j), np.asarray(g_j)
    np.testing.assert_array_equal(np.isfinite(ll), np.isfinite(ll_j))
    fin = np.isfinite(ll_j) & np.isfinite(g_j).all(1)
    np.testing.assert_array_equal(np.isfinite(g).all(1), np.isfinite(g_j).all(1))
    scale = 1e-4 * np.abs(ll_j[fin])
    assert np.all(np.abs(ll[fin] - ll_j[fin]) <= 1e-5 * np.abs(ll_j[fin]) + scale)
    assert np.all(np.abs(g[fin] - g_j[fin])
                  <= 1e-5 * np.abs(g_j[fin]) + scale[:, None] + 1e-30)
    assert fin.sum() > len(fin) // 2


@pytest.mark.parametrize("W", sorted({GROUP, 32}))
def test_group_order_matches_jax_fused_functions(W):
    y, theta = _y(), _theta(257, seed=20 + W)
    ll, g = arma_ll_vg_plain(torch.as_tensor(theta), torch.as_tensor(y), group=W)
    y32 = jnp.asarray(y)
    _assert_close_to_jax(ll, g, *arma_ll_vg_scan(jnp.asarray(theta), y32))
    _assert_close_to_jax(ll, g, *arma_ll_vg_pallas(jnp.asarray(theta), y32,
                                                   interpret=True))


@pytest.mark.parametrize("phi", PHIS)
@pytest.mark.parametrize("W", sorted({GROUP, 32}))
def test_group_order_matches_tile_fn(W, phi):
    """The whole tempered density against the JAX kernel's tile model: rtol
    1e-5 on logp; the gradient at 1e-5 |value| + 1e-4 |phi loglik| (a sum of
    terms of the loglik's scale); non-finite lanes alike."""
    y, theta = _y(), _theta(64, seed=30 + W)
    lp, g = ArmaModel().logp_and_grad(torch.as_tensor(theta), phi, group=W)
    lp_j, g_j = arma_tile_model(y).tile_fn((), [jnp.asarray(c) for c in theta.T],
                                           jnp.float32(phi))
    lp_j = np.asarray(lp_j)
    g_j = np.stack([np.asarray(c) for c in g_j], axis=1)
    lp, g = lp.numpy(), g.numpy()
    np.testing.assert_array_equal(np.isfinite(lp), np.isfinite(lp_j))
    fin = np.isfinite(lp_j)
    np.testing.assert_allclose(lp[fin], lp_j[fin], rtol=1e-5)
    ll = ArmaModel().loglik(torch.as_tensor(theta[fin]).double()).numpy()
    tol = 1e-5 * np.abs(g_j[fin]) + 1e-4 * phi * np.abs(ll)[:, None]
    assert np.all(np.abs(g[fin] - g_j[fin]) <= tol)


@pytest.fixture(scope="module")
def fused():
    import jax

    tm = arma_tile_model(_y())
    return jax.jit(lambda x, s, e, p, im: nuts_batch_pallas_fused(
        tm, x, s, e, p, im, max_depth=2, interpret=True))


def _tree_particles(n, seed):
    """As tests/test_torch_nuts.py makes them: three quarters near the
    posterior mode, one quarter dispersed."""
    rng = np.random.default_rng(seed)
    x = POST_MODE + rng.normal(0, 0.02, (n, 4))
    x[: n // 4] = POST_MODE + rng.normal(0, 0.3, (n // 4, 4))
    return x.astype(F)


@pytest.mark.parametrize("W,seed,phi", [(GROUP, 0, 1.0), (GROUP, 1, 0.4), (32, 0, 1.0)])
def test_plain_tree_in_group_order_matches_pallas_kernel(fused, W, seed, phi):
    """Integers exactly; floats at atol/rtol 1e-4 (tests/test_torch_nuts.py's
    _assert_outputs_match), delta_h at 1e-4 plus 32 float32 spacings of
    logp0, as tests/test_torch_prmwcd_group.py holds it: delta_h = (logp -
    kinetic) - H0 cancels terms of a few hundred nats (under zero bits every
    momentum is ~5.8, ke0 ~66), whose spacing is 1.5-3e-5, so a few last-bit
    changes of a logp move it past 1e-4 (lane 7 of seed 1 at phi 0.4 reads
    0.55710 in the sequential order and 0.55722 at W = 16, JAX 0.55704)."""
    x = _tree_particles(40, seed)
    ones = [1.0] * 4
    x_j, r_j, st_j = fused(jnp.asarray(x), jnp.int32(seed), jnp.float32(0.01),
                           jnp.float32(phi), jnp.asarray(ones, jnp.float32))
    x_t, r_t, st_t = nuts_tree_plain(ArmaModel().at_group(W), torch.as_tensor(x)[None],
                                     seed, 0.01, phi, torch.tensor(ones), 2, ZERO_BITS)
    np.testing.assert_allclose(x_t[0].numpy(), np.asarray(x_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(r_t[0].numpy(), np.asarray(r_j), rtol=1e-4, atol=1e-4)
    spacing = np.spacing(np.abs(np.asarray(st_j["logp0"])).astype(F))
    for k in STAT_KEYS:
        ours, theirs = st_t[k][0].numpy(), np.asarray(st_j[k])
        if k in INTEGER_STATS:
            np.testing.assert_array_equal(ours, theirs, err_msg=k)
        elif k == "delta_h":
            assert np.all(np.abs(ours - theirs) <= 1e-4 + 32 * spacing), k
        else:
            np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=1e-4, err_msg=k)
    assert st_t["moved"].mean() > 0.5
