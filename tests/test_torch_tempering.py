"""Adaptive tempering and systematic resampling against the JAX package's.

`next_temperature` and `ess_at_phi` on the same log-likelihood vectors as the
JAX functions: |phi - phi_jax| <= 1e-6, and exactly 1.0 when ESS(1.0) already
meets the target. Systematic ancestors, and several arrays resampled by one
ancestor draw (`take_rows`, `multinomial_take_rows`), with the uniforms JAX
draws from its key handed to the port: ancestors equal exactly. The batched
(B, N) forms equal each run alone, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smcnuts_torch.ops.resampling import (
    ancestors,
    multinomial_ancestors,
    multinomial_take_rows,
    resample_if_required,
    systematic_ancestors,
    take_rows,
)
from smcnuts_torch.ops.tempering import BISECT_ITERS, ess_at_phi, next_temperature
from smcnuts_torch.ops.weights import ess, normalise_weights
from smcnuts_tpu.ops import ess as jax_ess
from smcnuts_tpu.ops import normalise_weights as jax_normalise_weights
from smcnuts_tpu.ops.resampling import multinomial_take_rows as jax_multinomial_take_rows
from smcnuts_tpu.ops.resampling import resample_if_required as jax_resample_if_required
from smcnuts_tpu.ops.resampling import systematic_ancestors as jax_systematic_ancestors
from smcnuts_tpu.ops.tempering import BISECT_ITERS as JAX_BISECT_ITERS
from smcnuts_tpu.ops.tempering import ess_at_phi as jax_ess_at_phi
from smcnuts_tpu.ops.tempering import next_temperature as jax_next_temperature

torch.set_num_threads(2)

N = 256
# name: (scale of the log-likelihood, phi_old)
LOGLIK_CASES = {
    "peaked_from_0": (300.0, 0.0),
    "peaked_from_0.003": (300.0, 0.003),
    "moderate_from_0.2": (8.0, 0.2),
    "steep_from_0.9": (60.0, 0.9),
    "flat_from_0": (0.3, 0.0),  # ESS(1.0) meets the target
    "flat_from_0.5": (0.3, 0.5),
}


def _loglik(scale, seed=0, n=N):
    rng = np.random.default_rng(seed)
    return (-scale * rng.chisquare(3, n)).astype(np.float32)


@pytest.mark.parametrize("case", sorted(LOGLIK_CASES))
def test_next_temperature_matches_jax(case):
    scale, phi_old = LOGLIK_CASES[case]
    ll = _loglik(scale)
    phi = next_temperature(torch.as_tensor(ll), phi_old, N)
    phi_j = jax_next_temperature(jnp.asarray(ll), jnp.float32(phi_old), N)
    assert phi.shape == () and phi.dtype == torch.float32
    assert abs(float(phi) - float(phi_j)) <= 1e-6
    assert phi_old < float(phi) <= 1.0
    if scale < 1.0:
        assert float(phi) == 1.0 == float(phi_j)
    else:
        assert float(phi) < 1.0
        # The root: the ESS of the increment is the target, N / 2.
        got = float(ess_at_phi(torch.as_tensor(ll), phi, torch.tensor(phi_old)))
        assert abs(got - N / 2) < 0.02 * N


@pytest.mark.parametrize("phi", [0.01, 0.3, 1.0])
def test_ess_at_phi_matches_jax(phi):
    ll = _loglik(8.0, seed=1)
    got = ess_at_phi(torch.as_tensor(ll), torch.tensor(phi), torch.tensor(0.005))
    want = jax_ess_at_phi(jnp.asarray(ll), jnp.float32(phi), jnp.float32(0.005))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_bisection_is_fifty_fixed_steps_with_alpha():
    assert BISECT_ITERS == JAX_BISECT_ITERS == 50
    ll = _loglik(8.0, seed=2)
    for alpha in (0.3, 0.8):
        phi = next_temperature(torch.as_tensor(ll), 0.1, N, alpha=alpha)
        phi_j = jax_next_temperature(jnp.asarray(ll), jnp.float32(0.1), N, alpha=alpha)
        assert abs(float(phi) - float(phi_j)) <= 1e-6
    # A stricter ESS target takes a smaller step.
    assert (next_temperature(torch.as_tensor(ll), 0.1, N, alpha=0.8)
            < next_temperature(torch.as_tensor(ll), 0.1, N, alpha=0.3))


def test_next_temperature_per_run_equals_each_run_alone():
    """(B, N) log-likelihoods with one phi_old per run: every run bisects its
    own interval, the short-circuit is per run, and run b equals the run
    alone to the bit."""
    names = sorted(LOGLIK_CASES)
    ll = torch.as_tensor(np.stack([
        _loglik(LOGLIK_CASES[c][0], seed=i) for i, c in enumerate(names)]))
    phi_old = torch.tensor([LOGLIK_CASES[c][1] for c in names])
    phi = next_temperature(ll, phi_old, N)
    assert phi.shape == (len(names),)
    for b in range(len(names)):
        alone = next_temperature(ll[b], float(phi_old[b]), N)
        assert torch.equal(phi[b], alone), names[b]
        assert torch.equal(phi[b:b + 1], next_temperature(ll[b:b + 1], phi_old[b:b + 1], N))
    flat = [i for i, c in enumerate(names) if c.startswith("flat")]
    assert bool((phi[flat] == 1.0).all()) and bool((phi < 1.0).any())


def test_next_temperature_ignores_lanes_without_a_likelihood():
    """A -inf or NaN log-likelihood has weight 0 at every temperature, as in
    the JAX package (the masked logsumexp)."""
    ll = _loglik(8.0, seed=3)
    ll[:5] = -np.inf
    ll[5:8] = np.nan
    phi = next_temperature(torch.as_tensor(ll), 0.05, N)
    phi_j = jax_next_temperature(jnp.asarray(ll), jnp.float32(0.05), N)
    assert np.isfinite(float(phi)) and abs(float(phi) - float(phi_j)) <= 1e-6


WN_CASES = {
    "dirichlet": np.random.default_rng(3).dirichlet(np.ones(64)),
    "degenerate": np.random.default_rng(4).dirichlet(np.full(64, 0.05)),
    "with_zeros": np.where(np.arange(64) % 3 == 0, 0.0, 1.0) / 42.0,
}


@pytest.mark.parametrize("case", sorted(WN_CASES))
@pytest.mark.parametrize("key", [0, 1, 2])
def test_systematic_ancestors_equal_jax(case, key):
    wn = WN_CASES[case].astype(np.float32)
    k = jax.random.key(key)
    u = float(jax.random.uniform(k, ()))
    anc = systematic_ancestors(torch.as_tensor(wn), u)
    anc_j = jax_systematic_ancestors(k, jnp.asarray(wn))
    np.testing.assert_array_equal(anc.numpy(), np.asarray(anc_j))
    assert np.all(wn[anc.numpy()] > 0) and np.all(np.diff(anc.numpy()) >= 0)
    # Through the scheme switch the shared u is the first of the run's draws.
    uniforms = torch.full((64,), 0.5)
    uniforms[0] = u
    assert torch.equal(ancestors("systematic", torch.as_tensor(wn), uniforms), anc)


def test_systematic_ancestors_per_run_equal_each_run_alone():
    wn = torch.as_tensor(np.stack([WN_CASES[c] for c in sorted(WN_CASES)]).astype(np.float32))
    u = torch.tensor([0.1, 0.7, 0.999])
    anc = systematic_ancestors(wn, u)
    assert anc.shape == wn.shape
    for b in range(3):
        assert torch.equal(anc[b], systematic_ancestors(wn[b], float(u[b])))
    with pytest.raises(ValueError, match="Unknown resampling scheme"):
        ancestors("stratified", wn, torch.rand(3, 64))


@pytest.mark.parametrize("case", sorted(WN_CASES))
def test_multinomial_take_rows_equals_jax(case):
    """Several arrays resampled by one ancestor draw, as the tempered
    recycling does with the positions and their log-likelihoods."""
    wn = WN_CASES[case].astype(np.float32)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(64, 5)).astype(np.float32)
    ll = rng.normal(size=64).astype(np.float32)
    k = jax.random.key(11)
    u = np.array(jax.random.uniform(k, (64,), dtype=jnp.float32))
    x_r, ll_r = multinomial_take_rows(torch.as_tensor(wn), torch.as_tensor(u),
                                      [torch.as_tensor(x), torch.as_tensor(ll)])
    x_j, ll_j = jax_multinomial_take_rows(k, jnp.asarray(wn),
                                          [jnp.asarray(x), jnp.asarray(ll)])
    np.testing.assert_array_equal(x_r.numpy(), np.asarray(x_j))
    np.testing.assert_array_equal(ll_r.numpy(), np.asarray(ll_j))
    idx = multinomial_ancestors(torch.as_tensor(wn), torch.as_tensor(u))
    assert torch.equal(x_r, torch.as_tensor(x)[idx])


def test_take_rows_with_leading_axes():
    """idx (B, K, N) gathers (B, K, N) and (B, K, N, D) arrays alike: the
    saved-history pass resamples all K + 1 saved states of all runs at once."""
    g = torch.Generator().manual_seed(0)
    idx = torch.randint(0, 16, (2, 3, 16), generator=g)
    a = torch.randn(2, 3, 16, generator=g)
    x = torch.randn(2, 3, 16, 4, generator=g)
    a_r, x_r = take_rows(idx, [a, x])
    for b in range(2):
        for k in range(3):
            assert torch.equal(a_r[b, k], a[b, k][idx[b, k]])
            assert torch.equal(x_r[b, k], x[b, k][idx[b, k]])


@pytest.mark.parametrize("scale", [0.3, 5.0])  # ESS above / below N/2
def test_resample_if_required_systematic_matches_jax(scale):
    rng = np.random.default_rng(5)
    n = 48
    x = rng.normal(size=(n, 4)).astype(np.float32)
    logw = (rng.normal(size=n) * scale).astype(np.float32)
    wn_j, ll_j = jax_normalise_weights(jnp.asarray(logw))
    k = jax.random.key(7)
    xr_j, lw_j, do_j = jax_resample_if_required(
        k, jnp.asarray(x), jnp.asarray(logw), wn_j, ll_j, jax_ess(wn_j), 0.5,
        "systematic",
    )
    uniforms = torch.zeros(n)
    uniforms[0] = float(jax.random.uniform(k, ()))
    wn, ll = normalise_weights(torch.as_tensor(logw))
    xr, lw, do = resample_if_required(
        uniforms, torch.as_tensor(x), torch.as_tensor(logw), wn, ll, ess(wn), 0.5,
        "systematic",
    )
    assert bool(do) == bool(do_j) == (scale > 1.0)
    np.testing.assert_array_equal(xr.numpy(), np.asarray(xr_j))
    np.testing.assert_allclose(lw.numpy(), np.asarray(lw_j), rtol=1e-6)
