"""B runs at once: the batched SMC pieces against the JAX package's vmapped
functions, and run b of a batch against a run alone with seed seeds[b].

- The fixed-order sums of `ops.reduce` against torch's, and their
  independence of the batch around a row.
- normalise_weights, ess, moments and multinomial ancestors on (B, N)
  against `jax.vmap` of the JAX functions, with JAX's uniforms handed in.
- The runs' own draw streams (`ops.draws.run_draws`).
- One batched `smc_step` and `run_smc_batched` at B = 3 against three B = 1
  runs, to the bit, with resampling on in some runs and off in others, for
  arma and for PRMwCD with adaptation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smcnuts_torch import SMCConfig, run_smc, run_smc_batched
from smcnuts_torch.interop import carry_from_numpy, carry_to_numpy
from smcnuts_torch.models import get_model
from smcnuts_torch.ops.draws import PHILOX, run_draws
from smcnuts_torch.ops.moments import weighted_moments
from smcnuts_torch.ops.reduce import row_cumsum, row_sum
from smcnuts_torch.ops.resampling import multinomial_ancestors, resample_if_required
from smcnuts_torch.ops.weights import ess, normalise_weights
from smcnuts_torch.sampler import init_state, smc_step
from smcnuts_tpu.ops import ess as jax_ess
from smcnuts_tpu.ops import multinomial_ancestors as jax_multinomial_ancestors
from smcnuts_tpu.ops import normalise_weights as jax_normalise_weights
from smcnuts_tpu.ops import weighted_moments as jax_weighted_moments

torch.set_num_threads(2)

B, N = 3, 48


@pytest.mark.parametrize("n", [1, 7, 48, 64, 513])
def test_row_sums_match_torch_and_ignore_the_batch(n):
    v = torch.as_tensor(np.random.default_rng(n).random((4, n)))
    torch.testing.assert_close(row_sum(v), v.sum(-1), rtol=1e-12, atol=0)
    torch.testing.assert_close(row_cumsum(v), v.cumsum(-1), rtol=1e-12, atol=0)
    for b in range(4):
        assert torch.equal(row_sum(v[b:b + 1])[0], row_sum(v)[b])
        assert torch.equal(row_cumsum(v[b:b + 1])[0], row_cumsum(v)[b])


def test_row_cumsum_is_monotone_and_repeats_at_zero_weights():
    rng = np.random.default_rng(1)
    w = rng.dirichlet(np.full(500, 0.05), size=8).astype(np.float32)
    w[:, ::7] = 0.0
    cdf = row_cumsum(torch.as_tensor(w))
    assert torch.all(cdf[:, 1:] >= cdf[:, :-1])
    zero = torch.as_tensor(w[:, 1:] == 0.0)
    assert torch.equal(cdf[:, 1:][zero], cdf[:, :-1][zero])


def _logw(seed):
    """Three runs: a degenerate one (ESS < N/2), a flat one and one with
    -inf entries."""
    rng = np.random.default_rng(seed)
    logw = np.stack([rng.normal(0, 6.0, N), rng.normal(0, 0.2, N),
                     rng.normal(0, 0.3, N)])
    logw[2, ::10] = -np.inf
    return logw.astype(np.float32)


def test_batched_weights_and_moments_match_jax_vmap():
    logw = _logw(2)
    x = np.random.default_rng(3).normal(size=(B, N, 4)).astype(np.float32)
    wn, ll = normalise_weights(torch.as_tensor(logw))
    wn_j, ll_j = jax.vmap(jax_normalise_weights)(jnp.asarray(logw))
    np.testing.assert_allclose(wn.numpy(), np.asarray(wn_j), rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(ll.numpy(), np.asarray(ll_j), rtol=1e-6)
    np.testing.assert_allclose(ess(wn).numpy(), np.asarray(jax.vmap(jax_ess)(wn_j)),
                               rtol=1e-5)
    m, v = weighted_moments(torch.as_tensor(x), wn)
    m_j, v_j = jax.vmap(jax_weighted_moments)(jnp.asarray(x), wn_j)
    np.testing.assert_allclose(m.numpy(), np.asarray(m_j), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), rtol=1e-5, atol=1e-7)


def test_batched_ancestors_equal_jax_per_run():
    logw = _logw(4)
    wn_j, _ = jax.vmap(jax_normalise_weights)(jnp.asarray(logw))
    keys = jax.random.split(jax.random.key(5), B)
    u = np.stack([np.array(jax.random.uniform(k, (N,), jnp.float32)) for k in keys])
    anc = multinomial_ancestors(torch.tensor(np.asarray(wn_j)), torch.as_tensor(u))
    for b in range(B):
        np.testing.assert_array_equal(
            anc[b].numpy(), np.asarray(jax_multinomial_ancestors(keys[b], wn_j[b])))


def test_resample_decides_per_run():
    logw = torch.as_tensor(_logw(6))
    x = torch.as_tensor(np.random.default_rng(7).normal(size=(B, N, 4)),
                        dtype=torch.float32)
    u = torch.rand(B, N, generator=torch.Generator().manual_seed(8))
    wn, ll = normalise_weights(logw)
    xr, lw, do = resample_if_required(u, x, logw, wn, ll, ess(wn))
    assert do.tolist() == [True, False, False]
    assert torch.equal(xr[1:], x[1:]) and torch.equal(lw[1:], logw[1:])
    for b in range(B):
        xb, lwb, dob = resample_if_required(u[b], x[b], logw[b], wn[b], ll[b],
                                            ess(wn[b]))
        assert torch.equal(xb, xr[b]) and torch.equal(lwb, lw[b])
        assert bool(dob) == bool(do[b])


def test_run_draws_are_the_runs_own():
    seeds = torch.tensor([3, 2**40 + 3, 11])
    u, s = run_draws(seeds, range(0, 6), N)
    assert u.shape == (6, 3, N) and s.shape == (6, 3) and s.dtype == torch.int32
    assert bool((u >= 0).all() and (u < 1).all() and (s >= 0).all())
    u1, s1 = run_draws(seeds[2:], range(4, 6), N)
    assert torch.equal(u1[:, 0], u[4:, 2]) and torch.equal(s1[:, 0], s[4:, 2])
    assert not torch.equal(u[:, 0], u[:, 1])  # the high word of the seed counts
    assert len(set(s[:, 0].tolist())) == 6
    big = run_draws(torch.tensor([7]), range(3), 20000)[0]
    assert abs(float(big.mean()) - 0.5) < 0.01


def _fields(carry):
    out = {k: v for k, v in carry._asdict().items()
           if k != "da" and v is not None}
    out.update({f"da.{k}": v for k, v in carry.da._asdict().items()})
    return out


def _run(carry, b):
    return carry._replace(
        **{k: v[b:b + 1] for k, v in carry._asdict().items()
           if k != "da" and v is not None},
        da=type(carry.da)(*(v[b:b + 1] for v in carry.da)),
    )


def test_batched_step_equals_single_steps():
    model = get_model("arma")
    cfg = SMCConfig(n_particles=N, n_iterations=2, step_size=0.01,
                    max_tree_depth=3, adapt_step_size=True, adapt_mass_matrix=True)
    carry = init_state(model, cfg, [1, 2, 3], "cpu")
    carry = carry._replace(logw=torch.as_tensor(_logw(9)))
    u, s = run_draws(torch.tensor([1, 2, 3]), range(1), N)
    new, diag = smc_step(model, cfg, carry, u[0], s[0], "eager", PHILOX)
    assert diag["resampled"].tolist() == [True, False, False]
    for b in range(B):
        new_b, diag_b = smc_step(model, cfg, _run(carry, b), u[0, b:b + 1],
                                 s[0, b:b + 1], "eager", PHILOX)
        batched = _fields(new)
        for k, v in _fields(new_b).items():
            torch.testing.assert_close(v[0], batched[k][b], rtol=0, atol=0,
                                       equal_nan=True, msg=k)
        for k in diag:
            torch.testing.assert_close(diag_b[k][0], diag[k][b], rtol=0, atol=0,
                                       equal_nan=True, msg=k)


@pytest.mark.parametrize("name,adapt", [("arma", False), ("prmwcd", True)])
def test_run_smc_batched_equals_single_runs(name, adapt):
    K, n = 4, 32
    cfg = SMCConfig(n_particles=n, n_iterations=K, step_size=0.01,
                    max_tree_depth=3, save_history=True,
                    adapt_step_size=adapt, adapt_mass_matrix=adapt,
                    target_accept=0.5)
    seeds = [5, 7, 11]
    res = run_smc_batched(get_model(name), cfg, seeds, "cpu")
    assert res.mean_estimate.shape[:2] == (3, K + 1)
    assert res.x_saved.shape == (3, K + 1, n, get_model(name).dim)
    for b, seed in enumerate(seeds):
        one = run_smc(get_model(name), cfg, seed, "cpu")
        for f, v in one._asdict().items():
            torch.testing.assert_close(v, getattr(res, f)[b], rtol=0, atol=0,
                                       equal_nan=True, msg=f)
    flags = res.resampled[:, :K]
    assert bool(flags.any()) and not bool(flags.all())
    if adapt:
        assert torch.equal(res.step_size[:, -1], res.step_size[:, -2])
        assert not torch.equal(res.step_size[:, 0], res.step_size[:, 1])


def test_interop_run_axis_round_trip():
    rng = np.random.default_rng(10)
    fields = dict(
        x=rng.normal(size=(B, N, 4)).astype(np.float32),
        logw=rng.normal(size=(B, N)).astype(np.float32),
        phi=np.ones(B, np.float32), step_size=np.full(B, 0.01, np.float32),
        inv_mass=rng.random((B, 4)).astype(np.float32),
        da=tuple(rng.random(B).astype(np.float32) for _ in range(5)),
    )
    back = carry_to_numpy(carry_from_numpy(**fields, device="cpu"))
    for f, v in fields.items():
        np.testing.assert_array_equal(np.asarray(back[f]), np.asarray(v), err_msg=f)
    with pytest.raises(ValueError, match="one run"):
        carry_to_numpy(carry_from_numpy(**fields, device="cpu"), run_axis=False)
