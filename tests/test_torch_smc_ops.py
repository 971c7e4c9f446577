"""The port's SMC primitives against the JAX package's, on the same inputs.

Weight normalisation, ESS, moments and multinomial resampling; the
resampling uniforms are drawn by JAX and handed to the port, so ancestors
must be exactly equal. Also the config's validation and its guard for the two
settings still outside the port. Systematic resampling, tempering and the
L-kernels have files of their own (tests/test_torch_tempering.py,
tests/test_torch_lkernels.py).
The batched (B, N) forms of the same functions are held to the JAX package
in tests/test_torch_batched.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smcnuts_torch import DiagNormalProposal, SMCConfig
from smcnuts_torch.models import ArmaModel
from smcnuts_torch.ops.moments import estimate, weighted_moments
from smcnuts_torch.ops.resampling import (
    multinomial_ancestors,
    resample_if_required,
)
from smcnuts_torch.ops.weights import ess, normalise_weights
from smcnuts_tpu import DiagNormalProposal as JaxDiagNormalProposal
from smcnuts_tpu import SMCConfig as JaxSMCConfig
from smcnuts_tpu.models import make_arma
from smcnuts_tpu.ops import ess as jax_ess
from smcnuts_tpu.ops import multinomial_ancestors as jax_multinomial_ancestors
from smcnuts_tpu.ops import normalise_weights as jax_normalise_weights
from smcnuts_tpu.ops import weighted_moments as jax_weighted_moments
from smcnuts_tpu.ops.moments import estimate as jax_estimate
from smcnuts_tpu.ops.resampling import (
    resample_if_required as jax_resample_if_required,
)

torch.set_num_threads(2)

_rng = np.random.default_rng(0)
LOGW_CASES = {
    "finite": _rng.normal(size=50) * 10,
    "with_neg_inf": np.where(_rng.random(50) < 0.3, -np.inf, _rng.normal(size=50)),
    "with_nan": np.where(_rng.random(50) < 0.2, np.nan, _rng.normal(size=50) * 3),
    "all_neg_inf": np.full(50, -np.inf),
}


@pytest.mark.parametrize("case", sorted(LOGW_CASES))
def test_normalise_weights_and_ess_match_jax(case):
    logw = LOGW_CASES[case].astype(np.float32)
    wn, ll = normalise_weights(torch.as_tensor(logw))
    wn_j, ll_j = jax_normalise_weights(jnp.asarray(logw))
    np.testing.assert_allclose(wn.numpy(), np.asarray(wn_j), rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(float(ll), float(ll_j), rtol=1e-6)
    np.testing.assert_allclose(float(ess(wn)), float(jax_ess(wn_j)), rtol=1e-5)
    assert np.all(wn.numpy()[~(logw > -np.inf)] == 0.0)


def test_weighted_moments_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(40, 4)).astype(np.float32)
    wn = rng.dirichlet(np.ones(40)).astype(np.float32)
    m, v = weighted_moments(torch.as_tensor(x), torch.as_tensor(wn))
    m_j, v_j = jax_weighted_moments(jnp.asarray(x), jnp.asarray(wn))
    np.testing.assert_allclose(m.numpy(), np.asarray(m_j), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), rtol=1e-5, atol=1e-7)


def test_constrained_estimate_matches_jax():
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(40, 4)) * 0.3).astype(np.float32)
    wn = rng.dirichlet(np.ones(40)).astype(np.float32)
    m, v = estimate(ArmaModel(), torch.as_tensor(x), torch.as_tensor(wn))
    m_j, v_j = jax_estimate(make_arma(), jnp.asarray(x), jnp.asarray(wn))
    np.testing.assert_allclose(m.numpy(), np.asarray(m_j), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), rtol=1e-5, atol=1e-7)


WN_CASES = {
    "dirichlet": np.random.default_rng(3).dirichlet(np.ones(64)),
    "degenerate": np.random.default_rng(4).dirichlet(np.full(64, 0.05)),
    "with_zeros": np.where(np.arange(64) % 3 == 0, 0.0, 1.0) / 42.0,
}


@pytest.mark.parametrize("case", sorted(WN_CASES))
@pytest.mark.parametrize("key", [0, 1, 2])
def test_multinomial_ancestors_equal_jax(case, key):
    wn = WN_CASES[case].astype(np.float32)
    k = jax.random.key(key)
    u = np.array(jax.random.uniform(k, (wn.shape[0],), dtype=jnp.float32))
    anc = multinomial_ancestors(torch.as_tensor(wn), torch.as_tensor(u))
    anc_j = jax_multinomial_ancestors(k, jnp.asarray(wn))
    np.testing.assert_array_equal(anc.numpy(), np.asarray(anc_j))
    assert np.all(wn[anc.numpy()] > 0)


@pytest.mark.parametrize("scale", [0.3, 5.0])  # ESS above / below N/2
def test_resample_if_required_matches_jax(scale):
    rng = np.random.default_rng(5)
    n = 48
    x = rng.normal(size=(n, 4)).astype(np.float32)
    logw = (rng.normal(size=n) * scale).astype(np.float32)
    wn_j, ll_j = jax_normalise_weights(jnp.asarray(logw))
    ess_j = jax_ess(wn_j)
    k = jax.random.key(7)
    u = np.array(jax.random.uniform(k, (n,), dtype=jnp.float32))
    xr_j, lw_j, do_j = jax_resample_if_required(
        k, jnp.asarray(x), jnp.asarray(logw), wn_j, ll_j, ess_j, 0.5,
        "multinomial",
    )
    wn, ll = normalise_weights(torch.as_tensor(logw))
    xr, lw, do = resample_if_required(
        torch.as_tensor(u), torch.as_tensor(x), torch.as_tensor(logw), wn, ll,
        ess(wn), 0.5,
    )
    assert bool(do) == bool(do_j)
    np.testing.assert_array_equal(xr.numpy(), np.asarray(xr_j))
    np.testing.assert_allclose(lw.numpy(), np.asarray(lw_j), rtol=1e-6)


def test_diag_normal_proposal_logpdf_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(20, 4)).astype(np.float32)
    for mean, var in [(None, None), ((0.1, 0.2, 0.3, 0.4), (0.5, 1.0, 2.0, 4.0))]:
        lp = DiagNormalProposal(4, mean, var).logpdf(torch.as_tensor(x))
        lp_j = JaxDiagNormalProposal(4, mean, var).logpdf(jnp.asarray(x))
        np.testing.assert_allclose(lp.numpy(), np.asarray(lp_j), rtol=1e-6)


def test_diag_normal_proposal_draws_from_its_generator():
    g = torch.Generator().manual_seed(3)
    x = DiagNormalProposal(4, (1.0, 0, 0, 0), (4.0, 1, 1, 1)).rvs(g, 20000)
    assert x.shape == (20000, 4)
    np.testing.assert_allclose(x.mean(0).numpy(), [1, 0, 0, 0], atol=0.05)
    np.testing.assert_allclose(x.var(0).numpy(), [4, 1, 1, 1], rtol=0.05)


INVALID = [
    dict(n_particles=0), dict(n_iterations=0), dict(step_size=0.0),
    dict(lkernel="bogus"), dict(resampling="bogus"), dict(nuts_backend="xla"),
    dict(cached_loglik_min_phi=1.0), dict(compaction="yes"),
    dict(adapt_warmup_frac=0.0),
]


@pytest.mark.parametrize("bad", INVALID, ids=lambda d: next(iter(d)))
def test_config_validation_matches_jax(bad):
    base = dict(n_particles=8, n_iterations=2, step_size=0.01)
    with pytest.raises(ValueError):
        SMCConfig(**{**base, **bad})
    jax_bad = {"pallas_compaction" if k == "compaction" else k: v
               for k, v in bad.items()}
    if "nuts_backend" not in jax_bad:  # "xla" is valid in the JAX package
        with pytest.raises(ValueError):
            JaxSMCConfig(**{**base, **jax_bad})


OUT_OF_SLICE = [
    # The two settings that raised until the unfused proposal path and the
    # blocked eager tree were ported; each now runs, beside the strategies,
    # tempering and resampling settings, and matches the JAX config. The
    # second element names the ROADMAP item that brought it.
    (dict(lkernel="asymptoticLKernel", fused_epilogue=False), "Queue 1 item 5"),
    (dict(lkernel="GaussianApproxLKernel", eager_block_size=64), "Queue 1 item 4"),
    (dict(tempering=True, fused_epilogue=False), "Queue 1 item 5"),
    (dict(adapt_step_size=True, lkernel="asymptoticLKernel", eager_block_size=64),
     "Queue 1 item 4"),
    (dict(adapt_mass_matrix=True, tempering=True, fused_epilogue=False),
     "Queue 1 item 5"),
    (dict(resampling="systematic", eager_block_size=64), "Queue 1 item 4"),
    (dict(fused_epilogue=False), "Queue 1 item 5"),
    (dict(eager_block_size=4096), "Queue 1 item 4"),
]


@pytest.mark.parametrize("setting,item", OUT_OF_SLICE,
                         ids=lambda v: str(v) if isinstance(v, str) else next(iter(v)))
def test_settings_outside_slice_raise(setting, item):
    """Once outside the port (they raised NotImplementedError naming `item`),
    now accepted and equal to the JAX config field for field, with
    `eager_block_size` for the JAX package's `xla_block_size`."""
    cfg = SMCConfig(n_particles=8, n_iterations=2, step_size=0.01, **setting)
    jax_cfg = JaxSMCConfig(n_particles=8, n_iterations=2, step_size=0.01, **{
        "xla_block_size" if k == "eager_block_size" else k: v for k, v in setting.items()})
    for k, v in setting.items():
        jax_k = "xla_block_size" if k == "eager_block_size" else k
        assert getattr(cfg, k) == getattr(jax_cfg, jax_k) == v
    assert cfg.eager_block_size == jax_cfg.xla_block_size
    assert cfg.fused_epilogue == jax_cfg.fused_epilogue
    assert cfg.is_asymptotic == jax_cfg.is_asymptotic
    assert item in ("Queue 1 item 4", "Queue 1 item 5")


@pytest.mark.parametrize("setting", [
    dict(adapt_step_size=True), dict(adapt_mass_matrix=True),
    dict(adapt_step_size=True, adapt_mass_matrix=True, target_accept=0.5),
], ids=lambda d: "+".join(k for k in d if k.startswith("adapt")))
def test_adaptation_settings_accepted(setting):
    cfg = SMCConfig(n_particles=8, n_iterations=2, step_size=0.01, **setting)
    jax_cfg = JaxSMCConfig(n_particles=8, n_iterations=2, step_size=0.01, **setting)
    for k in ("adapt_step_size", "adapt_mass_matrix", "target_accept",
              "adapt_warmup_frac"):
        assert getattr(cfg, k) == getattr(jax_cfg, k)


@pytest.mark.parametrize("setting", [
    dict(lkernel="asymptoticLKernel"), dict(lkernel="GaussianApproxLKernel"),
    dict(tempering=True), dict(resampling="systematic"),
    dict(lkernel="asymptoticLKernel", tempering=True, save_history=False,
         resampling="systematic", adapt_step_size=True),
], ids=lambda d: "+".join(str(v) for v in d.values()))
def test_strategy_settings_accepted(setting):
    cfg = SMCConfig(n_particles=8, n_iterations=2, step_size=0.01, **setting)
    jax_cfg = JaxSMCConfig(n_particles=8, n_iterations=2, step_size=0.01, **setting)
    for k in setting:
        assert getattr(cfg, k) == getattr(jax_cfg, k)
    assert cfg.is_asymptotic == jax_cfg.is_asymptotic
    assert cfg.cached_loglik_min_phi == jax_cfg.cached_loglik_min_phi == 1e-2
