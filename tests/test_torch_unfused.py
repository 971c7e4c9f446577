"""The unfused proposal path against the JAX package.

Three iterations of `smc_step` with fused_epilogue=False (or a custom momentum
proposal, which turns the fused path off by itself, as in the JAX package)
against JAX's `_make_step` with `nuts_backend="pallas", fused_epilogue=False`,
its kernel interpreted on the CPU (zero bits in the tree), from one state
passed through `interop`. The port's step runs the plain tree with ZERO_BITS
draws and is handed the raw draws the JAX step makes from its key split: the
resampling uniforms (k_res), the momenta's standard normals (k_mom), the
accept-reject uniforms (k_acc) and, for the asymptotic strategy's streaming
estimates, the recycling uniforms. Tolerance atol 1e-4 / rtol 1e-4 on the
carry and the diagnostics (but one, stated at LOGW_ATOL), resampling
decisions exactly. Six cases: forwards; the Gaussian L-kernel (on eight
schools, whose leapfrog is not linear); the asymptotic strategy with
tempering; mass adaptation (momenta from N(0, M)); a diagonal and a dense
momentum proposal.

Then the pieces on their own against the JAX functions: the cached and the
plain accept-reject, the N(0, M) momenta and their density, the dense
proposal's draw and density, the acceptance metric. Within the port: run b
of a batch equals its single run to the bit on the unfused path, and the
unfused path is taken exactly where the JAX package takes it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smcnuts_torch import (
    DiagNormalProposal,
    FullNormalProposal,
    SMCConfig,
    run_smc,
    run_smc_batched,
)
from smcnuts_torch.interop import CARRY_FIELDS, carry_from_numpy, carry_to_numpy
from smcnuts_torch.models import get_model, make_gaussian
from smcnuts_torch.ops.adaptation import mass_momentum_logpdf, mass_momentum_rvs
from smcnuts_torch.ops.draws import ZERO_BITS
from smcnuts_torch.ops.nuts import hmc_accept_reject, hmc_accept_reject_cached
from smcnuts_torch.sampler import _acceptance_metric, smc_step, uses_fused_path
from smcnuts_tpu import DiagNormalProposal as JaxDiagNormalProposal
from smcnuts_tpu import SMCConfig as JaxSMCConfig
from smcnuts_tpu.models import get_model as jax_get_model
from smcnuts_tpu.models import make_gaussian as jax_make_gaussian
from smcnuts_tpu.ops import adaptation as jax_adaptation
from smcnuts_tpu.ops import nuts as jax_nuts
from smcnuts_tpu.proposals import FullNormalProposal as JaxFullNormalProposal
from smcnuts_tpu.sampler import _DIAG_FIELDS, SMCCarry as JaxSMCCarry
from smcnuts_tpu.sampler import _acceptance_metric as jax_acceptance_metric
from smcnuts_tpu.sampler import _make_step

torch.set_num_threads(2)

ITERS, MAX_DEPTH = 3, 3
G_MEAN, G_VAR, G_PRIOR = (1.0, -2.0, 0.5), (0.5, 2.0, 1.0), (4.0, 4.0, 4.0)
FULL_MEAN = (0.1, -0.2, 0.3)
FULL_COV = ((1.5, 0.3, 0.0), (0.3, 1.0, 0.2), (0.0, 0.2, 0.8))

# name: model, N, settings, step size, first temperature, momentum proposal.
# The path is the same for every model (arma runs it end to end in
# test_torch_eager_blocks.py and on the card); the cases take the Gaussian,
# whose interpreted JAX kernel compiles in a fifth of arma's time, and eight
# schools for the Gaussian L-kernel.
CASES = {
    "gaussian_forwards": ("gaussian", 64, dict(fused_epilogue=False), 0.3, 1.0, None),
    "eightschools_gaussianapprox": (
        "eightschools", 128, dict(lkernel="GaussianApproxLKernel", fused_epilogue=False),
        0.02, 1.0, None),
    "gaussian_asymptotic_tempered": (
        "gaussian", 64, dict(lkernel="asymptoticLKernel", tempering=True,
                             save_history=False, fused_epilogue=False), 0.6, 0.05, None),
    "gaussian_mass_adaptation": (
        "gaussian", 64, dict(adapt_mass_matrix=True, fused_epilogue=False), 0.3, 1.0, None),
    # A custom momentum proposal turns the fused path off by itself.
    "gaussian_diag_momentum": ("gaussian", 64, dict(), 0.3, 1.0, "diag"),
    "gaussian_full_momentum": ("gaussian", 64, dict(fused_epilogue=False), 0.3, 1.0, "full"),
}


# The Gaussian L-kernel's conditional covariance c_rr - c_rx c_xx^+ c_xr is
# formed by a float32 cancellation; with the real momenta of the unfused path
# its smallest eigenvalue falls to 0.007 by the third iteration, and on the
# same (r', x') the two packages' L-kernel densities then differ by 2e-3 (the
# port's is 6e-4 from a float64 evaluation, the JAX package's 2.3e-3). The log
# weights of that case are held at this absolute tolerance; all else at 1e-4.
LOGW_ATOL = {"eightschools_gaussianapprox": 5e-3}


def _models(name):
    if name == "gaussian":
        return (make_gaussian(G_MEAN, G_VAR, G_PRIOR),
                jax_make_gaussian(np.array(G_MEAN), np.array(G_VAR),
                                  prior_var=np.array(G_PRIOR)))
    return get_model(name), jax_get_model(name)


def _proposals(kind, dim):
    if kind == "diag":
        var = tuple(np.linspace(0.5, 2.0, dim))
        return DiagNormalProposal(dim, var=var), JaxDiagNormalProposal(dim, var=var)
    if kind == "full":
        return (FullNormalProposal(mean=FULL_MEAN, cov=FULL_COV),
                JaxFullNormalProposal(mean=FULL_MEAN, cov=FULL_COV))
    return None, JaxDiagNormalProposal(dim)


def _start(n, dim, rng):
    return (0.8 * rng.normal(size=(n, dim))).astype(np.float32)


@pytest.fixture(scope="module", params=sorted(CASES))
def trajectory(request):
    """Three JAX iterations from a fixed state, with every draw each
    iteration made from its key split; returns what the port's side needs."""
    model_name, n, settings, step, phi0, kind = CASES[request.param]
    tm, jm = _models(model_name)
    D = jm.dim
    mp, jmp = _proposals(kind, D)
    cfg = JaxSMCConfig(n_particles=n, n_iterations=ITERS, step_size=step,
                       nuts_backend="pallas", max_tree_depth=MAX_DEPTH, **settings)
    jstep = jax.jit(_make_step(jm, cfg, jmp))
    rng = np.random.default_rng(0)
    x0 = _start(n, D, rng)
    logw0 = rng.normal(0, 0.7, n).astype(np.float32)
    step0 = jnp.float32(step)
    streaming = cfg.is_asymptotic
    rec_key = jax.random.key(17)
    carry = JaxSMCCarry(
        x=jnp.asarray(x0), logw=jnp.asarray(logw0), phi=jnp.float32(phi0),
        step_size=step0, inv_mass=jnp.ones(D, jnp.float32),
        da=jax_adaptation.da_init(step0, jnp.float32), key=jax.random.key(3),
        loglik=jm.loglik_batch(jnp.asarray(x0)) if streaming else None,
        rec_key=rec_key if streaming else None,
    )
    fields = CARRY_FIELDS + (("loglik",) if streaming else ())

    def numpy_carry(c):
        return {f: jax.tree.map(np.asarray, getattr(c, f)) for f in fields}

    start = numpy_carry(carry)
    draws, carries, diags = [], [], []
    cd = jm.constrained_dim
    for k in range(ITERS):
        _, k_res, k_mom, _, k_acc = jax.random.split(carry.key, 5)
        draws.append({
            "uniforms": np.array(jax.random.uniform(k_res, (n,), jnp.float32)),
            "momentum_normals": np.array(jax.random.normal(k_mom, (n, D), jnp.float32)),
            "accept_uniforms": np.array(jax.random.uniform(k_acc, (n,), jnp.float32)),
            "recycle_uniforms": np.array(jax.random.uniform(
                jax.random.fold_in(rec_key, k), (n,), jnp.float32)),
        })
        carry, out = jstep(carry, jnp.int32(k))
        carries.append(numpy_carry(carry))
        d = np.asarray(out["diag"])
        nf = len(_DIAG_FIELDS)
        diags.append(dict(zip(_DIAG_FIELDS, d[:nf]), mean=d[nf:nf + cd],
                          var=d[nf + cd:]))
    torch_cfg = SMCConfig(n_particles=n, n_iterations=ITERS, step_size=step,
                          max_tree_depth=MAX_DEPTH, **settings)
    return request.param, tm, mp, torch_cfg, fields, start, draws, carries, diags


def test_three_unfused_steps_match_jax_step(trajectory):
    case, model, mp, cfg, fields, start, draws, carries, diags = trajectory
    assert not uses_fused_path(cfg, mp)
    carry = carry_from_numpy(**start, device="cpu")
    acceptance = []
    for k in range(ITERS):
        d = {name: torch.as_tensor(v)[None] for name, v in draws[k].items()}
        if not cfg.is_asymptotic:
            d.pop("accept_uniforms")
            d.pop("recycle_uniforms")
        carry, diag = smc_step(model, cfg, carry, backend="eager", draws=ZERO_BITS,
                               tree_seed=torch.zeros(1, dtype=torch.int32),
                               momentum_proposal=mp, **d)
        got, want = carry_to_numpy(carry, run_axis=False), carries[k]
        for f in fields:
            atol = LOGW_ATOL.get(case, 1e-4) if f == "logw" else 1e-4
            np.testing.assert_allclose(np.asarray(got[f]), np.asarray(want[f]),
                                       rtol=1e-4, atol=atol,
                                       err_msg=f"{case}, iteration {k}: {f}")
        for f in ("ess", "log_likelihood", "mean", "var", "phi", "acceptance",
                  "step_size", "tree_depth", "tree_leapfrogs", "accept_stat"):
            np.testing.assert_allclose(diag[f][0].numpy(), diags[k][f], rtol=1e-4,
                                       atol=1e-4, err_msg=f"{case}, iteration {k}: {f}")
        assert bool(diag["resampled"][0]) == bool(diags[k]["resampled"] > 0.5)
        acceptance.append(float(diag["acceptance"][0]))
    if cfg.adapt_mass_matrix:
        assert not np.allclose(carry_to_numpy(carry)["inv_mass"], 1.0)
    if cfg.is_asymptotic:
        # The accept-reject outside the tree rejected some proposals.
        assert 0.0 < min(acceptance) < 1.0


def _ar_inputs(seed, B=2, N=40, D=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, N, D)).astype(np.float32)
    xp = (x + 0.3 * rng.normal(size=(B, N, D))).astype(np.float32)
    r = rng.normal(size=(B, N, D)).astype(np.float32)
    rp = rng.normal(size=(B, N, D)).astype(np.float32)
    lp0 = rng.normal(-5, 1, (B, N)).astype(np.float32)
    lp1 = (lp0 + rng.normal(0, 1, (B, N))).astype(np.float32)
    u = rng.uniform(size=(B, N)).astype(np.float32)
    im = rng.uniform(0.5, 2.0, (B, D)).astype(np.float32)
    xp[0, 3, 1] = np.inf  # a non-finite proposal rejects
    lp1[1, 4] = np.nan  # so does a NaN density
    return x, xp, r, rp, lp0, lp1, u, im


@pytest.mark.parametrize("with_mass", [False, True])
def test_accept_reject_cached_matches_jax(with_mass):
    x, xp, r, rp, lp0, lp1, u, im = _ar_inputs(1)
    t = torch.as_tensor
    got = hmc_accept_reject_cached(t(lp0), t(lp1), t(x), t(xp), t(r), t(rp), t(u),
                                   t(im) if with_mass else None)
    for b in range(x.shape[0]):
        key = jax.random.key(b)
        u_b = np.array(jax.random.uniform(key, (x.shape[1],), jnp.float32))
        got_b = hmc_accept_reject_cached(
            t(lp0[b:b + 1]), t(lp1[b:b + 1]), t(x[b:b + 1]), t(xp[b:b + 1]),
            t(r[b:b + 1]), t(rp[b:b + 1]), t(u_b[None]),
            t(im[b:b + 1]) if with_mass else None)
        want = jax_nuts.hmc_accept_reject_cached(
            lp0[b], lp1[b], x[b], xp[b], r[b], rp[b], key,
            inv_mass=im[b] if with_mass else None)
        for g, w in zip(got_b, want):
            np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))
    accepted = got[2].numpy()
    assert not accepted[0, 3] and not accepted[1, 4]
    assert 0 < accepted.mean() < 1


def test_accept_reject_matches_jax():
    x, xp, r, rp, _, _, _, im = _ar_inputs(2)
    key = jax.random.key(4)
    u = np.array(jax.random.uniform(key, (x.shape[1],), jnp.float32))
    got = hmc_accept_reject(lambda z: -0.5 * (z * z).sum(-1), torch.as_tensor(x[:1]),
                            torch.as_tensor(xp[:1]), torch.as_tensor(r[:1]),
                            torch.as_tensor(rp[:1]), torch.as_tensor(u[None]),
                            torch.as_tensor(im[:1]))
    want = jax_nuts.hmc_accept_reject(lambda z: -0.5 * jnp.sum(z * z, axis=1), x[0], xp[0],
                                      r[0], rp[0], key, inv_mass=im[0])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))


def test_mass_momenta_and_density_match_jax():
    rng = np.random.default_rng(3)
    im = rng.uniform(0.2, 3.0, (2, 4)).astype(np.float32)
    for b in range(2):
        key = jax.random.key(10 + b)
        eps = np.array(jax.random.normal(key, (30, 4), jnp.float32))
        r = mass_momentum_rvs(torch.as_tensor(eps)[None], torch.as_tensor(im[b:b + 1]))
        r_j = jax_adaptation.mass_momentum_rvs(key, 30, jnp.asarray(im[b]), jnp.float32)
        np.testing.assert_allclose(r[0].numpy(), np.asarray(r_j), rtol=1e-6)
        lp = mass_momentum_logpdf(r, torch.as_tensor(im[b:b + 1]))
        lp_j = jax_adaptation.mass_momentum_logpdf(r_j, jnp.asarray(im[b]))
        np.testing.assert_allclose(lp[0].numpy(), np.asarray(lp_j), rtol=1e-5, atol=1e-5)


def test_full_normal_proposal_matches_jax():
    ours, theirs = (FullNormalProposal(mean=FULL_MEAN, cov=FULL_COV),
                    JaxFullNormalProposal(mean=FULL_MEAN, cov=FULL_COV))
    key = jax.random.key(5)
    eps = np.array(jax.random.normal(key, (200, 3), jnp.float32))
    x = ours.from_normals(torch.as_tensor(eps))
    x_j = theirs.rvs(key, 200)
    np.testing.assert_allclose(x.numpy(), np.asarray(x_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ours.logpdf(x).numpy(), np.asarray(theirs.logpdf(x_j)),
                               rtol=1e-5, atol=1e-5)
    assert ours.dim == 3
    g = torch.Generator().manual_seed(0)
    draws = ours.rvs(g, 20000).double()
    np.testing.assert_allclose(np.cov(draws.numpy().T), FULL_COV, atol=0.06)


def test_acceptance_metric_matches_jax():
    rng = np.random.default_rng(6)
    x_old = rng.normal(size=(2, 25, 3)).astype(np.float32)
    x_new = x_old.copy()
    x_new[:, :10] += 0.5
    x_new[0, 3, 1] = x_old[0, 3, 1]  # moved in two dimensions of three: not moved
    got = _acceptance_metric(torch.as_tensor(x_new), torch.as_tensor(x_old))
    for b in range(2):
        assert float(got[b]) == pytest.approx(
            float(jax_acceptance_metric(x_new[b], x_old[b])), rel=1e-6)
    assert float(got[0]) == pytest.approx(9 / 25) and float(got[1]) == pytest.approx(10 / 25)


@pytest.mark.parametrize("settings,kind", [
    (dict(fused_epilogue=False), None),
    (dict(lkernel="asymptoticLKernel", tempering=True, fused_epilogue=False), "full"),
    (dict(lkernel="GaussianApproxLKernel"), "diag"),
    (dict(adapt_mass_matrix=True, adapt_step_size=True, fused_epilogue=False), None),
], ids=["forwards", "asymptotic_full", "gaussianapprox_diag", "adapted"])
def test_unfused_batched_run_equals_single_runs(settings, kind):
    model = make_gaussian(G_MEAN, G_VAR, G_PRIOR)
    mp = (None if kind is None else
          DiagNormalProposal(3, var=(0.5, 1.0, 2.0)) if kind == "diag" else
          FullNormalProposal(mean=(0.0, 0.0, 0.0),
                             cov=((1.0, 0.2, 0.0), (0.2, 1.5, 0.1), (0.0, 0.1, 0.7))))
    cfg = SMCConfig(n_particles=48, n_iterations=4, step_size=0.4, max_tree_depth=4,
                    **settings)
    assert not uses_fused_path(cfg, mp)
    seeds = [3, 9, 27]
    batch = run_smc_batched(model, cfg, seeds, "cpu", momentum_proposal=mp)
    for b in (0, 2):
        one = run_smc(model, cfg, seeds[b], "cpu", momentum_proposal=mp)
        for f, v in one._asdict().items():
            if v is not None:
                assert torch.equal(v, getattr(batch, f)[b]), f"run {b}: {f}"
    assert torch.isfinite(batch.mean_estimate).all()
    assert not torch.equal(batch.x_final[0], batch.x_final[1])
    fused = run_smc_batched(model, SMCConfig(n_particles=48, n_iterations=4,
                                             step_size=0.4, max_tree_depth=4),
                            seeds, "cpu")
    assert not torch.equal(fused.x_final, batch.x_final)


def test_fused_path_is_taken_where_jax_takes_it():
    base = dict(n_particles=8, n_iterations=1, step_size=0.1)
    assert uses_fused_path(SMCConfig(**base))
    assert uses_fused_path(SMCConfig(**base), DiagNormalProposal(4))
    assert uses_fused_path(SMCConfig(**base), DiagNormalProposal(4, (0.0,) * 4, (1.0,) * 4))
    assert not uses_fused_path(SMCConfig(**base), DiagNormalProposal(4, var=(2.0,) * 4))
    assert not uses_fused_path(SMCConfig(**base), FullNormalProposal((0.0,), ((1.0,),)))
    # Under mass adaptation the tree draws N(0, M) itself: fused, whatever
    # the momentum proposal.
    adapted = SMCConfig(**base, adapt_mass_matrix=True)
    assert uses_fused_path(adapted, DiagNormalProposal(4, var=(2.0,) * 4))
    assert not uses_fused_path(SMCConfig(**base, fused_epilogue=False))
