"""The three L-kernel strategies with adaptive tempering, as a whole.

Against the JAX package: three iterations of `smc_step` against JAX's
`_make_step`, from one state passed through `interop`, for four
strategy/model pairs. The JAX step runs its Pallas NUTS kernel interpreted on
the CPU (zero bits), the port's step the plain tree with ZERO_BITS draws, and
the port is handed the raw uniforms the JAX step draws from its keys: those of
the resampling and, for the asymptotic strategy (save_history=False, the
streaming form), those of each iteration's tempered-recycling estimate.
Tolerance atol 1e-4 / rtol 1e-4 on the carry and the diagnostics, resampling
decisions exactly. Under zero bits the accept-reject accepts every finite
delta_h, so the eight-schools case plants one particle whose density is not
finite and which therefore rejects, in both packages. (While that particle is
in the population the JAX package's recycled estimate is not compared: its
one-hot matmul gather multiplies the particle's -inf log-likelihood by 0 for
every row, so all of its resampled log-likelihoods are NaN and its estimate is
0. The port gathers by index; the Gaussian case compares the estimates.)

Within the port, on the CPU: the recycled estimates made inside the loop equal
those from the saved history to the bit; run b of a batch equals the run
alone; the golden moments of the analytic Gaussian (tests/test_sampler.py) for
all three strategies; the tempered schedule; the CLI's new flags.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smcnuts_torch import SMCConfig, run_smc, run_smc_batched
from smcnuts_torch.__main__ import main as torch_main
from smcnuts_torch.interop import CARRY_FIELDS, carry_from_numpy, carry_to_numpy
from smcnuts_torch.models import get_model, make_gaussian, tempered_moments
from smcnuts_torch.ops.draws import ZERO_BITS
from smcnuts_torch.ops.nuts_cuda import nuts_tree_plain
from smcnuts_torch.sampler import _recycled_estimate, init_state, smc_step
from smcnuts_tpu import DiagNormalProposal as JaxDiagNormalProposal
from smcnuts_tpu import SMCConfig as JaxSMCConfig
from smcnuts_tpu.models import get_model as jax_get_model
from smcnuts_tpu.models import make_gaussian as jax_make_gaussian
from smcnuts_tpu.ops.adaptation import da_init
from smcnuts_tpu.sampler import _DIAG_FIELDS, SMCCarry as JaxSMCCarry
from smcnuts_tpu.sampler import _make_step
from smcnuts_tpu.sampler import _recycled_estimate as jax_recycled_estimate

torch.set_num_threads(2)

N, ITERS, MAX_DEPTH = 128, 3, 3
G_MEAN, G_VAR, G_PRIOR = (1.0, -2.0, 0.5), (0.5, 2.0, 1.0), (4.0, 4.0, 4.0)

# name: model, settings, step size, the first temperature, the planted
# particle (coordinate, value) whose density is not finite.
CASES = {
    # phi0 below cached_loglik_min_phi: the first iteration evaluates the
    # log-likelihood directly, the later ones recover it from the tree.
    "gaussian_forwards_tempered": (
        "gaussian", dict(lkernel="forwardsLKernel", tempering=True), 0.05, 0.005, None),
    "gaussian_gaussianapprox": (
        "gaussian", dict(lkernel="GaussianApproxLKernel"), 0.5, 1.0, None),
    "eightschools_gaussianapprox": (
        "eightschools", dict(lkernel="GaussianApproxLKernel"), 0.02, 1.0, None),
    "gaussian_asymptotic_tempered": (
        "gaussian", dict(lkernel="asymptoticLKernel", tempering=True,
                         save_history=False), 0.05, 0.05, None),
    "eightschools_asymptotic": (
        "eightschools", dict(lkernel="asymptoticLKernel", tempering=True,
                             save_history=False), 0.02, 0.05, (1, 200.0)),
}


# The Gaussian's leapfrog is linear, so with the one momentum of zero bits r'
# is a piecewise-linear function of x' and the L-kernel's conditional
# covariance is its 1e-6 ridge plus float32 rounding: log|cov| is then
# ill-conditioned, and the two packages' log-weights differ by one constant
# for all particles (normalised weights, ESS and estimates agree). The constant
# is held below RIDGE_OFFSET, far under the D log sqrt(2 pi) = 2.76 or the
# 0.5 sum log inv_mass that a wrong q(r0) would show; eight schools, whose
# leapfrog is not linear, is held to 1e-4 throughout.
RIDGE_BOUND = ("gaussian_gaussianapprox",)
RIDGE_OFFSET = 0.5


def _models(name):
    if name == "gaussian":
        return (make_gaussian(G_MEAN, G_VAR, G_PRIOR),
                jax_make_gaussian(np.array(G_MEAN), np.array(G_VAR),
                                  prior_var=np.array(G_PRIOR)))
    return get_model(name), jax_get_model(name)


@pytest.fixture(scope="module", params=sorted(CASES))
def trajectory(request):
    """Three JAX iterations from a fixed state, with the uniforms each
    iteration drew; returns what the port's side needs."""
    model_name, settings, step, phi0, planted = CASES[request.param]
    tm, jm = _models(model_name)
    D = jm.dim
    cfg = JaxSMCConfig(n_particles=N, n_iterations=ITERS, step_size=step,
                       nuts_backend="pallas", max_tree_depth=MAX_DEPTH, **settings)
    jstep = jax.jit(_make_step(jm, cfg, JaxDiagNormalProposal(D)))
    rng = np.random.default_rng(0)
    x0 = (0.8 * rng.normal(size=(N, D))).astype(np.float32)
    logw0 = rng.normal(0, 0.7, N).astype(np.float32)
    if planted is not None:
        x0[5, planted[0]] = planted[1]
        logw0[5] = -np.inf
    step0 = jnp.float32(step)
    streaming = cfg.is_asymptotic
    rec_key = jax.random.key(17)
    carry = JaxSMCCarry(
        x=jnp.asarray(x0), logw=jnp.asarray(logw0), phi=jnp.float32(phi0),
        step_size=step0, inv_mass=jnp.ones(D, jnp.float32),
        da=da_init(step0, jnp.float32), key=jax.random.key(3),
        loglik=jm.loglik_batch(jnp.asarray(x0)) if streaming else None,
        rec_key=rec_key if streaming else None,
    )
    fields = CARRY_FIELDS + (("loglik",) if streaming else ())

    def numpy_carry(c):
        return {f: jax.tree.map(np.asarray, getattr(c, f)) for f in fields}

    start = numpy_carry(carry)
    uniforms, recycle, carries, diags = [], [], [], []
    cd = jm.constrained_dim
    for k in range(ITERS):
        k_res = jax.random.split(carry.key, 5)[1]
        uniforms.append(np.array(jax.random.uniform(k_res, (N,), jnp.float32)))
        recycle.append(np.array(jax.random.uniform(
            jax.random.fold_in(rec_key, k), (N,), jnp.float32)))
        carry, out = jstep(carry, jnp.int32(k))
        carries.append(numpy_carry(carry))
        d = np.asarray(out["diag"])
        nf = len(_DIAG_FIELDS)
        diags.append(dict(zip(_DIAG_FIELDS, d[:nf]), mean=d[nf:nf + cd],
                          var=d[nf + cd:]))
    torch_cfg = SMCConfig(n_particles=N, n_iterations=ITERS, step_size=step,
                          max_tree_depth=MAX_DEPTH, **settings)
    return request.param, tm, torch_cfg, fields, start, uniforms, recycle, carries, diags


def test_three_steps_match_jax_step(trajectory):
    case, model, cfg, fields, start, uniforms, recycle, carries, diags = trajectory
    planted = CASES[case][4]
    carry = carry_from_numpy(**start, device="cpu")
    assert (carry.loglik is not None) == cfg.is_asymptotic
    phis = [float(carry.phi)]
    planted_in = planted is not None
    offsets = []
    for k in range(ITERS):
        carry, diag = smc_step(
            model, cfg, carry, torch.as_tensor(uniforms[k])[None],
            torch.zeros(1, dtype=torch.int32), "eager", ZERO_BITS,
            torch.as_tensor(recycle[k])[None] if cfg.is_asymptotic else None)
        got, want = carry_to_numpy(carry, run_axis=False), carries[k]
        for f in fields:
            g, w = got[f], want[f]
            if case in RIDGE_BOUND and f == "logw":
                offset = np.median(g - w)
                assert abs(offset) < RIDGE_OFFSET, f"{case}, iteration {k}: {offset}"
                offsets.append(offset)
                g = g - offset
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                       err_msg=f"{case}, iteration {k}: {f}")
        for f in ("ess", "log_likelihood", "mean", "var", "phi", "acceptance",
                  "step_size", "tree_depth", "tree_leapfrogs", "accept_stat"):
            if planted_in and f in ("mean", "var"):
                assert torch.isfinite(diag[f]).all()
                continue
            g = diag[f][0].numpy()
            if f == "log_likelihood" and k > 0 and case in RIDGE_BOUND:
                g = g - offsets[k - 1]  # the entering weights carry the offset
            np.testing.assert_allclose(g, diags[k][f], rtol=1e-4, atol=1e-4,
                                       err_msg=f"{case}, iteration {k}: {f}")
        assert bool(diag["resampled"][0]) == bool(diags[k]["resampled"] > 0.5)
        planted_in = planted_in and not bool(diag["resampled"][0])
        if planted is not None and k == 0:
            # The planted particle was in the tree and was rejected: it is
            # where it was, in both packages.
            assert not bool(diag["resampled"][0])
            assert got["x"][5, planted[0]] == np.float32(planted[1])
            assert got["x"][5, planted[0]] == want["x"][5, planted[0]]
            assert float(diag["acceptance"][0]) == pytest.approx((N - 1) / N)
        phis.append(float(carry.phi))
    if cfg.tempering:
        assert phis[0] < phis[1] and all(a <= b for a, b in zip(phis, phis[1:]))
    else:
        assert phis == [1.0] * (ITERS + 1)


@pytest.mark.parametrize("phi_k", [0.1, 1.0])
def test_recycled_estimate_matches_jax(phi_k):
    """One tempered-recycling estimate on the same state and uniforms."""
    tm, jm = _models("eightschools")
    rng = np.random.default_rng(4)
    x = (0.5 * rng.normal(size=(N, 10))).astype(np.float32)
    logw = rng.normal(0, 1.0, N).astype(np.float32)
    key = jax.random.key(9)
    u = np.array(jax.random.uniform(key, (N,), jnp.float32))
    ll_j = jm.loglik_batch(jnp.asarray(x))
    mean_j, var_j = jax_recycled_estimate(jm, key, jnp.asarray(x), jnp.asarray(logw),
                                          ll_j, jnp.float32(phi_k))
    mean, var = _recycled_estimate(
        tm, torch.as_tensor(u)[None], torch.as_tensor(x)[None],
        torch.as_tensor(logw)[None], torch.as_tensor(np.array(ll_j))[None],
        torch.tensor([phi_k]))
    np.testing.assert_allclose(mean[0].numpy(), np.asarray(mean_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(var[0].numpy(), np.asarray(var_j), rtol=1e-4, atol=1e-5)


# ---- within the port, on the CPU

def _gaussian_cfg(lkernel, tempering, n=64, k=6, **kw):
    return SMCConfig(n_particles=n, n_iterations=k, step_size=0.5, lkernel=lkernel,
                     tempering=tempering, max_tree_depth=5, **kw)


@pytest.mark.parametrize("resampling", ["multinomial", "systematic"])
def test_streaming_equals_saved_history(resampling):
    """The asymptotic strategy's estimates made inside the loop
    (save_history=False) and from the saved history draw the same uniforms
    and agree to the bit, as they do key for key in the JAX package."""
    model = make_gaussian(G_MEAN, G_VAR, G_PRIOR)
    cfg = _gaussian_cfg("asymptoticLKernel", True, resampling=resampling)
    saved = run_smc_batched(model, cfg, [1, 2], "cpu")
    stream = run_smc_batched(model, dataclasses.replace(cfg, save_history=False),
                             [1, 2], "cpu")
    assert saved.x_saved.shape == (2, 7, 64, 3) and stream.x_saved is None
    for f in ("mean_estimate", "variance_estimate", "phi", "ess", "log_likelihood",
              "x_final", "logw_final", "resampled"):
        assert torch.equal(getattr(saved, f), getattr(stream, f)), f
    # The estimates are the recycled ones at every index, not the plain ones.
    plain = run_smc_batched(
        model, dataclasses.replace(cfg, lkernel="forwardsLKernel"), [1, 2], "cpu")
    assert not torch.equal(saved.mean_estimate[:, 0], plain.mean_estimate[:, 0])


@pytest.mark.parametrize("lkernel,tempering", [
    ("asymptoticLKernel", True), ("GaussianApproxLKernel", False),
    ("GaussianApproxLKernel", True), ("forwardsLKernel", True),
])
def test_batched_run_equals_single_run(lkernel, tempering):
    model = make_gaussian(G_MEAN, G_VAR, G_PRIOR)
    cfg = _gaussian_cfg(lkernel, tempering, k=5)
    seeds = [3, 9, 27]
    batch = run_smc_batched(model, cfg, seeds, "cpu")
    for b in (0, 2):
        one = run_smc(model, cfg, seeds[b], "cpu")
        for f, v in one._asdict().items():
            if v is not None:
                assert torch.equal(v, getattr(batch, f)[b]), f"run {b}: {f}"
    assert not torch.equal(batch.x_final[0], batch.x_final[1])


@pytest.mark.parametrize("lkernel,tempering", [
    ("forwardsLKernel", False), ("GaussianApproxLKernel", False),
    ("asymptoticLKernel", True),
])
def test_gaussian_posterior_moments(lkernel, tempering):
    """The golden values of tests/test_sampler.py:26-39, same settings."""
    model = make_gaussian(G_MEAN, G_VAR, G_PRIOR)
    cfg = SMCConfig(n_particles=512, n_iterations=15, step_size=0.5,
                    lkernel=lkernel, tempering=tempering)
    calls = nuts_tree_plain.calls
    res = run_smc(model, cfg, 0, "cpu")
    assert nuts_tree_plain.calls == calls + 15
    want_mean, want_var = tempered_moments(G_MEAN, G_VAR, G_PRIOR, 1.0)
    np.testing.assert_allclose(want_mean, G_MEAN)
    np.testing.assert_allclose(res.mean_estimate[-1].numpy(), want_mean, atol=0.25)
    np.testing.assert_allclose(res.variance_estimate[-1].numpy(), want_var, rtol=0.35)
    assert float(res.acceptance_rate[-1]) == 0.0
    assert bool((res.phi == 1).all()) != tempering


@pytest.mark.parametrize("lkernel", ["asymptoticLKernel", "forwardsLKernel"])
def test_tempering_schedule_monotone(lkernel):
    model = make_gaussian(G_MEAN, G_VAR, G_PRIOR)
    cfg = SMCConfig(n_particles=256, n_iterations=10, step_size=0.5,
                    lkernel=lkernel, tempering=True, max_tree_depth=6)
    res = run_smc_batched(model, cfg, [0, 1, 2], "cpu")
    phi = res.phi.numpy()
    assert phi.shape == (3, 11)
    assert np.all(phi[:, 0] > 0.0) and np.all(phi[:, 0] < 1.0)
    assert np.all(np.diff(phi, axis=1) >= 0.0)
    assert np.all(phi[:, -1] == 1.0)
    assert len({float(v) for v in phi[:, 0]}) == 3  # every run its own schedule


def test_init_state_bisects_from_zero_on_the_prior_draws():
    """phi0 is the full bisection from phi_old = 0 per run, logw0 the tempered
    density at it minus the proposal's, and the asymptotic strategy carries
    the log-likelihood of the draws."""
    model = make_gaussian(G_MEAN, G_VAR, G_PRIOR)
    cfg = _gaussian_cfg("asymptoticLKernel", True, n=128)
    carry = init_state(model, cfg, [4, 5], "cpu")
    assert carry.phi.shape == (2,) and bool(((carry.phi > 0) & (carry.phi < 1)).all())
    for b in range(2):
        ll = model.loglik(carry.x[b])
        assert torch.equal(carry.loglik[b], ll)
        wn = torch.softmax(carry.phi[b] * ll, 0)
        assert float(1.0 / (wn ** 2).sum()) == pytest.approx(64.0, rel=0.02)
    plain = init_state(model, _gaussian_cfg("forwardsLKernel", False, n=128), [4, 5], "cpu")
    assert plain.loglik is None and bool((plain.phi == 1).all())
    assert torch.equal(plain.x, carry.x)


CLI = ["-N", "64", "-K", "4", "--max-tree-depth", "3", "--device", "cpu"]


@pytest.mark.parametrize("argv,tempered", [
    (["--model", "arma", "--tempering"], True),
    (["--model", "arma", "--resampling", "systematic"], False),
    (["--model", "eightschools", "--lkernel", "asymptoticLKernel", "--step-size", "0.2"], True),
    (["--model", "logistic", "--lkernel", "GaussianApproxLKernel", "--tempering",
      "--step-size", "0.1"], True),
    (["--model", "prmwcd", "--lkernel", "GaussianApproxLKernel"], False),
], ids=lambda v: "-".join(a.lstrip("-") for a in v[1:4]) if isinstance(v, list) else None)
def test_cli_strategy_flags(argv, tempered, capsys):
    summary = torch_main(CLI + argv)
    phis = summary["phi_schedule"]
    assert len(phis) == 5 and phis == sorted(phis) and phis[0] > 0
    assert (phis[0] < 1.0) == tempered or summary["model"] == "eightschools"
    assert np.all(np.isfinite(summary["mean"] + summary["variance"]))
    assert summary["lkernel"] == (argv[argv.index("--lkernel") + 1]
                                  if "--lkernel" in argv else "forwardsLKernel")
    assert '"phi_schedule"' in capsys.readouterr().out
