"""User-written densities: the autograd model and the generated in-kernel
models (`ops/generated.py`) against the JAX package's adapters.

- `CallableModel` (autograd) of arma's logprior and loglik written in torch
  against the JAX `make_arma()` Model's `jax.value_and_grad`, float64 and
  float32.
- The generated forward-mode arma (`arma_model_fwd`, plain version) against
  `arma_tile_model_fwd(y).tile_fn`, and the reverse-mode eight schools and a
  T=40 recurrence against `tile_model_from_logp(...).tile_fn`, on one lane
  tile layout.
- The plain tree on the generated T=40 arma under zero bits against the
  interpreted Pallas kernel with `tile_model_from_logp_fwd`, and three SMC
  iterations against the JAX step with that tile model, the hand and the
  generated model held to each other where both drift from JAX (step
  0.01); then `SMCSampler` end to end on the CPU, eager (autograd) and
  generated.
- The simplifier (CSE, identities, arma's op count beside the JAX simplified
  jaxpr's), unsupported ops, the emitted source, and the CLI's
  `--chunk-size`.

The kernels themselves run only on the card (tests/test_torch_cuda.py,
chip_smoke.py); inputs are made with numpy from fixed seeds.
"""

import dataclasses
import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smcnuts_torch import SMCConfig, SMCSampler
from smcnuts_torch.__main__ import main as torch_main
from smcnuts_torch.interop import CARRY_FIELDS, carry_from_numpy, carry_to_numpy
from smcnuts_torch.models import get_model
from smcnuts_torch.models.arma import (
    arma_logprior_seq,
    arma_loglik_seq,
    arma_model_fwd,
    load_asset,
)
from smcnuts_torch.models.base import CallableModel
from smcnuts_torch.models.eightschools import (
    SIGMA,
    Y,
    make_eightschools_generated,
)
from smcnuts_torch.ops.draws import ZERO_BITS
from smcnuts_torch.ops.generated import tile_model_from_logp, tile_model_from_logp_fwd
from smcnuts_torch.ops.nuts_cuda import STAT_KEYS, _model_data, nuts_tree_plain
from smcnuts_torch.sampler import resolve_backend, smc_step
from smcnuts_tpu import DiagNormalProposal as JaxDiagNormalProposal
from smcnuts_tpu import SMCConfig as JaxSMCConfig
from smcnuts_tpu.models import make_arma
from smcnuts_tpu.ops.adaptation import da_init
from smcnuts_tpu.ops.nuts_pallas import arma_tile_model_fwd, nuts_batch_pallas
from smcnuts_tpu.ops.nuts_pallas import tile_model_from_logp as jax_tile_model_from_logp
from smcnuts_tpu.sampler import _DIAG_FIELDS, SMCCarry as JaxSMCCarry
from smcnuts_tpu.sampler import _make_step

torch.set_num_threads(2)

POST_MODE = np.array([0.007, 0.957, -0.034, np.log(0.166)])
LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)
Y_ARMA = load_asset()["y"]


def _arma_points(n, seed):
    """Around the posterior and away from it; |theta| < 1 keeps the MA
    recurrence stable."""
    rng = np.random.default_rng(seed)
    return np.stack([
        rng.normal(0.0, 0.5, n), rng.uniform(-1.0, 1.5, n),
        rng.uniform(-0.9, 0.9, n), rng.normal(np.log(0.2), 0.5, n),
    ], axis=1)


def _arma_callable(y=Y_ARMA):
    loglik = arma_loglik_seq(y)
    return CallableModel("arma", 4, lambda t: arma_logprior_seq(t.unbind(0)),
                         lambda t: loglik(t.unbind(0)))


# ------------------------------------------------------------ (a) autograd

_JAX_ARMA = make_arma()
# One compile per dtype; phi is an argument.
_jax_value_and_grad = jax.jit(jax.vmap(
    jax.value_and_grad(lambda t, p: _JAX_ARMA.logp(t, p)), in_axes=(0, None)))


@pytest.mark.parametrize("phi", [1.0, 0.4])
def test_callable_model_matches_jax_model_float64(phi):
    """atol 1e-10, with rtol 1e-10 beside it: at the dispersed points the
    gradient reaches ~1e6, where float64's spacing is ~2e-10."""
    x = _arma_points(256, 0)
    lp, g = _arma_callable().logp_and_grad(torch.as_tensor(x), phi)
    with jax.enable_x64(True):
        lp_j, g_j = _jax_value_and_grad(jnp.asarray(x, jnp.float64), phi)
        lp_j, g_j = np.asarray(lp_j), np.asarray(g_j)
    assert lp.dtype == torch.float64
    np.testing.assert_allclose(lp.numpy(), lp_j, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(g.numpy(), g_j, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("phi", [1.0, 0.4])
def test_callable_model_matches_jax_model_float32(phi):
    x = _arma_points(256, 1).astype(np.float32)
    model = _arma_callable()
    xt = torch.as_tensor(x)
    lp, g = model.logp_and_grad(xt, phi)
    jm = make_arma()
    lp_j, g_j = _jax_value_and_grad(jnp.asarray(x), phi)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lp_j), rtol=1e-5)
    # rtol 1e-5, and beside it 1e-5 of the point's largest component: the
    # JAX model sums the recurrence by an associative scan, the port in
    # sequence, and a small component is a sum of terms as large as the
    # largest, which cancel.
    g_j = np.asarray(g_j)
    scale = np.abs(g_j).max(axis=1, keepdims=True)
    assert np.all(np.abs(g.numpy() - g_j) <= 1e-5 * (np.abs(g_j) + scale))
    # The batched methods are the per-particle callables under vmap.
    np.testing.assert_allclose(model.logp(xt, phi).numpy(), lp.numpy(), rtol=1e-6)
    np.testing.assert_allclose(model.loglik(xt).numpy(),
                               np.asarray(jax.vmap(jm.loglik)(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-4)  # atol: values near 0


# ------------------------------------------------------- (b) forward mode


@pytest.fixture(scope="module")
def arma200():
    """The generated arma at T=200, and the JAX simplified jaxpr of
    arma_tile_model_fwd(y).tile_fn on one (8, 128) tile layout (traced once:
    the simplifier's re-trace takes seconds)."""
    tm = arma_tile_model_fwd(Y_ARMA)
    tiles = [jnp.zeros((8, 128), jnp.float32)] * 4
    jaxpr = jax.make_jaxpr(lambda ts, p: tm.tile_fn((), ts, p))(
        tiles, jnp.full((8, 128), 0.7, jnp.float32))
    return arma_model_fwd(Y_ARMA), jaxpr


def test_generated_forward_arma_matches_jax_tile_fn(arma200):
    model, jaxpr = arma200
    rng = np.random.default_rng(5)
    x = (POST_MODE + rng.normal(0, 0.3, (1024, 4))).astype(np.float32)
    lp, g = model.tile_model.logp_and_grad(torch.as_tensor(x), 0.7)
    tiles = [jnp.asarray(x[:, d].reshape(8, 128)) for d in range(4)]
    out = jax.jit(lambda *a: jax.core.eval_jaxpr(jaxpr.jaxpr, jaxpr.consts, *a))(
        *tiles, jnp.full((8, 128), 0.7, jnp.float32))
    lp_j, g_j = out[0], out[1:]
    g_j = np.stack([np.asarray(v).reshape(-1) for v in g_j], axis=1)
    # rtol 2e-5, and atol 1e-4 for the logp values near 0: logp sums 200
    # squared errors, terms of ~1e2 each.
    np.testing.assert_allclose(lp.numpy(), np.asarray(lp_j).reshape(-1), rtol=2e-5,
                               atol=1e-4)
    scale = np.abs(g_j).max()
    np.testing.assert_allclose(g.numpy() / scale, g_j / scale, atol=1e-5)
    assert model.tile_model.autodiff == "forward"


# ------------------------------------------------------- (c) reverse mode


def _es_jax_logp(theta, phi):
    y, sigma = jnp.asarray(Y, jnp.float32), jnp.asarray(SIGMA, jnp.float32)
    mu, log_tau, tt = theta[0], theta[1], theta[2:]
    tau = jnp.exp(log_tau)
    z = mu / 5.0
    lp = -0.5 * z * z - math.log(5.0) - LOG_SQRT_2PI
    zt = tau / 5.0
    lp = lp - math.log(math.pi * 5.0) - jnp.log1p(zt * zt) + math.log(2.0) + log_tau
    lp = lp + jnp.sum(-0.5 * tt * tt - LOG_SQRT_2PI)
    zz = (y - (mu + tau * tt)) / sigma
    return lp + phi * jnp.sum(-0.5 * zz * zz - jnp.log(sigma) - LOG_SQRT_2PI)


T_REC = 40
Y_REC = np.random.default_rng(3).normal(size=T_REC)


def _rec_torch(theta, phi):
    """An AR(1)-error recurrence (the Stan frontend's test model): e_1 = y_1,
    e_t = y_t - a e_{t-1}, e ~ N(0, s), a ~ N(0, 1), log s unconstrained."""
    a, ls = theta[0], theta[1]
    e = theta.new_tensor(float(Y_REC[0]))
    ll = -0.5 * e * e * torch.exp(-2.0 * ls) - ls - LOG_SQRT_2PI
    acc = e * 0.0
    for t in range(1, T_REC):
        e = float(Y_REC[t]) - a * e
        acc = acc + e * 0.001
        ll = ll - 0.5 * e * e * torch.exp(-2.0 * ls) - ls - LOG_SQRT_2PI
    return -0.5 * a * a - LOG_SQRT_2PI + ls + phi * (ll + acc)


def _rec_jax(theta, phi):
    a, ls = theta[0], theta[1]
    e = jnp.asarray(float(Y_REC[0]), jnp.float32)
    ll = -0.5 * e * e * jnp.exp(-2.0 * ls) - ls - LOG_SQRT_2PI
    acc = e * 0.0
    for t in range(1, T_REC):
        e = float(Y_REC[t]) - a * e
        acc = acc + e * 0.001
        ll = ll - 0.5 * e * e * jnp.exp(-2.0 * ls) - ls - LOG_SQRT_2PI
    return -0.5 * a * a - LOG_SQRT_2PI + ls + phi * (ll + acc)


def _es_points(n, seed):
    rng = np.random.default_rng(seed)
    c = np.array([4.4, 1.2] + [0.0] * 8)
    sd = np.array([3.0, 0.5] + [1.0] * 8)
    return (c + sd * rng.normal(size=(n, 10))).astype(np.float32)


def _rec_points(n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-0.9, 0.9, n), rng.normal(0, 0.4, n)],
                    axis=1).astype(np.float32)


@pytest.mark.parametrize("case", ["eightschools", "recurrence"])
def test_generated_reverse_matches_jax_tile_fn(case):
    """At the tolerances of tests/test_stan_frontend.py:411."""
    if case == "eightschools":
        model = make_eightschools_generated().tile_model
        jax_fn, dim, x = _es_jax_logp, 10, _es_points(1024, 7)
    else:
        model = tile_model_from_logp(_rec_torch, 2, name="rec40")
        jax_fn, dim, x = _rec_jax, 2, _rec_points(1024, 8)
    assert model.autodiff == "reverse"
    lp, g = model.logp_and_grad(torch.as_tensor(x), 0.7)
    tm = jax_tile_model_from_logp(jax_fn, dim)
    tiles = [jnp.asarray(x[:, d].reshape(8, 128)) for d in range(dim)]
    lp_j, g_j = tm.tile_fn((), tiles, jnp.full((8, 128), 0.7, jnp.float32))
    g_j = np.stack([np.asarray(v).reshape(-1) for v in g_j], axis=1)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lp_j).reshape(-1),
                               rtol=1e-4, atol=1e-4)
    scale = np.abs(g_j).max() + 1e-6
    np.testing.assert_allclose(g.numpy() / scale, g_j / scale, atol=1e-5)


def test_generated_eightschools_matches_its_autograd_model():
    """The generated program and the CallableModel's autograd compute one
    density (the second reference, at float32 tolerance)."""
    model = make_eightschools_generated()
    x = torch.as_tensor(_es_points(256, 9))
    phi = torch.linspace(0.1, 1.0, 256)
    lp, g = model.logp_and_grad(x, phi)
    lp_g, g_g = model.tile_model.logp_and_grad(x, phi)
    torch.testing.assert_close(lp_g, lp, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(g_g, g, rtol=1e-5, atol=1e-5)


# ---------------------------------------- (d) the plain tree, zero bits


def test_plain_tree_on_generated_model_matches_pallas_interpret():
    n, depth, y = 16, 2, Y_ARMA[:40]
    rng = np.random.default_rng(0)
    x = (POST_MODE + rng.normal(0, 0.05, (n, 4))).astype(np.float32)
    r = rng.normal(size=(n, 4)).astype(np.float32)
    xj, rj, st_j = nuts_batch_pallas(arma_tile_model_fwd(y), jnp.asarray(x),
                                     jnp.asarray(r), 3, 0.05, 0.8,
                                     max_depth=depth, interpret=True)
    xt, rt, st = nuts_tree_plain(arma_model_fwd(y), torch.as_tensor(x)[None], 3, 0.05,
                                 0.8, None, depth, ZERO_BITS, r=torch.as_tensor(r)[None])
    for k in ("depth", "leapfrogs"):
        np.testing.assert_array_equal(st[k][0].numpy(), np.asarray(st_j[k]))
    tol = dict(atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(xt[0].numpy(), np.asarray(xj), **tol)
    np.testing.assert_allclose(rt[0].numpy(), np.asarray(rj), **tol)
    for k in ("logp0", "delta_h"):
        np.testing.assert_allclose(st[k][0].numpy(), np.asarray(st_j[k]), **tol)
    assert set(st) == set(STAT_KEYS)


# --------------------------------------------------------- (e) the slice

# test_torch_sampler.py's N, K and depth. The step size is 0.002, not its
# 0.01: at T=40 under zero bits (every momentum ~5.8 in every coordinate)
# trees at 0.01 lose 10-14 nats of energy, and there the port's hand-written
# arma model differs from the JAX step by as much (3.4e-3 in logw after three
# iterations) as the generated one: rounding, amplified by an unstable
# trajectory. test_hand_and_generated_steps_agree_at_step_0_01 holds the two
# port models to each other there.
N, ITERS, MAX_DEPTH, T_SLICE, STEP = 48, 3, 4, 40, 0.002
DRIFT_STEP = 0.01


def _jax_trajectory(step_size):
    """Three JAX iterations with the generated forward-mode tile model of
    the T=40 arma, from a fixed state, and each iteration's resampling
    uniforms."""
    y = Y_ARMA[:T_SLICE]
    jm = dataclasses.replace(make_arma(y), tile_model=arma_tile_model_fwd(y))
    cfg = JaxSMCConfig(n_particles=N, n_iterations=ITERS, step_size=step_size,
                       nuts_backend="pallas", max_tree_depth=MAX_DEPTH)
    step = jax.jit(_make_step(jm, cfg, JaxDiagNormalProposal(jm.dim)))
    rng = np.random.default_rng(0)
    x0 = (POST_MODE + rng.normal(0, 0.05, (N, 4))).astype(np.float32)
    logw0 = rng.normal(0, 2.0, N).astype(np.float32)
    step0 = jnp.float32(step_size)
    carry = JaxSMCCarry(
        x=jnp.asarray(x0), logw=jnp.asarray(logw0), phi=jnp.float32(1.0),
        step_size=step0, inv_mass=jnp.ones(4, jnp.float32),
        da=da_init(step0, jnp.float32), key=jax.random.key(3),
    )
    start = {k: jax.tree.map(np.asarray, getattr(carry, k)) for k in CARRY_FIELDS}
    uniforms, carries, diags = [], [], []
    for k in range(ITERS):
        k_res = jax.random.split(carry.key, 5)[1]
        uniforms.append(np.array(jax.random.uniform(k_res, (N,), jnp.float32)))
        carry, out = step(carry, jnp.int32(k))
        carries.append({f: jax.tree.map(np.asarray, getattr(carry, f))
                        for f in CARRY_FIELDS})
        d = np.asarray(out["diag"])
        diags.append(dict(zip(_DIAG_FIELDS, d[: len(_DIAG_FIELDS)]),
                          mean=d[len(_DIAG_FIELDS):len(_DIAG_FIELDS) + 4],
                          var=d[len(_DIAG_FIELDS) + 4:]))
    return start, uniforms, carries, diags


@pytest.fixture(scope="module")
def jax_trajectory():
    return _jax_trajectory(STEP)


def _port_steps(model, step_size, start, uniforms):
    """The port's smc_step from the JAX start state with the JAX uniforms,
    under zero bits: each iteration's (carry as numpy, diagnostics)."""
    cfg = SMCConfig(n_particles=N, n_iterations=ITERS, step_size=step_size,
                    max_tree_depth=MAX_DEPTH)
    carry, out = carry_from_numpy(**start, device="cpu"), []
    for k in range(ITERS):
        carry, diag = smc_step(model, cfg, carry, torch.as_tensor(uniforms[k])[None],
                               torch.zeros(1, dtype=torch.int32), "eager", ZERO_BITS)
        out.append((carry_to_numpy(carry, run_axis=False), diag))
    return out


def test_step_on_generated_model_matches_jax_step(jax_trajectory):
    start, uniforms, carries, diags = jax_trajectory
    model = arma_model_fwd(Y_ARMA[:T_SLICE])
    calls = nuts_tree_plain.model_calls
    for k, (got, diag) in enumerate(_port_steps(model, STEP, start, uniforms)):
        want = carries[k]
        for f in CARRY_FIELDS:
            np.testing.assert_allclose(got[f], want[f], rtol=1e-4, atol=1e-4,
                                       err_msg=f"iteration {k}: {f}")
        for f in ("ess", "log_likelihood", "mean", "var", "acceptance",
                  "tree_depth", "tree_leapfrogs", "accept_stat"):
            np.testing.assert_allclose(diag[f][0].numpy(), diags[k][f], rtol=1e-4,
                                       atol=1e-4, err_msg=f"iteration {k}: {f}")
        assert bool(diag["resampled"][0]) == bool(diags[k]["resampled"] > 0.5)
    assert nuts_tree_plain.model_calls > calls


def test_hand_and_generated_steps_agree_at_step_0_01():
    """Where the port drifts from the JAX step (step 0.01, the trees losing
    10-14 nats), the hand-written arma model and the generated one drift
    alike: their three iterations agree with each other at 1e-6, and both
    make the JAX step's resampling decisions. The hand model runs the
    recurrence in sequence (`at_group(1)`), the order of the generated
    program: in the kernel's group order its rounding differs, and the
    unstable trajectory amplifies that past 1e-6."""
    start, uniforms, _, diags = _jax_trajectory(DRIFT_STEP)
    y = Y_ARMA[:T_SLICE]
    hand = _port_steps(get_model("arma", y=y).at_group(1), DRIFT_STEP, start, uniforms)
    gen = _port_steps(arma_model_fwd(y), DRIFT_STEP, start, uniforms)
    for k, ((h, dh), (g, dg)) in enumerate(zip(hand, gen)):
        for f in CARRY_FIELDS:
            np.testing.assert_allclose(g[f], h[f], rtol=1e-6, atol=1e-6,
                                       err_msg=f"iteration {k}: {f}")
        for f in ("log_likelihood", "mean", "var", "accept_stat", "tree_leapfrogs"):
            np.testing.assert_allclose(dg[f].numpy(), dh[f].numpy(), rtol=1e-6,
                                       atol=1e-6, err_msg=f"iteration {k}: {f}")
        want = bool(diags[k]["resampled"] > 0.5)
        assert bool(dh["resampled"][0]) == bool(dg["resampled"][0]) == want


@pytest.mark.parametrize("kind", ["eager", "generated"])
def test_sampler_end_to_end_cpu(kind):
    """SMCSampler on the CPU with the arma density: autograd (no tile model)
    or the generated model's plain program. Both are the same density, so
    with the same seed they make the same decisions and end close."""
    K, n = 4, 64
    model = arma_model_fwd(Y_ARMA[:T_SLICE])
    if kind == "eager":
        model = CallableModel("arma", 4, model._logprior, model._loglik, model._constrain)
    cfg = SMCConfig(n_particles=n, n_iterations=K, step_size=0.02, max_tree_depth=3)
    res = SMCSampler(K, n, model, 0.02, config=cfg, seed=1, device="cpu").sample()
    assert res.mean_estimate.shape == (K + 1, 4)
    assert torch.isfinite(res.mean_estimate).all() and torch.isfinite(res.x_final).all()
    assert torch.all(res.phi == 1.0) and res.acceptance_rate[:K].min() > 0


def test_generated_and_eager_runs_agree():
    K, n = 3, 32
    model = arma_model_fwd(Y_ARMA[:T_SLICE])
    eager = CallableModel("arma", 4, model._logprior, model._loglik, model._constrain)
    cfg = SMCConfig(n_particles=n, n_iterations=K, step_size=0.02, max_tree_depth=3)
    a = SMCSampler(K, n, model, 0.02, config=cfg, seed=2, device="cpu").sample()
    b = SMCSampler(K, n, eager, 0.02, config=cfg, seed=2, device="cpu").sample()
    torch.testing.assert_close(a.mean_estimate, b.mean_estimate, rtol=1e-4, atol=1e-4)
    assert torch.equal(a.resampled, b.resampled)


def test_cuda_backend_needs_a_generated_model():
    eager = _arma_callable()
    cuda_cfg = SMCConfig(n_particles=8, n_iterations=1, step_size=0.1, nuts_backend="cuda")
    with pytest.raises(ValueError, match="eager"):
        resolve_backend(cuda_cfg, torch.device("cuda"), eager)
    auto = SMCConfig(n_particles=8, n_iterations=1, step_size=0.1)
    assert resolve_backend(auto, torch.device("cuda"), eager) == "eager"
    assert resolve_backend(auto, torch.device("cuda"), arma_model_fwd(Y_ARMA[:8])) == "cuda"
    with pytest.raises(NotImplementedError, match="no generated in-kernel model"):
        _model_data(eager, SimpleNamespace())


# -------------------------------------------------- (f) the simplifier


def test_cse_folds_duplicates_and_identities():
    def f(c, phi):
        x, y = c
        a = torch.exp(x) * y + torch.tanh(x)
        b = torch.exp(x) * y + torch.tanh(x)  # a duplicate of a
        return a + b + phi * (((y - 0.0) * 1.0 + 0.0) / 1.0 - (x - x))

    prog = tile_model_from_logp_fwd(f, 2).program
    ops = [op for op, *_ in prog.ops]
    assert ops.count("exp") == 1 and ops.count("tanh") == 1, ops
    x = torch.tensor([[0.3, -1.2], [1.1, 0.4]])
    lp, g = tile_model_from_logp_fwd(f, 2).logp_and_grad(x, 0.5)
    want = 2 * (torch.exp(x[:, 0]) * x[:, 1] + torch.tanh(x[:, 0])) + 0.5 * x[:, 1]
    torch.testing.assert_close(lp, want)
    torch.testing.assert_close(g[:, 1], 2 * torch.exp(x[:, 0]) + 0.5)


def test_identities_leave_no_operation():
    prog = tile_model_from_logp_fwd(
        lambda c, phi: ((c[0] - 0.0) * 1.0 + 0.0) / 1.0 + 0.0 * c[1], 2).program
    assert all(op in ("x", "phi", "data") for op, *_ in prog.ops)
    assert prog.grad == (1.0, 0.0)


def test_forward_arma_op_count_beside_jax_simplified_jaxpr(arma200):
    """The generated arma (T=200) has 3,837 operations; the JAX simplified
    jaxpr of arma_tile_model_fwd 3,846 equations: within 10%."""
    model, jaxpr = arma200
    ours = model.tile_model.n_ops
    theirs = len(jaxpr.jaxpr.eqns)
    assert abs(ours - theirs) <= 0.1 * theirs, (ours, theirs)
    assert (ours, theirs) == (3837, 3846)


# ------------------------------------------ (g) unsupported op, (h) source


def test_unsupported_op_raises_naming_it():
    with pytest.raises(NotImplementedError,
                       match="asinh.*model 'asinhmodel'|model 'asinhmodel'.*asinh"):
        tile_model_from_logp(lambda t, p: torch.asinh(t).sum() * p, 2, name="asinhmodel")


def test_lgamma_of_a_parameter_has_no_derivative_in_the_kernel():
    """lgamma of a parameter lowers, its derivative digamma built from the
    program's ops (tests/test_torch_generated_special.py holds both to
    torch.special and JAX); digamma of a parameter lowers too, its
    derivative trigamma built from the program's ops and equal to
    torch.special.polygamma(1, .) at rtol 2e-6 + atol 1e-6 (ATen's float
    code, mirrored); the chain stops one step on: trigamma of a parameter
    has no derivative (tetragamma) in the kernel, in either mode."""
    x = torch.tensor([[0.5], [3.0], [0.25], [17.0]])
    for tm in (tile_model_from_logp_fwd(lambda c, p: torch.lgamma(c[0]), 1),
               tile_model_from_logp(lambda t, p: torch.lgamma(t[0]), 1)):
        lp, g = tm.logp_and_grad(x, 1.0)
        torch.testing.assert_close(lp, torch.lgamma(x[:, 0]))
        torch.testing.assert_close(g[:, 0], torch.digamma(x[:, 0]), rtol=2e-6, atol=1e-6)
    for tm in (tile_model_from_logp_fwd(lambda c, p: torch.digamma(c[0]), 1),
               tile_model_from_logp(lambda t, p: torch.digamma(t[0]), 1)):
        lp, g = tm.logp_and_grad(x, 1.0)
        torch.testing.assert_close(lp, torch.digamma(x[:, 0]), rtol=2e-6, atol=1e-6)
        want = torch.special.polygamma(1, x[:, 0].double()).float()
        torch.testing.assert_close(g[:, 0], want, rtol=2e-6, atol=1e-6)
    with pytest.raises(NotImplementedError, match="tetragamma"):
        tile_model_from_logp_fwd(lambda c, p: torch.special.polygamma(1, c[0]), 1)
    with pytest.raises(NotImplementedError, match="polygamma"):
        tile_model_from_logp(lambda t, p: torch.special.polygamma(1, t[0]), 1)


def test_emitted_source_is_deterministic_and_exact():
    y = Y_ARMA[:40]
    a, b = arma_model_fwd(y).tile_model, arma_model_fwd(y).tile_model
    assert a.source == b.source and a.hash == b.hash
    assert "static constexpr int D = 4;" in a.source
    assert "static constexpr int kScalars = 0;" in a.source
    # The observations are exact: literals of the straight-line program, and
    # in the re-rolled one (the default) literals of its peeled steps or
    # entries of its data block's column.
    flat = arma_model_fwd(y, reroll=False).tile_model
    data = set(a.data.numpy().view(np.uint32).tolist())
    for v in y:
        literal = f"({float(np.float32(v)).hex()}f)"
        assert literal in flat.source
        assert literal in a.source or int(np.float32(v).view(np.uint32)) in data
    es = make_eightschools_generated().tile_model
    assert es.hash == make_eightschools_generated().tile_model.hash
    # The data (y, and what folds from sigma) are the data block, exactly.
    data = es.data.numpy()
    assert set(np.float32(Y)) <= set(data)
    assert np.float32(np.log(np.float32(15.0))) in set(data)
    assert "d[" in es.source and "kData = " in es.source


def test_forward_dimension_is_capped():
    with pytest.raises(ValueError, match="128"):
        tile_model_from_logp_fwd(lambda c, p: c[0], 129)


# ---------------------------------------------------------------- (i) CLI


def test_cli_chunk_size_names_its_roadmap_item():
    """Queue 1 item 9 ported --chunk-size: it runs (without --checkpoint it
    changes nothing); so does --mesh (Queue 1 item 10), which without a
    launcher shards over a group of one process and prints the same run."""
    argv = ["--chunk-size", "5", "--device", "cpu", "-N", "8", "-K", "1",
            "--max-tree-depth", "1"]
    assert torch_main(argv) == torch_main(argv[2:])
    assert torch_main(argv + ["--mesh"]) == torch_main(argv[2:])


def test_products_over_the_data_axis_run_as_sequential_sums():
    """A logistic regression written with `@` and `dot` (mv, dot and their
    backward ops) through the reverse adapter, against its autograd model;
    the design matrix and the labels are the data block."""
    rng = np.random.default_rng(0)
    X, y = rng.normal(size=(16, 3)), (rng.random(16) < 0.5).astype(float)

    def logprior(t):
        return -0.5 * torch.dot(t, t)

    def loglik(t):
        eta = t.new_tensor(X) @ t
        return torch.sum(t.new_tensor(y) * eta - torch.log1p(torch.exp(eta)))

    tm = tile_model_from_logp(lambda t, p: logprior(t) + p * loglik(t), 3)
    model = CallableModel("logistic", 3, logprior, loglik, tile_model=tm)
    x = torch.as_tensor(rng.normal(size=(64, 3)).astype(np.float32))
    lp, g = model.logp_and_grad(x, 0.6)
    lp_g, g_g = tm.logp_and_grad(x, 0.6)
    torch.testing.assert_close(lp_g, lp, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(g_g, g, rtol=1e-5, atol=1e-5)
    assert set(np.float32(X).ravel()) <= set(tm.data.numpy())
