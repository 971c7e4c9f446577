"""Step-size and mass adaptation against the JAX package.

`da_init`, `da_update` and `mass_matrix_from_particles` per run against
`jax.vmap` of the JAX functions. Then three adapted SMC iterations (arma,
adapt_step_size and adapt_mass_matrix, K = 3 so iterations 0 and 1 adapt and
iteration 2 runs frozen) against JAX's `_make_step` with the Pallas kernel
interpreted (zero bits) and the JAX resampling uniforms handed in: carries,
step size, inverse mass and dual-averaging state included, at atol/rtol
1e-4. Then the CLI's adaptation flags and its per-model step size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smcnuts_torch import SMCConfig
from smcnuts_torch.__main__ import main as torch_main
from smcnuts_torch import sampler as torch_sampler
from smcnuts_torch.interop import CARRY_FIELDS, carry_from_numpy, carry_to_numpy
from smcnuts_torch.models import get_model
from smcnuts_torch.models import prmwcd as torch_prmwcd
from smcnuts_torch.ops.adaptation import (
    DualAveragingState,
    da_init,
    da_update,
    mass_matrix_from_particles,
)
from smcnuts_torch.ops.draws import ZERO_BITS
from smcnuts_torch.sampler import smc_step
from smcnuts_tpu import DiagNormalProposal as JaxDiagNormalProposal
from smcnuts_tpu import SMCConfig as JaxSMCConfig
from smcnuts_tpu.models import make_arma
from smcnuts_tpu.ops import adaptation as jax_adaptation
from smcnuts_tpu.sampler import _DIAG_FIELDS, SMCCarry as JaxSMCCarry
from smcnuts_tpu.sampler import _make_step

torch.set_num_threads(2)

POST_MODE = np.array([0.007, 0.957, -0.034, np.log(0.166)])
# The JAX default target. At 0.6 the step size grows fivefold in two
# iterations, and the last-bit differences of XLA's and PyTorch's exp grow
# past 1e-4 in the log weights of the longer trajectories.
N, ITERS, MAX_DEPTH, TARGET = 48, 3, 4, 0.8
B = 4


def _state(seed):
    rng = np.random.default_rng(seed)
    return DualAveragingState(
        log_step=rng.normal(-4, 1, B), log_step_avg=rng.normal(-4, 1, B),
        h_bar=rng.normal(0, 0.1, B), mu=rng.normal(-2, 1, B),
        count=rng.integers(0, 50, B).astype(float),
    )


def test_da_init_matches_jax():
    eps = np.array([0.01, 0.1, 0.5, 2.0], np.float32)
    ours = da_init(torch.as_tensor(eps))
    theirs = jax.vmap(jax_adaptation.da_init)(jnp.asarray(eps))
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


@pytest.mark.parametrize("target", [0.8, 0.5])
def test_da_update_matches_jax(target):
    state = _state(0)
    accept = np.random.default_rng(1).random(B).astype(np.float32)
    ours = da_update(
        DualAveragingState(*(torch.tensor(v, dtype=torch.float32) for v in state)),
        torch.as_tensor(accept), target=target,
    )
    theirs = jax.vmap(lambda s, a: jax_adaptation.da_update(s, a, target=target))(
        jax_adaptation.DualAveragingState(*(jnp.asarray(v, jnp.float32) for v in state)),
        jnp.asarray(accept),
    )
    for f, a, b in zip(DualAveragingState._fields, ours, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6,
                                   err_msg=f)


def test_mass_matrix_matches_jax():
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(B, 40, 5)) * [0.1, 1.0, 3.0, 0.5, 1.0]).astype(np.float32)
    x[1, :, 4] = 0.25  # zero variance: the floor applies
    wn = rng.dirichlet(np.ones(40), size=B).astype(np.float32)
    old = rng.uniform(0.2, 2.0, (B, 5)).astype(np.float32)
    ours = mass_matrix_from_particles(torch.as_tensor(x), torch.as_tensor(wn),
                                      torch.as_tensor(old))
    theirs = jax.vmap(jax_adaptation.mass_matrix_from_particles)(
        jnp.asarray(x), jnp.asarray(wn), jnp.asarray(old))
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-5)


@pytest.fixture(scope="module")
def jax_adapted_trajectory():
    """Three adapted JAX iterations from a fixed state, with the uniforms
    each iteration's resampling drew."""
    jm = make_arma()
    cfg = JaxSMCConfig(n_particles=N, n_iterations=ITERS, step_size=0.01,
                       nuts_backend="pallas", max_tree_depth=MAX_DEPTH,
                       adapt_step_size=True, adapt_mass_matrix=True,
                       target_accept=TARGET)
    step = jax.jit(_make_step(jm, cfg, JaxDiagNormalProposal(jm.dim)))
    rng = np.random.default_rng(0)
    x0 = (POST_MODE + rng.normal(0, 0.05, (N, 4))).astype(np.float32)
    logw0 = (rng.normal(0, 2.0, N)).astype(np.float32)
    step0 = jnp.float32(0.01)
    carry = JaxSMCCarry(
        x=jnp.asarray(x0), logw=jnp.asarray(logw0), phi=jnp.float32(1.0),
        step_size=step0, inv_mass=jnp.ones(4, jnp.float32),
        da=jax_adaptation.da_init(step0, jnp.float32), key=jax.random.key(3),
    )

    def fields(c):
        return {f: jax.tree.map(np.asarray, getattr(c, f)) for f in CARRY_FIELDS}

    start = fields(carry)
    uniforms, carries, diags = [], [], []
    for k in range(ITERS):
        k_res = jax.random.split(carry.key, 5)[1]
        uniforms.append(np.array(jax.random.uniform(k_res, (N,), jnp.float32)))
        carry, out = step(carry, jnp.int32(k))
        carries.append(fields(carry))
        d = np.asarray(out["diag"])
        diags.append(dict(zip(_DIAG_FIELDS, d[: len(_DIAG_FIELDS)])))
    return start, uniforms, carries, diags


def test_adapted_steps_match_jax_step(jax_adapted_trajectory):
    start, uniforms, carries, diags = jax_adapted_trajectory
    cfg = SMCConfig(n_particles=N, n_iterations=ITERS, step_size=0.01,
                    max_tree_depth=MAX_DEPTH, adapt_step_size=True,
                    adapt_mass_matrix=True, target_accept=TARGET)
    model = get_model("arma")
    carry = carry_from_numpy(**start, device="cpu")
    steps = []
    for k in range(ITERS):
        carry, diag = smc_step(model, cfg, carry,
                               torch.as_tensor(uniforms[k])[None],
                               torch.zeros(1, dtype=torch.int32), "eager",
                               ZERO_BITS)
        got, want = carry_to_numpy(carry, run_axis=False), carries[k]
        for f in CARRY_FIELDS:
            np.testing.assert_allclose(np.asarray(got[f]), np.asarray(want[f]),
                                       rtol=1e-4, atol=1e-4,
                                       err_msg=f"iteration {k}: {f}")
        for f in ("step_size", "accept_stat", "ess", "tree_depth", "acceptance"):
            np.testing.assert_allclose(diag[f][0].numpy(), diags[k][f], rtol=1e-4,
                                       atol=1e-4, err_msg=f"iteration {k}: {f}")
        steps.append(float(carry.step_size[0]))
    # Adapted in iterations 0 and 1, frozen at the averaged iterate in 2.
    assert steps[0] != 0.01 and steps[1] != steps[0]
    assert float(carry.da.count[0]) == 2.0
    assert not np.allclose(carry_to_numpy(carry)["inv_mass"], 1.0)


def test_cli_adaptation_flags_cpu():
    summary = torch_main(["--model", "prmwcd", "-N", "16", "-K", "2",
                          "--max-tree-depth", "2", "--adapt-step-size",
                          "--adapt-mass-matrix", "--seed", "4",
                          "--device", "cpu"])
    assert len(summary["mean"]) == 13
    assert np.all(np.isfinite(summary["mean"] + summary["variance"]))


def test_cli_takes_the_models_step_size(monkeypatch):
    seen = {}
    real = torch_sampler.run_smc

    def spy(model, cfg, *args, **kwargs):
        seen.update(model=model.name, step=cfg.step_size,
                    adapt=(cfg.adapt_step_size, cfg.adapt_mass_matrix))
        return real(model, cfg, *args, **kwargs)

    monkeypatch.setattr(torch_sampler, "run_smc", spy)
    monkeypatch.setattr(torch_prmwcd, "default_step_size", lambda: 0.02)
    torch_main(["--model", "prmwcd", "-N", "8", "-K", "1", "--max-tree-depth",
                "1", "--adapt-mass-matrix", "--device", "cpu"])
    assert seen == {"model": "prmwcd", "step": 0.02, "adapt": (False, True)}
