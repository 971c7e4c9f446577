"""The slice as a whole: the port's SMC iteration against the JAX package's.

Both packages start from one state (passed through `interop`). The JAX step
runs the Pallas NUTS kernel interpreted on the CPU (zero bits), the port's
step (one run, B = 1) the plain tree with ZERO_BITS draws, and the port is
handed the raw resampling uniforms the JAX step draws from its key split.
Three iterations must agree at atol 1e-4 / rtol 1e-4, resampling decisions
exactly. Then the port runs end to end on the CPU through `SMCSampler` and
the CLI.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smcnuts_torch import SMCConfig, SMCSampler
from smcnuts_torch.__main__ import main as torch_main
from smcnuts_torch.interop import CARRY_FIELDS, carry_from_numpy, carry_to_numpy
from smcnuts_torch.models import get_model
from smcnuts_torch.ops.draws import ZERO_BITS
from smcnuts_torch.ops.nuts_cuda import nuts_tree_plain
from smcnuts_torch.sampler import resolve_backend, smc_step
from smcnuts_tpu import DiagNormalProposal as JaxDiagNormalProposal
from smcnuts_tpu import SMCConfig as JaxSMCConfig
from smcnuts_tpu.models import make_arma
from smcnuts_tpu.ops.adaptation import da_init
from smcnuts_tpu.sampler import _DIAG_FIELDS, SMCCarry as JaxSMCCarry
from smcnuts_tpu.sampler import _make_step

torch.set_num_threads(2)

POST_MODE = np.array([0.007, 0.957, -0.034, np.log(0.166)])
N, ITERS, MAX_DEPTH = 48, 3, 4


@pytest.fixture(scope="module")
def jax_trajectory():
    """Three JAX iterations from a fixed state, with the uniforms each
    iteration's resampling drew."""
    jm = make_arma()
    cfg = JaxSMCConfig(n_particles=N, n_iterations=ITERS, step_size=0.01,
                       nuts_backend="pallas", max_tree_depth=MAX_DEPTH)
    step = jax.jit(_make_step(jm, cfg, JaxDiagNormalProposal(jm.dim)))
    rng = np.random.default_rng(0)
    x0 = (POST_MODE + rng.normal(0, 0.05, (N, 4))).astype(np.float32)
    logw0 = (rng.normal(0, 2.0, N)).astype(np.float32)
    step0 = jnp.float32(0.01)
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


def test_step_matches_jax_step(jax_trajectory):
    start, uniforms, carries, diags = jax_trajectory
    cfg = SMCConfig(n_particles=N, n_iterations=ITERS, step_size=0.01,
                    max_tree_depth=MAX_DEPTH)
    model = get_model("arma")
    carry = carry_from_numpy(**start, device="cpu")
    resampled = []
    for k in range(ITERS):
        carry, diag = smc_step(model, cfg, carry,
                               torch.as_tensor(uniforms[k])[None],
                               torch.zeros(1, dtype=torch.int32), "eager",
                               ZERO_BITS)
        got, want = carry_to_numpy(carry, run_axis=False), carries[k]
        for f in CARRY_FIELDS:
            np.testing.assert_allclose(got[f], want[f], rtol=1e-4, atol=1e-4,
                                       err_msg=f"iteration {k}: {f}")
        for f in ("ess", "log_likelihood", "mean", "var", "phi", "acceptance",
                  "step_size", "tree_depth", "tree_leapfrogs", "accept_stat"):
            np.testing.assert_allclose(diag[f][0].numpy(), diags[k][f], rtol=1e-4,
                                       atol=1e-4, err_msg=f"iteration {k}: {f}")
        assert bool(diag["resampled"][0]) == bool(diags[k]["resampled"] > 0.5)
        resampled.append(bool(diag["resampled"][0]))
    assert any(resampled) and not all(resampled)  # both branches ran


def test_interop_round_trip(jax_trajectory):
    start = jax_trajectory[0]
    back = carry_to_numpy(carry_from_numpy(**start, device="cpu"), run_axis=False)
    for f in CARRY_FIELDS:
        np.testing.assert_array_equal(back[f], start[f])


def _check_series(res, K, n):
    for name in ("mean_estimate", "variance_estimate"):
        v = getattr(res, name)
        assert v.shape == (K + 1, 4) and torch.isfinite(v).all(), name
    for name in ("ess", "log_likelihood", "phi", "acceptance_rate",
                 "step_size", "tree_depth", "tree_leapfrogs", "accept_stat"):
        v = getattr(res, name)
        assert v.shape == (K + 1,) and torch.isfinite(v).all(), name
    assert res.resampled.shape == (K + 1,) and res.resampled.dtype == torch.bool
    assert res.acceptance_rate[K] == 0
    assert torch.all(res.phi == 1.0)
    assert res.x_final.shape == (n, 4) and torch.isfinite(res.x_final).all()


def test_sampler_end_to_end_cpu():
    K, n = 5, 64
    cfg = SMCConfig(n_particles=n, n_iterations=K, step_size=0.01,
                    max_tree_depth=MAX_DEPTH)
    calls = nuts_tree_plain.calls
    sampler = SMCSampler(K, n, get_model("arma"), 0.01, config=cfg, seed=1,
                         device="cpu")
    res = sampler.sample()
    assert nuts_tree_plain.calls == calls + K
    _check_series(res, K, n)
    assert res.x_saved.shape == (K + 1, n, 4)
    assert sampler.acceptance_rate.shape == (K + 1,)
    assert len(sampler.resampled) == K + 1
    again = SMCSampler(K, n, get_model("arma"), 0.01, config=cfg, seed=1,
                       device="cpu").sample()
    torch.testing.assert_close(again.x_final, res.x_final, rtol=0, atol=0)


def test_cli_end_to_end_cpu(capsys):
    summary = torch_main(["--model", "arma", "-N", "64", "-K", "5",
                          "--max-tree-depth", str(MAX_DEPTH), "--seed", "2",
                          "--device", "cpu"])
    assert set(summary) == {"model", "lkernel", "N", "K", "mean", "variance",
                            "ess", "log_likelihood", "phi_schedule"}
    assert summary["phi_schedule"] == [1.0] * 6
    assert np.all(np.isfinite(summary["mean"] + summary["variance"]))
    assert '"phi_schedule"' in capsys.readouterr().out


# What the JAX CLI (smcnuts_tpu/__main__.py) does with each argv: --mesh is
# the one flag still outside the port (NotImplementedError naming its
# ROADMAP item); --stan compiles the file, so a missing one raises
# FileNotFoundError, as open() does in the JAX CLI; without --stan, --data
# and --stan-tile change nothing and the model runs. (--checkpoint,
# --chunk-size and --output run: tests/test_torch_io_cli.py; a Stan program
# through the CLI: tests/test_torch_stan_tile.py.)
_JAX_CLI_OUTCOME = {
    ("--lkernel", "asymptoticLKernel", "--mesh"): (NotImplementedError, "Queue 1 item 10"),
    ("--resampling", "systematic", "--stan", "m.stan"): (FileNotFoundError, "m.stan"),
    ("--stan-tile",): None,
    ("--mesh",): (NotImplementedError, "Queue 1 item 10"),
    ("--stan", "m.stan"): (FileNotFoundError, "m.stan"),
    ("--data", "d.json"): None,
}


@pytest.mark.parametrize("argv", [list(a) for a in _JAX_CLI_OUTCOME], ids=lambda a: a[0])
def test_cli_flags_outside_slice_raise(argv, capsys):
    outcome = _JAX_CLI_OUTCOME[tuple(argv)]
    run = lambda: torch_main(["-N", "8", "-K", "1", "--device", "cpu"] + argv)  # noqa: E731
    if outcome is None:
        summary = run()
        assert summary["model"] == "arma" and summary["phi_schedule"] == [1.0, 1.0]
        assert '"phi_schedule"' in capsys.readouterr().out
    else:
        with pytest.raises(outcome[0], match=outcome[1]):
            run()


def test_backend_resolution():
    cfg = SMCConfig(n_particles=8, n_iterations=1, step_size=0.01)
    assert resolve_backend(cfg, torch.device("cpu")) == "eager"
    cuda_cfg = SMCConfig(n_particles=8, n_iterations=1, step_size=0.01,
                         nuts_backend="cuda")
    with pytest.raises(ValueError, match="CUDA device"):
        resolve_backend(cuda_cfg, torch.device("cpu"))
    f64 = SMCConfig(n_particles=8, n_iterations=1, step_size=0.01,
                    dtype="float64")
    with pytest.raises(NotImplementedError, match="float64 on CUDA"):
        resolve_backend(f64, torch.device("cuda"))


def test_float64_eager_run_cpu():
    cfg = SMCConfig(n_particles=16, n_iterations=2, step_size=0.01,
                    max_tree_depth=2, dtype="float64")
    res = SMCSampler(2, 16, get_model("arma"), 0.01, config=cfg,
                     device="cpu").sample()
    assert res.x_final.dtype == torch.float64
    _check_series(res, 2, 16)
