"""float64 runs of the port: the eager backend in float64 on any device,
the kernels float32 only, nothing cast quietly to float32.

- tests/test_float64.py's check, at a size that runs in seconds: 64
  particles x K = 5, 3 runs, arma without tempering and eight schools with
  it (its two cases), in float32 and float64 on the CPU; the float32
  moments inside the float64 runs' Monte Carlo spread (4 combined MC
  standard errors + 1e-3, its bound).
- `resolve_backend`: "auto" takes the eager tree for float64 on a CUDA
  device, "cuda" refuses float64.
- A `CallableModel` that carries a generated model takes autograd in
  float64 (the generated program computes in float32, as its kernel).
- The fused ARMA kernel (K5) refuses float64.
- The draws in float64 are the float32 draws, exactly: what the card's
  float64 run draws is the CPU's.
"""

import numpy as np
import pytest
import torch

from smcnuts_torch import SMCConfig, run_smc_batched
from smcnuts_torch.models import get_model
from smcnuts_torch.models.base import CallableModel
from smcnuts_torch.ops import arma_fused
from smcnuts_torch.ops.draws import LEAF, PHILOX, TreeDraws
from smcnuts_torch.ops.generated import tile_model_from_logp
from smcnuts_torch.ops.nuts_cuda import nuts_tree_plain
from smcnuts_torch.sampler import resolve_backend

torch.set_num_threads(2)

RUNS = 3


def _moments(model, dtype, tempering):
    cfg = SMCConfig(n_particles=64, n_iterations=5, step_size=0.01, dtype=dtype,
                    tempering=tempering, save_history=False)
    res = run_smc_batched(get_model(model), cfg, [7 * (i + 1) for i in range(RUNS)], "cpu")
    assert res.x_final.dtype == getattr(torch, dtype)
    for field in ("mean_estimate", "variance_estimate", "log_likelihood", "ess"):
        value = getattr(res, field)
        assert value.dtype == getattr(torch, dtype) and torch.isfinite(value).all(), field
    return res.mean_estimate[:, -1].double().numpy(), res.variance_estimate[:, -1].double().numpy()


@pytest.mark.parametrize("model,tempering", [("arma", False), ("eightschools", True)])
def test_f32_matches_f64_within_mc_error(model, tempering):
    m32, v32 = _moments(model, "float32", tempering)
    m64, v64 = _moments(model, "float64", tempering)
    se = np.sqrt(m32.var(axis=0, ddof=1) / RUNS + m64.var(axis=0, ddof=1) / RUNS)
    delta = np.abs(m32.mean(0) - m64.mean(0))
    assert np.all(delta <= 4.0 * se + 1e-3), (delta, se)
    vse = np.sqrt(v32.var(axis=0, ddof=1) / RUNS + v64.var(axis=0, ddof=1) / RUNS)
    vdelta = np.abs(v32.mean(0) - v64.mean(0))
    assert np.all(vdelta <= 4.0 * vse + 0.05 * np.abs(v64.mean(0)) + 1e-3)


def _gaussian_callable(tile):
    def logp(theta):
        return -0.5 * (theta * theta).sum()

    tm = tile_model_from_logp(lambda t, p: logp(t), 2) if tile else None
    return CallableModel("gauss", 2, logp, lambda t: t.new_zeros(()), tile_model=tm)


def test_backend_resolution_in_float64():
    cuda = torch.device("cuda")
    for model in (get_model("arma"), _gaussian_callable(True), _gaussian_callable(False)):
        auto = SMCConfig(n_particles=8, n_iterations=1, step_size=0.01, dtype="float64")
        assert resolve_backend(auto, cuda, model) == "eager"
        assert resolve_backend(auto, torch.device("cpu"), model) == "eager"
    kernel = SMCConfig(n_particles=8, n_iterations=1, step_size=0.01, dtype="float64",
                       nuts_backend="cuda")
    with pytest.raises(NotImplementedError, match="float32 only"):
        resolve_backend(kernel, cuda, get_model("arma"))
    # float32 on the card keeps the kernel.
    f32 = SMCConfig(n_particles=8, n_iterations=1, step_size=0.01)
    assert resolve_backend(f32, cuda, _gaussian_callable(True)) == "cuda"


def test_callable_with_generated_model_takes_autograd_in_float64():
    """The plain tree prefers a generated model's program in float32 (the
    kernel's plain version) and takes the model's autograd in float64: the
    float64 tree of the model with a generated model equals, to the bit,
    that of the same density without one."""
    x = torch.tensor(np.random.default_rng(0).normal(size=(1, 16, 2)))
    args = (torch.tensor([3]), 0.2, 1.0, torch.ones(2, dtype=torch.float64), 4, PHILOX)
    with_tile = nuts_tree_plain(_gaussian_callable(True), x, *args)
    without = nuts_tree_plain(_gaussian_callable(False), x, *args)
    assert with_tile[0].dtype == torch.float64
    assert torch.equal(with_tile[0], without[0]) and torch.equal(with_tile[1], without[1])
    for k, v in with_tile[2].items():
        assert torch.equal(v, without[2][k]), k
    with pytest.raises(NotImplementedError, match="float32"):
        _gaussian_callable(True).tile_model.logp_and_grad(x[0], 1.0)


def test_fused_arma_kernel_refuses_float64():
    theta = torch.zeros((4, 4), dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="float32 only"):
        arma_fused._launch("smcnuts_arma_ll_vg", theta, torch.zeros(10, dtype=torch.float64))


def test_float64_draws_are_the_float32_draws():
    seed = torch.tensor([11, 12])
    run, particle = torch.tensor([0, 0, 1, 1]), torch.tensor([0, 5, 2, 7])
    d32 = TreeDraws(PHILOX, seed, run, particle, torch.float32)
    d64 = TreeDraws(PHILOX, seed, run, particle, torch.float64)
    u32, u64 = d32.uniforms(LEAF, range(8), 0), d64.uniforms(LEAF, range(8), 0)
    assert u64.dtype == torch.float64 and torch.equal(u64, u32.double())
