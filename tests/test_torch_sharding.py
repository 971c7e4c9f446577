"""The particle and run axes over a torch.distributed process group (the
port's `parallel/`), on the CPU with gloo: the counterpart of
tests/test_sharding.py and of the dryrun phases (a)-(d), (f) of
MULTICHIP_r05.json.

One gang of 4 rank processes (`smcnuts_torch.parallel.gang`, port code only:
no rank imports JAX or this module) runs the jobs ops, runs, steps and
run_axes once for the module and saves its results; the cases below read
them. This process computes the references meanwhile:

- sharded == unsharded port, to the bit, at P = 1, 2, 4: the fold of
  `row_sum` over the ranks, normalise, ESS, moments, the ESS bisection,
  the Gaussian L-kernel's population moments and log-pdf, the ancestor
  exchange of both resampling schemes, and the loop's resample with one run
  resampling (no exchange at all when none does); whole runs (K = 4, B = 2, N = 128,
  eager tree) of arma forwards, the Gaussian L-kernel with systematic
  resampling, asymptotic with tempering, and adapted step size and mass;
- the sharded ops against the JAX package's on the 8-device CPU mesh of
  tests/conftest.py, inputs placed by `weight_sharding` /
  `particle_sharding`: normalise and ESS at rtol 1e-6 (as
  tests/test_sharding.py:39-47), the moments at rtol 1e-5 / atol 1e-7 and
  the bisection at rtol 1e-5 (tests/test_torch_smc_ops.py's and
  tests/test_torch_tempering.py's tolerances for the unsharded port against
  JAX), the L-kernel at 1e-3 (tests/test_torch_lkernels.py's), and the CDF
  inversion exactly;
- three sharded steps at P = 2 and P = 4 against JAX's `_make_step(...,
  mesh=particle_mesh())` over the 8 CPU devices with the Pallas kernel
  interpreted (zero bits, so its per-device seed offset draws nothing), the
  port fed JAX's resampling uniforms: every carry field and diagnostic at
  rtol/atol 1e-4, the resample decisions exactly, both branches taken. The
  trees are cut to depth 2: interpreted over 8 devices, JAX's step at depth
  4 cost 84 s for the three (44 s of it the first), at depth 2 26 s. The
  scalar fields start replicated over the mesh, so the step compiles once;
- the run axes: `map_runs` over 2 ranks and the 2 x 2 grid `map_runs_2d`
  equal to `run_smc_batched` of the same seeds, to the bit;
- a shard's trees (`particle_map`) equal the same particles' trees of the
  unsharded call, on the plain tree and the eager tree in blocks.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from smcnuts_torch import SMCConfig
from smcnuts_torch.models import get_model
from smcnuts_torch.ops.draws import PHILOX, ZERO_BITS
from smcnuts_torch.ops.nuts_cuda import STAT_KEYS, nuts_tree, nuts_tree_plain
from smcnuts_torch.parallel import gang
from smcnuts_torch.sampler import run_smc_batched
from smcnuts_tpu import DiagNormalProposal as JaxDiagNormalProposal
from smcnuts_tpu import SMCConfig as JaxSMCConfig
from smcnuts_tpu.models import make_arma
from smcnuts_tpu.ops import ess as jax_ess
from smcnuts_tpu.ops import gaussian_lkernel_logpdf as jax_gaussian_lkernel_logpdf
from smcnuts_tpu.ops import next_temperature as jax_next_temperature
from smcnuts_tpu.ops import normalise_weights as jax_normalise_weights
from smcnuts_tpu.ops import weighted_moments as jax_weighted_moments
from smcnuts_tpu.ops.adaptation import da_init
from smcnuts_tpu.ops.resampling import _invert_cdf as jax_invert_cdf
from smcnuts_tpu.parallel import particle_mesh, particle_sharding, weight_sharding
from smcnuts_tpu.sampler import _DIAG_FIELDS, SMCCarry as JaxSMCCarry
from smcnuts_tpu.sampler import _make_step

torch.set_num_threads(2)

SIZES = (1, 2, 4)
POST_MODE = np.array([0.007, 0.957, -0.034, np.log(0.166)])
STEP_N, STEP_ITERS, STEP_DEPTH = 64, 3, 2
STEP_SIZES = (2, 4)
OPS = ("row_sum", "wn", "log_likelihood", "ess", "mean", "var", "phi", "lk_mean",
       "lk_cov", "lk_logpdf", "ancestors_multinomial", "rows_multinomial",
       "ancestors_systematic", "rows_systematic", "resample_x", "resample_logw",
       "quiet_resample_calls")


def bits_equal(got, want):
    got, want = np.atleast_1d(got), np.atleast_1d(want)
    return got.shape == want.shape and got.dtype == want.dtype and np.array_equal(
        got.view(np.uint8), want.view(np.uint8))


def _steps_start():
    """The state the three steps start from, and the resampling uniforms the
    JAX step draws from its key at each iteration."""
    rng = np.random.default_rng(0)
    x0 = (POST_MODE + rng.normal(0, 0.05, (STEP_N, 4))).astype(np.float32)
    logw0 = rng.normal(0, 2.0, STEP_N).astype(np.float32)
    key = jax.random.key(3)
    uniforms = []
    for _ in range(STEP_ITERS):
        key, k_res = jax.random.split(key, 5)[:2]
        uniforms.append(np.array(jax.random.uniform(k_res, (STEP_N,), jnp.float32)))
    return x0, logw0, np.stack(uniforms)


def _jax_steps(x0, logw0, uniforms):
    """Three iterations of the JAX package's step sharded over the 8 CPU
    devices (Pallas kernel interpreted) from (x0, logw0)."""
    mesh = particle_mesh()
    jm = make_arma()
    cfg = JaxSMCConfig(n_particles=STEP_N, n_iterations=STEP_ITERS, step_size=0.01,
                       nuts_backend="pallas", max_tree_depth=STEP_DEPTH)
    step = jax.jit(_make_step(jm, cfg, JaxDiagNormalProposal(jm.dim), mesh=mesh))
    step0 = jnp.float32(0.01)

    def replicated(v):
        return jax.device_put(v, NamedSharding(mesh, PartitionSpec()))

    carry = JaxSMCCarry(
        x=jax.device_put(jnp.asarray(x0), particle_sharding(mesh)),
        logw=jax.device_put(jnp.asarray(logw0), weight_sharding(mesh)),
        phi=replicated(jnp.float32(1.0)), step_size=replicated(step0),
        inv_mass=replicated(jnp.ones(4, jnp.float32)),
        da=jax.tree.map(replicated, da_init(step0, jnp.float32)),
        key=replicated(jax.random.key(3)),
    )
    out = []
    for k in range(STEP_ITERS):
        k_res = jax.random.split(carry.key, 5)[1]
        np.testing.assert_array_equal(
            np.asarray(jax.random.uniform(k_res, (STEP_N,), jnp.float32)), uniforms[k])
        carry, o = step(carry, jnp.int32(k))
        d = np.asarray(o["diag"])
        n_diag = len(_DIAG_FIELDS)
        out.append(dict(
            x=np.asarray(carry.x), logw=np.asarray(carry.logw), phi=np.asarray(carry.phi),
            step_size=np.asarray(carry.step_size), inv_mass=np.asarray(carry.inv_mass),
            diag=dict(zip(_DIAG_FIELDS, d[:n_diag]), mean=d[n_diag:n_diag + 4],
                      var=d[n_diag + 4:])))
    return out


def _jax_ops(inp, b=0):
    """The JAX package's ops on run b of the inputs, placed on the 8-device
    mesh; the CDF inversions of both schemes at the same uniforms."""
    mesh = particle_mesh()
    ws, ps = weight_sharding(mesh), particle_sharding(mesh)
    logw = jax.device_put(jnp.asarray(inp["logw"][b]), ws)
    x = jax.device_put(jnp.asarray(inp["x"][b]), ps)
    r = jax.device_put(jnp.asarray(inp["r"][b]), ps)
    loglik = jax.device_put(jnp.asarray(inp["loglik"][b]), ws)
    u = jax.device_put(jnp.asarray(inp["uniforms"][b]), ws)
    n = logw.shape[0]

    @jax.jit
    def ops(logw, x, r, loglik, u, u0):
        wn, ll = jax_normalise_weights(logw)
        mean, var = jax_weighted_moments(x, wn)
        cdf = jnp.cumsum(wn)
        positions = ((jnp.arange(n) + u0) / n).astype(wn.dtype)
        return dict(
            wn=wn, log_likelihood=ll, ess=jax_ess(wn), mean=mean, var=var,
            phi=jax_next_temperature(loglik, inp["phi_old"][b], n),
            lk_logpdf=jax_gaussian_lkernel_logpdf(r, x),
            ancestors_multinomial=jax_invert_cdf(cdf, u * cdf[-1]),
            ancestors_systematic=jax_invert_cdf(cdf / cdf[-1], positions),
        )

    return {k: np.asarray(v) for k, v in
            ops(logw, x, r, loglik, u, jnp.float32(inp["shared_uniform"][b])).items()}


def _in_thread(fn):
    """Start fn in a thread; the returned function joins it and gives fn's
    result, or raises what fn raised."""
    box = {}

    def target():
        try:
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised by the getter
            box["error"] = e

    thread = threading.Thread(target=target)
    thread.start()

    def result():
        thread.join()
        if "error" in box:
            raise box["error"]
        return box["value"]

    return result


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The gang's results, the unsharded port's and the JAX package's."""
    out = tmp_path_factory.mktemp("gang")
    x0, logw0, uniforms = _steps_start()
    steps_input = out / "steps_input.npz"
    da = da_init(jnp.float32(0.01), jnp.float32)
    np.savez(steps_input, x=x0, logw=logw0, phi=np.float32(1.0),
             step_size=np.float32(0.01), inv_mass=np.ones(4, np.float32),
             uniforms=uniforms, max_depth=STEP_DEPTH,
             **{f"da{i}": np.asarray(v) for i, v in enumerate(da)})
    gang_run = _in_thread(lambda: gang.launch(
        out, 4, ["ops", "runs", "steps", "run_axes"],
        {"steps_input": str(steps_input)}, timeout=300))
    inp = gang.op_inputs()
    port_refs = _in_thread(lambda: {
        "ops": {k: v.numpy() for k, v in gang.op_results(
            {k: torch.from_numpy(v) for k, v in inp.items()}).items()},
        "runs": {name: gang.result_arrays(run_smc_batched(
            get_model("arma"), gang.run_config(**kw), list(gang.RUN_SEEDS), "cpu"))
            for name, kw in gang.RUN_CASES.items()},
        "run_axes": gang.result_arrays(run_smc_batched(
            get_model("arma"), SMCConfig(**gang.AXIS_CONFIG), list(gang.AXIS_SEEDS),
            "cpu")),
    })
    ref = {}
    try:
        ref.update(jax_ops=_jax_ops(inp), jax_steps=_jax_steps(x0, logw0, uniforms))
    finally:
        ref.update(port_refs())
        gang_run()
    ref["gang"] = {p.stem: dict(np.load(p)) for p in out.glob("*.npz")
                   if p.name != "steps_input.npz"}
    ref["inputs"] = inp
    return ref


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("size", SIZES)
def test_sharded_ops_equal_unsharded(world, size, op):
    got = world["gang"][f"ops_P{size}"][op]
    assert bits_equal(got, world["ops"][op]), op


def test_ops_inputs_cover_the_masked_weights(world):
    logw = world["inputs"]["logw"]
    assert np.isneginf(logw).any() and np.isfinite(logw).any()
    # The bisection stops inside (phi_old, 1) for run 0, and the ancestors of
    # the particles of -inf weight are never chosen.
    assert 0.0 < world["ops"]["phi"][0] < 1.0
    for scheme in ("multinomial", "systematic"):
        anc = world["ops"][f"ancestors_{scheme}"]
        assert np.all(np.take_along_axis(world["ops"]["wn"], anc, -1) > 0)


@pytest.mark.parametrize("size", (2, 4))
def test_loop_resample_fetches_only_what_it_needs(world, size):
    """Run 0 resampled and run 1 kept, by rows fetched from their owners;
    with no run below its threshold the resample made no collective."""
    got, x = world["gang"][f"ops_P{size}"], world["inputs"]["x"]
    assert int(got["quiet_resample_calls"]) == 0
    assert np.array_equal(got["resample_x"][1], x[1])
    assert not np.array_equal(got["resample_x"][0], x[0])


TOLERANCES = {"wn": dict(rtol=1e-6, atol=0), "log_likelihood": dict(rtol=1e-6, atol=0),
              "ess": dict(rtol=1e-6, atol=0), "mean": dict(rtol=1e-5, atol=1e-7),
              "var": dict(rtol=1e-5, atol=1e-7), "phi": dict(rtol=1e-5, atol=0),
              "lk_logpdf": dict(rtol=1e-3, atol=1e-3)}


@pytest.mark.parametrize("op", sorted(TOLERANCES) + ["ancestors_multinomial",
                                                     "ancestors_systematic"])
@pytest.mark.parametrize("size", (2, 4))
def test_sharded_ops_match_jax_sharded(world, size, op):
    got = world["gang"][f"ops_P{size}"][op][0]
    want = world["jax_ops"][op]
    if op.startswith("ancestors"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOLERANCES[op], err_msg=op)


@pytest.mark.parametrize("name", sorted(gang.RUN_CASES))
@pytest.mark.parametrize("size", SIZES)
def test_sharded_run_equals_unsharded(world, size, name):
    got, want = world["gang"][f"runs_{name}_P{size}"], world["runs"][name]
    assert set(got) == set(want)
    differing = [k for k in want if not bits_equal(got[k], want[k].numpy())]
    assert not differing, differing
    res = want["resampled"].numpy()
    assert res.any() and not res.all()


@pytest.mark.parametrize("k", range(STEP_ITERS))
@pytest.mark.parametrize("size", STEP_SIZES)
def test_sharded_steps_match_jax_sharded_step(world, size, k):
    got = world["gang"][f"steps_P{size}"]
    want = world["jax_steps"][k]
    for f in ("x", "logw", "phi", "step_size", "inv_mass"):
        np.testing.assert_allclose(got[f"{f}_{k}"].reshape(want[f].shape), want[f],
                                   rtol=1e-4, atol=1e-4, err_msg=f"iteration {k}: {f}")
    for f in ("ess", "log_likelihood", "mean", "var", "phi", "acceptance", "step_size",
              "tree_depth", "tree_leapfrogs", "accept_stat"):
        np.testing.assert_allclose(got[f"{f}_{k}"][0], want["diag"][f], rtol=1e-4,
                                   atol=1e-4, err_msg=f"iteration {k}: {f}")
    assert bool(got[f"resampled_{k}"][0]) == bool(want["diag"]["resampled"] > 0.5)


@pytest.mark.parametrize("size", STEP_SIZES)
def test_sharded_steps_take_both_branches(world, size):
    assert len(jax.devices()) == 8
    took = [bool(world["gang"][f"steps_P{size}"][f"resampled_{k}"][0])
            for k in range(STEP_ITERS)]
    assert any(took) and not all(took)


@pytest.mark.parametrize("case", ["run_axes_map_P2", "run_axes_grid_P4"])
def test_run_axes_equal_batched(world, case):
    got, want = world["gang"][case], world["run_axes"]
    assert set(got) == set(want)
    assert got["x_final"].shape[0] == len(gang.AXIS_SEEDS)
    differing = [k for k in want if not bits_equal(got[k], want[k].numpy())]
    assert not differing, differing


@pytest.mark.parametrize("draws", [PHILOX, ZERO_BITS])
@pytest.mark.parametrize("size", (2, 4))
def test_shard_trees_equal_unsharded_trees(size, draws):
    """Each rank's share of the particles (particle_map (rank, size)) grows
    the trees those particles grow in the unsharded call, staged and in
    blocks alike."""
    model = get_model("arma")
    g = torch.Generator().manual_seed(4)
    x = (torch.tensor(POST_MODE, dtype=torch.float32)
         + 0.05 * torch.randn(2, 16, 4, generator=g))
    seed = torch.tensor([17, 90], dtype=torch.int32)
    args = (model, x, seed, 0.01, torch.tensor([1.0, 0.4]), None, 4, draws)
    full = nuts_tree_plain(*args)
    for rank in range(size):
        xs = x[:, rank::size].contiguous()
        # The last rank also staged and in blocks of 3 lanes.
        for kw in [dict()] + [dict(compaction=(1, 2), block_size=3)] * (rank == size - 1):
            part = nuts_tree_plain(model, xs, *args[2:], particle_map=(rank, size), **kw)
            assert torch.equal(part[0], full[0][:, rank::size])
            assert torch.equal(part[1], full[1][:, rank::size])
            for key in STAT_KEYS:
                assert torch.equal(part[2][key], full[2][key][:, rank::size]), key
    # nuts_tree on CPU tensors is the plain tree with the same map.
    part = nuts_tree(model, x[:, 1::2].contiguous(), *args[2:], particle_map=(1, 2))
    assert torch.equal(part[0], full[0][:, 1::2])


def test_particle_map_is_checked():
    x = torch.zeros(1, 4, 4)
    with pytest.raises(ValueError, match="particle_map"):
        nuts_tree_plain(get_model("arma"), x, torch.zeros(1, dtype=torch.int32), 0.01,
                        max_depth=1, particle_map=(2, 2))
