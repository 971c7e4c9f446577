"""Small dense linear algebra, folded data and the Newton solver under
tile=True: the Stan programs whose generated models the lowering's linear
algebra (Cholesky-Banachiewicz, forward and back substitution, LU with
partial pivoting by selects, the determinant and its logarithm), its bool
and integer constants and its view ops unblock.

- examples/stan/mvn_quadform, inv_wishart_cov (cov_matrix and corr_matrix
  parameters, inv_wishart, lkj_corr), multi_student_t and ordered_logistic,
  the algebra solver of tests/test_stan_orientation.py:420 (16 Newton
  steps), and a program whose matrix needs row swaps (inverse,
  log_determinant, determinant, mdivide_left_spd, mdivide_left_tri_low of a
  parameter matrix): each generated model's plain version, reverse and
  forward, against the JAX frontend's `tile_fn` on (8, 128) tiles, at
  tests/test_stan_frontend.py:411's tolerance (logp rtol 1e-4 + atol 1e-4,
  the gradient 1e-5 of its largest component).
- Three SMC iterations of inv_wishart_cov on the port's plain tree (zero
  bits) against the JAX step with its Pallas kernel interpreted at depth 2,
  as tests/test_torch_stan_tile.py holds a compiled program: at atol 1e-4 /
  rtol 1e-4, the resampling decisions exactly.
- The pivot: the kernel's program and the plain one are the same program;
  a tie between two candidate rows takes the first, as LAPACK does, and a
  matrix that is not positive definite gives NaN in the density, not a
  crash. truncated_glm, which the JAX frontend does not tile (a
  ConcretizationTypeError), lowers here and agrees with the port's eager
  model.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smcnuts_torch import SMCConfig
from smcnuts_torch import stan as tstan
from smcnuts_torch.interop import CARRY_FIELDS, carry_from_numpy, carry_to_numpy
from smcnuts_torch.models.base import CallableModel
from smcnuts_torch.ops.draws import ZERO_BITS
from smcnuts_torch.ops.generated import tile_model_from_logp
from smcnuts_torch.sampler import smc_step
from smcnuts_tpu import DiagNormalProposal as JaxDiagNormalProposal
from smcnuts_tpu import SMCConfig as JaxSMCConfig
from smcnuts_tpu import stan as jstan
from smcnuts_tpu.ops.adaptation import da_init
from smcnuts_tpu.sampler import _DIAG_FIELDS, SMCCarry as JaxSMCCarry
from smcnuts_tpu.sampler import _make_step

from test_torch_stan_tile_ops import against_tile_fn

torch.set_num_threads(2)

_EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "examples", "stan")

ALGEBRA = """
functions {
  vector sq_system(vector y, array[] real theta, array[] real x_r, array[] int x_i) {
    vector[1] z;
    z[1] = y[1] * y[1] - theta[1];
    return z;
  }
}
data { real phi; }
parameters { real<lower=0> a; }
model {
  vector[1] guess = [1.0]';
  vector[1] root = algebra_solver(sq_system, guess, {a}, {0.0}, {0});
  target += -0.5 * square(root[1] - 2.0);
  a ~ normal(4, 2);
}
"""

# A parameter matrix whose first column's largest entry is not on the
# diagonal: the elimination swaps rows.
PIVOTED = """
data { vector[3] b; }
parameters { vector[3] d; real r; }
model {
  matrix[3, 3] M = [[0.1 * r, 1.0, 0.2], [exp(d[1]), 0.5 * r, 0.3],
                    [0.4, r, exp(d[2]) + exp(d[3])]];
  d ~ normal(0, 1);
  r ~ normal(0, 1);
  target += -0.5 * dot_self(inverse(M) * b) - 0.5 * log_determinant(M)
            + 0.1 * determinant(M) + 0.1 * sum(mdivide_left_spd(crossprod(M), b))
            + 0.1 * sum(mdivide_left_tri_low(cholesky_decompose(crossprod(M)), b));
}
"""


def _example(name):
    path = os.path.join(_EXAMPLES, name)
    with open(path + ".stan") as f:
        return f.read(), tstan.load_stan_data(path + ".json")


def _program(name):
    if name == "algebra_solver":
        return ALGEBRA, {}
    if name == "pivoted":
        return PIVOTED, {"b": [1.0, -0.5, 0.3]}
    return _example(name)


PROGRAMS = ["mvn_quadform", "inv_wishart_cov", "multi_student_t", "ordered_logistic",
            "algebra_solver", "pivoted"]


@pytest.mark.parametrize("mode", ["reverse", "forward"])
@pytest.mark.parametrize("name", PROGRAMS)
def test_program_matches_jax_tile_fn(name, mode):
    src, data = _program(name)
    dim = tstan.compile_stan_program(src, data, name=name).dim
    x = np.random.default_rng(4).normal(0, 0.5, (1024, dim))
    tm = against_tile_fn(src, data, mode, x, name=name)
    # The eager model (ATen's linalg, by autograd) agrees with the program.
    xt = torch.tensor(x[:64], dtype=torch.float32)
    lp_t, g_t = tm.tile_model.logp_and_grad(xt, 0.7)
    lp_e, g_e = CallableModel.logp_and_grad(tm, xt, 0.7)
    np.testing.assert_allclose(lp_t.numpy(), lp_e.numpy(), rtol=1e-4, atol=1e-4)
    scale = float(g_e.abs().max()) + 1e-6
    np.testing.assert_allclose(g_t.numpy() / scale, g_e.numpy() / scale, atol=1e-5)


def test_data_alone_folds_to_literals():
    """mvn_quadform's inverse(A) and log_determinant(A) are data: the
    interpreter evaluates them on the host in float64, and the program
    holds only their values rounded to float32, no solve."""
    src, data = _example("mvn_quadform")
    tm = tstan.compile_stan_program(src, data, name="mvn", tile=True).tile_model
    assert tm.n_ops < 20 and {op for op, *_ in tm.program.ops} <= {
        "x", "phi", "data", "add", "sub", "mul", "neg"}


def test_pivot_ties_take_the_first_row_and_not_pd_gives_nan():
    """solve(A, b) of a parameter matrix: where two rows' first entries tie
    in magnitude the elimination keeps the first (no swap), where the second
    is larger it swaps, both equal to the closed form; Cholesky of a matrix
    that is not positive definite gives NaN, not a crash."""
    def logp(t, phi):
        A = torch.stack([torch.stack([t[0] + 1.0, torch.ones_like(t[0])]),
                         torch.stack([t[1], 2.0 * torch.ones_like(t[0])])])
        return torch.linalg.solve(A, torch.stack([t[0] * 0 + 1.0, t[0] * 0 + 3.0])).sum()

    tm = tile_model_from_logp(logp, 2)
    x = torch.tensor([[0.0, 1.0], [0.0, -1.0], [-0.5, 3.0], [-3.0, 1.0]])
    lp, g = tm.logp_and_grad(x, 1.0)
    want = torch.stack([torch.linalg.solve(
        torch.tensor([[a + 1.0, 1.0], [c, 2.0]]), torch.tensor([1.0, 3.0])).sum()
        for a, c in x.tolist()])
    torch.testing.assert_close(lp, want, rtol=1e-6, atol=1e-6)
    assert torch.isfinite(g).all()
    chol = tile_model_from_logp(
        lambda t, p: torch.linalg.cholesky(torch.stack([
            torch.stack([t[0] + 1.0, t[1]]), torch.stack([t[1], t[0] + 1.0])])).sum(), 2)
    lp, _ = chol.logp_and_grad(torch.tensor([[0.0, 0.5], [0.0, 2.0]]), 1.0)
    assert torch.isfinite(lp[0]) and torch.isnan(lp[1])
    # The Stan frontend's eager path gives NaN there too (jnp.linalg's
    # result), not an exception.
    src = """parameters { real a; real c; }
    model { matrix[2, 2] S = [[1, c], [c, 1]];
            target += sum(cholesky_decompose(S)) + sum(inverse(S)) + a; }"""
    for tile in (False, True):
        m = tstan.compile_stan_program(src, {}, name="spd", tile=tile)
        x = torch.tensor([[0.3, 0.5], [0.3, 2.0], [0.3, 1.0]])
        lp = (m.tile_model.logp_and_grad(x, 1.0) if tile else m.logp_and_grad(x))[0]
        assert torch.isfinite(lp[0]) and torch.isnan(lp[1:]).all()


def test_truncated_glm_lowers_and_agrees_with_the_eager_model():
    """truncated_glm, which the JAX frontend does not tile (its T[-4, 4]
    truncation meets a ConcretizationTypeError), lowers here: its generated
    model against the port's eager model at rtol 1e-4 + atol 1e-4."""
    src, data = _example("truncated_glm")
    m = tstan.compile_stan_program(src, data, name="tglm", tile=True)
    x = torch.tensor(np.random.default_rng(6).normal(0, 0.5, (64, m.dim)), dtype=torch.float32)
    lp_t, g_t = m.tile_model.logp_and_grad(x, 0.7)
    lp_e, g_e = CallableModel.logp_and_grad(m, x, 0.7)
    np.testing.assert_allclose(lp_t.numpy(), lp_e.numpy(), rtol=1e-4, atol=1e-4)
    scale = float(g_e.abs().max())
    np.testing.assert_allclose(g_t.numpy() / scale, g_e.numpy() / scale, atol=1e-5)


N_PART, ITERS, MAX_DEPTH = 16, 3, 2
# The step of the JAX comparison. Zero bits draw every momentum component
# at -5.77 (ke0 66.5), and at step 0.1 the trajectories reach the steep
# corner of inv_wishart's density, where two float32 evaluations of the same
# density (JAX's and the port's, each within 1e-5 of the other at a point)
# part by 0.03 in the weights within two iterations: the port's generated
# and eager models then still agree at 1e-4
# (test_inv_wishart_cov_generated_steps_match_eager_steps).
IW_STEP = 0.02


def _jax_tile_model_with_data(jm):
    """The JAX frontend's reverse tile model of jm with the arrays its
    density closes over passed through the kernel's data refs: its own
    adapter (`nuts_pallas.tile_model_from_logp`) leaves them as constants
    of the kernel, which pallas_call refuses ("captures constants") for a
    program with matrix data such as inv_wishart_cov. The density is jm's
    jaxpr, evaluated with the arrays read from the refs; the gradient by
    jax.vjp inside the kernel, as the adapter takes it."""
    from smcnuts_tpu.ops.nuts_pallas import TileModel

    closed = jax.make_jaxpr(jm.logp)(jnp.zeros(jm.dim, jnp.float32), jnp.float32(1.0))
    consts = tuple(jnp.asarray(c) for c in closed.consts)

    def tile_fn(extra_refs, x_tiles, phi):
        cs = [r[...] for r in extra_refs]
        theta = jnp.stack(list(x_tiles))
        phi_t = jnp.broadcast_to(jnp.asarray(phi, theta.dtype), theta.shape[1:])

        def logp(t, p):
            return jax.core.eval_jaxpr(closed.jaxpr, cs, t, p)[0]

        lanes = jax.vmap(logp, in_axes=(-1, -1), out_axes=-1)
        tiles = jax.vmap(lanes, in_axes=(1, 0), out_axes=0)
        value, pull = jax.vjp(lambda th: tiles(th, phi_t), theta)
        grads = pull(jnp.ones_like(value))[0]
        return value, [grads[d] for d in range(jm.dim)]

    return TileModel(dim=jm.dim, extra=consts, tile_fn=tile_fn, autodiff="reverse")


def test_inv_wishart_cov_steps_match_jax_step():
    """Three SMC iterations of inv_wishart_cov (D = 4: a cov_matrix and a
    corr_matrix) at step IW_STEP on the port's plain tree with ZERO_BITS
    draws against the JAX step with its Pallas kernel interpreted on the
    CPU (zero bits), from
    one state, the port handed the resampling uniforms the JAX step draws:
    at atol 1e-4 / rtol 1e-4, the resampling decisions exactly. The JAX
    model's tile model passes its data arrays through the kernel's refs
    (`_jax_tile_model_with_data`)."""
    import copy

    src, data = _example("inv_wishart_cov")
    jm = copy.copy(jstan.compile_stan_program(src, data, name="iw"))
    object.__setattr__(jm, "tile_model", _jax_tile_model_with_data(jm))
    tm = tstan.compile_stan_program(src, data, name="iw", tile=True)
    assert tm.tile_model.autodiff == "reverse" and jm.dim == tm.dim == 4
    cfg_j = JaxSMCConfig(n_particles=N_PART, n_iterations=ITERS, step_size=IW_STEP,
                         nuts_backend="pallas", max_tree_depth=MAX_DEPTH)
    step = jax.jit(_make_step(jm, cfg_j, JaxDiagNormalProposal(jm.dim)))
    rng = np.random.default_rng(0)
    x0 = rng.normal(0, 0.3, (N_PART, 4)).astype(np.float32)
    logw0 = rng.normal(0, 2.0, N_PART).astype(np.float32)
    step0 = jnp.float32(IW_STEP)
    carry = JaxSMCCarry(x=jnp.asarray(x0), logw=jnp.asarray(logw0), phi=jnp.float32(1.0),
                        step_size=step0, inv_mass=jnp.ones(4, jnp.float32),
                        da=da_init(step0, jnp.float32), key=jax.random.key(3))
    start = {k: jax.tree.map(np.asarray, getattr(carry, k)) for k in CARRY_FIELDS}
    cfg = SMCConfig(n_particles=N_PART, n_iterations=ITERS, step_size=IW_STEP,
                    max_tree_depth=MAX_DEPTH)
    tcarry = carry_from_numpy(**start, device="cpu")
    for k in range(ITERS):
        k_res = jax.random.split(carry.key, 5)[1]
        uniforms = np.array(jax.random.uniform(k_res, (N_PART,), jnp.float32))
        carry, out = step(carry, jnp.int32(k))
        want = {f: jax.tree.map(np.asarray, getattr(carry, f)) for f in CARRY_FIELDS}
        d = np.asarray(out["diag"])
        diag_j = dict(zip(_DIAG_FIELDS, d[: len(_DIAG_FIELDS)]))
        tcarry, diag = smc_step(tm, cfg, tcarry, torch.as_tensor(uniforms)[None],
                                torch.zeros(1, dtype=torch.int32), "eager", ZERO_BITS)
        got = carry_to_numpy(tcarry, run_axis=False)
        for f in CARRY_FIELDS:
            np.testing.assert_allclose(got[f], want[f], rtol=1e-4, atol=1e-4,
                                       err_msg=f"iteration {k}: {f}")
        for f in ("ess", "log_likelihood", "acceptance", "tree_depth", "tree_leapfrogs"):
            np.testing.assert_allclose(diag[f][0].numpy(), diag_j[f], rtol=1e-4, atol=1e-4,
                                       err_msg=f"iteration {k}: {f}")
        assert bool(diag["resampled"][0]) == bool(diag_j["resampled"] > 0.5)


def test_inv_wishart_cov_generated_steps_match_eager_steps():
    """Three SMC iterations of inv_wishart_cov at step 0.1 (zero bits), the
    port's plain tree on its generated model (the kernel's program) against
    the same tree on its eager model (ATen's linalg by autograd), from one
    state and the same resampling uniforms: every carry field at atol 1e-4
    / rtol 1e-4, the resampling decisions exactly."""
    src, data = _example("inv_wishart_cov")
    models = {"generated": tstan.compile_stan_program(src, data, name="iw", tile=True),
              "eager": tstan.compile_stan_program(src, data, name="iw")}
    rng = np.random.default_rng(0)
    x0 = rng.normal(0, 0.3, (N_PART, 4)).astype(np.float32)
    logw0 = rng.normal(0, 2.0, N_PART).astype(np.float32)
    step0 = jnp.float32(0.1)
    carry = JaxSMCCarry(x=jnp.asarray(x0), logw=jnp.asarray(logw0), phi=jnp.float32(1.0),
                        step_size=step0, inv_mass=jnp.ones(4, jnp.float32),
                        da=da_init(step0, jnp.float32), key=jax.random.key(3))
    start = {k: jax.tree.map(np.asarray, getattr(carry, k)) for k in CARRY_FIELDS}
    cfg = SMCConfig(n_particles=N_PART, n_iterations=ITERS, step_size=0.1,
                    max_tree_depth=MAX_DEPTH)
    carries = {k: carry_from_numpy(**start, device="cpu") for k in models}
    uniforms = np.random.default_rng(1).uniform(size=(ITERS, N_PART)).astype(np.float32)
    for k in range(ITERS):
        out = {}
        for key, model in models.items():
            carries[key], diag = smc_step(model, cfg, carries[key],
                                          torch.as_tensor(uniforms[k])[None],
                                          torch.zeros(1, dtype=torch.int32), "eager", ZERO_BITS)
            out[key] = (carry_to_numpy(carries[key], run_axis=False), diag)
        (got, dg), (want, de) = out["generated"], out["eager"]
        for f in CARRY_FIELDS:
            np.testing.assert_allclose(got[f], want[f], rtol=1e-4, atol=1e-4,
                                       err_msg=f"iteration {k}: {f}")
        assert bool(dg["resampled"][0]) == bool(de["resampled"][0])
