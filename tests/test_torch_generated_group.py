"""Reverse-mode generated programs split over a group of lanes
(`ops/generated.py`: `_Scalars.reduce`, `_Body`, `_choose_group`,
`_group_program`, `Loop`).

- The re-roll pass finds the generated eight schools' four sums over the
  schools (the tt prior, the likelihood, d/d mu, d/d log_tau) as one loop
  body, with grad[2 + j] exported from it, the data re-laid out as a table
  whose entry i belongs to school i; group=1, the default, keeps the
  straight-line program.
- An emulation in numpy float32 of what the emitted CUDA computes (the
  straight-line nodes in the schedule's order; each loop lane by lane over
  its summands i = lane + s W, with the template ops, the data table and
  x[a + i]; the lane partials folded in index order and the xor butterfly;
  the exports broadcast from the lane that owns each index) equals the
  grouped program's plain version (`GeneratedModel.logp_and_grad`, the fx
  graph) to the bit, at W = 2, 4 and 8, phi 1.0 and 0.4, a lane at
  log_tau 200 included.
- The grouped program against the JAX package's reverse-mode tile model
  (`tile_model_from_logp`, nuts_pallas.py:1126) at the tolerance of
  tests/test_torch_generated.py::test_generated_reverse_matches_jax_tile_fn.
- A density whose summand cones differ (a school with y = 0 written as a
  Python float: 0 - m becomes a negation, one operation fewer in that
  school's cone) keeps W = 1 and the source of group=1, byte for byte, by
  default, and raises where a width is asked for by name.
- The plain tree on the grouped model against the Pallas kernel interpreted
  with zero bits at depth 3: integers exactly, floats at atol/rtol 1e-4.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smcnuts_torch.models.base import LOG_SQRT_2PI, normal_lpdf
from smcnuts_torch.models.eightschools import (
    SIGMA, Y, eightschools_logprior, make_eightschools_generated)
from smcnuts_torch.ops import generated
from smcnuts_torch.ops.draws import ZERO_BITS
from smcnuts_torch.ops.generated import tile_model_from_logp
from smcnuts_torch.ops.nuts_cuda import STAT_KEYS, nuts_tree_plain
from smcnuts_tpu.models import get_model as jax_get_model
from smcnuts_tpu.ops.nuts_pallas import nuts_batch_pallas_fused
from smcnuts_tpu.ops.nuts_pallas import tile_model_from_logp as jax_tile_model_from_logp

torch.set_num_threads(2)

F = np.float32
WIDTHS = [2, 4, 8]
INTEGER_STATS = ("depth", "leapfrogs", "moved")


@pytest.fixture(scope="module")
def schools():
    """The generated eight schools at each width, and unsplit."""
    out = {w: make_eightschools_generated(group=w).tile_model for w in [1] + WIDTHS}
    out[None] = make_eightschools_generated().tile_model
    return out


def _points(n, seed):
    rng = np.random.default_rng(seed)
    c = np.array([4.4, 1.2] + [0.0] * 8)
    sd = np.array([3.0, 0.5] + [1.0] * 8)
    return (c + sd * rng.normal(size=(n, 10))).astype(np.float32)


def test_the_four_sums_over_the_schools_are_one_body(schools):
    tm = schools[2]
    assert tm.group == 2
    (loop,) = tm.program.loops
    assert loop.n == 8 and len(loop.sums) == 4
    # grad[2 + j] leaves the loop from the lane that owns school j.
    (t, nodes), = loop.exports
    assert [v for _, v in nodes] == list(tm.program.grad[2:])
    assert [i for i, _ in nodes] == list(range(8))
    # The data table: y, sigma and log sigma, entry i school i's.
    cols = {o for _, refs in loop.ops for kind, o in refs if kind == "col"}
    table = {tuple(tm.program.data[o:o + 8]) for o in cols}
    assert tuple(np.float32(Y).tolist()) in table and tuple(np.float32(SIGMA).tolist()) in table
    assert {r[0] for r, _ in loop.sums} == {"t"}
    # Every width has the same body; group=1 is the straight-line program.
    for w in WIDTHS:
        assert schools[w].group == w and schools[w].program.loops == tm.program.loops
        assert schools[w].n_ops == schools[1].n_ops == tm.n_ops
    assert schools[1].group == 1 and schools[1].program.loops == ()
    assert "kGroup" not in schools[1].source and f"kGroup = {tm.group};" in tm.source
    # Where no width is named the program is the straight-line one.
    assert schools[None].group == generated.DEFAULT_GROUP == 1
    assert schools[None].source == schools[1].source


def _unary(op, v):
    fn = {"neg": np.negative, "recip": lambda a: F(1.0) / a, "sign": np.sign}.get(op)
    if fn is not None:
        return F(fn(v))
    return F(generated._UNARY[op](torch.tensor(v, dtype=torch.float32)).item())


def _apply(op, a):
    binary = {"add": np.add, "sub": np.subtract, "mul": np.multiply, "div": np.divide}
    if op in binary:
        return F(binary[op](F(a[0]), F(a[1])))
    if op in generated._CMP:
        return bool(generated._CMP[op](a[0], a[1]))
    if op == "where":
        return a[1] if a[0] else a[2]
    if op == "pow":
        return F(torch.pow(torch.tensor(a[0], dtype=torch.float32), a[1]).item())
    return _unary(op, a[0])


def _emulate(prog, x, phi):
    """The emitted CUDA of a grouped program, for one particle x (D,): every
    lane of the group in turn where the kernel runs them together."""
    W, data = prog.group, np.asarray(prog.data, F)
    v = {}

    def val(a):
        return v[a] if type(a) is int else (a if type(a) is bool else F(a))

    for kind, k in prog.schedule:
        if kind == "v":
            op, *a = prog.ops[k]
            v[k] = (F(x[a[0]]) if op == "x" else F(phi) if op == "phi"
                    else data[a[0]] if op == "data" else _apply(op, [val(u) for u in a]))
            continue
        loop = prog.loops[k]
        n, steps = loop.n, -(-loop.n // W)
        partial = [[F(0.0)] * len(loop.sums) for _ in range(W)]
        kept = [[[None] * steps for _ in loop.exports] for _ in range(W)]
        for lane in range(W):
            for step in range(steps):
                i = step * W + lane
                if i >= n:
                    continue
                t = []

                def ref(r):
                    kind_, u = r
                    if kind_ == "u":
                        return val(u)
                    if kind_ == "x":
                        return F(x[u + i])
                    if kind_ == "col":
                        return data[u + i]
                    return t[u]

                for op, refs in loop.ops:
                    t.append(_apply(op, [ref(r) for r in refs]))
                for r, (summand, _) in enumerate(loop.sums):
                    s = ref(summand)
                    partial[lane][r] = s if step == 0 else F(partial[lane][r] + s)
                for e, (top, _) in enumerate(loop.exports):
                    kept[lane][e][step] = t[top]
        o = W // 2
        while o:  # p = p + __shfl_xor_sync(mask, p, o), every lane at once
            partial = [[F(a + c) for a, c in zip(partial[lane], partial[lane ^ o])]
                       for lane in range(W)]
            o //= 2
        for r, (_, root) in enumerate(loop.sums):
            v[root] = partial[0][r]
        for e, (_, nodes) in enumerate(loop.exports):
            for i, node in nodes:
                v[node] = kept[i % W][e][i // W]
    return val(prog.logp), [val(g) for g in prog.grad]


def _same_bits(a, b):
    a, b = np.asarray(a, F), np.asarray(b, F)
    return np.all((a.view(np.uint32) == b.view(np.uint32)) | (np.isnan(a) & np.isnan(b)))


@pytest.mark.parametrize("phi", [1.0, 0.4])
@pytest.mark.parametrize("W", WIDTHS)
def test_emulated_lanes_equal_the_plain_version_to_the_bit(schools, W, phi):
    tm = schools[W]
    x = _points(6, seed=W)
    x[-1, 1] = 200.0  # tau = inf
    lp, g = tm.logp_and_grad(torch.as_tensor(x), phi)
    with np.errstate(all="ignore"):
        rows = [_emulate(tm.program, row, phi) for row in x]
    assert _same_bits(lp.numpy(), [r[0] for r in rows])
    assert _same_bits(g.numpy(), [r[1] for r in rows])
    assert np.isfinite(lp.numpy()[:-1]).all() and not np.isfinite(lp.numpy()[-1])


def _logistic_logp(X, y):
    """A logistic regression written with `@` and `dot`: 16 observations of
    3 covariates, the design matrix and the labels as tensor constants."""
    def logp(t, phi):
        eta = t.new_tensor(X) @ t
        return -0.5 * torch.dot(t, t) + phi * torch.sum(
            t.new_tensor(y) * eta - torch.log1p(torch.exp(eta)))
    return logp


@pytest.mark.parametrize("W", [2, 4, 8])
def test_a_program_of_two_loops_emulated_to_the_bit(W):
    """The logistic regression's sums: the prior's dot of 3 summands (lane 1
    takes one summand, lane 0 two at W = 2; a sum of 3 < W runs straight-line
    at W = 4 and 8), and the 16-observation sum with the three gradient sums
    in a later loop (their summands read the dot products eta_i, which that
    loop's body computes again lane by lane)."""
    rng = np.random.default_rng(0)
    X, y = rng.normal(size=(16, 3)), (rng.random(16) < 0.5).astype(float)
    tm = tile_model_from_logp(_logistic_logp(X, y), 3, group=W)
    assert tm.group == W
    assert [(loop.n, len(loop.sums)) for loop in tm.program.loops] == (
        [(3, 1), (16, 4)] if W == 2 else [(16, 4)])
    x = rng.normal(size=(8, 3)).astype(np.float32)
    for phi in (1.0, 0.4):
        lp, g = tm.logp_and_grad(torch.as_tensor(x), phi)
        rows = [_emulate(tm.program, row, phi) for row in x]
        assert _same_bits(lp.numpy(), [r[0] for r in rows])
        assert _same_bits(g.numpy(), [r[1] for r in rows])


def test_the_widths_sum_in_other_orders(schools):
    x = torch.as_tensor(_points(256, seed=5))
    lp1, _ = schools[1].logp_and_grad(x, 0.7)
    for w in WIDTHS:
        assert not torch.equal(schools[w].logp_and_grad(x, 0.7)[0], lp1)


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


@pytest.mark.parametrize("W", WIDTHS)
def test_grouped_reverse_matches_jax_tile_fn(schools, W):
    """At the tolerances of test_generated_reverse_matches_jax_tile_fn."""
    x = _points(1024, 7)
    lp, g = schools[W].logp_and_grad(torch.as_tensor(x), 0.7)
    tm = jax_tile_model_from_logp(_es_jax_logp, 10)
    tiles = [jnp.asarray(x[:, d].reshape(8, 128)) for d in range(10)]
    lp_j, g_j = tm.tile_fn((), tiles, jnp.full((8, 128), 0.7, jnp.float32))
    g_j = np.stack([np.asarray(v).reshape(-1) for v in g_j], axis=1)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lp_j).reshape(-1),
                               rtol=1e-4, atol=1e-4)
    scale = np.abs(g_j).max() + 1e-6
    np.testing.assert_allclose(g.numpy() / scale, g_j / scale, atol=1e-5)


def test_summands_of_another_shape_keep_the_straight_line_program():
    """School 4's y is 0 and the data are Python floats: (0 - m) / s is a
    negation and a division where the other schools subtract and divide, so
    the likelihood's cones are not one body. The tt prior's still are, but
    a split that left the likelihood in every lane would not pay: W = 1."""
    y0 = [float(v) for v in Y]
    y0[3] = 0.0

    def loglik(theta):
        mu, tau, tt = theta[0], torch.exp(theta[1]), theta[2:]
        return torch.sum(torch.stack([
            normal_lpdf(y0[j], mu + tau * tt[j], float(SIGMA[j])) for j in range(8)]))

    def logp(theta, phi):
        return eightschools_logprior(theta) + phi * loglik(theta)

    tm = tile_model_from_logp(logp, 10, name="eightschools, y_4 = 0")
    ref = tile_model_from_logp(logp, 10, name="eightschools, y_4 = 0", group=1)
    assert tm.group == 1 and tm.program.loops == ()
    assert tm.source == ref.source
    # A width asked for by name that the program cannot take raises, naming
    # the sum whose summands are not one body.
    with pytest.raises(ValueError, match=r"cannot split over 8 lanes: the summands "
                                         r"of sum \d+ \(8 summands, node \d+\) are "
                                         r"not one body"):
        tile_model_from_logp(logp, 10, name="eightschools, y_4 = 0", group=8)


def test_a_group_must_be_a_power_of_two():
    with pytest.raises(ValueError, match="power of two"):
        make_eightschools_generated(group=3)


@pytest.fixture(scope="module")
def fused():
    import jax

    tm = jax_get_model("eightschools").tile_model
    return jax.jit(lambda x, s, e, p, im: nuts_batch_pallas_fused(
        tm, x, s, e, p, im, max_depth=3, interpret=True))


@pytest.mark.parametrize("seed,phi", [(6, 1.0), (7, 0.4)])
def test_plain_tree_on_the_grouped_model_matches_pallas_kernel(fused, seed, phi):
    model = make_eightschools_generated(group=2)
    assert model.tile_model.group == 2
    rng = np.random.default_rng(seed)
    x = (np.array([4.4, 1.2] + [0.0] * 8)
         + 0.3 * rng.normal(size=(40, 10))).astype(np.float32)
    im = np.linspace(0.5, 2.0, 10).astype(np.float32)
    x_j, r_j, st_j = fused(jnp.asarray(x), jnp.int32(seed), jnp.float32(0.02),
                           jnp.float32(phi), jnp.asarray(im))
    x_t, r_t, st_t = nuts_tree_plain(model, torch.as_tensor(x)[None], seed, 0.02, phi,
                                     torch.as_tensor(im), 3, ZERO_BITS)
    np.testing.assert_allclose(x_t[0].numpy(), np.asarray(x_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(r_t[0].numpy(), np.asarray(r_j), rtol=1e-4, atol=1e-4)
    for k in STAT_KEYS:
        got, want = st_t[k][0].numpy(), np.asarray(st_j[k])
        if k in INTEGER_STATS:
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=k)
    assert st_t["depth"].max() >= 2 and st_t["moved"].mean() > 0.5
