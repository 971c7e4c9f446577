"""The whole-tree NUTS proposal against the JAX package's Pallas kernel.

Under interpret mode the Pallas kernel's TPU PRNG returns zero bits, so every
uniform is 2^-24 and its trees are deterministic. The port's plain tree,
given the ZERO_BITS source, must reproduce them: integer outputs exactly,
float outputs at atol 1e-4 / rtol 1e-4 (f32 rounding of the 200-step model
recurrence, and XLA's and PyTorch's exp/log, differ in the last bits).

The fused-form trees run the model in the JAX kernel's sequential order
(`ArmaModel().at_group(1)`): at depth 4 a tree's delta_h cancels logps of
~10^2 to a few 10^-1, and the kernel's group order moves it past 1e-4 on some
lanes (tests/test_torch_arma_group.py holds the group order to the JAX
kernel at depth 2).

Two interpreted kernels are compiled, once each: the fused form (momenta
drawn in the kernel) at N=40 (not a multiple of 128) and max_depth 4, with
seed, phi and inverse mass as runtime values; and the r-given form at
max_depth 0, the one-leapfrog identity. The CUDA kernel is held to the plain
tree in tests/test_torch_cuda.py, on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smcnuts_torch.models import ArmaModel
from smcnuts_torch.ops.draws import PHILOX, ZERO_BITS
from smcnuts_torch.ops.nuts_cuda import (
    STAT_KEYS,
    nuts_tree,
    nuts_tree_plain,
)
from smcnuts_tpu.models import make_arma
from smcnuts_tpu.models.arma import _ASSET
from smcnuts_tpu.ops.nuts_pallas import (
    arma_tile_model,
    nuts_batch_pallas,
    nuts_batch_pallas_fused,
)

torch.set_num_threads(2)

POST_MODE = np.array([0.007, 0.957, -0.034, np.log(0.166)])
N, MAX_DEPTH = 40, 4
INTEGER_STATS = ("depth", "leapfrogs", "moved")
CASES = {
    "phi1": (0, 1.0, [1.0, 1.0, 1.0, 1.0]),
    "phi0.4": (1, 0.4, [1.0, 1.0, 1.0, 1.0]),
    "inv_mass": (2, 1.0, [0.5, 2.0, 1.5, 0.25]),
}


@pytest.fixture(scope="module")
def pallas():
    tm = arma_tile_model(np.load(_ASSET)["y"])
    fused = jax.jit(lambda x, s, e, p, im: nuts_batch_pallas_fused(
        tm, x, s, e, p, im, max_depth=MAX_DEPTH, interpret=True))
    given = jax.jit(lambda x, r, e, p, im: nuts_batch_pallas(
        tm, x, r, 0, e, p, im, max_depth=0, interpret=True))
    return fused, given


def _particles(n, seed):
    """Three quarters near the posterior mode, one quarter dispersed."""
    rng = np.random.default_rng(seed)
    x = POST_MODE + rng.normal(0, 0.02, (n, 4))
    x[: n // 4] = POST_MODE + rng.normal(0, 0.3, (n // 4, 4))
    return x.astype(np.float32)


def _assert_outputs_match(x_t, r_t, st_t, x_j, r_j, st_j):
    np.testing.assert_allclose(x_t, x_j, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(r_t, r_j, rtol=1e-4, atol=1e-4)
    for k in STAT_KEYS:
        if k in INTEGER_STATS:
            np.testing.assert_array_equal(st_t[k], st_j[k], err_msg=k)
        else:
            np.testing.assert_allclose(st_t[k], st_j[k], rtol=1e-4, atol=1e-4,
                                       err_msg=k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_tree_matches_pallas_kernel(pallas, case):
    seed, phi, im = CASES[case]
    fused, _ = pallas
    x = _particles(N, seed)
    x_j, r_j, st_j = fused(jnp.asarray(x), jnp.int32(seed), jnp.float32(0.01),
                           jnp.float32(phi), jnp.asarray(im, jnp.float32))
    x_t, r_t, st_t = nuts_tree_plain(
        ArmaModel().at_group(1), torch.as_tensor(x)[None], seed, 0.01, phi,
        torch.tensor(im), MAX_DEPTH, ZERO_BITS,
    )
    _assert_outputs_match(
        x_t[0].numpy(), r_t[0].numpy(), {k: v[0].numpy() for k, v in st_t.items()},
        np.asarray(x_j), np.asarray(r_j), {k: np.asarray(v) for k, v in st_j.items()},
    )
    # The trees are real: most particles move, some stop before max depth.
    assert st_t["moved"].mean() > 0.5
    assert st_t["depth"].min() >= 1 and st_t["depth"].max() <= MAX_DEPTH + 1


@pytest.mark.parametrize("im", [[1.0, 1.0, 1.0, 1.0], [0.5, 2.0, 1.5, 0.25]])
def test_r_given_depth0_is_one_leapfrog(pallas, im):
    """With max_depth 0 and zero bits the tree is one leapfrog, its leaf
    always taken: hold it to the Pallas kernel and to jax.grad."""
    _, given = pallas
    jm = make_arma()
    rng = np.random.default_rng(4)
    x = rng.normal(0, 0.3, (16, 4)).astype(np.float32)
    r = rng.normal(size=(16, 4)).astype(np.float32)
    phi, eps = 0.7, 0.01
    im_np = np.asarray(im, np.float32)
    x_t, r_t, st_t = nuts_tree_plain(
        ArmaModel(), torch.as_tensor(x)[None], 0, eps, phi, torch.tensor(im),
        0, ZERO_BITS, r=torch.as_tensor(r)[None],
    )
    x_j, r_j, st_j = given(jnp.asarray(x), jnp.asarray(r), jnp.float32(eps),
                           jnp.float32(phi), jnp.asarray(im_np))
    _assert_outputs_match(
        x_t[0].numpy(), r_t[0].numpy(), {k: v[0].numpy() for k, v in st_t.items()},
        np.asarray(x_j), np.asarray(r_j), {k: np.asarray(v) for k, v in st_j.items()},
    )
    vg = jax.vmap(jax.value_and_grad(lambda t: jm.logp(t, phi)))
    _, g0 = vg(jnp.asarray(x))
    r_half = r + 0.5 * eps * np.asarray(g0)
    x_exp = x + eps * im_np * r_half
    _, g1 = vg(jnp.asarray(x_exp))
    r_exp = r_half + 0.5 * eps * np.asarray(g1)
    np.testing.assert_allclose(x_t[0].numpy(), x_exp, atol=1e-6)
    np.testing.assert_allclose(r_t[0].numpy(), r_exp, atol=1e-5)


def test_nuts_tree_runs_plain_version_for_cpu_tensors():
    x = torch.as_tensor(_particles(8, 5))[None]
    launches, calls = nuts_tree.launches, nuts_tree_plain.calls
    out = nuts_tree(ArmaModel(), x, 3, 0.01, 1.0, None, 2, PHILOX)
    ref = nuts_tree_plain(ArmaModel(), x, 3, 0.01, 1.0, None, 2, PHILOX)
    assert nuts_tree.launches == launches
    assert nuts_tree_plain.calls == calls + 2
    torch.testing.assert_close(out[0], ref[0], rtol=0, atol=0)


def test_batched_runs_take_their_own_parameters():
    """B runs flattened on the particle axis: run b uses its own step size,
    phi and inverse mass, as if it ran alone (zero bits, so the draws do not
    depend on the run index)."""
    x = torch.as_tensor(_particles(24, 6)).view(2, 12, 4)
    eps, phi = torch.tensor([0.01, 0.02]), torch.tensor([1.0, 0.5])
    im = torch.tensor([[1.0, 1.0, 1.0, 1.0], [0.5, 2.0, 1.5, 0.25]])
    m = ArmaModel()
    xb, rb, sb = nuts_tree_plain(m, x, 0, eps, phi, im, 3, ZERO_BITS)
    for b in range(2):
        x1, r1, s1 = nuts_tree_plain(m, x[b:b + 1], 0, eps[b], phi[b], im[b],
                                     3, ZERO_BITS)
        torch.testing.assert_close(xb[b], x1[0], rtol=0, atol=0)
        torch.testing.assert_close(rb[b], r1[0], rtol=0, atol=0)
        for k in STAT_KEYS:
            torch.testing.assert_close(sb[k][b], s1[k][0], rtol=0, atol=0)
