"""Draw sources of the NUTS proposal: Philox4x32-10, the uniform and normal
maps, the zero-bits source, draws addressed by their place in the tree (one
at a time or batched), and the unfused path's draws from each run's stream."""

import numpy as np
import pytest
import torch

from smcnuts_torch.models import ArmaModel
from smcnuts_torch.ops.draws import (
    DIRECTION,
    LEAF,
    PHILOX,
    PROLOGUE,
    ZERO_BITS,
    TreeDraws,
    accept_draws,
    box_muller,
    momentum_draws,
    philox4x32_10,
    recycle_draws,
    uniform_from_words,
)
from smcnuts_torch.ops.nuts_cuda import nuts_tree_plain

torch.set_num_threads(2)

POST_MODE = np.array([0.007, 0.957, -0.034, np.log(0.166)])


def _philox_reference(ctr, key):
    """Philox4x32-10 in Python integers (Salmon et al., SC'11)."""
    c, k = list(ctr), list(key)
    mask = 0xFFFFFFFF
    for rnd in range(10):
        if rnd:
            k = [(k[0] + 0x9E3779B9) & mask, (k[1] + 0xBB67AE85) & mask]
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & mask, (p0 >> 32) ^ c[3] ^ k[1],
             p0 & mask]
    return c


def test_philox_known_answer():
    """Counter 0 and key 0 (Random123's known-answer vector)."""
    out = [int(w) for w in philox4x32_10(0, 0, 0, 0, 0, 0)]
    assert out == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    assert _philox_reference([0] * 4, [0, 0]) == out


def test_philox_tensor_matches_integer_reference():
    """The int64 tensor version (products split into 16-bit halves) equals
    the integer one on words with every high bit pattern."""
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2**32, size=(64, 6), dtype=np.uint64)
    words[0] = 0xFFFFFFFF
    t = torch.as_tensor(words.astype(np.int64))
    out = torch.stack(philox4x32_10(*t.unbind(1)), dim=1).numpy()
    for row, got in zip(words, out):
        ref = _philox_reference([int(v) for v in row[:4]],
                                [int(v) for v in row[4:]])
        assert [int(v) for v in got] == ref


def test_uniform_map_endpoints():
    w = torch.tensor([0, 0xFF, 0x100, 0xFFFFFFFF], dtype=torch.int64)
    u = uniform_from_words(w)
    assert u.dtype == torch.float32
    assert u.tolist() == [2.0**-24, 2.0**-24, 2.0**-23, 1.0]


def test_zero_bits_every_uniform_is_2_pow_minus_24():
    d = TreeDraws(ZERO_BITS, torch.tensor([5]), torch.zeros(7, dtype=torch.int64),
                  torch.arange(7))
    for kind, j, l in [(PROLOGUE, 0, 0), (LEAF, 3, 5)]:
        assert torch.all(d.uniform(kind, j, l) == 2.0**-24)


def test_box_muller_moments():
    d = TreeDraws(PHILOX, torch.tensor([11]), torch.zeros(40000, dtype=torch.int64),
                  torch.arange(40000))
    z = box_muller(d.uniform(PROLOGUE, 0, 0), d.uniform(PROLOGUE, 0, 1))
    assert abs(float(z.mean())) < 0.02
    assert abs(float(z.var()) - 1.0) < 0.03


def test_draws_addressed_by_particle_not_by_population():
    """A particle's draws depend on (seed, run, particle, place in the tree),
    not on how many particles or runs sit around it."""
    def draws(n, b, run):
        runs = torch.arange(b).repeat_interleave(n)
        parts = torch.arange(n).repeat(b)
        d = TreeDraws(PHILOX, torch.tensor([3, 4, 5][:b]), runs, parts)
        return d.uniform(LEAF, 2, 1).view(b, n)[run]

    small, large = draws(10, 1, 0), draws(50, 1, 0)
    assert torch.equal(small, large[:10])
    assert torch.equal(draws(10, 3, 1), draws(20, 2, 1)[:10])
    assert not torch.equal(draws(10, 2, 0), draws(10, 2, 1))


@pytest.mark.parametrize("source", [PHILOX, ZERO_BITS])
def test_tree_outputs_do_not_depend_on_population(source):
    """The plain tree gives particle i the same result whether it runs with
    8 particles or 20: lockstep masking never leaks between lanes."""
    rng = np.random.default_rng(1)
    x = torch.as_tensor(
        (POST_MODE + rng.normal(0, 0.02, (20, 4))).astype(np.float32)
    )
    m = ArmaModel()
    out8 = nuts_tree_plain(m, x[None, :8].contiguous(), 9, 0.01, 1.0, None, 3, source)
    out20 = nuts_tree_plain(m, x[None], 9, 0.01, 1.0, None, 3, source)
    torch.testing.assert_close(out8[0], out20[0][:, :8], rtol=0, atol=0)
    for k in out8[2]:
        torch.testing.assert_close(out8[2][k], out20[2][k][:, :8], rtol=0, atol=0)


@pytest.mark.parametrize("source", [PHILOX, ZERO_BITS])
def test_batched_tree_draws_equal_one_draw_at_a_time(source):
    """TreeDraws.uniforms, the plain tree's batched draws, row for row equal
    to uniform at each place, over leaves of one doubling and over depths."""
    seed = torch.tensor([7, 123456], dtype=torch.int32)
    lanes = torch.arange(40)
    src = TreeDraws(source, seed, lanes // 20, lanes % 20)
    leaves = src.uniforms(LEAF, 5, range(3, 11))
    assert leaves.shape == (8, 40)
    for i, leaf in enumerate(range(3, 11)):
        assert torch.equal(leaves[i], src.uniform(LEAF, 5, leaf))
    depths = src.uniforms(DIRECTION, range(2, 6), 0)
    for i, depth in enumerate(range(2, 6)):
        assert torch.equal(depths[i], src.uniform(DIRECTION, depth, 0))


def test_unfused_path_draws_come_from_each_runs_own_stream():
    """The momenta's normals and the accept-reject uniforms of run b of a
    batch are those of the run alone; uniforms in [0, 1), normals of unit
    scale, and no two kinds or iterations alike."""
    seeds = torch.tensor([3, 2**40 + 5, 11], dtype=torch.int64)
    eps = momentum_draws(seeds, range(2, 5), 500, 4)
    u = accept_draws(seeds, range(2, 5), 500)
    assert eps.shape == (3, 3, 500, 4) and u.shape == (3, 3, 500)
    assert torch.equal(momentum_draws(seeds[1:2], range(2, 5), 500, 4)[:, 0], eps[:, 1])
    assert torch.equal(accept_draws(seeds[2:], range(3, 4), 500)[0, 0], u[1, 2])
    assert bool(((u >= 0) & (u < 1)).all()) and torch.isfinite(eps).all()
    assert abs(float(eps.std()) - 1.0) < 0.05 and abs(float(eps.mean())) < 0.05
    assert not torch.equal(eps[0, 0, :, 0], eps[1, 0, :, 0])
    assert not torch.equal(u[0], recycle_draws(seeds, range(2, 3), 500)[0])
