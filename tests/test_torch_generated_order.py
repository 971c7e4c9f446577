"""The emission order of generated forward-mode programs (`ops/generated.py`).

`tile_model_from_logp_fwd` emits its program in (primal node, pass) order:
each node a tangent pass creates is keyed by the primal node and the pass it
was created for, and a topological order takes the smallest key first, so
step t of a recurrence is followed by its four tangents and their sum terms.
The built order (`order="built"`), the whole primal before the first pass,
is the same program in another order: the same operations on the same
operands, so the same bits, with far more values live at once.

- Both orders of the generated arma (T = 200) and of small random forward
  programs are topological: every `v<i>` of the CUDA body is defined before
  a line reads it.
- The generated arma holds at most 32 values live at once in the primal
  order (`peak_live`), 214 in the built order, and keeps its 3,837
  operations.
- Its `logp_and_grad` (the fx graph, the kernel's plain version) equals the
  built order's to the bit on 64 points, at phi 1.0 and 0.4.
- Reverse-mode programs keep the built order: the eight-schools source at
  group=1 (not split over lanes) is byte for byte the one of the previous
  emission (its hash), and the built order of the arma is too.
"""

import re

import numpy as np
import pytest
import torch

from smcnuts_torch.models.arma import arma_model_fwd
from smcnuts_torch.models.eightschools import make_eightschools_generated
from smcnuts_torch.ops.generated import count_ops, peak_live, tile_model_from_logp_fwd

torch.set_num_threads(2)

# Source hashes of the programs as emitted before the (primal node, pass)
# order: the reverse-mode eight schools, which keeps its order, and the
# forward-mode arma in the built order, the measurement witness.
SCHOOLS_HASH = "75a6c41d66c26658"
ARMA_BUILT_HASH = "e254d05f13f36d39"


@pytest.fixture(scope="module")
def arma():
    # Straight-line: the emission order of every op (the default re-rolls
    # the recurrence as a loop, tests/test_torch_generated_loop.py).
    return {order: arma_model_fwd(order=order, reroll=False).tile_model
            for order in ("primal", "built")}


def _random_density(seed, dim=3, n_ops=40):
    """A forward density of `dim` scalars: a random straight-line program of
    adds, multiplies, subtractions and smooth unary maps over the
    coordinates and the values before, with a recurrence through the last
    value, then a sum of squares scaled by phi."""
    rng = np.random.default_rng(seed)
    plan = [(int(rng.integers(6)), int(rng.integers(1 << 30)), int(rng.integers(1 << 30)),
             float(rng.uniform(-0.5, 0.5))) for _ in range(n_ops)]

    def logp_seq(coords, phi):
        vals = list(coords)
        for kind, i, j, c in plan:
            a, b = vals[i % len(vals)], vals[-1]
            v = (a + b * c, a * b * c, a - c * b, torch.tanh(a + c),
                 torch.log1p(a * a), torch.exp(c * torch.tanh(b)))[kind]
            vals.append(v if kind != 1 else v + vals[j % len(vals)])
        s = vals[0] * 0.0
        for v in vals[dim:]:
            s = s + v * v
        return -0.5 * sum(c * c for c in coords) - phi * 0.01 * s

    return logp_seq


def _assert_topological(tm):
    body = [line for line in tm.source.splitlines() if line.startswith("    const ")]
    assert len(body) == len(tm.program.ops)
    for i, line in enumerate(body):
        name, rhs = re.match(r"    const \w+ v(\d+) = (.*);$", line).groups()
        assert int(name) == i
        assert all(int(u) < i for u in re.findall(r"\bv(\d+)\b", rhs)), line
    outs = [line for line in tm.source.splitlines()
            if line.startswith("    grad[") or line.startswith("    return ")]
    assert all(int(u) < len(body) for line in outs for u in re.findall(r"\bv(\d+)\b", line))


@pytest.mark.parametrize("order", ["primal", "built"])
def test_the_arma_emission_is_topological(arma, order):
    _assert_topological(arma[order])


def test_the_arma_primal_order_holds_few_values_live(arma):
    assert peak_live(arma["primal"].program) <= 32
    assert peak_live(arma["built"].program) == 214
    assert count_ops(arma["primal"].program) == count_ops(arma["built"].program) == 3837
    assert arma["primal"].n_ops == 3837


def test_the_orders_are_one_program(arma):
    """The same operations on the same operands: as multisets, once each
    node is named by its operation tree (hash-consed, shared by both)."""
    names = {}

    def trees(prog):
        mine = []
        for op, *args in prog.ops:
            if op not in ("x", "phi", "data"):
                args = [("node", mine[a]) if type(a) is int else a for a in args]
            mine.append(names.setdefault((op, *args), len(names)))
        return sorted(mine)

    p, b = arma["primal"].program, arma["built"].program
    assert p.data == b.data and trees(p) == trees(b)


@pytest.mark.parametrize("phi", [1.0, 0.4])
def test_the_orders_agree_to_the_bit(arma, phi):
    rng = np.random.default_rng(0)
    x = torch.as_tensor((np.array([0.007, 0.957, -0.034, -1.8])
                         + 0.05 * rng.normal(size=(64, 4))).astype(np.float32))
    lp_p, g_p = arma["primal"].logp_and_grad(x, phi)
    lp_b, g_b = arma["built"].logp_and_grad(x, phi)
    assert torch.equal(lp_p, lp_b) and torch.equal(g_p, g_b)
    assert torch.isfinite(lp_p).all() and torch.isfinite(g_p).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_forward_programs(seed):
    """Both orders topological, one program to the bit, and the gradient
    that of autograd (float32, rtol 1e-4: the program rounds otherwise)."""
    fn = _random_density(seed)
    tms = {order: tile_model_from_logp_fwd(fn, 3, name=f"random{seed}", order=order)
           for order in ("primal", "built")}
    for tm in tms.values():
        _assert_topological(tm)
    x = torch.as_tensor(np.random.default_rng(seed).normal(0, 0.5, (16, 3)).astype(np.float32))
    lp_p, g_p = tms["primal"].logp_and_grad(x, 0.7)
    lp_b, g_b = tms["built"].logp_and_grad(x, 0.7)
    assert torch.equal(lp_p, lp_b) and torch.equal(g_p, g_b)
    xd = x.double().requires_grad_()
    ref = torch.stack([fn(tuple(row), 0.7) for row in xd])
    (g_ref,) = torch.autograd.grad(ref.sum(), xd)
    torch.testing.assert_close(lp_p.double(), ref.detach(), rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(g_p.double(), g_ref, rtol=1e-4, atol=1e-4)


def test_reverse_mode_keeps_the_built_order(arma):
    # group=1: the reverse-mode program not split over lanes (the default).
    assert make_eightschools_generated(group=1).tile_model.hash == SCHOOLS_HASH
    assert arma["built"].hash == ARMA_BUILT_HASH
    assert arma["primal"].hash != ARMA_BUILT_HASH


def test_an_unknown_order_raises():
    with pytest.raises(ValueError, match="order"):
        tile_model_from_logp_fwd(_random_density(0), 3, order="depth")
