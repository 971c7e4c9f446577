"""The eager path's regularised incomplete gamma functions of a parameter
shape: `stan/math.py`'s `_RegularizedGamma` (torch's values of gammainc /
gammaincc, the derivative in x in closed form, in a by
`smcnuts::igamma_grad_a`, XLA's `IgammaGradA` written in torch).

- Value and gradient of gamma_lcdf, gamma_lccdf, inv_gamma_lcdf,
  inv_gamma_lccdf, chi_square_lcdf and chi_square_lccdf of a parameter
  shape (and of a parameter scale where the density has one) against the
  JAX package: in float32 at rtol 1e-5 + atol 1e-5 on the value and 1e-5 of
  the largest component on the gradient (two float32 implementations of
  the same series), in float64 (JAX_ENABLE_X64 in a subprocess, as
  tests/test_torch_stan_solvers.py runs it) at rtol 1e-10 + atol 1e-12
  (the same algorithm, to the same convergence).
- `igamma_grad_a` itself against a central difference of
  torch.special.gammainc in float64 across both regions (the series and
  the continued fraction), 0 at x = 0 and NaN outside the domain; under
  vmap and make_fx it is one op.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smcnuts_torch import stan as tstan
from smcnuts_torch.ops.generated import trace_fx
from smcnuts_torch.stan.math import igamma_grad_a
from smcnuts_tpu import stan as jstan

torch.set_num_threads(2)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name -> the term a two-parameter program adds (a shape exp(x[1]), a scale
# exp(x[2]) where the density has one).
TERMS = {
    "gamma_lcdf": "gamma_lcdf(1.3 | exp(x[1]), exp(x[2]))",
    "gamma_lccdf": "gamma_lccdf(1.3 | exp(x[1]), exp(x[2]))",
    "inv_gamma_lcdf": "inv_gamma_lcdf(0.8 | exp(x[1]), exp(x[2]))",
    "inv_gamma_lccdf": "inv_gamma_lccdf(0.8 | exp(x[1]), exp(x[2]))",
    "chi_square_lcdf": "chi_square_lcdf(2.5 | exp(x[1])) + 0 * x[2]",
    "chi_square_lccdf": "chi_square_lccdf(2.5 | exp(x[1])) + 0 * x[2]",
}


def _source(name):
    return f"parameters {{ vector[2] x; }} model {{ target += {TERMS[name]}; }}"


def _points():
    """Shapes from 0.14 to 7 and scales from 0.2 to 5: both regions of the
    derivative (x below and above max(1, a))."""
    g = np.linspace(-2.0, 2.0, 7)
    return np.stack(np.meshgrid(g, np.linspace(-1.6, 1.6, 5)), -1).reshape(-1, 2)


@pytest.mark.parametrize("name", list(TERMS))
def test_float32_matches_jax(name):
    x = _points().astype(np.float32)
    tm = tstan.compile_stan_program(_source(name), {}, name=name)
    jm = jstan.compile_stan_program(_source(name), {}, name=name)
    lp, g = tm.logp_and_grad(torch.tensor(x))
    lj, gj = jax.vmap(jax.value_and_grad(lambda t: jm.logp(t, 1.0)))(jnp.asarray(x))
    lj, gj = np.asarray(lj), np.asarray(gj)
    assert np.isfinite(lj).all() and np.isfinite(gj).all()
    np.testing.assert_allclose(lp.numpy(), lj, rtol=1e-5, atol=1e-5)
    scale = np.abs(gj).max()
    np.testing.assert_allclose(g.numpy() / scale, gj / scale, atol=1e-5)


_X64 = r"""
import json, sys
import jax
import jax.numpy as jnp
import numpy as np
from smcnuts_tpu.stan import compile_stan_program

assert jax.config.jax_enable_x64
sources, x = json.loads(sys.stdin.read())
out = {}
for name, src in sources.items():
    m = compile_stan_program(src, {}, name=name)
    lp, g = jax.jit(jax.vmap(jax.value_and_grad(lambda t: m.logp(t, 1.0))))(jnp.asarray(x))
    out[name] = [np.asarray(lp).tolist(), np.asarray(g).tolist()]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_x64():
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1", PYTHONPATH=_REPO)
    stdin = json.dumps([{n: _source(n) for n in TERMS}, _points().tolist()])
    out = subprocess.run([sys.executable, "-c", _X64], input=stdin, capture_output=True,
                         text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return {k: (np.asarray(v[0]), np.asarray(v[1])) for k, v in json.loads(out.stdout).items()}


@pytest.mark.parametrize("name", list(TERMS))
def test_float64_matches_jax_x64(jax_x64, name):
    tm = tstan.compile_stan_program(_source(name), {}, name=name)
    lp, g = tm.logp_and_grad(torch.tensor(_points(), dtype=torch.float64))
    lj, gj = jax_x64[name]
    np.testing.assert_allclose(lp.numpy(), lj, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(g.numpy(), gj, rtol=1e-10, atol=1e-12)


def test_igamma_grad_a_against_a_central_difference():
    a = torch.tensor([0.3, 0.3, 1.5, 1.5, 4.0, 4.0, 12.0, 12.0], dtype=torch.float64)
    x = torch.tensor([0.2, 3.0, 0.7, 5.0, 2.0, 9.0, 10.0, 20.0], dtype=torch.float64)
    h = 1e-6
    fd = (torch.special.gammainc(a + h, x) - torch.special.gammainc(a - h, x)) / (2 * h)
    torch.testing.assert_close(igamma_grad_a(a, x), fd, rtol=1e-6, atol=1e-9)
    edge = igamma_grad_a(torch.tensor([2.0, -1.0, 2.0], dtype=torch.float64),
                         torch.tensor([0.0, 1.0, -1.0], dtype=torch.float64))
    assert edge[0] == 0 and edge[1:].isnan().all()


def test_igamma_grad_a_is_one_op_under_vmap_and_make_fx():
    """Under torch.func.vmap the op's rule runs the batch in one call (its
    inputs broadcast); make_fx of a vmapped gradient records one node."""
    a = torch.tensor([[0.5, 2.0], [3.0, 7.0]])
    x = torch.tensor([1.0, 4.0])
    got = torch.func.vmap(igamma_grad_a, in_dims=(0, None))(a, x)
    torch.testing.assert_close(got, igamma_grad_a(a, x[None].expand(2, 2)))

    from smcnuts_torch.stan.math import _gammainc

    def g(t):
        return torch.func.vmap(torch.func.grad(lambda s: _gammainc(torch.exp(s), 1.5)))(t)

    gm = trace_fx(g, torch.tensor([0.1, 0.9]))
    nodes = [n for n in gm.graph.nodes if "igamma_grad_a" in str(n.target)]
    assert len(nodes) == 1
    torch.testing.assert_close(gm(torch.tensor([0.3, -0.2])), g(torch.tensor([0.3, -0.2])))
