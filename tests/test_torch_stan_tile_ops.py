"""The elementwise ops of the generated lowering that a Stan program reaches
under tile=True: tan, atan, asin, acos, sinh, cosh and atan2, fmin / fmax
(torch.minimum / maximum), log_mix (logaddexp), log_sum_exp, inv_Phi
(ndtri), digamma (whose derivative is trigamma) and weibull_lpdf with a
parameter shape (pow with an exponent that is not constant).

- Each one-line program's generated model, in reverse mode (K7r) and in
  forward mode (K7f), its plain version (`GeneratedModel.logp_and_grad`, the
  program its CUDA kernel runs, op by op in torch) against the JAX
  frontend's `tile_fn` on (8, 128) tiles, at tests/test_stan_frontend.py:
  411's tolerance on logp (rtol 1e-4, atol 1e-4) and 1e-5 of the largest
  gradient component on the gradient.
- trigamma and ndtri built from the program's ops (ATen's float code,
  mirrored) against torch.special on float64 at a sweep of float32 points,
  at rtol 2e-6 + atol 1e-6 (tests/test_torch_generated_special.py's
  tolerance; trigamma below 0 at rtol 5e-5, where torch's own float32 op is
  3.4e-5 off); ndtri's derivative against autograd's formula likewise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smcnuts_torch import stan as tstan
from smcnuts_torch.ops.generated import (function_graph, lower_function, tile_model_from_logp,
                                         tile_model_from_logp_fwd)
from smcnuts_tpu import stan as jstan

torch.set_num_threads(2)

LOGP_TOL = (1e-4, 1e-4)  # tests/test_stan_frontend.py:411
GRAD_ATOL = 1e-5  # of the largest gradient component
SPECIAL_RTOL, SPECIAL_ATOL = 2e-6, 1e-6


def against_tile_fn(src, data, mode, x, phi=0.7, logp_tol=LOGP_TOL, grad_atol=GRAD_ATOL,
                    name="prog"):
    """The port's generated model of (src, data) in `mode` against the JAX
    frontend's tile_fn at the points x (1024, D): logp at logp_tol, the
    gradient at grad_atol of its largest component. Returns the port's
    model."""
    tm = tstan.compile_stan_program(src, data, name=name, tile=True, tile_autodiff=mode)
    jm = jstan.compile_stan_program(src, data, name=name, tile=True)
    assert tm.tile_model.autodiff == mode and tm.dim == jm.dim == x.shape[1]
    tiles = [jnp.asarray(x[:, d].reshape(8, 128), jnp.float32) for d in range(jm.dim)]
    logp_j, grads_j = jax.jit(lambda ts, p: jm.tile_model.tile_fn((), ts, p))(
        tiles, jnp.full((8, 128), phi, jnp.float32))
    logp_j = np.asarray(logp_j).reshape(-1)
    g_j = np.stack([np.asarray(g).reshape(-1) for g in grads_j], axis=1)
    lp_t, g_t = tm.tile_model.logp_and_grad(torch.tensor(x, dtype=torch.float32), phi)
    assert np.isfinite(logp_j).all() and np.isfinite(g_j).all()
    np.testing.assert_allclose(lp_t.numpy(), logp_j, rtol=logp_tol[0], atol=logp_tol[1])
    scale = np.abs(g_j).max() + 1e-6
    np.testing.assert_allclose(g_t.numpy() / scale, g_j / scale, atol=grad_atol)
    return tm


def one_line(expr):
    return f"parameters {{ real x; }} model {{ x ~ normal(0, 1); target += {expr}; }}"


# name -> the term a one-parameter program adds to a standard normal prior.
OPS = {
    "tan": "tan(x)",
    "atan": "atan(x)",
    "asin": "asin(tanh(x))",
    "acos": "acos(tanh(x))",
    "sinh": "sinh(x)",
    "cosh": "-cosh(x)",
    "atan2": "atan2(x, 2.0) + atan2(2.0, x) + atan2(-x, -1.5) + atan2(x - 0.2, x)",
    "fmin": "fmin(x, 0.3) + fmin(0.1, 2 * x)",
    "fmax": "fmax(x, 0.3) + fmax(0.1, 2 * x)",
    "log_mix": "log_mix(0.3, normal_lpdf(x | -1, 1), normal_lpdf(x | 1, 1))",
    "log_sum_exp": "log_sum_exp(x, 2 * x) + log_sum_exp([x, -x, 0.5 * x]')",
    "inv_Phi": "inv_Phi(inv_logit(3 * x))",
    "digamma": "digamma(exp(x))",
    "weibull": "weibull_lpdf(1.5 | exp(x), 2.0) + weibull_lpdf(0.7 | 2.0, exp(x))",
}


# inv_Phi's gradient: its upper tail reads 1 - y, whose float32 rounding the
# derivative sqrt(2 pi) exp(ndtri^2 / 2) amplifies (to ~6e-5 relative at y
# = 0.999), and JAX's ndtri is another float32 algorithm than ATen's.
GRAD_ATOL_OF = {"inv_Phi": 1e-4}


@pytest.mark.parametrize("mode", ["reverse", "forward"])
@pytest.mark.parametrize("op", list(OPS))
def test_elementwise_op_matches_jax_tile_fn(op, mode):
    x = np.random.default_rng(3).normal(0, 0.8, (1024, 1))
    tm = against_tile_fn(one_line(OPS[op]), {}, mode, x, name=op,
                         grad_atol=GRAD_ATOL_OF.get(op, GRAD_ATOL))
    assert tm.tile_model.n_ops > 0


def _sweep(lo, hi, n=20001, geom=False):
    pts = np.geomspace(lo, hi, n) if geom else np.linspace(lo, hi, n)
    return pts.astype(np.float32)


def _lowered(fn):
    """fn of one float32 scalar through the lowering (`lower_function`) and
    its plain graph, on a vector of points."""
    f = lower_function(fn, [torch.zeros((), dtype=torch.float32)])
    g = function_graph(f)
    return lambda x: g(x[:, None])[:, 0]


@pytest.mark.parametrize("region", ["positive", "below_half", "negative"])
def test_trigamma_matches_torch_special(region):
    lo, hi, geom = {"positive": (1e-3, 1e4, True), "below_half": (-0.499, 0.499, False),
                    "negative": (-9.97, -0.03, False)}[region]
    x = _sweep(lo, hi, geom=geom)
    if region == "negative":  # away from the poles at the negative integers
        x = x[np.abs(x - np.round(x)) > 0.03]
    x = x[x != 0.0]
    got = _lowered(lambda t: torch.special.polygamma(1, t))(torch.tensor(x))
    want = torch.special.polygamma(1, torch.tensor(x, dtype=torch.float64))
    # Below 0 the reflection's sin(pi x) rounds pi x in float32: torch's own
    # float32 trigamma is 3.4e-5 off there too.
    rtol = SPECIAL_RTOL if region != "negative" else 5e-5
    torch.testing.assert_close(got.double(), want, rtol=rtol, atol=SPECIAL_ATOL)


@pytest.mark.parametrize("region", ["central", "lower_tail", "upper_tail", "far_tail"])
def test_ndtri_matches_torch_special(region):
    lo, hi, geom = {"central": (0.14, 0.86, False), "lower_tail": (1e-13, 0.14, True),
                    "upper_tail": (0.86, 1.0 - 6e-8, False),
                    "far_tail": (1e-37, 1e-13, True)}[region]
    x = _sweep(lo, hi, geom=geom)
    got = _lowered(torch.special.ndtri)(torch.tensor(x))
    want = torch.special.ndtri(torch.tensor(x, dtype=torch.float64))
    torch.testing.assert_close(got.double(), want, rtol=SPECIAL_RTOL, atol=SPECIAL_ATOL)


def test_ndtri_edges_and_derivative():
    """ndtri at 0, 1 and outside [0, 1] as ATen gives it (-inf, inf, NaN);
    its derivative sqrt(2 pi) exp(ndtri^2 / 2) in both modes against
    autograd's on float64."""
    edge = torch.tensor([0.0, 1.0, -0.5, 1.5, float("nan")])
    got = _lowered(torch.special.ndtri)(edge)
    torch.testing.assert_close(got, torch.special.ndtri(edge), equal_nan=True)
    x = torch.tensor(_sweep(1e-6, 1 - 1e-6, n=2001))[:, None]
    y = x.double().requires_grad_()
    want = torch.autograd.grad(torch.special.ndtri(y).sum(), y)[0]
    for tm in (tile_model_from_logp(lambda t, p: torch.special.ndtri(t[0]), 1),
               tile_model_from_logp_fwd(lambda c, p: torch.special.ndtri(c[0]), 1)):
        _, g = tm.logp_and_grad(x, 1.0)
        torch.testing.assert_close(g.double(), want, rtol=SPECIAL_RTOL, atol=SPECIAL_ATOL)


def test_unary_ops_are_libdevice_calls_in_the_kernel():
    """tan, atan, asin, acos, sinh and cosh are emitted as their libdevice
    calls, atan2 as atan and selects (its reverse-mode backward as ATen's
    masked formula), each a single op of the program."""
    tm = tile_model_from_logp(
        lambda t, p: (torch.tan(t[0]) + torch.atan(t[0]) + torch.asin(torch.tanh(t[0]))
                      + torch.acos(torch.tanh(t[0])) + torch.sinh(t[0]) + torch.cosh(t[0])
                      + torch.atan2(t[0], torch.exp(t[0]))), 1)
    for call in ("tanf(", "atanf(", "asinf(", "acosf(", "sinhf(", "coshf("):
        assert call in tm.source, call
    assert "atan2" not in tm.source
