"""The fused ARMA value and gradient (K5's plain version) against the JAX package.

`arma_ll_vg_plain` against the JAX package's `arma_ll_vg_scan` and its Pallas
kernel `arma_ll_vg_pallas` in interpret mode, on the same float32 inputs made
from a numpy seed; against torch autograd of `ArmaModel.loglik` in float64;
and `make_arma(fused=...)` against the model without it. The CUDA kernel
itself runs only on the card (`tests/test_torch_cuda.py`, `chip_smoke.py`
phase 10a).

Tolerance against JAX, per lane: |port - JAX| <= 1e-5 |JAX| + 1e-4 |loglik|
(float32; the two libraries round the 199-step recurrence alike, but exp and
the last additions of `_assemble` may differ in the last bit, and a gradient
is a difference of sums of the loglik's scale). Against autograd in float64:
rtol 1e-10. `fused="plain"` and the model without `fused` run the same
recurrence and are held to the bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smcnuts_torch.models import ArmaModel, make_arma
from smcnuts_torch.ops import arma_fused
from smcnuts_torch.ops.arma_fused import (
    arma_ll_vg,
    arma_ll_vg_plain,
    make_arma_loglik_vg,
)
from smcnuts_tpu.models.arma import _ASSET
from smcnuts_tpu.ops.arma_fused import arma_ll_vg_pallas, arma_ll_vg_scan

torch.set_num_threads(2)

POST_MODE = np.array([0.007, 0.957, -0.034, np.log(0.166)])


def _y():
    return np.asarray(np.load(_ASSET)["y"], np.float64)


def _theta(n, seed):
    """Three quarters near the posterior mode, one quarter dispersed."""
    rng = np.random.default_rng(seed)
    theta = POST_MODE + rng.normal(0, 0.05, (n, 4))
    theta[: n // 4] = rng.normal(0, 0.3, (n // 4, 4))
    return theta.astype(np.float32)


def _assert_close_to_jax(ll, g, ll_j, g_j):
    ll_j, g_j = np.asarray(ll_j), np.asarray(g_j)
    scale = 1e-4 * np.abs(ll_j)
    np.testing.assert_array_less(np.abs(ll.numpy() - ll_j), 1e-5 * np.abs(ll_j) + scale + 1e-30)
    np.testing.assert_array_less(np.abs(g.numpy() - g_j),
                                 1e-5 * np.abs(g_j) + scale[:, None] + 1e-30)


@pytest.mark.parametrize("n", [1, 11, 1025])
def test_plain_matches_jax_scan_and_interpreted_kernel(n):
    y, theta = _y(), _theta(n, n)
    ll, g = arma_ll_vg_plain(torch.as_tensor(theta), torch.as_tensor(y))
    assert ll.shape == (n,) and g.shape == (n, 4) and ll.dtype == torch.float32
    y32 = jnp.asarray(y, jnp.float32)
    _assert_close_to_jax(ll, g, *arma_ll_vg_scan(jnp.asarray(theta), y32))
    _assert_close_to_jax(ll, g, *arma_ll_vg_pallas(jnp.asarray(theta), y32,
                                                   interpret=True))


def test_extreme_log_sigma_gives_the_same_non_finite_lanes_as_jax():
    """log_sigma of +-20 and +-60: inv_s2 of e^-40, e^40, 0 and inf."""
    y, theta = _y(), _theta(8, 3)
    theta[:4, 3] = [20.0, -20.0, 60.0, -60.0]
    ll, g = arma_ll_vg_plain(torch.as_tensor(theta), torch.as_tensor(y))
    ll_j, g_j = (np.asarray(v) for v in arma_ll_vg_scan(
        jnp.asarray(theta), jnp.asarray(y, jnp.float32)))
    for a, b in ((ll.numpy(), ll_j), (g.numpy(), g_j)):
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
        np.testing.assert_array_equal(a[~np.isfinite(a)], b[~np.isfinite(b)])
    assert not np.isfinite(ll.numpy()[3])  # inv_s2 = inf
    fin = np.isfinite(ll_j)
    np.testing.assert_allclose(ll.numpy()[fin], ll_j[fin], rtol=1e-5)


def test_plain_matches_autograd_in_float64():
    model = ArmaModel().double()
    x = torch.as_tensor(_theta(33, 5), dtype=torch.float64).requires_grad_(True)
    ll_ref = model.loglik(x)
    (g_ref,) = torch.autograd.grad(ll_ref.sum(), x)
    ll, g = arma_ll_vg_plain(x.detach(), model.y)
    torch.testing.assert_close(ll, ll_ref.detach(), rtol=1e-10, atol=0)
    torch.testing.assert_close(g, g_ref, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("phi", [1.0, 0.3])
def test_fused_plain_model_equals_the_model_without_it(phi):
    x = torch.as_tensor(_theta(64, 7))
    calls = arma_ll_vg_plain.calls
    lp, g = make_arma(fused="plain").logp_and_grad(x, phi)
    assert arma_ll_vg_plain.calls == calls + 1
    lp_ref, g_ref = ArmaModel().logp_and_grad(x, phi)
    assert arma_ll_vg_plain.calls == calls + 1  # the model without fused: inline
    assert torch.equal(lp, lp_ref) and torch.equal(g, g_ref)


def test_cuda_on_a_cpu_tensor_raises():
    x = torch.as_tensor(_theta(4, 1))
    with pytest.raises(ValueError, match="CUDA tensor"):
        make_arma(fused="cuda").logp_and_grad(x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        make_arma_loglik_vg(torch.as_tensor(_y(), dtype=torch.float32), "cuda")(x)
    with pytest.raises(ValueError, match="fused"):
        make_arma(fused="pallas")


def test_wrapper_takes_the_plain_version_for_a_cpu_tensor_only():
    x, y = torch.as_tensor(_theta(16, 2)), torch.as_tensor(_y())
    launches, calls = arma_ll_vg.launches, arma_ll_vg_plain.calls
    ll, g = arma_ll_vg(x, y)
    assert arma_ll_vg.launches == launches and arma_ll_vg_plain.calls == calls + 1
    ll_p, g_p = arma_fused.arma_loglik_grad(x, y.to(torch.float32))
    assert torch.equal(ll, ll_p) and torch.equal(g, g_p)
    with pytest.raises(ValueError, match="cpu or cuda"):
        arma_ll_vg(x.to("meta"), y)
