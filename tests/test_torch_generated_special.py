"""The special functions of the generated lowering (`ops/generated.py`):
cos, sin, erf, erfc, Phi, log_ndtr, i0e, i1e and lgamma (whose derivative
is digamma) of a parameter, each as the plain graph of a generated model
computes it (the program its CUDA kernel runs), with its derivative, in
reverse and forward mode, against torch.special and JAX over a grid of
float32 inputs.

The references are float64 at the same float32 points: torch's op and its
autograd derivative, and JAX's (jax.scipy.special, jax.grad) with
JAX_ENABLE_X64 in one subprocess (as tests/test_float64.py runs it).
Tolerance: rtol 2e-6 + atol 1e-6 against both, on every point. A float32
reference would not do: autograd's formulas lose the rounding of x^2 in
the tails (log_ndtr's exp(-(log_ndtr(x) + x^2/2)) by ~1e-4 at x = -40),
where the lowering's own derivatives hold.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from smcnuts_torch.ops import generated
from smcnuts_torch.ops.generated import (LIBDEVICE_SWEEP, libdevice_unary, tile_model_from_logp,
                                         tile_model_from_logp_fwd)

torch.set_num_threads(2)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 2e-6, 1e-6

# name -> (torch function, JAX expression, range, grid spacing).
FUNCTIONS = {
    "cos": (torch.cos, "jnp.cos", (-50.0, 50.0), "lin"),
    "sin": (torch.sin, "jnp.sin", (-50.0, 50.0), "lin"),
    "erf": (torch.erf, "jsp.erf", (-10.0, 10.0), "lin"),
    "erfc": (torch.erfc, "jsp.erfc", (-10.0, 10.0), "lin"),
    "ndtr": (torch.special.ndtr, "jsp.ndtr", (-40.0, 10.0), "lin"),
    "log_ndtr": (torch.special.log_ndtr, "jsp.log_ndtr", (-40.0, 10.0), "lin"),
    "i0e": (torch.special.i0e, "jsp.i0e", (0.0, 500.0), "lin"),
    "i1e": (torch.special.i1e, "jsp.i1e", (0.0, 500.0), "lin"),
    # lgamma's derivative is digamma: its range.
    "lgamma": (torch.lgamma, "jax.lax.lgamma", (1e-3, 1e4), "geom"),
}


def grid(name):
    """4,001 float32 points over the range, and the points where a
    composition switches segment (ATen's 8 of i0e / i1e, 10 of digamma's
    recurrence, log_ndtr's -3 and 0) with their float32 neighbours."""
    lo, hi = FUNCTIONS[name][2]
    pts = np.geomspace(lo, hi, 4001) if FUNCTIONS[name][3] == "geom" else np.linspace(lo, hi, 4001)
    edges = {"i0e": [8.0], "i1e": [8.0], "lgamma": [10.0, 9.0, 1.0],
             "log_ndtr": [-3.0, 0.0]}.get(name, [])
    near = [np.nextafter(np.float32(e), np.float32(s)) for e in edges for s in (-np.inf, np.inf)]
    return np.unique(np.concatenate([pts, edges, near]).astype(np.float32))


_JAX_REFERENCE = r"""
import json, sys
import jax
import jax.numpy as jnp
import jax.scipy.special as jsp
import numpy as np

assert jax.config.jax_enable_x64
out = {}
for name, (expr, xs) in json.loads(sys.stdin.read()).items():
    f = eval("lambda x: " + expr + "(x)")
    x = jnp.asarray(np.asarray(xs, np.float32), jnp.float64)
    out[name] = [np.asarray(f(x)).tolist(), np.asarray(jax.vmap(jax.grad(f))(x)).tolist()]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_reference():
    """JAX's float64 value and derivative of each function on its grid."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1", PYTHONPATH=_REPO)
    stdin = json.dumps({n: (FUNCTIONS[n][1], grid(n).tolist()) for n in FUNCTIONS})
    out = subprocess.run([sys.executable, "-c", _JAX_REFERENCE], input=stdin,
                         capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return {k: tuple(np.asarray(v, np.float64) for v in vs)
            for k, vs in json.loads(out.stdout).items()}


def generated_model(name, mode):
    f = FUNCTIONS[name][0]
    if mode == "reverse":
        return tile_model_from_logp(lambda t, p: f(t[0]), 1, name=name)
    return tile_model_from_logp_fwd(lambda c, p: f(c[0]), 1, name=name)


@pytest.mark.parametrize("mode", ["reverse", "forward"])
@pytest.mark.parametrize("name", list(FUNCTIONS))
def test_lowered_function_and_derivative(name, mode, jax_reference):
    x = grid(name)
    tm = generated_model(name, mode)
    value, grad = tm.logp_and_grad(torch.tensor(x)[:, None], 1.0)
    value, grad = value.double().numpy(), grad[:, 0].double().numpy()
    x64 = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    want = FUNCTIONS[name][0](x64)
    (dwant,) = torch.autograd.grad(want.sum(), x64)
    refs = {"torch": (want.detach().numpy(), dwant.numpy()), "jax": jax_reference[name]}
    for who, (v_ref, d_ref) in refs.items():
        np.testing.assert_allclose(value, v_ref, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name} ({mode}) against {who}")
        np.testing.assert_allclose(grad, d_ref, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name}' ({mode}) against {who}")


# What the kernel may call: libdevice's functions, where a plain version
# runs ATen's CUDA op of the same name; cos, sin, erf, erfc and lgamma are
# held to ATen's on every float32 of their range on the card
# (`libdevice_unary`, chip_smoke.py phase `solvers`).
_STRUCTURE = {"SMCNUTS_ENTRY", "__int_as_float", "accepts", "d", "logp_grad", "static_cast"}


def called(source):
    names = set(re.findall(r"\b([A-Za-z_][A-Za-z0-9_]*)\s*\(", source))
    return {n for n in names if not n.startswith("GeneratedModel_")} - _STRUCTURE


@pytest.mark.parametrize("name", list(FUNCTIONS))
def test_emitted_source_calls_no_function_aten_implements_itself(name):
    """i0e, i1e, digamma and log_ndtr are ATen's own code (a kernel built
    with -fmad=false would not round as it does): their programs call
    libdevice alone, and of the special functions only those held to
    ATen's ops on the card."""
    for mode in ("reverse", "forward"):
        calls = called(generated_model(name, mode).source)
        assert calls <= set(generated._CALL.values()) | {"powf"}, calls
        specials = {op for op, fn in generated._CALL.items() if fn in calls} & {
            "cos", "sin", "erf", "erfc", "lgamma"}
        assert specials <= set(LIBDEVICE_SWEEP), specials


def test_libdevice_unary_plain_version_is_torchs_op():
    x = torch.linspace(-3.0, 3.0, 101)
    for op in LIBDEVICE_SWEEP:
        v = x.abs() + 0.5 if op == "lgamma" else x / 3.0 if op in ("asin", "acos") else x
        assert torch.equal(libdevice_unary(op, v), getattr(torch, op)(v))
    assert libdevice_unary.launches == 0
    with pytest.raises(ValueError, match="one of"):
        libdevice_unary("exp", x)
