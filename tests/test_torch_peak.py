"""The FP32 peak kernel's (K8) plain version and its FLOP count.

The plain chain equals a numpy float32 chain (a multiply and an add a step,
each rounded to float32) to the bit; its coefficients and starting offsets
are those of `experiments/bench_vpu_peak.py::make_kernel` (read from its
source); it agrees with that Pallas kernel, run in interpret mode, within
one rounding a step; and the count of FLOPs is the JAX script's
(`bench_vpu_peak.py:92`, read from its source). The kernel itself runs on
the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import ast
import functools
import importlib.util
import os
import types

import numpy as np
import pytest
import torch

from smcnuts_torch.ops.peak import CHAINS, STEPS, coefficients, flops, fma_chains

torch.set_num_threads(2)

_SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "experiments", "bench_vpu_peak.py")


def _numpy_chains(x, nchains, steps):
    a, b = coefficients(nchains)
    chains = [np.float32(x) + np.float32(c * 0.125) for c in range(nchains)]
    for _ in range(steps):
        chains = [np.float32(a[c]) * ch + np.float32(b[c]) for c, ch in enumerate(chains)]
    acc = chains[0]
    for ch in chains[1:]:
        acc = acc + ch
    return acc


@pytest.mark.parametrize("nchains", CHAINS)
def test_plain_chain_equals_numpy_float32(nchains):
    x = np.random.default_rng(nchains).normal(size=64).astype(np.float32)
    got = fma_chains(torch.as_tensor(x), nchains, 8)
    want = _numpy_chains(x, nchains, 8)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def _script_flops_expr():
    """The expression `flops = ...` of bench_vpu_peak.measure, and the
    script's NBLK and STEPS."""
    tree = ast.parse(open(_SCRIPT).read())
    consts = {n.targets[0].id: ast.literal_eval(n.value) for n in tree.body
              if isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Name)
              and n.targets[0].id in ("NBLK", "STEPS")}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "flops"):
            return compile(ast.Expression(node.value), _SCRIPT, "eval"), consts
    raise AssertionError("no flops expression in the script")


@pytest.mark.parametrize("nchains", CHAINS)
def test_flop_count_is_the_jax_scripts(nchains):
    expr, consts = _script_flops_expr()
    assert consts["STEPS"] == STEPS
    want = eval(expr, {"nchains": nchains, **consts})
    assert flops(consts["NBLK"] * 8 * 128, nchains, consts["STEPS"]) == want


def _kernel_assigns():
    """The list comprehensions `name = [...]` of make_kernel's inner
    kernel, by name, as code to evaluate."""
    tree = ast.parse(open(_SCRIPT).read())
    make = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "make_kernel")
    kernel = next(n for n in make.body
                  if isinstance(n, ast.FunctionDef) and n.name == "kernel")
    return {n.targets[0].id: compile(ast.Expression(n.value), _SCRIPT, "eval")
            for n in kernel.body
            if isinstance(n, ast.Assign) and isinstance(n.value, ast.ListComp)}


def test_coefficients_are_the_jax_kernels():
    exprs = _kernel_assigns()
    a, b = coefficients(32)
    assert a == [float(np.float32(v)) for v in eval(exprs["a"], {"nchains": 32})]
    assert b == [float(np.float32(v)) for v in eval(exprs["b"], {"nchains": 32})]
    # The chains start at x + offset_c: with no step, the plain chain of x = 0
    # is the sum of the script's offsets.
    for nchains in CHAINS:
        offsets = eval(exprs["chains"], {"nchains": nchains, "x": np.float32(0.0)})
        want = np.float32(0.0)
        for v in offsets:
            want = np.float32(want + np.float32(v))
        assert float(fma_chains(torch.zeros(1), nchains, 0)[0]) == float(want)


def _jax_peak_module():
    """experiments/bench_vpu_peak.py, imported with its pallas_call in
    interpret mode (the script itself is unchanged)."""
    from jax.experimental import pallas as pl

    spec = importlib.util.spec_from_file_location("bench_vpu_peak", _SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.pl = types.SimpleNamespace(
        BlockSpec=pl.BlockSpec,
        pallas_call=functools.partial(pl.pallas_call, interpret=True))
    return module


@pytest.mark.parametrize("nchains", CHAINS)
def test_plain_chain_against_the_jax_kernel(nchains):
    """make_kernel(nchains, 8) in interpret mode on the script's whole grid
    against the plain chain on the same lanes: within one rounding a step
    of each chain (XLA on the CPU fuses the multiply and the add, as the
    FMA variant does; the plain chain rounds both), the bound chip_smoke.py
    holds the FMA variant to."""
    steps = 8
    bench = _jax_peak_module()
    x = np.random.default_rng(nchains).normal(size=(bench.NBLK, 8, 128)).astype(np.float32)
    want = np.asarray(bench.make_kernel(nchains, steps)(x)).reshape(-1)
    got = fma_chains(torch.as_tensor(x.reshape(-1)), nchains, steps).numpy()
    tol = nchains * steps * 2.0 ** -23 * (float(np.abs(x).max()) + 0.125 * nchains + 1.0)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= tol


def test_wrapper_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="nchains"):
        fma_chains(torch.zeros(4), 5, 8)
    with pytest.raises(ValueError, match="variant"):
        fma_chains(torch.zeros(4), 4, 8, variant="fma2")
