"""The port stands alone: `smcnuts_torch` imports neither jax nor smcnuts_tpu."""

import ast
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(2)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG = os.path.join(_REPO, "smcnuts_torch")

_MODULES = (
    "smcnuts_torch", "smcnuts_torch.sampler", "smcnuts_torch.interop",
    "smcnuts_torch.__main__", "smcnuts_torch.ops.nuts_cuda",
    "smcnuts_torch.ops.draws", "smcnuts_torch.ops.adaptation",
    "smcnuts_torch.ops.reduce", "smcnuts_torch.models.prmwcd",
    "smcnuts_torch.utils.timing", "smcnuts_torch.ops.lkernels",
    "smcnuts_torch.ops.tempering", "smcnuts_torch.ops.resampling",
    "smcnuts_torch.models.gaussian", "smcnuts_torch.models.eightschools",
    "smcnuts_torch.models.logistic", "smcnuts_torch.ops.arma_fused",
    "smcnuts_torch.ops.nuts", "smcnuts_torch.proposals", "smcnuts_torch.config",
    "smcnuts_torch.ops.generated", "smcnuts_torch.ops.peak", "smcnuts_torch.models.base",
    "smcnuts_torch.models.arma", "smcnuts_torch.runner", "smcnuts_torch.utils.checkpoint",
    "smcnuts_torch.utils.io", "smcnuts_torch.utils.profiling",
    "smcnuts_torch.stan", "smcnuts_torch.stan.parser", "smcnuts_torch.stan.math",
    "smcnuts_torch.stan.compiler",
)


def test_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['smcnuts_tpu'] = None\n"
        "import importlib\n"
        f"for m in {_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "from smcnuts_torch.models import get_model, make_gaussian\n"
        "get_model('arma'); get_model('prmwcd')\n"
        "get_model('eightschools'); get_model('logistic')\n"
        "make_gaussian([0.0, 1.0], [1.0, 2.0], [4.0, 4.0])\n"
        "import torch\n"
        "from smcnuts_torch.models import make_arma\n"
        "from smcnuts_torch import FullNormalProposal, SMCConfig\n"
        "make_arma(fused='plain').logp_and_grad(torch.zeros(2, 4))\n"
        "FullNormalProposal((0.0, 0.0), ((1.0, 0.0), (0.0, 1.0))).logpdf(torch.zeros(3, 2))\n"
        "from smcnuts_torch.models.arma import arma_model_fwd\n"
        "from smcnuts_torch.models.eightschools import make_eightschools_generated\n"
        "m = arma_model_fwd([0.1, -0.2, 0.3, 0.05])\n"
        "m.logp_and_grad(torch.zeros(2, 4)); m.tile_model.logp_and_grad(torch.zeros(2, 4))\n"
        "make_eightschools_generated().tile_model.source\n"
        "from smcnuts_torch.ops.peak import fma_chains\n"
        "fma_chains(torch.zeros(4), 4, 2)\n"
        "SMCConfig(n_particles=4, n_iterations=1, step_size=0.1, fused_epilogue=False,\n"
        "          eager_block_size=2)\n"
        "from smcnuts_torch.stan import compile_stan_file\n"
        "s = compile_stan_file('examples/stan/radon_intercepts.stan',\n"
        "                      data='examples/stan/radon_intercepts.json', tile=True)\n"
        "s.logp_and_grad(torch.zeros(2, 9)); s.tile_model.logp_and_grad(torch.zeros(2, 9))\n"
        "compile_stan_file('examples/stan/gq_rng.stan', data='examples/stan/gq_rng.json')\\\n"
        "    .constrain(torch.zeros(2, 1))\n"
        "sys.path.insert(0, 'experiments')\n"
        "import run_experiments_torch, stan_step_sizes_torch\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=_REPO, OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=env, timeout=300, cwd=_REPO,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _py_files():
    for root, _, files in os.walk(_PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


@pytest.mark.parametrize("forbidden", ["jax", "smcnuts_tpu"])
def test_no_source_imports(forbidden):
    """No module of the port names jax or smcnuts_tpu in an import, even
    inside a function (where the subprocess test would not reach it)."""
    hits = []
    for path in _py_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            hits += [
                (path, n) for n in names
                if n == forbidden or n.startswith(forbidden + ".")
            ]
    assert not hits


def _imported_names(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def test_chip_smoke_imports_neither():
    """The chip script names jax and smcnuts_tpu in no import."""
    names = _imported_names(os.path.join(_REPO, "chip_smoke.py"))
    assert not [n for n in names
                if n.split(".")[0] in ("jax", "jaxlib", "smcnuts_tpu")]
    assert any(n.startswith("smcnuts_torch") for n in names)


def test_experiment_driver_imports_neither():
    """The port's experiment driver names jax and smcnuts_tpu in no import."""
    names = _imported_names(os.path.join(_REPO, "experiments", "run_experiments_torch.py"))
    assert not [n for n in names
                if n.split(".")[0] in ("jax", "jaxlib", "smcnuts_tpu")]
    assert any(n.startswith("smcnuts_torch") for n in names)


def test_stan_step_size_script_imports_neither():
    """The port's Stan step-size script names jax and smcnuts_tpu in no
    import (its JAX counterpart, experiments/stan_step_sizes_jax.py, is the
    reference's and runs on the CPU only)."""
    names = _imported_names(os.path.join(_REPO, "experiments", "stan_step_sizes_torch.py"))
    assert not [n for n in names
                if n.split(".")[0] in ("jax", "jaxlib", "smcnuts_tpu")]
    assert any(n.startswith("smcnuts_torch") for n in names)


def test_kernel_sources_of_every_model_are_in_the_package():
    """Each in-kernel model has its device function beside the kernel that
    includes it, and the fused ARMA kernel shares arma's."""
    csrc = os.path.join(_PKG, "csrc")
    with open(os.path.join(csrc, "nuts_tree.cu")) as f:
        kernel = f.read()
    for model in ("arma", "prmwcd", "gaussian", "eightschools", "logistic"):
        assert os.path.isfile(os.path.join(csrc, f"{model}_model.cuh")), model
        assert f'#include "{model}_model.cuh"' in kernel
        assert f"smcnuts_nuts_tree_{model}" in kernel
    # The kernel template that generated models include, and K8.
    assert '#include "nuts_tree.cuh"' in kernel
    with open(os.path.join(csrc, "nuts_tree.cuh")) as f:
        assert "#define SMCNUTS_ENTRY" in f.read()
    with open(os.path.join(csrc, "fma_peak.cu")) as f:
        assert "smcnuts_fma_peak" in f.read()
    with open(os.path.join(csrc, "arma_fused.cu")) as f:
        fused = f.read()
    assert '#include "arma_model.cuh"' in fused and "arma_loglik_grad<" in fused
    assert "smcnuts_arma_ll_vg" in fused
