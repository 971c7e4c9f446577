"""Experiment output and the CLI's file flags (the counterpart of
tests/test_io_cli.py): the port's `utils.io` writes the same bytes as the
JAX package's on the same arrays and reads them back; the CLI runs
--checkpoint, --chunk-size and --output on the CPU, its npz equal to the
in-process result to the bit and holding the fields and shapes the JAX CLI
writes, its summary keys the JAX CLI's; a rerun resumes at k_done == K; the
experiment driver writes the reference's file names."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from smcnuts_torch import SMCConfig, run_smc
from smcnuts_torch.__main__ import main as torch_main
from smcnuts_torch.models import default_step_size, get_model
from smcnuts_torch.ops.nuts_cuda import nuts_tree_plain
from smcnuts_torch.utils.io import load_run_csvs, save_run_csvs
from smcnuts_tpu.__main__ import main as jax_main
from smcnuts_tpu.utils.io import load_run_csvs as jax_load_run_csvs
from smcnuts_tpu.utils.io import save_run_csvs as jax_save_run_csvs

torch.set_num_threads(2)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERIES = ("mean_estimate", "var_estimate", "ess", "phi", "acceptance_rate")
N, K, DEPTH = 16, 2, 2


def _series(seed, k=4, cd=4):
    rng = np.random.default_rng(seed)
    return {
        "mean_estimate": rng.normal(size=(k + 1, cd)).astype(np.float32),
        "variance_estimate": rng.random((k + 1, cd)).astype(np.float32),
        "ess": (rng.random(k + 1) * 64).astype(np.float32),
        "phi": np.sort(rng.random(k + 1)).astype(np.float32),
        "acceptance_rate": rng.random(k + 1).astype(np.float32),
    }


def test_csvs_byte_identical_to_the_jax_package(tmp_path):
    runs = [_series(i) for i in range(2)]
    for i, run in enumerate(runs):
        torch_dir = save_run_csvs({k: torch.from_numpy(v) for k, v in run.items()},
                                  "forward_lkernel", i, str(tmp_path / "torch"))
        jax_dir = jax_save_run_csvs(run, "forward_lkernel", i, str(tmp_path / "jax"))
    assert sorted(os.listdir(torch_dir)) == sorted(os.listdir(jax_dir)) == sorted(
        f"{name}_{i}.csv" for name in SERIES for i in range(2))
    for name in os.listdir(jax_dir):
        with open(os.path.join(torch_dir, name), "rb") as a, \
                open(os.path.join(jax_dir, name), "rb") as b:
            assert a.read() == b.read(), name
    for name in SERIES:
        got = load_run_csvs(torch_dir, 2, name)
        np.testing.assert_array_equal(got, jax_load_run_csvs(jax_dir, 2, name))
        key = "variance_estimate" if name == "var_estimate" else name
        np.testing.assert_array_equal(got, np.stack([r[key] for r in runs]))


def test_csv_round_trip_of_a_run(tmp_path):
    cfg = SMCConfig(n_particles=32, n_iterations=3, step_size=0.01, max_tree_depth=DEPTH,
                    save_history=False)
    res = run_smc(get_model("arma"), cfg, 0, "cpu")
    out = save_run_csvs(res, "forward_lkernel", 0, str(tmp_path))
    for name in SERIES:
        assert os.path.exists(os.path.join(out, f"{name}_0.csv")), name
    np.testing.assert_array_equal(load_run_csvs(out, 1, "mean_estimate")[0],
                                  res.mean_estimate.numpy())


@pytest.fixture(scope="module")
def jax_cli(tmp_path_factory):
    """The JAX CLI's summary and npz at the port's test size."""
    out = str(tmp_path_factory.mktemp("jax") / "diag.npz")
    from contextlib import redirect_stdout
    from io import StringIO

    buf = StringIO()
    with redirect_stdout(buf):
        jax_main(["--model", "arma", "-N", str(N), "-K", str(K), "--max-tree-depth",
                  str(DEPTH), "--output", out])
    text = buf.getvalue()
    summary, _ = json.JSONDecoder().raw_decode(text[text.index("{"):])
    with np.load(out) as data:
        arrays = {k: data[k] for k in data.files}
    return summary, arrays, text


def _argv(tmp_path, *extra):
    return ["--model", "arma", "-N", str(N), "-K", str(K), "--max-tree-depth", str(DEPTH),
            "--device", "cpu", "--output", str(tmp_path / "diag.npz"), *extra]


def test_cli_output_holds_the_jax_fields_and_shapes(tmp_path, jax_cli, capsys):
    jax_summary, jax_arrays, jax_text = jax_cli
    summary = torch_main(_argv(tmp_path))
    out = capsys.readouterr().out
    assert set(summary) == set(jax_summary)
    assert out.rstrip().splitlines()[-1] == f"saved diagnostics to {tmp_path / 'diag.npz'}"
    assert jax_text.rstrip().splitlines()[-1].startswith("saved diagnostics to ")
    with np.load(tmp_path / "diag.npz") as data:
        assert sorted(data.files) == sorted(jax_arrays)
        for name in data.files:
            assert data[name].shape == jax_arrays[name].shape, name
            assert data[name].dtype == jax_arrays[name].dtype, name


@pytest.mark.parametrize("lkernel", ["forwardsLKernel", "asymptoticLKernel"])
def test_cli_checkpoint_chunks_output(tmp_path, capsys, lkernel):
    """--checkpoint --chunk-size --output on the CPU: the npz equals the
    in-process run to the bit (with the asymptotic strategy the CLI saves
    the history); run again, it resumes at k_done == K and runs no tree."""
    ckpt = str(tmp_path / "ck.npz")
    argv = _argv(tmp_path, "--checkpoint", ckpt, "--chunk-size", "1", "--lkernel", lkernel)
    summary = torch_main(argv)
    asym = lkernel == "asymptoticLKernel"
    cfg = SMCConfig(n_particles=N, n_iterations=K, step_size=default_step_size("arma"),
                    lkernel=lkernel, tempering=asym, save_history=asym,
                    max_tree_depth=DEPTH)
    want = run_smc(get_model("arma"), cfg, 0, "cpu")
    with np.load(tmp_path / "diag.npz") as data:
        assert sorted(data.files) == sorted(f for f, v in want._asdict().items()
                                            if v is not None)
        assert ("x_saved" in data.files) == asym
        for name in data.files:
            assert torch.equal(torch.from_numpy(data[name]), getattr(want, name)), name
    with np.load(ckpt) as data:
        assert int(data["k_done"]) == K
    calls = nuts_tree_plain.calls
    capsys.readouterr()
    assert torch_main(argv) == summary
    assert nuts_tree_plain.calls == calls
    assert "saved diagnostics to" in capsys.readouterr().out


def test_cli_chunk_size_without_checkpoint_changes_nothing(tmp_path, capsys):
    a = torch_main(_argv(tmp_path, "--chunk-size", "1"))
    b = torch_main(_argv(tmp_path))
    assert a == b


def test_experiment_driver_writes_the_reference_names(tmp_path):
    out = tmp_path / "exp"
    env = dict(os.environ, PYTHONPATH=_REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, os.path.join(_REPO, "experiments", "run_experiments_torch.py"),
         "--model", "arma", "--runs", "2", "-N", "32", "-K", "3", "--max-tree-depth",
         str(DEPTH), "--device", "cpu", "--output", str(out)],
        capture_output=True, text=True, env=env, timeout=600, cwd=_REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    strategies = ("forward_lkernel", "gaussian_lkernel", "asymptotic_lkernel")
    names = set()
    for strategy in strategies:
        files = sorted(os.listdir(out / strategy))
        assert files == sorted(f"{n}_{i}.csv" for n in SERIES for i in range(2))
        names |= {(strategy, n) for n in SERIES}
        assert load_run_csvs(str(out / strategy), 2, "mean_estimate").shape == (2, 4, 4)
    assert len(names) == 15
    timings = json.loads((out / "timings.json").read_text())
    assert set(timings) == set(strategies)
    assert all(t["device"] == "cpu" for t in timings.values())
    # Run 1 has seed 20 and equals its run alone.
    cfg = SMCConfig(n_particles=32, n_iterations=3, step_size=default_step_size("arma"),
                    max_tree_depth=DEPTH, save_history=False)
    alone = run_smc(get_model("arma"), cfg, 20, "cpu")
    np.testing.assert_array_equal(
        np.loadtxt(out / "forward_lkernel" / "ess_1.csv", delimiter=","),
        alone.ess.numpy().astype(np.float64))


def test_experiment_driver_refuses_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH=_REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, os.path.join(_REPO, "experiments", "run_experiments_torch.py"),
         "--runs", "1", "-N", "8", "-K", "1", "--output", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=600, cwd=_REPO)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
