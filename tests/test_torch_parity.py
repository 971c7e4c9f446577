"""The port's one-command parity pipeline (experiments/run_parity_torch.py)
and the PARITY criterion it applies (`smcnuts_torch.utils.parity`), against
the JAX package's experiments/parity_summary.py.

On the CPU at 2 runs x N=32 x K=3 for arma: the pipeline writes the
reference's CSVs and arma_summary.json, which equals the JAX script's
`summarize` over the same CSVs key for key, to the bit; the plotting driver
writes both PNGs (skipped only where matplotlib is absent); the driver
refuses a missing card; evidence of no strategy is never a pass.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from smcnuts_torch.models import ground_truth
from smcnuts_torch.utils import parity

torch.set_num_threads(2)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_REPO, "experiments"))

import parity_summary  # noqa: E402  (the JAX package's script)
import plot_experiments_torch  # noqa: E402
import run_parity_torch  # noqa: E402

RUNS = 2
SERIES = ("mean_estimate", "var_estimate", "ess", "phi", "acceptance_rate")


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    out = tmp_path_factory.mktemp("parity")
    summaries = run_parity_torch.main([
        "--device", "cpu", "--runs", str(RUNS), "-N", "32", "-K", "3",
        "--models", "arma", "--output", str(out)])
    return out, summaries


def test_pipeline_writes_the_csvs_and_summary(pipeline):
    out, summaries = pipeline
    arma = out / "arma"
    for s in parity.STRATEGIES:
        assert sorted(os.listdir(arma / s)) == sorted(
            f"{n}_{i}.csv" for n in SERIES for i in range(RUNS))
    with open(arma / "arma_summary.json") as f:
        written = json.load(f)
    assert written == summaries["arma"]
    assert set(written["strategies"]) == set(parity.STRATEGIES)
    timings = json.loads((arma / "timings.json").read_text())
    assert set(timings) == set(parity.STRATEGIES)
    assert all(t["device"] == "cpu" and "nvidia_smi" not in t for t in timings.values())


def test_summary_equals_the_jax_script_to_the_bit(pipeline):
    out, _ = pipeline
    with open(out / "arma" / "arma_summary.json") as f:
        ours = json.load(f)
    theirs = parity_summary.summarize("arma", str(out / "arma"), RUNS)
    assert list(ours) == list(theirs)
    for key in theirs:
        assert ours[key] == theirs[key], key


def test_plots_write_both_pngs(pipeline):
    pytest.importorskip("matplotlib")
    out, _ = pipeline
    plot_experiments_torch.main(["--model", "arma", "--runs", str(RUNS),
                                 "--output", str(out / "arma")])
    for kind in ("mean", "mse"):
        with open(out / "arma" / f"arma_{kind}.png", "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_pipeline_refuses_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_parity_torch.main(["--runs", "1", "-N", "8", "-K", "1", "--models", "arma",
                               "--output", str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_no_evidence_is_no_pass(tmp_path):
    out = parity.summarize("arma", str(tmp_path), 25)
    assert out["strategies"] == {} and out["pass"] is False
    assert parity.summary("prmwcd", 25, {})["pass"] is False


@pytest.mark.parametrize("model", ["arma", "prmwcd"])
def test_strategy_entry_equals_the_jax_summary_on_arrays(tmp_path, model):
    """Runs' estimates made from a seed, inside and outside the bands,
    written as CSVs: the JAX script's summary of them equals `summarize`'s,
    and `strategy_entry` on the final rows read back equals each of its
    entries, to the bit; the verdicts are as built."""
    from smcnuts_torch.utils.io import load_run_csvs, save_run_csvs

    gt_mean, gt_var = ground_truth(model)
    rng = np.random.default_rng(7)
    runs, d = 5, len(gt_mean)
    shifts = {"forward_lkernel": 0.0, "gaussian_lkernel": 0.02,
              "asymptotic_lkernel": 3.0}
    for s, shift in shifts.items():
        mean = gt_mean + np.sqrt(gt_var) * (shift + 0.05 * rng.normal(size=(runs, 3, d)))
        var = gt_var * (1.0 + 0.05 * rng.normal(size=(runs, 3, d)))
        for i in range(runs):
            save_run_csvs({"mean_estimate": mean[i], "variance_estimate": var[i],
                           "ess": np.ones(3), "phi": np.ones(3),
                           "acceptance_rate": np.zeros(3)}, s, i, str(tmp_path))
    theirs = parity_summary.summarize(model, str(tmp_path), runs)
    assert parity.summarize(model, str(tmp_path), runs) == theirs
    for s in shifts:
        sdir = str(tmp_path / s)
        entry = parity.strategy_entry(load_run_csvs(sdir, runs, "mean_estimate")[:, -1],
                                      load_run_csvs(sdir, runs, "var_estimate")[:, -1],
                                      gt_mean, gt_var)
        assert entry == theirs["strategies"][s], s
    assert [theirs["strategies"][s]["pass"] for s in shifts] == [True, True, False]
    assert theirs["pass"] is False
