"""Experiment output CSVs in the reference's layout (the JAX package's
`utils/io.py`, numpy only).

Writes the five per-run series of the reference's save_output (reference
experiments/run_experiments.py:195-215) under their names:
mean_estimate_{i}.csv, var_estimate_{i}.csv, ess_{i}.csv, phi_{i}.csv and
acceptance_rate_{i}.csv in output_dir/<strategy>/, so the reference's
evaluation tooling (experiments/plot_experiments.py, PARITY.md) reads the
port's runs. A result's tensors are copied to the host first.
"""

from __future__ import annotations

import os

import numpy as np


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)


def save_run_csvs(result, strategy: str, run_idx: int, output_dir: str):
    """One run's series (an `SMCResult` without a run axis, or a dict with
    its field names) as the reference's CSVs; returns the strategy's
    directory."""
    path = os.path.join(output_dir, strategy)
    os.makedirs(path, exist_ok=True)
    get = (
        result.__getitem__ if isinstance(result, dict)
        else lambda k: getattr(result, k)
    )
    series = {
        "mean_estimate": _host(get("mean_estimate")),
        "var_estimate": _host(get("variance_estimate")),
        "ess": _host(get("ess")),
        "phi": _host(get("phi")),
        "acceptance_rate": _host(get("acceptance_rate")),
    }
    for name, arr in series.items():
        np.savetxt(os.path.join(path, f"{name}_{run_idx}.csv"), arr, delimiter=",")
    return path


def load_run_csvs(strategy_dir: str, n_runs: int, name: str = "mean_estimate"):
    """One series across Monte-Carlo runs -> (n_runs, K+1, ...) array."""
    return np.asarray([
        np.loadtxt(os.path.join(strategy_dir, f"{name}_{i}.csv"), delimiter=",")
        for i in range(n_runs)
    ])
