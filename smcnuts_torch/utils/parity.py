"""The PARITY criterion in one place (the JAX package's
`experiments/parity_summary.py:45-106`, numpy only).

The reference validates by 25 Monte-Carlo runs a strategy, their final
estimates against the Stan long-chain ground truth (reference
experiments/plot_experiments.py:26-79). The verdict, calibrated to what the
algorithm achieves at finite N (`PARITY.md`):

- mean estimates: |MC mean - truth| <= 3 MC se + 0.1 posterior sd;
- variance estimates: |MC mean - truth| <= 3 MC se + 40% relative.

`strategy_entry` makes one strategy's entry from its runs' final
estimates, `summary` the `<model>_summary.json` object from the entries,
and `summarize` both from the CSVs an experiment directory holds
(`experiments/run_experiments_torch.py`). `chip_smoke.py` applies the same
bands to the runs it makes on the card. Evidence of no strategy is never a
pass.
"""

from __future__ import annotations

import os

import numpy as np

from ..models import ground_truth
from .io import load_run_csvs

STRATEGIES = ("forward_lkernel", "gaussian_lkernel", "asymptotic_lkernel")


def mean_band(mc_sd, runs, gt_var):
    """PARITY band for mean estimates: 3 MC-se + 0.1 posterior-sd."""
    return 3.0 * mc_sd / np.sqrt(runs) + 0.1 * np.sqrt(gt_var)


def var_band(mc_vsd, runs, gt_var):
    """PARITY band for variance estimates: 3 MC-se + 40% relative."""
    return 3.0 * mc_vsd / np.sqrt(runs) + 0.40 * np.abs(gt_var)


def _rounded(values):
    return [round(float(v), 6) for v in values]


def strategy_entry(final_mean, final_var, gt_mean, gt_var):
    """One strategy's entry of the summary from its runs' final mean and
    variance estimates, (R, D) each, against the truth (D,) each."""
    final_mean = np.asarray(final_mean, np.float64)
    final_var = np.asarray(final_var, np.float64)
    mc_mean = final_mean.mean(axis=0)
    mc_sd = final_mean.std(axis=0, ddof=1)
    mc_vmean = final_var.mean(axis=0)
    mc_vsd = final_var.std(axis=0, ddof=1)
    r = final_mean.shape[0]
    ok_mean = np.abs(mc_mean - gt_mean) <= mean_band(mc_sd, r, gt_var)
    ok_var = np.abs(mc_vmean - gt_var) <= var_band(mc_vsd, r, gt_var)
    return {
        "final_mse_mean": float(((final_mean - gt_mean) ** 2).mean()),
        "final_mse_var": float(((final_var - gt_var) ** 2).mean()),
        "mc_mean": _rounded(mc_mean),
        "mc_sd": _rounded(mc_sd),
        "mc_var_mean": _rounded(mc_vmean),
        "mc_var_sd": _rounded(mc_vsd),
        "mean_within_band": [bool(b) for b in ok_mean],
        "var_within_band": [bool(b) for b in ok_var],
        "pass": bool(ok_mean.all() and ok_var.all()),
    }


def summary(model, runs, entries):
    """The `<model>_summary.json` object from per-strategy entries; its
    verdict passes only when every entry does and there is at least one."""
    gt_mean, gt_var = ground_truth(model)
    return {
        "model": model,
        "runs": runs,
        "ground_truth_mean": _rounded(gt_mean),
        "ground_truth_var": _rounded(gt_var),
        "strategies": dict(entries),
        "pass": all(e["pass"] for e in entries.values()) and bool(entries),
    }


def summarize(model, output_dir, runs):
    """The summary of the strategies whose CSVs `output_dir` holds, each
    over its runs' final estimates."""
    gt_mean, gt_var = ground_truth(model)
    entries = {}
    for s in STRATEGIES:
        sdir = os.path.join(output_dir, s)
        if not os.path.isdir(sdir):
            continue
        mean_runs = load_run_csvs(sdir, runs, "mean_estimate")  # (R, K+1, D)
        var_runs = load_run_csvs(sdir, runs, "var_estimate")
        entries[s] = strategy_entry(mean_runs[:, -1, :], var_runs[:, -1, :],
                                    gt_mean, gt_var)
    return summary(model, runs, entries)
