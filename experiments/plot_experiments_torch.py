"""Evaluation plots of the PyTorch/CUDA port's experiments: MC-averaged
estimator trajectories and MSE against the truth, the counterpart of
experiments/plot_experiments.py (the JAX package's) for `smcnuts_torch`.

Loads each strategy's per-run mean and variance CSVs
(experiments/run_experiments_torch.py) through `smcnuts_torch.utils.io`,
forms the Monte-Carlo mean +/- sd trajectory of each parameter across the
runs and the per-iteration MSE against the Stan ground truth on a log
scale, and writes <model>_mean.png and <model>_mse.png beside them.

The variance truth is the square of the reference's .params third column,
which is the posterior standard deviation (`models.ground_truth`), as in
the JAX script. Needs matplotlib, and raises naming it where it is absent.

    python3 experiments/plot_experiments_torch.py --model arma --runs 25 \\
        --output parity_torch/arma
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from smcnuts_torch.models import ground_truth
from smcnuts_torch.utils.io import load_run_csvs

STRATEGY_LABELS = {
    "forward_lkernel": "Forwards-proposal L-kernel",
    "gaussian_lkernel": "Gaussian-approx optimal L-kernel",
    "asymptotic_lkernel": "Asymptotic L-kernel (tempered)",
}


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("plot_experiments_torch.py needs matplotlib, which is "
                          "not installed here") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default="arma")
    p.add_argument("--runs", type=int, default=25)
    p.add_argument("--output", default=None)
    args = p.parse_args(argv)
    plt = _pyplot()

    output_dir = args.output or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "output", args.model)
    gt_mean, gt_var = ground_truth(args.model)
    dim = len(gt_mean)

    strategies = [
        s for s in STRATEGY_LABELS if os.path.isdir(os.path.join(output_dir, s))
    ]
    if not strategies:
        raise SystemExit(f"No strategy outputs under {output_dir}")

    data = {}
    for s in strategies:
        sdir = os.path.join(output_dir, s)
        data[s] = (load_run_csvs(sdir, args.runs, "mean_estimate"),
                   load_run_csvs(sdir, args.runs, "var_estimate"))

    k1 = next(iter(data.values()))[0].shape[1]
    iters = np.arange(k1)

    # MC mean +/- sd trajectories per parameter.
    ncols = min(dim, 4)
    nrows = (dim + ncols - 1) // ncols
    fig, axes = plt.subplots(nrows, ncols, figsize=(4 * ncols, 3 * nrows), squeeze=False)
    for d in range(dim):
        ax = axes[d // ncols][d % ncols]
        for s in strategies:
            mean_runs, _ = data[s]
            mc_mean = mean_runs[..., d].mean(axis=0)
            mc_sd = mean_runs[..., d].std(axis=0)
            ax.plot(iters, mc_mean, label=STRATEGY_LABELS[s])
            ax.fill_between(iters, mc_mean - mc_sd, mc_mean + mc_sd, alpha=0.2)
        ax.axhline(gt_mean[d], color="k", ls="--", lw=1)
        ax.set_title(f"param {d}")
        ax.set_xlabel("iteration")
    axes[0][0].legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(os.path.join(output_dir, f"{args.model}_mean.png"), dpi=120)
    plt.close(fig)

    # Per-iteration MSE against the ground truth, log scale.
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 4))
    for s in strategies:
        mean_runs, var_runs = data[s]
        ax1.semilogy(iters, ((mean_runs - gt_mean) ** 2).mean(axis=(0, 2)),
                     label=STRATEGY_LABELS[s])
        ax2.semilogy(iters, ((var_runs - gt_var) ** 2).mean(axis=(0, 2)),
                     label=STRATEGY_LABELS[s])
    ax1.set_title("MSE of mean estimates")
    ax2.set_title("MSE of variance estimates")
    for ax in (ax1, ax2):
        ax.set_xlabel("iteration")
        ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(os.path.join(output_dir, f"{args.model}_mse.png"), dpi=120)
    plt.close(fig)
    print(f"Wrote {args.model}_mean.png and {args.model}_mse.png to {output_dir}")


if __name__ == "__main__":
    main()
