"""One-command parity evidence run of the PyTorch/CUDA port: the
counterpart of experiments/run_parity.py (the JAX package's) for
`smcnuts_torch`.

Reproduces the reference's validation workflow at the BASELINE config, 25
Monte-Carlo runs x 3 L-kernel strategies x {arma, PRMwCD}, N=512, K=100,
on the card: for each model, experiments/run_experiments_torch.py (each
strategy's runs in one `run_smc_batched` call; run i has seed
seed0 * (i + 1)), then experiments/parity_summary_torch.py, which writes
the machine-readable verdict. `--plots` also draws the MC trajectories and
MSE curves (experiments/plot_experiments_torch.py; needs matplotlib).

    python3 experiments/run_parity_torch.py --output parity_torch
    python3 experiments/run_parity_torch.py --device cpu --runs 2 -N 32 -K 3 \\
        --models arma --output /tmp/parity

Artifacts per model under <output>/<model>/: per-run CSVs (not committed,
regenerable), timings.json (each strategy's wall, the card's name and power
limit), <model>_summary.json, and with --plots <model>_mean.png and
<model>_mse.png. `--device` defaults to cuda and never falls back to the
CPU.
"""

import argparse
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))
sys.path.insert(0, _HERE)

import parity_summary_torch
import plot_experiments_torch
import run_experiments_torch

from smcnuts_torch.sampler import resolve_device


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--output", default="parity_torch")
    p.add_argument("--runs", type=int, default=25)
    p.add_argument("-N", "--particles", type=int, default=512)
    p.add_argument("-K", "--iterations", type=int, default=100)
    p.add_argument("--models", nargs="+", default=["arma", "prmwcd"],
                   choices=["arma", "prmwcd"])
    p.add_argument("--seed0", type=int, default=10,
                   help="run i uses seed0*(i+1)")
    p.add_argument("--device", default="cuda",
                   help="cuda | cuda:<i> | cpu (default cuda; never falls back "
                        "to the CPU)")
    p.add_argument("--plots", action="store_true",
                   help="also write <model>_mean.png and <model>_mse.png")
    args = p.parse_args(argv)
    resolve_device(args.device)

    summaries = {}
    for model in args.models:
        out = os.path.join(args.output, model)
        os.makedirs(out, exist_ok=True)
        run_experiments_torch.main([
            "--model", model, "--runs", str(args.runs),
            "-N", str(args.particles), "-K", str(args.iterations),
            "--output", out, "--seed0", str(args.seed0), "--device", args.device,
        ])
        if args.plots:
            plot_experiments_torch.main([
                "--model", model, "--runs", str(args.runs), "--output", out,
            ])
        summaries[model] = parity_summary_torch.main([
            "--model", model, "--runs", str(args.runs), "--output", out,
        ])
    return summaries


if __name__ == "__main__":
    summaries = main()
    sys.exit(0 if all(s["pass"] for s in summaries.values()) else 1)
