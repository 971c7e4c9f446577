"""Experiment driver of the PyTorch/CUDA port: Monte-Carlo runs x the three
L-kernel strategies, written as the reference's CSVs.

The counterpart of experiments/run_experiments.py (the JAX package's) for
`smcnuts_torch`: for each strategy, (i) the forwards-proposal L-kernel, (ii)
the Gaussian-approximation L-kernel and (iii) the asymptotic L-kernel with
adaptive tempering and accept-reject, the R runs go through one
`run_smc_batched` call (one NUTS launch an iteration for all of them; run i
has seed seed0 * (i + 1) and equals its run alone to the bit), and each
run's five series (mean and variance estimates, ESS, phi, acceptance rate)
are saved under the reference's names, output/<model>/<strategy>/*_<run>.csv
(`smcnuts_torch.utils.io`), which experiments/plot_experiments.py reads.

    python3 experiments/run_experiments_torch.py --model arma --runs 25
    python3 experiments/run_experiments_torch.py --model prmwcd --runs 2 \\
        -N 32 -K 3 --device cpu

timings.json beside the CSVs holds each strategy's wall time (CUDA events on
the card, the host clock on the CPU) with the device it ran on, and on the
card its name and power limit as `nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader` gives them.
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from smcnuts_torch import SMCConfig, run_smc_batched
from smcnuts_torch.models import default_step_size, get_model
from smcnuts_torch.sampler import resolve_device
from smcnuts_torch.utils.io import save_run_csvs

STRATEGIES = {
    "forward_lkernel": dict(lkernel="forwardsLKernel", tempering=False),
    "gaussian_lkernel": dict(lkernel="GaussianApproxLKernel", tempering=False),
    "asymptotic_lkernel": dict(lkernel="asymptoticLKernel", tempering=True),
}


def _wall_seconds(fn, device):
    """fn() and its wall time, up to its results on the host."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def card_line(device):
    """nvidia-smi's name and power limit of the card `device` is on."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
             "-i", str(index)], capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip() or f"nvidia-smi failed: {out.stderr.strip()}"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default="arma", choices=["arma", "prmwcd"])
    p.add_argument("--runs", type=int, default=25, help="Monte-Carlo runs")
    p.add_argument("--particles", "-N", type=int, default=512)
    p.add_argument("--iterations", "-K", type=int, default=100)
    p.add_argument("--step-size", type=float, default=None)
    p.add_argument("--max-tree-depth", type=int, default=10)
    p.add_argument("--resampling", default="multinomial",
                   choices=["multinomial", "systematic"])
    p.add_argument("--strategies", nargs="+", default=list(STRATEGIES),
                   choices=list(STRATEGIES))
    p.add_argument("--output", default=None)
    p.add_argument("--seed0", type=int, default=10, help="run i uses seed0*(i+1)")
    p.add_argument("--device", default="cuda",
                   help="cuda | cuda:<i> | cpu (default cuda; never falls back "
                        "to the CPU)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    model = get_model(args.model)
    step_size = args.step_size or default_step_size(args.model)
    output_dir = args.output or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "output", args.model)
    os.makedirs(output_dir, exist_ok=True)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    smi = card_line(device) if device.type == "cuda" else None
    print(f"Model: {args.model}  N={args.particles}  K={args.iterations}  "
          f"step_size={step_size}  runs={args.runs}  device: {where}")

    seeds = [args.seed0 * (i + 1) for i in range(args.runs)]
    timings = {}
    for name in args.strategies:
        cfg = SMCConfig(
            n_particles=args.particles, n_iterations=args.iterations,
            step_size=step_size, resampling=args.resampling,
            max_tree_depth=args.max_tree_depth,
            # Only the asymptotic strategy's estimates read the history.
            save_history=STRATEGIES[name]["lkernel"] == "asymptoticLKernel",
            **STRATEGIES[name],
        )
        result, seconds = _wall_seconds(
            lambda: run_smc_batched(model, cfg, seeds, device), device)
        for i in range(args.runs):
            save_run_csvs({f: getattr(result, f)[i] for f in (
                "mean_estimate", "variance_estimate", "ess", "phi", "acceptance_rate")},
                name, i, output_dir)
        timings[name] = {
            "device": where, "runs": args.runs, "wall_s": seconds,
            "particle_iters_per_s": args.runs * args.particles * args.iterations / seconds,
        }
        if smi is not None:
            timings[name]["nvidia_smi"] = smi
        print(f"{name}: {args.runs} runs batched in {seconds:.3f} s ({where})")
    with open(os.path.join(output_dir, "timings.json"), "w") as f:
        json.dump(timings, f, indent=1)
    print(json.dumps(timings, indent=1))


if __name__ == "__main__":
    main()
