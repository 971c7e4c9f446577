"""Acceptance and tree depth of the port's Stan programs at candidate step
sizes: the step each program takes in `chip_smoke.py` phase 13 and the larger
ones its source names.

    python experiments/stan_step_sizes_torch.py             # on the card
    python experiments/stan_step_sizes_torch.py --device cpu --runs 1 -N 128 -K 20

The programs and data are chip_smoke.py's STAN_PROGRAMS that run on the
kernel (radon_intercepts, irt_ar, the AR(1)-error recurrence of
tests/test_stan_frontend.py at T=200, lv_rk4 and the five programs of the
special functions), compiled with tile=True. Each program runs once a step through
`run_smc_batched` (--runs runs, seeds 0, 1, ...; forwards L-kernel without
tempering, max depth 10): on the card through the generated NUTS kernel, on
the CPU through its plain version. Steps: 0.05, 0.1, 0.2 (radon's README,
its tempered asymptotic run's) and 0.5 (the CLI's default for --stan).

One line a run: acceptance (the share of particles that moved in every
coordinate) over iterations 0-19 and over the rest, mean tree depth,
leapfrogs a particle-iteration, final ESS, and the final mean of the last
parameter (radon's sigma_y, irt_ar's sigma_b, the recurrence's s).
experiments/stan_step_sizes_jax.py prints the same lines for the JAX
frontend on the CPU.
"""

import argparse
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import STAN_PROGRAMS, stan_source  # noqa: E402
from smcnuts_torch import SMCConfig, run_smc_batched  # noqa: E402
from smcnuts_torch.sampler import resolve_device  # noqa: E402
from smcnuts_torch.stan import compile_stan_program  # noqa: E402

STEPS = (0.05, 0.1, 0.2, 0.5)
EARLY = 20  # acceptance is split at this iteration


def summary_line(name, step, acceptance, depth, leapfrogs, ess, last_mean, where, seconds):
    """The line both step-size scripts print for one run; `acceptance`,
    `depth` and `leapfrogs` are numpy arrays (runs, K), `ess` and
    `last_mean` the runs' final values."""
    runs, k = acceptance.shape
    late = (f", iterations {EARLY}-{k - 1} {acceptance[:, EARLY:].mean():.4f}"
            if k > EARLY else "")
    per_run = acceptance.mean(1)
    return (f"{name} step {step}: acceptance {acceptance.mean():.4f} (iterations 0-"
            f"{min(k, EARLY) - 1} {acceptance[:, :EARLY].mean():.4f}{late}; {runs} runs, "
            f"{per_run.min():.4f}-{per_run.max():.4f}), mean tree depth "
            f"{depth.mean():.3f}, leapfrogs per particle-iteration {leapfrogs.mean():.2f}, "
            f"final ESS {ess.mean():.1f}, final mean of the last parameter "
            f"{last_mean.mean():.4f} ({where}, {seconds:.1f} s)")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    tile = [n for n, prog in STAN_PROGRAMS.items() if prog["mode"] is not None]
    p.add_argument("--programs", nargs="+", default=tile, choices=tile)
    p.add_argument("--steps", nargs="+", type=float, default=list(STEPS))
    p.add_argument("--runs", type=int, default=25)
    p.add_argument("--particles", "-N", type=int, default=512)
    p.add_argument("--iterations", "-K", type=int, default=100)
    p.add_argument("--device", default="cuda",
                   help="cuda | cuda:<i> | cpu (default cuda; never falls back "
                        "to the CPU)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    seeds = list(range(args.runs))
    k = args.iterations
    for name in args.programs:
        src, data = stan_source(name)
        model = compile_stan_program(src, data, name=name, tile=True).to(device)
        for step in args.steps:
            cfg = SMCConfig(n_particles=args.particles, n_iterations=k, step_size=step,
                            max_tree_depth=10)
            t0 = time.perf_counter()
            res = run_smc_batched(model, cfg, seeds, device)
            print(summary_line(
                name, step, res.acceptance_rate[:, :k].double().cpu().numpy(),
                res.tree_depth[:, :k].double().cpu().numpy(),
                res.tree_leapfrogs[:, :k].double().cpu().numpy(),
                res.ess[:, k].double().cpu().numpy(),
                res.mean_estimate[:, k, -1].double().cpu().numpy(), where,
                time.perf_counter() - t0), flush=True)


if __name__ == "__main__":
    main()
