"""The JAX frontend's acceptance at the step sizes of
experiments/stan_step_sizes_torch.py, on the CPU: the reference for the
steps `chip_smoke.py` phase 13 takes.

    JAX_PLATFORMS=cpu python experiments/stan_step_sizes_jax.py -N 128 -K 20

The same programs and data (chip_smoke.py's STAN_PROGRAMS) compiled by
`smcnuts_tpu.stan` without a tile model, one `run_smc` a program and step
(forwards L-kernel without tempering, max depth 10, its XLA NUTS, keys
jax.random.key(0), key(1), ...), printing the line the port's script prints.
It runs on the CPU only: the JAX package is the port's reference, not a
program measured on a card.
"""

import argparse
import os
import sys
import time

import jax
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "experiments"))

from stan_step_sizes_torch import STEPS, summary_line  # noqa: E402

from chip_smoke import STAN_PROGRAMS, stan_source  # noqa: E402
from smcnuts_tpu import SMCConfig, run_smc  # noqa: E402
from smcnuts_tpu.stan import compile_stan_program  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--programs", nargs="+", default=list(STAN_PROGRAMS),
                   choices=list(STAN_PROGRAMS))
    p.add_argument("--steps", nargs="+", type=float, default=list(STEPS))
    p.add_argument("--runs", type=int, default=1)
    p.add_argument("--particles", "-N", type=int, default=128)
    p.add_argument("--iterations", "-K", type=int, default=20)
    args = p.parse_args(argv)
    if jax.default_backend() != "cpu":
        raise SystemExit("run with JAX_PLATFORMS=cpu: the reference runs on the CPU")

    k = args.iterations
    for name in args.programs:
        src, data = stan_source(name)
        model = compile_stan_program(src, data, name=name)
        for step in args.steps:
            cfg = SMCConfig(n_particles=args.particles, n_iterations=k, step_size=step,
                            max_tree_depth=10)
            t0 = time.perf_counter()
            run = jax.jit(lambda key, cfg=cfg: run_smc(model, cfg, key))
            res = [jax.tree.map(np.asarray, run(jax.random.key(s))) for s in range(args.runs)]
            field = lambda f: np.stack([np.asarray(getattr(r, f), np.float64) for r in res])  # noqa: E731
            print(summary_line(
                name, step, field("acceptance_rate")[:, :k], field("tree_depth")[:, :k],
                field("tree_leapfrogs")[:, :k], field("ess")[:, k],
                field("mean_estimate")[:, k, -1], "cpu, the JAX frontend",
                time.perf_counter() - t0), flush=True)


if __name__ == "__main__":
    main()
