"""Command-line entry: `python -m smcnuts_torch ...`.

Prints the JSON summary of the JAX package's CLI (same keys) for the models
arma, prmwcd, eightschools and logistic, with any of the three L-kernel
strategies, `--tempering` (always on with the asymptotic strategy, as in that
CLI) and either resampling scheme. `--checkpoint PATH` runs through
`runner.ChunkedRunner` in chunks of `--chunk-size` iterations (default 10;
without a checkpoint it changes nothing, as in that CLI), resuming from PATH
when it exists; `--output PATH` saves every result field that is not None
to an .npz, as host numpy arrays.

`--stan FILE.stan --data DATA.json` compiles a Stan program (`stan/`) as the
target in place of `--model`, with a default step size of 0.5, as that CLI
does; it runs on the eager backend by autograd, and with `--stan-tile` the
program also gets a generated in-kernel model, so that `--nuts-backend auto`
on a card runs it inside the CUDA NUTS kernel: every program the JAX
frontend tiles (dense linear algebra, the algebra solvers, the adaptive ODE
solvers inlined in the kernel, the special functions), raising
NotImplementedError naming the op and the model where the lowering lacks one
(the incomplete gamma functions of a parameter, among others), with no
fallback to the eager path. A program with an adaptive ODE solver prints
each call site's route in float32 and float64 to stderr
(`StanModel.ode_routes`: the ODE kernel, in the NUTS kernel under
`--stan-tile`, or the host loop). Without `--stan`, `--data` and
`--stan-tile` change nothing, as in that CLI.

`--mesh` shards the particles over a process group (`parallel/`): under
torchrun, every rank it starts (one a card, NCCL, device cuda:{LOCAL_RANK};
gloo with `--device cpu`),

    torchrun --standalone --nproc-per-node 4 -m smcnuts_torch --mesh -N 1048576

and without a launcher a group of one process. Rank 0 prints the JSON, which
equals that of the same run without `--mesh`, to the bit; `--checkpoint`
writes the global file from rank 0 and resumes at any number of ranks.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        prog="smcnuts_torch", description="SMC-NUTS sampler on PyTorch/CUDA"
    )
    p.add_argument("--model", default="arma", help="arma | prmwcd | eightschools | logistic")
    p.add_argument("--stan", default=None, metavar="FILE.stan",
                   help="compile a Stan program as the target (overrides "
                        "--model); pair with --data")
    p.add_argument("--data", default=None, metavar="DATA.json",
                   help="Stan data JSON for --stan ('phi' in the data block "
                        "is bound as the tempering parameter)")
    p.add_argument("--stan-tile", action="store_true",
                   help="with --stan: also build the generated in-kernel "
                        "model, so the program runs inside the CUDA NUTS "
                        "kernel (loops fully unrolled, adaptive ODE solves "
                        "inlined); an op the lowering lacks raises")
    p.add_argument("-N", "--particles", type=int, default=512)
    p.add_argument("-K", "--iterations", type=int, default=100)
    p.add_argument("--step-size", type=float, default=None)
    p.add_argument("--max-tree-depth", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda | cuda:<i> | cpu (default cuda; never falls "
                        "back to the CPU)")
    p.add_argument("--nuts-backend", default="auto",
                   choices=["auto", "eager", "cuda"])
    p.add_argument(
        "--lkernel", default="forwardsLKernel",
        choices=["asymptoticLKernel", "forwardsLKernel", "GaussianApproxLKernel"],
    )
    p.add_argument("--resampling", default="multinomial",
                   choices=["multinomial", "systematic"])
    p.add_argument("--tempering", action="store_true")
    p.add_argument("--adapt-step-size", action="store_true")
    p.add_argument("--adapt-mass-matrix", action="store_true")
    p.add_argument("--mesh", action="store_true",
                   help="shard the particles over the process group torchrun set "
                        "up (NCCL on cuda, gloo on cpu), or a group of one")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint path (a chunked run that resumes from it)")
    p.add_argument("--chunk-size", type=int, default=10)
    p.add_argument("--output", default=None, help="save the results' .npz here")
    args = p.parse_args(argv)
    if not args.mesh:
        return _main(args)

    import torch
    import torch.distributed as dist

    from .parallel.multihost import initialize

    owned = not dist.is_initialized()
    initialize(backend="nccl" if torch.device(args.device).type == "cuda" else "gloo")
    try:
        return _main(args)
    finally:
        if owned:
            dist.destroy_process_group()


def _main(args) -> dict:
    from .config import SMCConfig
    from .models import default_step_size, get_model
    from .sampler import run_smc

    if args.stan is not None:
        from .stan import compile_stan_file

        model = compile_stan_file(args.stan, data=args.data, tile=args.stan_tile)
        args.model = model.name
        for site, routes in model.ode_routes.items():
            print(f"ODE solver {site}: "
                  + "; ".join(f"{dtype} {route}" for dtype, route in routes.items()),
                  file=sys.stderr)
        if args.step_size is None:
            args.step_size = 0.5
    else:
        model = get_model(args.model)
    if args.step_size is None:
        # The step size stored with the model's data; 0.5 without one (the
        # reference's default, run_experiments.py:87-90).
        args.step_size = default_step_size(args.model)

    cfg = SMCConfig(
        n_particles=args.particles, n_iterations=args.iterations,
        step_size=args.step_size, lkernel=args.lkernel,
        tempering=args.tempering or args.lkernel == "asymptoticLKernel",
        resampling=args.resampling, max_tree_depth=args.max_tree_depth,
        save_history=args.lkernel == "asymptoticLKernel",
        nuts_backend=args.nuts_backend,
        adapt_step_size=args.adapt_step_size,
        adapt_mass_matrix=args.adapt_mass_matrix,
    )
    group, device = None, args.device
    if args.mesh:
        from .parallel.sharding import particle_group

        # Under NCCL the rank's own card (cuda:{LOCAL_RANK}).
        group = particle_group(device=None if device == "cuda" else device)
        device = group.device
    if args.checkpoint:
        from .runner import ChunkedRunner

        result = ChunkedRunner(model, cfg, checkpoint_path=args.checkpoint,
                               chunk_size=args.chunk_size,
                               device=device, group=group).run(args.seed)
    else:
        result = run_smc(model, cfg, args.seed, device, group=group)
    if group is not None:
        from .parallel.sharding import gather_result

        result = gather_result(result, group)

    summary = {
        "model": args.model,
        "lkernel": args.lkernel,
        "N": args.particles,
        "K": args.iterations,
        "mean": result.mean_estimate[-1].tolist(),
        "variance": result.variance_estimate[-1].tolist(),
        "ess": float(result.ess[-1]),
        "log_likelihood": float(result.log_likelihood[-1]),
        "phi_schedule": [round(v, 4) for v in result.phi.tolist()],
    }
    if group is not None and group.rank != 0:
        return summary
    print(json.dumps(summary, indent=1))
    if args.output:
        np.savez(args.output, **{f: v.cpu().numpy() for f, v in result._asdict().items()
                                 if v is not None})
        print(f"saved diagnostics to {args.output}")
    return summary


if __name__ == "__main__":
    main()
