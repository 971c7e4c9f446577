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
on a card runs it inside the CUDA NUTS kernel. Without `--stan`, `--data`
and `--stan-tile` change nothing, as in that CLI. `--mesh` is not ported
yet and raises NotImplementedError naming its ROADMAP item.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

_NOT_PORTED = {  # flag attribute -> ROADMAP item
    "mesh": "Queue 1 item 10",
}


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
                        "kernel (loops fully unrolled)")
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
    # Accepted so that it fails loudly, not as an unknown flag.
    p.add_argument("--mesh", action="store_true")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint path (a chunked run that resumes from it)")
    p.add_argument("--chunk-size", type=int, default=10)
    p.add_argument("--output", default=None, help="save the results' .npz here")
    args = p.parse_args(argv)

    for flag, item in _NOT_PORTED.items():
        if getattr(args, flag) not in (None, False):
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} is not ported to smcnuts_torch "
                f"yet (ROADMAP {item})"
            )

    from .config import SMCConfig
    from .models import default_step_size, get_model
    from .sampler import run_smc

    if args.stan is not None:
        from .stan import compile_stan_file

        model = compile_stan_file(args.stan, data=args.data, tile=args.stan_tile)
        args.model = model.name
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
    if args.checkpoint:
        from .runner import ChunkedRunner

        result = ChunkedRunner(model, cfg, checkpoint_path=args.checkpoint,
                               chunk_size=args.chunk_size,
                               device=args.device).run(args.seed)
    else:
        result = run_smc(model, cfg, args.seed, args.device)

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
    print(json.dumps(summary, indent=1))
    if args.output:
        np.savez(args.output, **{f: v.cpu().numpy() for f, v in result._asdict().items()
                                 if v is not None})
        print(f"saved diagnostics to {args.output}")
    return summary


if __name__ == "__main__":
    main()
