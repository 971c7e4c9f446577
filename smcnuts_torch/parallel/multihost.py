"""Process-group set-up and the multi-process entry (the JAX package's
`parallel/multihost.py`).

A sharded run is the same program on every rank: once the process group
exists, `particle_group()` spans it and `run_smc(..., group=group)` runs one
shard of the particles a rank, with explicit collectives
(`parallel.sharding`). This module is the launcher glue. Under torchrun:

    torchrun --nproc-per-node 4 -m smcnuts_torch.parallel.multihost --model arma

(NCCL, one rank a card, device cuda:{LOCAL_RANK}), or by hand on each of P
processes:

    python -m smcnuts_torch.parallel.multihost --coordinator HOST:PORT \\
        --num-processes P --process-id I [--backend gloo --device cpu]

Gloo serves CPU ranks, and ranks that share one card when the caller names
the card (`--backend gloo --device cuda`). Nothing falls back: NCCL that
fails to initialise raises.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               backend="nccl"):
    """`torch.distributed.init_process_group`, idempotent: a process whose
    group exists keeps it. With a coordinator ("host:port"), the process
    count and this process's id, a TCP rendezvous there; else torchrun's
    environment (MASTER_ADDR, RANK, WORLD_SIZE); else a group of one
    process. NCCL binds the process to cuda:{LOCAL_RANK} (torchrun's, else
    the process id modulo the cards) and initialises its communicator at
    once, so a failure raises here. Returns (rank, world size)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and process_id")
        kw = dict(init_method=f"tcp://{coordinator_address}",
                  world_size=int(num_processes), rank=int(process_id))
    elif "MASTER_ADDR" in os.environ:
        kw = dict(init_method="env://")
    else:
        kw = dict(store=dist.HashStore(), world_size=1, rank=0)
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("the NCCL backend needs a CUDA device; use backend='gloo' "
                               "on the CPU")
        rank = int(kw.get("rank", os.environ.get("RANK", 0)))
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        device = torch.device(f"cuda:{local}")
        torch.cuda.set_device(device)
        kw["device_id"] = device
    dist.init_process_group(backend, **kw)
    return dist.get_rank(), dist.get_world_size()


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="smcnuts_torch.parallel.multihost",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="arma")
    p.add_argument("-N", "--particles", type=int, default=1 << 20)
    p.add_argument("-K", "--iterations", type=int, default=100)
    p.add_argument("--step-size", type=float, default=0.01)
    p.add_argument("--lkernel", default="forwardsLKernel")
    p.add_argument("--tempering", action="store_true")
    p.add_argument("--max-tree-depth", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--coordinator", default=None, help="host:port of the rendezvous")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--backend", default="nccl", choices=BACKENDS)
    p.add_argument("--device", default=None,
                   help="the ranks' device (default: cuda:{LOCAL_RANK} under NCCL, "
                        "the CPU under gloo; name cuda for ranks sharing a card)")
    p.add_argument("--checkpoint", default=None,
                   help="run in chunks, checkpointed here, resuming from it")
    p.add_argument("--chunk-size", type=int, default=10)
    p.add_argument("--output", default=None,
                   help="rank 0 saves the result, particles gathered, to this .npz")
    p.add_argument("--crash-after-chunk", type=int, default=None, metavar="C",
                   help="recovery drill: exit with code 17 once chunk C's checkpoint "
                        "is written (unless the run resumed)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    rank, size = initialize(args.coordinator, args.num_processes, args.process_id,
                            args.backend)
    try:
        return _run(args, rank, size)
    finally:
        dist.destroy_process_group()


def _run(args, rank, size):
    import numpy as np

    from ..config import SMCConfig
    from ..models import get_model
    from ..runner import ChunkedRunner
    from ..sampler import run_smc
    from .sharding import gather_result, particle_group

    group = particle_group(device=args.device)
    if rank == 0:
        print(f"initialized {size} processes, backend {dist.get_backend()}, "
              f"device {group.device}", flush=True)
    cfg = SMCConfig(
        n_particles=args.particles, n_iterations=args.iterations,
        step_size=args.step_size, lkernel=args.lkernel,
        tempering=args.tempering, save_history=False,
        max_tree_depth=args.max_tree_depth,
    )
    model = get_model(args.model)
    if args.checkpoint:
        resumed = os.path.exists(args.checkpoint)

        def progress(k_done, total):
            drill = args.crash_after_chunk
            if (drill is not None and not resumed
                    and k_done == min(drill * args.chunk_size, total)):
                print(f"rank {rank}: recovery drill, exiting after chunk {drill}",
                      flush=True)
                os._exit(17)

        runner = ChunkedRunner(model, cfg, checkpoint_path=args.checkpoint,
                               chunk_size=args.chunk_size, device=group.device,
                               group=group)
        result = runner.run(args.seed, progress=progress)
        if rank == 0:
            print(f"resumed={resumed}", flush=True)
    else:
        result = run_smc(model, cfg, args.seed, group.device, group=group)
    result = gather_result(result, group)
    if rank == 0:
        print("mean:", result.mean_estimate[-1].tolist())
        print("ess:", float(result.ess[-1]), flush=True)
        if args.output:
            np.savez(args.output, **{f: v.cpu().numpy() for f, v in result._asdict().items()
                                     if v is not None})
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
