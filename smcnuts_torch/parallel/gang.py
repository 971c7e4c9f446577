"""Sharded computations a gang of ranks runs and saves, for a caller to hold
against the unsharded port: the CPU tests (tests/test_torch_sharding.py,
tests/test_torch_multihost.py) and chip_smoke.py's phase `mesh`.

    python -m smcnuts_torch.parallel.gang OUT_DIR JOB [JOB ...] \\
        --coordinator HOST:PORT --num-processes P --process-id I \\
        [--backend gloo --device cpu] [--params JSON]

Each job runs on sub-groups of the gang (`sharding.shard_group`) and rank 0
of each sub-group writes its results, the particles gathered into the
global order, to OUT_DIR/<job>_<case>_P<size>.npz. The inputs come from
numpy seeds (`op_inputs`) or from the configurations here (`RUN_CASES`), so
the caller makes the same inputs for its unsharded reference. Jobs:

- ops: the SMC ops at P = 1, 2, 4 (`op_results`);
- runs: whole runs of `RUN_CASES` at P = 1 and 2 (side by side), then 4;
- steps: three `smc_step`s at P = 2 and 4 from the state and resampling
  uniforms in params["steps_input"] (an .npz), zero-bits draws;
- run_axes: `map_runs` over ranks 0-1 and the 2 x 2 grid `map_runs_2d`;
- checkpoint: `ChunkedRunner` at P = 2 stopped after chunk 1 and resumed,
  beside the uninterrupted run; the chunk-1 file resumed at P = 1 and 4;
- wide: each run of params["runs"] over the whole gang, with its wall, the
  collectives' calls, bytes and seconds, the kernel launches and, one rank
  at a time, the rank's NUTS kernel timed on its final shard (device time
  alone, `utils.timing.device_ms`).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

import numpy as np
import torch

from .multihost import BACKENDS, initialize
from .sharding import (
    gather_particles,
    gather_result,
    particle_group,
    shard_group,
)

# Whole runs, B = 2, on the eager tree: the strategies of the JAX package's
# dryrun (MULTICHIP_r05.json (a), (b), (d), (f)) and tests/test_sharding.py.
RUN_SEEDS = (3, 11)
RUN_BASE = dict(n_particles=128, n_iterations=4, step_size=0.01, max_tree_depth=4)
RUN_CASES = {
    "forwards": dict(),
    "gaussian_systematic": dict(lkernel="GaussianApproxLKernel", resampling="systematic"),
    "asymptotic_tempered": dict(lkernel="asymptoticLKernel", tempering=True),
    "adapted": dict(adapt_step_size=True, adapt_mass_matrix=True, target_accept=0.5),
}
# The run axes: 4 runs over 2 ranks, and over a 2 x 2 grid.
AXIS_SEEDS = (0, 5, 9, 12)
AXIS_CONFIG = dict(n_particles=64, n_iterations=3, step_size=0.01, max_tree_depth=3)
# Checkpoints: K = 4 in chunks of 2.
CKPT_SEEDS = (2, 7)
CKPT_CONFIG = dict(n_particles=64, n_iterations=4, step_size=0.01, max_tree_depth=3,
                   lkernel="asymptoticLKernel", tempering=True, save_history=True)
CKPT_CHUNK = 2


def run_config(**overrides):
    from ..config import SMCConfig

    return SMCConfig(**{**RUN_BASE, **overrides})


def op_inputs(seed=0, b=2, n=256, d=4) -> dict:
    """The ops' inputs, from numpy: float32 log weights with -inf entries,
    particles and momenta, an untempered log-likelihood, phi_old, the
    resampling uniforms and each run's shared systematic uniform."""
    rng = np.random.default_rng(seed)
    logw = (rng.normal(size=(b, n)) * 3.0).astype(np.float32)
    logw[rng.random((b, n)) < 0.1] = -np.inf
    x = rng.normal(size=(b, n, d)).astype(np.float32)
    r = (0.4 * x + rng.normal(size=(b, n, d))).astype(np.float32)
    return {
        "v": rng.normal(size=(b, n)).astype(np.float32),
        "logw": logw, "x": x, "r": r,
        "loglik": (rng.normal(size=(b, n)) * 20.0 - 50.0).astype(np.float32),
        "phi_old": np.array([0.0, 0.3], dtype=np.float32)[:b],
        "uniforms": rng.random((b, n), dtype=np.float32),
        "shared_uniform": rng.random(b, dtype=np.float32),
    }


def op_results(inp: dict, group=None) -> dict:
    """Every op of the slice on `inp` (torch tensors, the rank's shard with a
    group), its per-particle outputs gathered into the global order."""
    from ..ops.lkernels import gaussian_lkernel_logpdf, population_moments
    from ..ops.moments import weighted_moments
    from ..ops.reduce import row_sum
    from ..ops.resampling import ancestors, fetch_rows, resample_if_required
    from ..ops.tempering import next_temperature
    from ..ops.weights import ess, normalise_weights

    def full(v, dim=-1):
        return gather_particles(v, group, dim)

    n = inp["logw"].shape[-1] * (1 if group is None else group.size)
    wn, ll = normalise_weights(inp["logw"], group)
    mean, var = weighted_moments(inp["x"], wn, group)
    mu_X, cov_X, _ = population_moments(inp["r"], inp["x"], group)
    out = {
        "row_sum": row_sum(inp["v"], group), "wn": full(wn), "log_likelihood": ll,
        "ess": ess(wn, group), "mean": mean, "var": var,
        "phi": next_temperature(inp["loglik"], inp["phi_old"], n, group=group),
        "lk_mean": mu_X, "lk_cov": cov_X,
        "lk_logpdf": full(gaussian_lkernel_logpdf(inp["r"], inp["x"], group)),
    }
    for scheme in ("multinomial", "systematic"):
        idx = ancestors(scheme, wn, inp["uniforms"], group, inp["shared_uniform"])
        (rows,) = fetch_rows(idx, [inp["x"]], group)
        out[f"ancestors_{scheme}"] = full(idx)
        out[f"rows_{scheme}"] = full(rows, -2)
    # The resample of the loop with run 0 below its threshold and the others
    # above, then with none below: that one exchanges nothing.
    ess_val = torch.full_like(ll, float(n))
    ess_val[0] = 0.0
    x_res, logw_res, _ = resample_if_required(inp["uniforms"], inp["x"], inp["logw"], wn,
                                              ll, ess_val, group=group)
    out["resample_x"], out["resample_logw"] = full(x_res, -2), full(logw_res)
    calls = 0 if group is None else group.stats["calls"]
    resample_if_required(inp["uniforms"], inp["x"], inp["logw"], wn, ll,
                         torch.full_like(ll, float(n)), group=group)
    out["quiet_resample_calls"] = torch.tensor(
        (0 if group is None else group.stats["calls"]) - calls)
    return out


def _save(path, arrays: dict):
    tmp = path + ".tmp.npz"
    np.savez(tmp, **{k: v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
                     for k, v in arrays.items() if v is not None})
    os.replace(tmp, path)


def result_arrays(result) -> dict:
    return {k: v for k, v in result._asdict().items() if v is not None}


def _groups(world, layout):
    """The sub-groups of `layout` (lists of ranks; every rank makes every
    group), and this rank's, or None."""
    mine = None
    for ranks in layout:
        if max(ranks) >= world.size:
            continue
        g = shard_group(world, ranks)
        if g is not None:
            mine = g
    return mine


def job_ops(world, out, params):
    inp = op_inputs()
    for layout in ([[0]], [[0, 1]], [list(range(4))]):
        g = _groups(world, layout)
        if g is None:
            continue
        local = {k: torch.from_numpy(v).to(g.device) for k, v in inp.items()}
        for k in ("logw", "x", "r", "loglik", "uniforms", "v"):
            local[k] = g.take_shard(local[k], 1)
        res = op_results(local, g)
        if g.rank == 0:
            _save(os.path.join(out, f"ops_P{g.size}.npz"), res)


def job_runs(world, out, params):
    from ..models import get_model
    from ..sampler import run_smc_batched

    for layout in ([[0], [2, 3]], [list(range(4))]):
        g = _groups(world, layout)
        if g is None:
            continue
        for name, kw in RUN_CASES.items():
            res = gather_result(run_smc_batched(get_model("arma"), run_config(**kw),
                                                list(RUN_SEEDS), g.device, group=g), g)
            if g.rank == 0:
                _save(os.path.join(out, f"runs_{name}_P{g.size}.npz"), result_arrays(res))


def job_steps(world, out, params):
    data = dict(np.load(params["steps_input"]))
    for layout in ([[0, 1]], [list(range(4))]):
        g = _groups(world, layout)
        if g is not None:
            _steps(g, out, data)


def _steps(g, out, data):
    from ..interop import carry_from_numpy
    from ..models import get_model
    from ..ops.draws import ZERO_BITS
    from ..sampler import smc_step

    n_iter = data["uniforms"].shape[0]
    cfg = run_config(n_particles=data["x"].shape[0], n_iterations=n_iter,
                     max_tree_depth=int(data["max_depth"]))
    start = {k: data[k] for k in ("x", "logw", "phi", "step_size", "inv_mass")}
    start["da"] = tuple(data[f"da{i}"] for i in range(5))
    carry = carry_from_numpy(**start, device=g.device)
    carry = carry._replace(x=g.take_shard(carry.x, 1), logw=g.take_shard(carry.logw, 1))
    model = get_model("arma")
    saved = {}
    for k in range(n_iter):
        u = torch.from_numpy(data["uniforms"][k])[None].to(g.device)
        carry, diag = smc_step(model, cfg, carry, g.take_shard(u, 1),
                               torch.zeros(1, dtype=torch.int32, device=g.device),
                               "eager", ZERO_BITS, group=g, shared_uniform=u[..., 0])
        saved[f"x_{k}"] = gather_particles(carry.x, g, -2)
        saved[f"logw_{k}"] = gather_particles(carry.logw, g)
        for name in ("phi", "step_size", "inv_mass"):
            saved[f"{name}_{k}"] = getattr(carry, name)
        saved.update({f"{name}_{k}": v for name, v in diag.items()})
    if g.rank == 0:
        _save(os.path.join(out, f"steps_P{g.size}.npz"), saved)


def job_run_axes(world, out, params):
    from ..config import SMCConfig
    from ..models import get_model
    from .runs import map_runs, map_runs_2d, runs_particles_mesh

    cfg = SMCConfig(**AXIS_CONFIG)
    pair = _groups(world, [[0, 1], [2, 3]])
    res = map_runs(get_model("arma"), cfg, list(AXIS_SEEDS), pair)
    if world.rank == 0:
        _save(os.path.join(out, "run_axes_map_P2.npz"), result_arrays(res))
    grid = runs_particles_mesh(2, device=world.device)
    res = map_runs_2d(get_model("arma"), cfg, list(AXIS_SEEDS), grid)
    if world.rank == 0:
        _save(os.path.join(out, "run_axes_grid_P4.npz"), result_arrays(res))


class _Stop(Exception):
    pass


def job_checkpoint(world, out, params):
    from ..config import SMCConfig
    from ..models import get_model
    from ..runner import ChunkedRunner

    cfg, model = SMCConfig(**CKPT_CONFIG), get_model("arma")
    path = os.path.join(out, "ckpt_P2.npz")
    chunk1 = os.path.join(out, "ckpt_P2_chunk1.npz")

    def runner(g, ckpt):
        return ChunkedRunner(model, cfg, checkpoint_path=ckpt, chunk_size=CKPT_CHUNK,
                             device=g.device, group=g)

    # The job starts from no checkpoint, whatever an earlier run left.
    if world.rank == 0:
        for stale in (path, chunk1):
            if os.path.exists(stale):
                os.remove(stale)
    world.barrier()
    # Ranks 0-1: stopped after chunk 1, the file kept, then resumed; ranks
    # 2-3: the same run uninterrupted.
    g = _groups(world, [[0, 1], [2, 3]])
    if world.rank < 2:
        def stop(k_done, total):
            if k_done == CKPT_CHUNK:
                raise _Stop
        try:
            runner(g, path).run(list(CKPT_SEEDS), progress=stop)
        except _Stop:
            pass
        if g.rank == 0:
            shutil.copyfile(path, chunk1)
        g.barrier()
        res = gather_result(runner(g, path).run(list(CKPT_SEEDS)), g)
        if g.rank == 0:
            _save(os.path.join(out, "checkpoint_resumed_P2.npz"), result_arrays(res))
    else:
        res = gather_result(runner(g, None).run(list(CKPT_SEEDS)), g)
        if g.rank == 0:
            _save(os.path.join(out, "checkpoint_uninterrupted_P2.npz"), result_arrays(res))
    world.barrier()
    # The chunk-1 file of P = 2, resumed at P = 1 and at P = 4.
    for layout in ([[0]], [list(range(4))]):
        g = _groups(world, layout)
        if g is None:
            continue
        copy = os.path.join(out, f"ckpt_from_P2_at_P{g.size}.npz")
        if g.rank == 0:
            shutil.copyfile(chunk1, copy)
        g.barrier()
        res = gather_result(runner(g, copy).run(list(CKPT_SEEDS)), g)
        if g.rank == 0:
            _save(os.path.join(out, f"checkpoint_from_P2_P{g.size}.npz"), result_arrays(res))


def job_wide(world, out, params):
    """Each run of params["runs"] (name, model, seeds, config: SMCConfig
    keywords) over the whole gang, timed."""
    for run in params["runs"]:
        _wide_run(world, out, run)


def _wide_run(world, out, run):
    from ..config import SMCConfig
    from ..models import get_model
    from ..ops.nuts_cuda import nuts_tree
    from ..sampler import resolve_compaction, run_smc_batched
    from ..utils.timing import device_ms

    g = world
    g.timed = True
    g.stats.update(calls=0, bytes_in=0, seconds=0.0)
    cfg = SMCConfig(**run["config"])
    model = get_model(run.get("model", "arma")).to(g.device)
    seeds = list(run.get("seeds", [0]))
    launches0, stages0 = nuts_tree.launches, nuts_tree.stage_launches
    g.barrier()
    if g.device.type == "cuda":
        torch.cuda.synchronize(g.device)
    t0 = time.perf_counter()
    res = run_smc_batched(model, cfg, seeds, g.device, group=g)
    res.mean_estimate.cpu()
    wall = time.perf_counter() - t0
    stats = dict(g.stats)
    launches = nuts_tree.launches - launches0
    stages = nuts_tree.stage_launches - stages0
    n_local = g.local_count(cfg.n_particles)
    splits = resolve_compaction(cfg, model, len(seeds) * n_local)
    # Each rank's kernel on its final shard, one rank at a time: 20 launches
    # queued back to back (utils.timing.device_ms).
    kernel_ms = None
    for r in range(g.size):
        g.barrier()
        if r == g.rank and g.device.type == "cuda":
            seed_t = torch.zeros(len(seeds), dtype=torch.int32, device=g.device)
            kernel_ms = device_ms(lambda: nuts_tree(
                model, res.x_final, seed_t, cfg.step_size, 1.0, None, cfg.max_tree_depth,
                compaction=splits, particle_map=g.particle_map))
    g.timed = False
    info = {"rank": g.rank, "size": g.size, "wall_s": wall, "launches": launches,
            "stage_launches": stages, "splits": list(splits), "lanes": len(seeds) * n_local,
            "resampled": int(res.resampled.sum()),
            "collective_calls": stats["calls"], "collective_bytes_in": stats["bytes_in"],
            "collective_s": stats["seconds"], "kernel_ms": kernel_ms}
    infos = [None] * g.size
    torch.distributed.all_gather_object(infos, info, group=g.group)
    res = gather_result(res, g)
    if g.rank == 0:
        name = f"wide_{run['name']}_P{g.size}"
        _save(os.path.join(out, name + ".npz"), result_arrays(res))
        with open(os.path.join(out, name + ".json"), "w") as f:
            json.dump(infos, f)


def launch(out, n_ranks, jobs, params=None, backend="gloo", device="cpu", timeout=600.0,
           env=None):
    """Run `jobs` on a gang of n_ranks processes of this module (a
    `Supervisor` without restarts: a rank's failure fails the gang), their
    results under `out`; returns the Incarnation, and raises with the ranks'
    output if any rank fails."""
    from .elastic import Supervisor

    def make_cmd(pid, coordinator, attempt):
        return [sys.executable, "-m", "smcnuts_torch.parallel.gang", str(out), *jobs,
                "--coordinator", coordinator, "--num-processes", str(n_ranks),
                "--process-id", str(pid), "--backend", backend, "--device", device,
                "--params", json.dumps(params or {})]

    sup = Supervisor(make_cmd, n_ranks, env=env, max_restarts=0,
                     cwd=os.path.dirname(os.path.dirname(os.path.dirname(
                         os.path.abspath(__file__)))))
    try:
        return sup.run(timeout=timeout)
    except RuntimeError as e:
        outputs = "\n".join(f"--- rank {i}:\n{o[-4000:]}"
                            for i, o in enumerate(sup.incarnations[-1].outputs))
        raise RuntimeError(f"{e}\n{outputs}") from None


JOBS = {"ops": job_ops, "runs": job_runs, "steps": job_steps, "run_axes": job_run_axes,
        "checkpoint": job_checkpoint, "wide": job_wide}


def main(argv=None):
    p = argparse.ArgumentParser(prog="smcnuts_torch.parallel.gang")
    p.add_argument("out")
    p.add_argument("jobs", nargs="+", choices=sorted(JOBS))
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--backend", default="gloo", choices=BACKENDS)
    p.add_argument("--device", default="cpu")
    p.add_argument("--params", default="{}", help="a JSON object for the jobs")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cpu":
        torch.set_num_threads(1)
    initialize(args.coordinator, args.num_processes, args.process_id, args.backend)
    try:
        world = particle_group(device=args.device)
        params = json.loads(args.params)
        for job in args.jobs:
            JOBS[job](world, args.out, params)
            world.barrier()
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
