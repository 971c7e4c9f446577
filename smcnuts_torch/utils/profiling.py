"""Profiling: where an SMC iteration's time goes (the JAX package's
`utils/profiling.py`, on torch.profiler and CUDA events).

- `trace(log_dir)`: torch.profiler around a block, written as a Chrome trace.
- `phase_timings(model, cfg)`: seconds an iteration of each SMC phase (the
  NUTS proposal, normalise + ESS + resample, the reweight's model
  evaluations, the Gaussian L-kernel density, the tempering bisection), each
  timed over `iters` calls back to back on one run's state after init_state:
  CUDA events on the card, `time.perf_counter` on the CPU. On the card a
  phase's time includes the host's launches where the host, not the device,
  is what it waits on, as it does in the loop.
- `profile_iterations(model, cfg, seeds)`: the first iterations of the loop
  itself (`smc_step` as `run_smc_batched` drives it), timed with CUDA
  events, then again under torch.profiler: device kernels an iteration,
  device busy time, idle share, and the time of the port's own kernels.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

# The port's own kernels, by the name of their CUDA function.
OWN_KERNELS = ("nuts_tree_kernel", "arma_ll_vg_kernel")


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block, the host's activity and, where a CUDA
    device exists, the device's; writes `log_dir/trace.json` (Chrome trace
    format, chrome://tracing or Perfetto) and yields the profiler, whose
    `key_averages()` sums the time by operator and kernel."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _seconds_a_call(fn, device, iters, repeats):
    """Best of `repeats` of the time of `iters` calls fn(i) back to back,
    over iters: CUDA events on a CUDA device, the host clock otherwise."""
    fn(0)
    best = float("inf")
    for _ in range(repeats):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(iters):
                fn(i)
            end.record()
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for i in range(iters):
                fn(i)
            seconds = time.perf_counter() - t0
        best = min(best, seconds / iters)
    return best


def phase_timings(model, cfg, seed=0, repeats=3, iters=20, device="cuda") -> dict:
    """{phase: seconds an iteration} for one run of N = cfg.n_particles at
    the state init_state gives it: "propose_nuts" (the whole-tree CUDA
    kernel where the backend resolves to it, else the eager tree),
    "normalise_resample", "reweight_target_evals", "gaussian_lkernel" and
    "temper_bisect". The device defaults to the card, as everywhere in the
    package."""
    from ..ops.draws import PHILOX
    from ..ops.lkernels import gaussian_lkernel_logpdf
    from ..ops.nuts_cuda import nuts_tree, nuts_tree_plain
    from ..ops.resampling import resample_if_required
    from ..ops.tempering import next_temperature
    from ..ops.weights import ess, normalise_weights
    from ..sampler import init_state, resolve_backend, resolve_device

    device = resolve_device(device)
    backend = resolve_backend(cfg, device, model)
    model = model.to(device)
    carry = init_state(model, cfg, [seed], device)
    x, logw = carry.x, carry.logw
    n = cfg.n_particles
    g = torch.Generator(device=device).manual_seed(seed)
    r = torch.randn(x.shape, generator=g, device=device, dtype=x.dtype)
    uniforms = torch.rand(logw.shape, generator=g, device=device, dtype=x.dtype)
    loglik = model.loglik(x[0])[None]
    tree_args = (carry.step_size, carry.phi, carry.inv_mass, cfg.max_tree_depth, PHILOX)

    def propose(i):
        if backend == "cuda":
            return nuts_tree(model, x, i, *tree_args)
        return nuts_tree_plain(model, x, i, *tree_args, block_size=cfg.eager_block_size)

    def normalise_resample(i):
        wn, ll = normalise_weights(logw)
        return resample_if_required(uniforms, x, logw, wn, ll, ess(wn),
                                    cfg.ess_threshold_frac, cfg.resampling)

    phases = {
        "propose_nuts": propose,
        "normalise_resample": normalise_resample,
        "reweight_target_evals": lambda i: model.logp(x[0], 1.0),
        "gaussian_lkernel": lambda i: gaussian_lkernel_logpdf(r, x),
        "temper_bisect": lambda i: next_temperature(loglik, 0.0, n),
    }
    return {name: _seconds_a_call(fn, device, iters, repeats)
            for name, fn in phases.items()}


def profile_iterations(model, cfg, seeds, iterations=20, momentum_proposal=None,
                       device="cuda"):
    """Where an iteration's time goes on the card: the first `iterations`
    iterations of the SMC loop of B = len(seeds) runs (`smc_step` on the
    state of `init_state`, with the draws of `iteration_draws`, as
    `run_smc_batched` drives it), once timed with CUDA events, then again
    under torch.profiler (device activity only; the profiler slows the host,
    so the wall time is the first pass's).

    Returns None when torch.profiler recorded no device event, else a dict:
    "iterations", "ms" (an iteration, CUDA events, unprofiled), "kernels"
    (device kernels an iteration), "busy_ms" (device busy time an
    iteration), "idle_share" (1 - busy / unprofiled time) and "own": for each
    of OWN_KERNELS that ran, (launches, ms, share of the device time), the
    first two an iteration."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..ops.draws import PHILOX
    from ..sampler import (
        init_state, iteration_draws, resolve_backend, resolve_device, smc_step,
        uses_fused_path)
    from .timing import CudaTimer

    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError(f"profile_iterations times the card; got device {device}")
    k = min(iterations, cfg.n_iterations)
    model = model.to(device)
    start = init_state(model, cfg, seeds, device)
    seeds_t = torch.tensor(seeds, dtype=torch.int64, device=device)
    backend = resolve_backend(cfg, device, model)
    step_draws = iteration_draws(cfg, seeds_t, range(k), cfg.n_particles, model.dim,
                                 start.x.dtype, uses_fused_path(cfg, momentum_proposal))

    def loop():
        carry = start
        for i in range(k):
            carry, _ = smc_step(model, cfg, carry, backend=backend, draws=PHILOX,
                                momentum_proposal=momentum_proposal,
                                **{name: v[i] for name, v in step_draws.items()})
        torch.cuda.synchronize()

    loop()
    with CudaTimer() as t:
        loop()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        loop()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernels = [e for e in events if not e.name.startswith(("Memcpy", "Memset"))]
    if not kernels:
        return None
    busy_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
    own = {}
    for name in OWN_KERNELS:
        mine = [e for e in kernels if name in e.name]
        if mine:
            ms = sum(e.time_range.elapsed_us() for e in mine) / 1e3
            own[name] = (len(mine) / k, ms / k, ms / busy_ms)
    return {"iterations": k, "ms": t.ms / k, "kernels": len(kernels) / k,
            "busy_ms": busy_ms / k, "idle_share": 1.0 - busy_ms / t.ms, "own": own}
