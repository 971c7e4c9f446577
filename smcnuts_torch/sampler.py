"""SMC sampler: the JAX package's `sampler.py`, on its fused and its unfused
proposal paths, for B independent runs at once, with the three L-kernel
strategies and adaptive tempering.

One iteration, in the reference's order (reference smc_sampler.py:109-140),
for every run:

    1. record the phi used this iteration
    2. normalise weights (masked logsumexp) -> wn, running log-likelihood
    3. estimates at index k from the *entering* weights (the asymptotic
       strategy without saved history: the tempered-recycling estimate)
    4. ESS; 5. resample if ESS < N/2 (multinomial or systematic), before the
       proposal
    6. whole-tree NUTS proposal at temperature phi, as one kernel or staged
       with lane compaction (cfg.compaction), or on the eager tree in blocks
       (cfg.eager_block_size). Fused path: momenta drawn inside, the
       asymptotic accept-reject in its epilogue. Unfused path (where the JAX
       package's Pallas backend takes it: fused_epilogue=False, or a custom
       momentum proposal without mass adaptation): momenta drawn outside
       (the momentum proposal, or N(0, M) under mass adaptation) and handed
       to the tree, the accept-reject outside on the tree's cached densities
    7. with tempering, the next temperature from the proposed positions by
       ESS bisection, on the log-likelihood recovered from the tree's cached
       density
    8. reweight. Asymptotic: logw += (phi' - phi) loglik on the PRE-proposal
       positions. Otherwise logw += logp1' - logp1 + (L - q): forwards
       L-kernel L - q = delta_h - (logp' - logp0), which without tempering
       collapses the increment to delta_h; Gaussian L-kernel L from the
       population and q(r0) from ke0. Unfused: L - q from the momentum
       density, L = q(-r') for the forwards L-kernel
    9. acceptance = share of particles that moved in EVERY dimension
   10. adaptation, when configured: dual averaging of the step size on the
       mean accept statistic (frozen at the averaged iterate after
       round(adapt_warmup_frac * K) iterations) and the diagonal inverse mass
       from the reweighted particles (JAX sampler.py:489-517)

Quirks kept from the reference: acceptance at index K is 0; phi[K] is the
last temperature computed; the asymptotic strategy overwrites ALL estimates
with the tempered-recycling estimates (smc_sampler.py:152-153), from the
saved history after the loop or, with save_history=False, inside it: the two
draw the same uniforms and agree to the bit.

Batching: `run_smc_batched(model, cfg, seeds, device)` steps B runs through
one NUTS launch per iteration (B*N threads); weights, ESS, resampling and
adaptation are per run, as tensor ops over the run axis. It is the
counterpart of `jax.vmap(run_smc)` over keys, and `run_smc` is its B = 1
case. Every random number of run b comes from b's own seed: the initial
particles from a `torch.Generator` seeded with it, and per iteration the
resampling uniforms and the tree's seed from its Philox stream
(`ops.draws.run_draws`), and on the unfused path the momenta's standard
normals and the accept-reject uniforms (`momentum_draws`, `accept_draws`).
Every sum over particles takes the fixed order of `ops.reduce`. So run b of a
batch equals, bit for bit, a run alone with seed seeds[b]; what a model
computes outside the tree (logprior, loglik) is evaluated one run at a time
for the same reason. The K loop does no host sync: the resample decision and
the temperature bisection's short-circuit are `torch.where`s, the guard of
the recovered log-likelihood evaluates both sides and selects per run, and
the diagnostics stay on the device until `finalize`. (The Gaussian
L-kernel's two small factorisations are library calls, made per run;
`torch.linalg.pinv` checks its status on the host.)

Sharding: every entry takes `group`, a `parallel.sharding.ParticleGroup`
(the JAX package's `mesh=`). Each rank then holds the particles rank,
rank + P, ... of every run: init_state draws each run's global x0 from its
generator and keeps the rank's rows, the per-iteration draws are the global
ones at the rank's particles, the trees take the shard's particle map, the
sums over particles continue over the ranks in a fixed order, and
resampling exchanges ancestors (`ops.resampling`). Every diagnostic is the
same on every rank and the run equals the unsharded run to the bit; the
result's per-particle fields hold the rank's shard
(`parallel.sharding.gather_result` assembles them).
"""

from __future__ import annotations

import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from .config import SMCConfig
from .models.base import ADAPTED_HINT_TARGET, COMPACTION_MIN_LANES, LOG_SQRT_2PI, CallableModel
from .ops.adaptation import (
    DualAveragingState,
    da_init,
    da_update,
    mass_matrix_from_particles,
    mass_momentum_logpdf,
    mass_momentum_rvs,
)
from .ops.draws import PHILOX, accept_draws, momentum_draws, recycle_draws, run_draws
from .ops.lkernels import forward_lkernel_logpdf, gaussian_lkernel_logpdf
from .ops.moments import estimate as constrained_estimate
from .ops.nuts import hmc_accept_reject_cached
from .ops.nuts_cuda import nuts_tree, nuts_tree_plain
from .ops.reduce import row_mean, row_sum
from .ops.resampling import multinomial_take_rows, resample_if_required
from .ops.tempering import next_temperature
from .ops.weights import ess as compute_ess
from .ops.weights import normalise_weights
from .proposals import DiagNormalProposal

# Bound on the elements of one `run_draws` block (iterations x runs x N).
_DRAW_BLOCK = 1 << 22


class SMCCarry(NamedTuple):
    """The state of B runs between iterations."""

    x: torch.Tensor  # (B, N, D) unconstrained positions
    logw: torch.Tensor  # (B, N) log weights
    phi: torch.Tensor  # (B,) temperature for the next proposal
    step_size: torch.Tensor  # (B,)
    inv_mass: torch.Tensor  # (B, D) diagonal inverse mass
    da: DualAveragingState  # fields (B,)
    # Asymptotic strategy only (None otherwise): the untempered
    # log-likelihood of x, which the tempered-recycling estimates need.
    loglik: torch.Tensor | None = None  # (B, N)


class SMCResult(NamedTuple):
    """Per-iteration series of length K+1 (reference smc_sampler.py:66-85),
    as tensors on the run's device. From `run_smc_batched` every field leads
    with the run axis B; from `run_smc` it has none."""

    mean_estimate: torch.Tensor  # (K+1, CD)
    variance_estimate: torch.Tensor  # (K+1, CD)
    ess: torch.Tensor  # (K+1,)
    log_likelihood: torch.Tensor  # (K+1,)
    phi: torch.Tensor  # (K+1,)
    acceptance_rate: torch.Tensor  # (K+1,)
    resampled: torch.Tensor  # (K+1,) bool
    step_size: torch.Tensor  # (K+1,) the step size after each iteration's adaptation
    x_saved: torch.Tensor | None  # (K+1, N, D) if cfg.save_history
    logw_saved: torch.Tensor | None  # (K+1, N)
    x_final: torch.Tensor  # (N, D)
    logw_final: torch.Tensor  # (N,)
    tree_depth: torch.Tensor  # (K+1,) population means; index K repeats K-1
    tree_leapfrogs: torch.Tensor  # (K+1,)
    accept_stat: torch.Tensor  # (K+1,)


_SERIES = (
    "phi", "log_likelihood", "ess", "acceptance", "resampled", "step_size",
    "tree_depth", "tree_leapfrogs", "accept_stat", "mean", "var",
)


def resolve_backend(cfg: SMCConfig, device: torch.device, model=None) -> str:
    """The proposal backend: cuda (the kernel) or eager (the plain tree).

    "auto" picks cuda on a CUDA device and eager on the CPU, and eager for a
    `CallableModel` without a generated in-kernel model, which "cuda" refuses
    (as the JAX package's pallas backend refuses a model without a
    tile_model, `smcnuts_tpu/sampler.py:246-250`). The kernels compute in
    float32, as the JAX package's Pallas kernels do, so a float64 run takes
    the eager tree on any device (the JAX package's float64 path is its XLA
    backend) and "cuda" refuses it."""
    no_kernel = isinstance(model, CallableModel) and model.tile_model is None
    backend = cfg.nuts_backend
    if backend == "auto":
        backend = ("cuda" if device.type == "cuda" and not no_kernel
                   and cfg.dtype == "float32" else "eager")
    if backend == "cuda" and device.type != "cuda":
        raise ValueError(f"nuts_backend='cuda' needs a CUDA device, got {device}")
    if backend == "cuda" and no_kernel:
        raise ValueError(
            f"model '{model.name}' has no tile_model; the cuda NUTS backend is "
            "unavailable for it: run it on nuts_backend='eager' (autograd), or "
            "give it a generated tile_model (ops.generated.tile_model_from_logp)")
    if backend == "cuda" and cfg.dtype == "float64":
        raise NotImplementedError(
            "the CUDA NUTS kernels run float32 only; float64 runs on "
            "nuts_backend='eager' (float64 kernels: ROADMAP Queue 2 item 1)"
        )
    return backend


def resolve_device(device) -> torch.device:
    """The device of a run. The entry points default to the card: asking
    for a CUDA device where there is none raises, it never carries on on the
    CPU. The CPU is used only when the caller names it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device '{device}' was asked for (the default) but no CUDA device "
            "is available; pass device='cpu' (--device cpu) to run on the CPU"
        )
    return device


def resolve_compaction(cfg: SMCConfig, model, n_lanes: int) -> tuple:
    """The splits of the staged NUTS dispatch for this configuration and
    `n_lanes` = B x N trees per dispatch: an explicit tuple as given, None or
    () none, and "auto" the model's hint.

    A hint is a measurement at one regime of tree depths and widths.
    `compaction_hint` was measured at a fixed step size.
    `compaction_hint_adapted` was measured under step-size adaptation at
    target_accept = ADAPTED_HINT_TARGET, and another target settles on
    another step size and other depths, so there "auto" takes no hint of
    either kind and runs the single kernel. Either hint pays only past the
    model's `compaction_min_lanes` (COMPACTION_MIN_LANES, one block of the
    one-thread-a-tree kernel on every SM, where it names none): up to there
    no warp waits for another and a dispatch lasts as long as its deepest
    tree, staged or not, so "auto" runs the single kernel there too."""
    if cfg.compaction != "auto":
        return tuple(cfg.compaction or ())
    if n_lanes <= getattr(model, "compaction_min_lanes", COMPACTION_MIN_LANES):
        return ()
    if not cfg.adapt_step_size:
        return tuple(getattr(model, "compaction_hint", ()))
    if cfg.target_accept == ADAPTED_HINT_TARGET:
        return tuple(getattr(model, "compaction_hint_adapted", ()))
    return ()


def _is_standard_momentum(momentum_proposal) -> bool:
    """True for the standard N(0, I) momentum proposal (None is that
    default): the distribution the tree's own momentum draw implements when
    inv_mass is ones. Checked as the JAX package checks it."""
    if momentum_proposal is None:
        return True
    if not isinstance(momentum_proposal, DiagNormalProposal):
        return False
    mean_ok = momentum_proposal.mean is None or not np.any(
        np.asarray(momentum_proposal.mean))
    var_ok = momentum_proposal.var is None or np.allclose(
        np.asarray(momentum_proposal.var), 1.0)
    return bool(mean_ok and var_ok)


def uses_fused_path(cfg: SMCConfig, momentum_proposal=None) -> bool:
    """Whether the proposal runs fused (momenta drawn inside the tree): only
    where the JAX package's Pallas backend fuses, with fused_epilogue and
    either mass adaptation (inv_mass is the live state) or the standard
    momentum proposal. On both backends (`config.py` says why)."""
    return cfg.fused_epilogue and (
        cfg.adapt_mass_matrix or _is_standard_momentum(momentum_proposal))


def _acceptance_metric(x_new, x_old, group=None):
    """Per run, the share of particles whose position changed in EVERY
    dimension (reference smc_sampler.py:97)."""
    return row_mean(torch.all(x_new != x_old, dim=-1).to(x_new.dtype), group)


def iteration_draws(cfg: SMCConfig, seeds, iterations, n, dim, dtype,
                    fused=True, index=None) -> dict:
    """The per-iteration draws of B runs for a range of iterations, from each
    run's own stream, keyed by the `smc_step` argument each feeds, every
    value leading with the iteration axis: the resampling uniforms, the tree
    seeds, with the asymptotic strategy's streaming estimates the recycling
    uniforms, and on the unfused path the momenta's standard normals and
    (asymptotic strategy) the accept-reject uniforms. seeds: (B,) int64.
    index: the global indices (n,) of a shard's particles (None: 0..n-1);
    a shard's systematic resampling also gets the shared uniform, the draw
    of global particle 0."""
    uniforms, tree_seed = run_draws(seeds, iterations, n, dtype, index)
    out = {"uniforms": uniforms, "tree_seed": tree_seed}
    if index is not None and cfg.resampling == "systematic":
        first = torch.zeros(1, dtype=torch.int64, device=seeds.device)
        out["shared_uniform"] = run_draws(seeds, iterations, 1, dtype, first)[0][..., 0]
    if cfg.is_asymptotic and not cfg.save_history:
        out["recycle_uniforms"] = recycle_draws(seeds, iterations, n, dtype, index)
    if not fused:
        out["momentum_normals"] = momentum_draws(seeds, iterations, n, dim, dtype, index)
        if cfg.is_asymptotic:
            out["accept_uniforms"] = accept_draws(seeds, iterations, n, dtype, index)
    return out


def _per_run(fn, x):
    """fn (a model's logprior or loglik, (N, D) -> (N,)) on each run of x
    (B, N, D) alone: a model's own sums and products may pick their order
    from the shape, and a run must not depend on the runs beside it."""
    return torch.stack([fn(x[b]) for b in range(x.shape[0])]).to(x.dtype)


def _recover_loglik(model, phi, logp_at_phi, logprior, positions, min_phi):
    """The untempered log-likelihood from a tree-cached tempered log-density,
    loglik = (logp(x, phi) - logprior(x)) / phi (phi > 0 always: tempering
    starts from a bisection result in (0, 1]).

    The division amplifies the float32 rounding of the cached density by
    1 / phi (300x at the first tempered phi ~ 3e-3 seen in practice), so for
    the runs with phi < min_phi the value is a direct `model.loglik`
    instead. Both sides are evaluated and selected per run, with no host
    sync, which is what the JAX package's `lax.cond` lowers to under `vmap`.
    Only the tempered non-asymptotic path asks for the guard: there the value
    enters the phi = 1 reweight unscaled, while the asymptotic path consumes
    it through phi-scaled differences where the amplification cancels."""
    cached = (logp_at_phi - logprior) / phi[:, None]
    if min_phi <= 0.0:
        return cached
    direct = _per_run(model.loglik, positions)
    return torch.where((phi < min_phi)[:, None], direct, cached)


def _recycled_estimate(model, uniforms, x, logw, loglik, phi_k, group=None):
    """One tempered-recycling estimate per run (reference
    estimate_from_tempered.py:24-55): a fresh multinomial resample by the
    weights, which target pi_{phi_k}, then the importance correction to pi by
    (1 - phi_k) loglik. x (..., N, D); uniforms, logw and loglik (..., N);
    phi_k (...). The loop and the saved-history pass share it."""
    wn, _ = normalise_weights(logw, group)
    x_r, loglik_r = multinomial_take_rows(wn, uniforms, [x, loglik], group)
    wn_corr, _ = normalise_weights((1.0 - phi_k)[..., None] * loglik_r, group)
    return constrained_estimate(model, x_r, wn_corr, group)


def init_state(model, cfg: SMCConfig, seeds, device,
               sample_proposal=None, group=None) -> SMCCarry:
    """x0 ~ sample proposal; phi0 = 1, or with tempering a full ESS bisection
    on the prior draws from phi_old = 0 (reference samples.py:82);
    logw0 = logp(x0, phi0) - q0(x0) (samples.py:63-88); one run per seed.
    Each run draws from a generator seeded with its own seed and its
    densities are evaluated alone, so it does not depend on the runs beside
    it; the bisection is one call in which every run has its own interval.
    With a group each run still draws its N global particles, and the rank
    keeps its shard of them."""
    dtype = getattr(torch, cfg.dtype)
    device = torch.device(device)
    if sample_proposal is None:
        sample_proposal = DiagNormalProposal(model.dim)
    generators = [torch.Generator(device=device).manual_seed(int(s)) for s in seeds]
    xs = [sample_proposal.rvs(g, cfg.n_particles, dtype=dtype) for g in generators]
    if group is not None:
        xs = [group.take_shard(x0, dim=0) for x0 in xs]
    loglik = None
    if cfg.tempering or cfg.is_asymptotic:
        loglik = torch.stack([model.loglik(x0).to(dtype) for x0 in xs])
    if cfg.tempering:
        # One bisection for all runs: each run's interval is its own.
        phi = next_temperature(loglik, 0.0, cfg.n_particles,
                               alpha=cfg.tempering_alpha, group=group)
    else:
        phi = torch.ones(len(xs), dtype=dtype, device=device)
    logws = [(model.logp(x0, phi[b]) - sample_proposal.logpdf(x0)).to(dtype)
             for b, x0 in enumerate(xs)]
    B = len(xs)
    step_size = torch.full((B,), cfg.step_size, dtype=dtype, device=device)
    return SMCCarry(
        x=torch.stack(xs),
        logw=torch.stack(logws),
        phi=phi,
        step_size=step_size,
        inv_mass=torch.ones((B, model.dim), dtype=dtype, device=device),
        da=da_init(step_size),
        loglik=loglik if cfg.is_asymptotic else None,
    )


def smc_step(model, cfg: SMCConfig, carry: SMCCarry, uniforms, tree_seed,
             backend: str, draws: str = PHILOX, recycle_uniforms=None,
             momentum_proposal=None, momentum_normals=None,
             accept_uniforms=None, group=None, shared_uniform=None):
    """One SMC iteration of B runs; returns (next carry, diagnostics of this
    one, each with a leading run axis).

    uniforms (B, N) in [0, 1) are the resampling draws and tree_seed (B,)
    int32 the seeds of the runs' trees (`ops.draws.run_draws`; a test hands
    in the JAX package's uniforms); `draws` picks the tree's draw source.
    recycle_uniforms (B, N) are the draws of this iteration's
    tempered-recycling estimate (`ops.draws.recycle_draws`), needed by the
    asymptotic strategy with save_history=False only. On the unfused path
    (`uses_fused_path` false) momentum_normals (B, N, D) are the standard
    normals of the momenta and accept_uniforms (B, N) in [0, 1) those of the
    asymptotic strategy's accept-reject (`iteration_draws`; a test hands in
    the JAX package's k_mom and k_acc draws); momentum_proposal None is the
    standard normal. With a particle group every per-particle argument holds
    the rank's shard (the draws at its particles' global indices), and the
    systematic scheme takes shared_uniform (B,), the draw of global particle
    0 (`iteration_draws`)."""
    phi = carry.phi
    n = carry.x.shape[1] * (1 if group is None else group.size)
    asymptotic = cfg.is_asymptotic
    wn, log_likelihood = normalise_weights(carry.logw, group)
    if asymptotic and not cfg.save_history:
        # The entering (x, logw, loglik, phi) are what the saved-history pass
        # reads at index k, and the uniforms are those it draws there.
        mean_k, var_k = _recycled_estimate(
            model, recycle_uniforms, carry.x, carry.logw, carry.loglik, phi, group)
    else:
        mean_k, var_k = constrained_estimate(model, carry.x, wn, group)
    ess_k = compute_ess(wn, group)
    x_r, logw_r, did_resample = resample_if_required(
        uniforms, carry.x, carry.logw, wn, log_likelihood, ess_k,
        cfg.ess_threshold_frac, cfg.resampling, group, shared_uniform,
    )

    # With acc_rej the kernel's epilogue ran the asymptotic strategy's
    # accept-reject: x_new, r_new and logp_prop are the state after it.
    fused = uses_fused_path(cfg, momentum_proposal)
    r = None
    if not fused:
        # The momenta, drawn outside the tree from N(0, M) under mass
        # adaptation (the kinetic energy's distribution), else from the
        # momentum proposal; the reweight uses the same density.
        if cfg.adapt_mass_matrix:
            r = mass_momentum_rvs(momentum_normals, carry.inv_mass)

            def momentum_logpdf(rr):
                return mass_momentum_logpdf(rr, carry.inv_mass)
        else:
            proposal = momentum_proposal or DiagNormalProposal(model.dim)
            r = proposal.from_normals(momentum_normals)

            def momentum_logpdf(rr):
                return _per_run(proposal.logpdf, rr)
    tree_args = (model, x_r, tree_seed, carry.step_size, phi, carry.inv_mass,
                 cfg.max_tree_depth, draws)
    particle_map = (0, 1) if group is None else group.particle_map
    if backend == "cuda":
        # "auto" decides at this rank's own lane count.
        x_new, r_new, st = nuts_tree(
            *tree_args, r=r, acc_rej=asymptotic and fused,
            compaction=resolve_compaction(cfg, model, x_r.shape[0] * x_r.shape[1]),
            particle_map=particle_map)
    else:
        # "auto" is the kernel's choice, measured on its dispatch; the eager
        # tree stages only at splits the caller names, as the JAX package's
        # XLA backend never compacts.
        x_new, r_new, st = nuts_tree_plain(
            *tree_args, r=r, acc_rej=asymptotic and fused,
            compaction=() if cfg.compaction == "auto" else cfg.compaction,
            block_size=cfg.eager_block_size, particle_map=particle_map)
    logp_prop = st["logp_prop"]
    if asymptotic and not fused:
        # The accept-reject that makes the move pi_phi-invariant, on the
        # densities the tree cached (JAX sampler.py:378-390).
        x_new, r_new, accepted = hmc_accept_reject_cached(
            st["logp0"], logp_prop, x_r, x_new, r, r_new, accept_uniforms,
            carry.inv_mass)
        logp_prop = torch.where(accepted, logp_prop, st["logp0"])

    # The next temperature, from the proposed positions. The untempered
    # log-likelihood at both endpoints comes from the tree's cached densities
    # and an O(D) logprior: no model evaluation outside the tree, but for the
    # guarded recovery on the tempered non-asymptotic path.
    tempered = cfg.tempering or asymptotic
    guard = cfg.cached_loglik_min_phi if cfg.tempering and not asymptotic else 0.0
    if tempered:
        logprior_new = _per_run(model.logprior, x_new)
        logprior_old = _per_run(model.logprior, x_r)
        loglik_new = _recover_loglik(model, phi, logp_prop, logprior_new,
                                     x_new, guard)
    if cfg.tempering:
        phi_next = next_temperature(loglik_new, phi, n, alpha=cfg.tempering_alpha,
                                    group=group)
    else:
        phi_next = torch.ones_like(phi)

    if asymptotic:
        # The move leaves pi_phi invariant and carries no weight change; only
        # the temperature increment on the PRE-proposal positions does
        # (reference samples.py:169-180).
        loglik_old = _recover_loglik(model, phi, st["logp0"], logprior_old,
                                     x_r, 0.0)
        logw_new = logw_r + (phi_next - phi)[:, None] * loglik_old
    else:
        # The momentum-density difference L(-r'|x') - q(r).
        if not fused:
            if cfg.lkernel == "forwardsLKernel":
                lk = forward_lkernel_logpdf(momentum_logpdf, r_new)
            else:
                lk = gaussian_lkernel_logpdf(r_new, x_new, group)
            lk_minus_q = lk - momentum_logpdf(r)
        elif cfg.lkernel == "forwardsLKernel":
            # From the fused outputs: the N(0, M) constants cancel and
            # ke(r0) - ke(r') = delta_h - (logp' - logp0).
            lk_minus_q = st["delta_h"] - (st["logp_prop"] - st["logp0"])
        else:
            # Gaussian L-kernel, q(r0) = -ke0 + 0.5 sum log inv_mass - D log sqrt(2 pi).
            q_r = (-st["ke0"]
                   + (0.5 * row_sum(torch.log(carry.inv_mass)))[:, None]
                   - model.dim * LOG_SQRT_2PI)
            lk_minus_q = gaussian_lkernel_logpdf(r_new, x_new, group) - q_r
        if not cfg.tempering:
            # phi is 1, so the tree's cached endpoint densities are the
            # phi = 1 values (forwards, fused: the increment collapses to delta_h).
            logp_new_1, logp_old_1 = st["logp_prop"], st["logp0"]
        else:
            logp_new_1 = logprior_new + loglik_new
            logp_old_1 = logprior_old + _recover_loglik(
                model, phi, st["logp0"], logprior_old, x_r, guard)
        logw_new = logw_r + logp_new_1 - logp_old_1 + lk_minus_q

    # Adaptation (JAX sampler.py:489-517). The warmup freeze uses da.count
    # as the iteration counter, as the JAX package does.
    accept_stat = row_mean(st["accept_stat"], group)
    step_size, da = carry.step_size, carry.da
    if cfg.adapt_step_size:
        warmup_iters = max(1, round(cfg.adapt_warmup_frac * cfg.n_iterations))
        in_warmup = carry.da.count < warmup_iters
        da_new = da_update(carry.da, accept_stat, target=cfg.target_accept)
        da = DualAveragingState(*(
            torch.where(in_warmup, new, old) for new, old in zip(da_new, carry.da)
        ))
        step_size = torch.exp(
            torch.where(in_warmup, da.log_step, da.log_step_avg)
        )
    inv_mass = carry.inv_mass
    if cfg.adapt_mass_matrix:
        wn_new, _ = normalise_weights(logw_new, group)
        inv_mass = mass_matrix_from_particles(x_new, wn_new, carry.inv_mass, group=group)

    diag = {
        "phi": phi,
        "log_likelihood": log_likelihood,
        "ess": ess_k,
        # The tree's "moved" is the same flag, but before an accept-reject
        # made outside it.
        "acceptance": (_acceptance_metric(x_new, x_r, group) if asymptotic and not fused
                       else row_mean(st["moved"], group)),
        "resampled": did_resample,
        "step_size": step_size,
        "tree_depth": row_mean(st["depth"], group),
        "tree_leapfrogs": row_mean(st["leapfrogs"], group),
        "accept_stat": accept_stat,
        "mean": mean_k,
        "var": var_k,
    }
    new_carry = SMCCarry(
        x=x_new, logw=logw_new, phi=phi_next,
        step_size=step_size, inv_mass=inv_mass, da=da,
        loglik=loglik_new if asymptotic else None,
    )
    return new_carry, diag


def finalize(model, cfg: SMCConfig, carry: SMCCarry, diags: list,
             x_hist=None, logw_hist=None, loglik_hist=None,
             recycle_uniforms=None, group=None) -> SMCResult:
    """Append the final half-iteration at index K (smc_sampler.py:143-149);
    every series is (B, K+1, ...).

    The asymptotic strategy replaces ALL estimates by the tempered-recycling
    ones (smc_sampler.py:152-153). With the history saved (x_hist, logw_hist
    and loglik_hist, lists of K+1 entries) they are made here in one pass
    over the K+1 saved states, from recycle_uniforms (B, K+1, N). Without it
    the loop made those of 0..K-1 and only index K, the final state, is made
    here, from recycle_uniforms (B, N). The uniforms of index k are the same
    either way (`ops.draws.recycle_draws`), and so are the estimates."""
    wn_f, loglik_f = normalise_weights(carry.logw, group)
    s = {k: torch.stack([d[k] for d in diags], dim=1) for k in _SERIES}

    def cat(seq, last):
        return torch.cat([seq, last[:, None].to(seq.dtype)], dim=1)

    phi_series = cat(s["phi"], carry.phi)
    if cfg.is_asymptotic and cfg.save_history:
        mean_est, var_est = _recycled_estimate(
            model, recycle_uniforms, torch.stack(x_hist, dim=1),
            torch.stack(logw_hist, dim=1), torch.stack(loglik_hist, dim=1),
            phi_series, group,
        )
    else:
        if cfg.is_asymptotic:
            mean_f, var_f = _recycled_estimate(
                model, recycle_uniforms, carry.x, carry.logw, carry.loglik,
                carry.phi, group)
        else:
            mean_f, var_f = constrained_estimate(model, carry.x, wn_f, group)
        mean_est, var_est = cat(s["mean"], mean_f), cat(s["var"], var_f)

    return SMCResult(
        mean_estimate=mean_est,
        variance_estimate=var_est,
        ess=cat(s["ess"], compute_ess(wn_f, group)),
        log_likelihood=cat(s["log_likelihood"], loglik_f),
        phi=phi_series,
        acceptance_rate=cat(s["acceptance"], torch.zeros_like(s["acceptance"][:, 0])),
        resampled=cat(s["resampled"], torch.zeros_like(s["resampled"][:, 0])),
        step_size=cat(s["step_size"], carry.step_size),
        x_saved=None if x_hist is None else torch.stack(x_hist, dim=1),
        logw_saved=None if logw_hist is None else torch.stack(logw_hist, dim=1),
        x_final=carry.x,
        logw_final=carry.logw,
        tree_depth=cat(s["tree_depth"], s["tree_depth"][:, -1]),
        tree_leapfrogs=cat(s["tree_leapfrogs"], s["tree_leapfrogs"][:, -1]),
        accept_stat=cat(s["accept_stat"], s["accept_stat"][:, -1]),
    )


class RunState:
    """Where B runs stand between iterations: the carry after `k_done`
    iterations, the diagnostics of each of those iterations (one dict of
    (B, ...) tensors an iteration, keyed as `_SERIES`), and with
    cfg.save_history the history lists "x", "logw" (and "loglik" with the
    asymptotic strategy) of the k_done + 1 states so far. What a checkpoint
    holds (`utils.checkpoint`)."""

    def __init__(self, carry: SMCCarry, k_done: int = 0, diags=None, history=None):
        self.carry = carry
        self.k_done = k_done
        self.diags = [] if diags is None else diags
        self.history = history


class SMCRun:
    """B = len(seeds) runs on one device, in the three parts that
    `run_smc_batched` chains and `runner.ChunkedRunner` calls a chunk at a
    time: `init` (init_state), `iterate` (iterations [k_done, k1) of the
    loop, by absolute index) and `finalize`. Resolves the device and the
    backend and moves the model to the device, as `run_smc_batched` does.
    With a particle group this rank's shard of every run's particles."""

    def __init__(self, model, cfg: SMCConfig, seeds, device="cuda",
                 momentum_proposal=None, draws: str = PHILOX, group=None):
        device = resolve_device(device)
        if group is not None and device.type != group.device.type:
            raise ValueError(f"the run's device {device} is not its particle "
                             f"group's ({group.device})")
        self.backend = resolve_backend(cfg, device, model)
        self.model = model.to(device)
        seeds = [int(s) for s in seeds]
        if not seeds or not all(0 <= s < 2**63 for s in seeds):
            raise ValueError(f"seeds must be one or more integers in [0, 2^63), got {seeds}")
        self.cfg, self.device, self.seeds = cfg, device, seeds
        self.seeds_t = torch.tensor(seeds, dtype=torch.int64, device=device)
        self.momentum_proposal, self.draws = momentum_proposal, draws
        self.group = group
        # The particles of a run this rank holds, and their global indices.
        self.n_local = cfg.n_particles if group is None else group.local_count(cfg.n_particles)
        self.index = None if group is None else group.local_indices(cfg.n_particles, device)
        self.dtype = getattr(torch, cfg.dtype)
        self.fused = uses_fused_path(cfg, momentum_proposal)
        per_iteration = (len(seeds) * (self.n_local + 1)
                         * (1 if self.fused else 2 * model.dim + 2))
        # Iterations whose draws are made in one call. The draws are
        # addressed by iteration, so where a block starts changes no value.
        self.block = max(1, _DRAW_BLOCK // per_iteration)

    def init(self, sample_proposal=None) -> RunState:
        carry = init_state(self.model, self.cfg, self.seeds, self.device, sample_proposal,
                           self.group)
        history = None
        if self.cfg.save_history:
            history = {"x": [carry.x], "logw": [carry.logw]}
            if self.cfg.is_asymptotic:
                history["loglik"] = [carry.loglik]
        return RunState(carry, history=history)

    def iterate(self, state: RunState, k1: int) -> RunState:
        """Iterations state.k_done .. k1 - 1, each drawing what its absolute
        index addresses; appends their diagnostics and histories to state."""
        cfg, N, D = self.cfg, self.n_local, self.model.dim
        for k0 in range(state.k_done, k1, self.block):
            iterations = range(k0, min(k0 + self.block, k1))
            step_draws = iteration_draws(cfg, self.seeds_t, iterations, N, D,
                                         self.dtype, self.fused, self.index)
            for i in range(len(iterations)):
                state.carry, diag = smc_step(
                    self.model, cfg, state.carry, backend=self.backend,
                    draws=self.draws, momentum_proposal=self.momentum_proposal,
                    group=self.group,
                    **{name: v[i] for name, v in step_draws.items()})
                state.diags.append(diag)
                if state.history is not None:
                    for name, seq in state.history.items():
                        seq.append(getattr(state.carry, name))
        state.k_done = k1
        return state

    def finalize(self, state: RunState) -> SMCResult:
        """`finalize` of the K iterations of state, with the recycling
        uniforms the asymptotic strategy's estimates at the end need."""
        cfg, K, N = self.cfg, self.cfg.n_iterations, self.n_local
        if state.k_done != K:
            raise ValueError(f"{state.k_done} of {K} iterations done")
        recycle = None
        if cfg.is_asymptotic and not cfg.save_history:
            recycle = recycle_draws(self.seeds_t, [K], N, self.dtype, self.index)[0]
        elif cfg.is_asymptotic:
            recycle = torch.cat([
                recycle_draws(self.seeds_t, range(k, min(k + self.block, K + 1)), N,
                              self.dtype, self.index)
                for k in range(0, K + 1, self.block)
            ]).transpose(0, 1)
        hist = state.history or {}
        return finalize(self.model, cfg, state.carry, state.diags, hist.get("x"),
                        hist.get("logw"), hist.get("loglik"), recycle, self.group)


def run_smc_batched(model, cfg: SMCConfig, seeds, device="cuda",
                    sample_proposal=None, momentum_proposal=None,
                    draws: str = PHILOX, group=None) -> SMCResult:
    """Run B = len(seeds) independent SMC runs of K iterations on `device`:
    init_state, K calls of smc_step (one NUTS launch each), finalize
    (`SMCRun`). Every field of the result leads with B, and run b equals
    `run_smc` with seed seeds[b]. Seeds are integers in [0, 2^63). Moves the
    model to the device. The device defaults to the card and is never
    replaced by the CPU: without a CUDA device the call raises unless "cpu"
    is asked for. With a particle group (`parallel.sharding.particle_group`)
    every rank of it calls this alike and holds its shard of the particles;
    the result equals the unsharded one to the bit (its per-particle fields
    the rank's rows)."""
    run = SMCRun(model, cfg, seeds, device, momentum_proposal, draws, group)
    return run.finalize(run.iterate(run.init(sample_proposal), cfg.n_iterations))


def run_smc(model, cfg: SMCConfig, seed: int = 0, device="cuda",
            sample_proposal=None, momentum_proposal=None,
            draws: str = PHILOX, group=None) -> SMCResult:
    """One run: `run_smc_batched` with B = 1, its run axis dropped."""
    result = run_smc_batched(model, cfg, [seed], device, sample_proposal,
                             momentum_proposal, draws, group)
    return SMCResult(*(None if v is None else v[0] for v in result))


class SMCSampler:
    """Reference-shaped API (reference smc_sampler.py:25-36):
    SMCSampler(K, N, target, step_size, ...).sample(), then read attributes."""

    def __init__(self, K, N, target, step_size, sample_proposal=None,
                 momentum_proposal=None, lkernel="forwardsLKernel",
                 tempering=False, seed=0, config: SMCConfig | None = None,
                 device="cuda", group=None):
        if config is None:
            config = SMCConfig(
                n_particles=N, n_iterations=K, step_size=step_size,
                lkernel=lkernel, tempering=tempering,
            )
        self.cfg = config
        self.target = target
        self.K, self.N = config.n_iterations, config.n_particles
        self.seed = seed
        self.device = torch.device(device)
        self.group = group
        self._sample_proposal = sample_proposal
        self._momentum_proposal = momentum_proposal
        self.result: SMCResult | None = None
        self.run_time = None

    def sample(self, seed=None, show_progress=False) -> SMCResult:
        """Run the sampler; `run_time` is the wall time up to the results on
        the host. `show_progress=True` shows the reference's progress bar
        (reference smc_sampler.py:109): the run goes through
        `runner.ChunkedRunner` in chunks of ceil(K / 20) iterations, with a
        tqdm bar advanced after each (without tqdm, a line `SMC iteration
        k/K` on stderr), and its results equal those without, to the bit."""
        seed = self.seed if seed is None else seed
        start = time.perf_counter()
        if show_progress:
            result = self._sample_with_progress(seed)
        else:
            result = run_smc(
                self.target, self.cfg, seed, self.device,
                sample_proposal=self._sample_proposal,
                momentum_proposal=self._momentum_proposal, group=self.group,
            )
        host = {
            k: None if v is None else v.cpu().numpy()
            for k, v in result._asdict().items()
        }
        self.run_time = time.perf_counter() - start
        self.result = result
        self.mean_estimate = host["mean_estimate"]
        self.variance_estimate = host["variance_estimate"]
        self.ess = host["ess"]
        self.log_likelihood = host["log_likelihood"]
        self.phi = host["phi"]
        self.acceptance_rate = host["acceptance_rate"]
        self.resampled = host["resampled"].tolist()
        if host["x_saved"] is not None:
            self.x_saved = host["x_saved"]
            self.logw_saved = host["logw_saved"]
        return result

    def _sample_with_progress(self, seed) -> SMCResult:
        from .runner import ChunkedRunner

        runner = ChunkedRunner(
            self.target, self.cfg, chunk_size=-(-self.cfg.n_iterations // 20),
            sample_proposal=self._sample_proposal,
            momentum_proposal=self._momentum_proposal, device=self.device,
            group=self.group,
        )
        # tqdm is imported alone: an ImportError raised by the run itself must
        # not be taken for a missing tqdm.
        try:
            from tqdm import tqdm
        except ImportError:
            tqdm = None
        if tqdm is None:
            def progress(k_done, total):
                print(f"SMC iteration {k_done}/{total}", file=sys.stderr)

            return runner.run(seed, progress=progress)
        bar = tqdm(total=self.cfg.n_iterations, desc="SMC", unit="it")

        def progress(k_done, total):
            bar.n = k_done
            bar.refresh()

        try:
            return runner.run(seed, progress=progress)
        finally:
            bar.close()
