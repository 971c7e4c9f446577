"""SMC sampler: the JAX package's `sampler.py` for the slice ported so far,
for B independent runs at once.

One iteration, in the reference's order (reference smc_sampler.py:109-140),
for every run:

    1. record the phi used this iteration
    2. normalise weights (masked logsumexp) -> wn, running log-likelihood
    3. estimates at index k from the *entering* weights
    4. ESS; 5. resample if ESS < N/2, before the proposal
    6. whole-tree NUTS proposal at temperature phi (momenta drawn inside),
       as one kernel or staged with lane compaction (cfg.compaction)
    7. reweight: logw += logp' - logp0 + (delta_h - (logp' - logp0)),
       the forwards L-kernel on the non-tempered fused path
    8. acceptance = share of particles that moved in EVERY dimension
    9. adaptation, when configured: dual averaging of the step size on the
       mean accept statistic (frozen at the averaged iterate after
       round(adapt_warmup_frac * K) iterations) and the diagonal inverse mass
       from the reweighted particles (JAX sampler.py:489-517)

Diagnostics quirks kept from the reference: acceptance at index K is 0, and
phi[K] is the last temperature computed.

Batching: `run_smc_batched(model, cfg, seeds, device)` steps B runs through
one NUTS launch per iteration (B*N threads); weights, ESS, resampling and
adaptation are per run, as tensor ops over the run axis. It is the
counterpart of `jax.vmap(run_smc)` over keys, and `run_smc` is its B = 1
case. Every random number of run b comes from b's own seed: the initial
particles from a `torch.Generator` seeded with it, and per iteration the
resampling uniforms and the tree's seed from its Philox stream
(`ops.draws.run_draws`). Every sum over particles takes the fixed order of
`ops.reduce`. So run b of a batch equals, bit for bit, a run alone with seed
seeds[b]. The K loop does no host sync: the resample decision is a
`torch.where`, and the diagnostics stay on the device until `finalize`.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from .config import SMCConfig
from .models.base import ADAPTED_HINT_TARGET, COMPACTION_MIN_LANES
from .ops.adaptation import (
    DualAveragingState,
    da_init,
    da_update,
    mass_matrix_from_particles,
)
from .ops.draws import PHILOX, run_draws
from .ops.moments import estimate as constrained_estimate
from .ops.nuts_cuda import nuts_tree, nuts_tree_plain
from .ops.reduce import row_mean
from .ops.resampling import resample_if_required
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


def resolve_backend(cfg: SMCConfig, device: torch.device) -> str:
    """The proposal backend: cuda (the kernel) or eager (the plain tree).

    "auto" picks cuda on a CUDA device and eager on the CPU."""
    backend = cfg.nuts_backend
    if backend == "auto":
        backend = "cuda" if device.type == "cuda" else "eager"
    if backend == "cuda" and device.type != "cuda":
        raise ValueError(f"nuts_backend='cuda' needs a CUDA device, got {device}")
    if cfg.dtype == "float64" and device.type == "cuda":
        raise NotImplementedError(
            "float64 on CUDA is not ported to smcnuts_torch yet "
            "(ROADMAP Queue 2 item 1)"
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
    either kind and runs the single kernel. Either hint pays only past
    COMPACTION_MIN_LANES, one block of the kernel on every SM: up to there
    no warp waits for another and a dispatch lasts as long as its deepest
    tree, staged or not, so "auto" runs the single kernel there too."""
    if cfg.compaction != "auto":
        return tuple(cfg.compaction or ())
    if n_lanes <= COMPACTION_MIN_LANES:
        return ()
    if not cfg.adapt_step_size:
        return tuple(getattr(model, "compaction_hint", ()))
    if cfg.target_accept == ADAPTED_HINT_TARGET:
        return tuple(getattr(model, "compaction_hint_adapted", ()))
    return ()


def _check_momentum(momentum_proposal):
    if momentum_proposal is None:
        return
    if not (
        isinstance(momentum_proposal, DiagNormalProposal)
        and momentum_proposal.is_standard()
    ):
        raise NotImplementedError(
            "a non-standard momentum proposal needs the unfused proposal "
            "path, not ported to smcnuts_torch yet (ROADMAP Queue 1 item 5)"
        )


def init_state(model, cfg: SMCConfig, seeds, device,
               sample_proposal=None) -> SMCCarry:
    """x0 ~ sample proposal, phi0 = 1, logw0 = logp(x0, 1) - q0(x0)
    (reference samples.py:63-88, non-tempered), one run per seed. Each run
    draws from a generator seeded with its own seed and is evaluated alone,
    so it does not depend on the runs beside it."""
    dtype = getattr(torch, cfg.dtype)
    device = torch.device(device)
    if sample_proposal is None:
        sample_proposal = DiagNormalProposal(model.dim)
    xs, logws = [], []
    for seed in seeds:
        generator = torch.Generator(device=device).manual_seed(int(seed))
        x0 = sample_proposal.rvs(generator, cfg.n_particles, dtype=dtype)
        xs.append(x0)
        logws.append((model.logp(x0, 1.0) - sample_proposal.logpdf(x0)).to(dtype))
    B = len(xs)
    step_size = torch.full((B,), cfg.step_size, dtype=dtype, device=device)
    return SMCCarry(
        x=torch.stack(xs),
        logw=torch.stack(logws),
        phi=torch.ones(B, dtype=dtype, device=device),
        step_size=step_size,
        inv_mass=torch.ones((B, model.dim), dtype=dtype, device=device),
        da=da_init(step_size),
    )


def smc_step(model, cfg: SMCConfig, carry: SMCCarry, uniforms, tree_seed,
             backend: str, draws: str = PHILOX):
    """One SMC iteration of B runs; returns (next carry, diagnostics of this
    one, each with a leading run axis).

    uniforms (B, N) in [0, 1) are the resampling draws and tree_seed (B,)
    int32 the seeds of the runs' trees (`ops.draws.run_draws`; a test hands
    in the JAX package's uniforms); `draws` picks the tree's draw source."""
    phi = carry.phi
    wn, log_likelihood = normalise_weights(carry.logw)
    mean_k, var_k = constrained_estimate(model, carry.x, wn)
    ess_k = compute_ess(wn)
    x_r, logw_r, did_resample = resample_if_required(
        uniforms, carry.x, carry.logw, wn, log_likelihood, ess_k,
        cfg.ess_threshold_frac,
    )

    tree = nuts_tree if backend == "cuda" else nuts_tree_plain
    x_new, _, st = tree(
        model, x_r, tree_seed, carry.step_size, phi, carry.inv_mass,
        cfg.max_tree_depth, draws,
        compaction=resolve_compaction(cfg, model, x_r.shape[0] * x_r.shape[1]),
    )

    # Forwards L-kernel, fused: the momentum-density difference
    # L(-r'|x') - q(r) comes back as delta_h - (logp' - logp0), and on the
    # non-tempered path (phi = 1) the tree's cached endpoint densities are
    # the phi = 1 values, so the increment collapses to delta_h.
    lk_minus_q = st["delta_h"] - (st["logp_prop"] - st["logp0"])
    logp_new_1, logp_old_1 = st["logp_prop"], st["logp0"]
    logw_new = logw_r + logp_new_1 - logp_old_1 + lk_minus_q

    # Adaptation (JAX sampler.py:489-517). The warmup freeze uses da.count
    # as the iteration counter, as the JAX package does.
    accept_stat = row_mean(st["accept_stat"])
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
        wn_new, _ = normalise_weights(logw_new)
        inv_mass = mass_matrix_from_particles(x_new, wn_new, carry.inv_mass)

    diag = {
        "phi": phi,
        "log_likelihood": log_likelihood,
        "ess": ess_k,
        "acceptance": row_mean(st["moved"]),
        "resampled": did_resample,
        "step_size": step_size,
        "tree_depth": row_mean(st["depth"]),
        "tree_leapfrogs": row_mean(st["leapfrogs"]),
        "accept_stat": accept_stat,
        "mean": mean_k,
        "var": var_k,
    }
    new_carry = SMCCarry(
        x=x_new, logw=logw_new, phi=torch.ones_like(phi),
        step_size=step_size, inv_mass=inv_mass, da=da,
    )
    return new_carry, diag


def finalize(model, carry: SMCCarry, diags: list, x_hist=None,
             logw_hist=None) -> SMCResult:
    """Append the final half-iteration at index K (smc_sampler.py:143-149);
    every series is (B, K+1, ...)."""
    wn_f, loglik_f = normalise_weights(carry.logw)
    mean_f, var_f = constrained_estimate(model, carry.x, wn_f)
    s = {k: torch.stack([d[k] for d in diags], dim=1) for k in _SERIES}

    def cat(seq, last):
        return torch.cat([seq, last[:, None].to(seq.dtype)], dim=1)

    return SMCResult(
        mean_estimate=cat(s["mean"], mean_f),
        variance_estimate=cat(s["var"], var_f),
        ess=cat(s["ess"], compute_ess(wn_f)),
        log_likelihood=cat(s["log_likelihood"], loglik_f),
        phi=cat(s["phi"], carry.phi),
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


def run_smc_batched(model, cfg: SMCConfig, seeds, device="cuda",
                    sample_proposal=None, momentum_proposal=None,
                    draws: str = PHILOX) -> SMCResult:
    """Run B = len(seeds) independent SMC runs of K iterations on `device`:
    init_state, K calls of smc_step (one NUTS launch each), finalize. Every
    field of the result leads with B, and run b equals `run_smc` with seed
    seeds[b]. Seeds are integers in [0, 2^63). Moves the model to the
    device. The device defaults to the card and is never replaced by the
    CPU: without a CUDA device the call raises unless "cpu" is asked for."""
    _check_momentum(momentum_proposal)
    device = resolve_device(device)
    backend = resolve_backend(cfg, device)
    model = model.to(device)
    seeds = [int(s) for s in seeds]
    if not seeds or not all(0 <= s < 2**63 for s in seeds):
        raise ValueError(f"seeds must be one or more integers in [0, 2^63), got {seeds}")
    carry = init_state(model, cfg, seeds, device, sample_proposal)
    seeds_t = torch.tensor(seeds, dtype=torch.int64, device=device)
    B, N = carry.logw.shape
    K = cfg.n_iterations
    block = max(1, _DRAW_BLOCK // (B * (N + 1)))
    diags = []
    x_hist = [carry.x] if cfg.save_history else None
    logw_hist = [carry.logw] if cfg.save_history else None
    for k in range(K):
        if k % block == 0:
            uniforms, tree_seeds = run_draws(
                seeds_t, range(k, min(k + block, K)), N, carry.x.dtype
            )
        carry, diag = smc_step(model, cfg, carry, uniforms[k % block],
                               tree_seeds[k % block], backend, draws)
        diags.append(diag)
        if cfg.save_history:
            x_hist.append(carry.x)
            logw_hist.append(carry.logw)
    return finalize(model, carry, diags, x_hist, logw_hist)


def run_smc(model, cfg: SMCConfig, seed: int = 0, device="cuda",
            sample_proposal=None, momentum_proposal=None,
            draws: str = PHILOX) -> SMCResult:
    """One run: `run_smc_batched` with B = 1, its run axis dropped."""
    result = run_smc_batched(model, cfg, [seed], device, sample_proposal,
                             momentum_proposal, draws)
    return SMCResult(*(None if v is None else v[0] for v in result))


class SMCSampler:
    """Reference-shaped API (reference smc_sampler.py:25-36):
    SMCSampler(K, N, target, step_size, ...).sample(), then read attributes."""

    def __init__(self, K, N, target, step_size, sample_proposal=None,
                 momentum_proposal=None, lkernel="forwardsLKernel",
                 tempering=False, seed=0, config: SMCConfig | None = None,
                 device="cuda"):
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
        self._sample_proposal = sample_proposal
        self._momentum_proposal = momentum_proposal
        self.result: SMCResult | None = None
        self.run_time = None

    def sample(self, seed=None) -> SMCResult:
        """Run the sampler; `run_time` is the wall time up to the results on
        the host."""
        start = time.perf_counter()
        result = run_smc(
            self.target, self.cfg, self.seed if seed is None else seed,
            self.device, sample_proposal=self._sample_proposal,
            momentum_proposal=self._momentum_proposal,
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
