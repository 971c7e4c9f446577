"""SMC sampler: the JAX package's `sampler.py` for the slice ported so far.

One iteration, in the reference's order (reference smc_sampler.py:109-140):

    1. record the phi used this iteration
    2. normalise weights (masked logsumexp) -> wn, running log-likelihood
    3. estimates at index k from the *entering* weights
    4. ESS; 5. resample if ESS < N/2, before the proposal
    6. whole-tree NUTS proposal at temperature phi (momenta drawn inside)
    7. reweight: logw += logp' - logp0 + (delta_h - (logp' - logp0)),
       the forwards L-kernel on the non-tempered fused path
    8. acceptance = share of particles that moved in EVERY dimension

Diagnostics quirks kept from the reference: acceptance at index K is 0, and
phi[K] is the last temperature computed.

Every random number comes from one `torch.Generator` on the run's device:
per iteration the N resampling uniforms, then the seed of the tree's draws.
The K loop does no host sync: the resample decision is a `torch.where`, and
the per-iteration diagnostics stay on the device until `finalize`.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from .config import SMCConfig
from .ops.draws import PHILOX
from .ops.moments import estimate as constrained_estimate
from .ops.nuts_cuda import nuts_tree, nuts_tree_plain
from .ops.resampling import resample_if_required
from .ops.weights import ess as compute_ess
from .ops.weights import normalise_weights
from .proposals import DiagNormalProposal

_SEED_BOUND = 2**31 - 1


class SMCCarry(NamedTuple):
    x: torch.Tensor  # (N, D) unconstrained positions
    logw: torch.Tensor  # (N,) log weights
    phi: torch.Tensor  # () temperature for the next proposal
    step_size: torch.Tensor  # ()
    inv_mass: torch.Tensor  # (D,) diagonal inverse mass


class SMCResult(NamedTuple):
    """Per-iteration series of length K+1 (reference smc_sampler.py:66-85),
    as tensors on the run's device."""

    mean_estimate: torch.Tensor  # (K+1, CD)
    variance_estimate: torch.Tensor  # (K+1, CD)
    ess: torch.Tensor  # (K+1,)
    log_likelihood: torch.Tensor  # (K+1,)
    phi: torch.Tensor  # (K+1,)
    acceptance_rate: torch.Tensor  # (K+1,)
    resampled: torch.Tensor  # (K+1,) bool
    step_size: torch.Tensor  # (K+1,)
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


def init_state(model, cfg: SMCConfig, generator: torch.Generator,
               sample_proposal=None) -> SMCCarry:
    """x0 ~ sample proposal, phi0 = 1, logw0 = logp(x0, 1) - q0(x0)
    (reference samples.py:63-88, non-tempered)."""
    dtype = getattr(torch, cfg.dtype)
    device = generator.device
    if sample_proposal is None:
        sample_proposal = DiagNormalProposal(model.dim)
    x0 = sample_proposal.rvs(generator, cfg.n_particles, dtype=dtype)
    logw0 = model.logp(x0, 1.0) - sample_proposal.logpdf(x0)
    return SMCCarry(
        x=x0,
        logw=logw0.to(dtype),
        phi=torch.ones((), dtype=dtype, device=device),
        step_size=torch.full((), cfg.step_size, dtype=dtype, device=device),
        inv_mass=torch.ones(model.dim, dtype=dtype, device=device),
    )


def smc_step(model, cfg: SMCConfig, carry: SMCCarry,
             generator: torch.Generator, backend: str, draws: str = PHILOX,
             uniforms: torch.Tensor | None = None):
    """One SMC iteration; returns (next carry, diagnostics of this one).

    `uniforms` (N,) in [0, 1) replaces the resampling draw (a test hands in
    the JAX package's); `draws` picks the tree's draw source."""
    n = cfg.n_particles
    x = carry.x
    if uniforms is None:
        uniforms = torch.rand(
            n, generator=generator, dtype=x.dtype, device=x.device
        )
    seed = torch.randint(
        0, _SEED_BOUND, (1,), generator=generator, dtype=torch.int32,
        device=x.device,
    )
    phi = carry.phi

    wn, log_likelihood = normalise_weights(carry.logw)
    mean_k, var_k = constrained_estimate(model, x, wn)
    ess_k = compute_ess(wn)
    x_r, logw_r, did_resample = resample_if_required(
        uniforms, x, carry.logw, wn, log_likelihood, ess_k,
        cfg.ess_threshold_frac,
    )

    tree = nuts_tree if backend == "cuda" else nuts_tree_plain
    x_new, _, st = tree(
        model, x_r[None], seed, carry.step_size, phi, carry.inv_mass,
        cfg.max_tree_depth, draws,
    )
    x_new = x_new[0]
    st = {k: v[0] for k, v in st.items()}

    # Forwards L-kernel, fused: the momentum-density difference
    # L(-r'|x') - q(r) comes back as delta_h - (logp' - logp0), and on the
    # non-tempered path (phi = 1) the tree's cached endpoint densities are
    # the phi = 1 values, so the increment collapses to delta_h.
    lk_minus_q = st["delta_h"] - (st["logp_prop"] - st["logp0"])
    logp_new_1, logp_old_1 = st["logp_prop"], st["logp0"]
    logw_new = logw_r + logp_new_1 - logp_old_1 + lk_minus_q

    diag = {
        "phi": phi,
        "log_likelihood": log_likelihood,
        "ess": ess_k,
        "acceptance": torch.mean(st["moved"]),
        "resampled": did_resample,
        "step_size": carry.step_size,
        "tree_depth": torch.mean(st["depth"]),
        "tree_leapfrogs": torch.mean(st["leapfrogs"]),
        "accept_stat": torch.mean(st["accept_stat"]),
        "mean": mean_k,
        "var": var_k,
    }
    new_carry = SMCCarry(
        x=x_new, logw=logw_new, phi=torch.ones_like(phi),
        step_size=carry.step_size, inv_mass=carry.inv_mass,
    )
    return new_carry, diag


def finalize(model, carry: SMCCarry, diags: list, x_hist=None,
             logw_hist=None) -> SMCResult:
    """Append the final half-iteration at index K (smc_sampler.py:143-149)."""
    wn_f, loglik_f = normalise_weights(carry.logw)
    mean_f, var_f = constrained_estimate(model, carry.x, wn_f)
    s = {k: torch.stack([d[k] for d in diags]) for k in _SERIES}

    def cat(seq, last):
        return torch.cat([seq, last.reshape((1,) + seq.shape[1:]).to(seq.dtype)])

    return SMCResult(
        mean_estimate=cat(s["mean"], mean_f),
        variance_estimate=cat(s["var"], var_f),
        ess=cat(s["ess"], compute_ess(wn_f)),
        log_likelihood=cat(s["log_likelihood"], loglik_f),
        phi=cat(s["phi"], carry.phi),
        acceptance_rate=cat(s["acceptance"], torch.zeros_like(s["acceptance"][0])),
        resampled=cat(s["resampled"], torch.zeros_like(s["resampled"][0])),
        step_size=cat(s["step_size"], carry.step_size),
        x_saved=None if x_hist is None else torch.stack(x_hist),
        logw_saved=None if logw_hist is None else torch.stack(logw_hist),
        x_final=carry.x,
        logw_final=carry.logw,
        tree_depth=cat(s["tree_depth"], s["tree_depth"][-1]),
        tree_leapfrogs=cat(s["tree_leapfrogs"], s["tree_leapfrogs"][-1]),
        accept_stat=cat(s["accept_stat"], s["accept_stat"][-1]),
    )


def run_smc(model, cfg: SMCConfig, generator: torch.Generator,
            sample_proposal=None, momentum_proposal=None,
            draws: str = PHILOX) -> SMCResult:
    """Run K iterations on the generator's device: init_state, K calls of
    smc_step, finalize. Moves the model to that device."""
    _check_momentum(momentum_proposal)
    device = generator.device
    backend = resolve_backend(cfg, device)
    model = model.to(device)
    carry = init_state(model, cfg, generator, sample_proposal)
    diags = []
    x_hist = [carry.x] if cfg.save_history else None
    logw_hist = [carry.logw] if cfg.save_history else None
    for _ in range(cfg.n_iterations):
        carry, diag = smc_step(model, cfg, carry, generator, backend, draws)
        diags.append(diag)
        if cfg.save_history:
            x_hist.append(carry.x)
            logw_hist.append(carry.logw)
    return finalize(model, carry, diags, x_hist, logw_hist)


class SMCSampler:
    """Reference-shaped API (reference smc_sampler.py:25-36):
    SMCSampler(K, N, target, step_size, ...).sample(), then read attributes."""

    def __init__(self, K, N, target, step_size, sample_proposal=None,
                 momentum_proposal=None, lkernel="forwardsLKernel",
                 tempering=False, seed=0, config: SMCConfig | None = None,
                 device="cpu"):
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
        generator = torch.Generator(device=self.device)
        generator.manual_seed(self.seed if seed is None else seed)
        start = time.perf_counter()
        result = run_smc(
            self.target, self.cfg, generator,
            sample_proposal=self._sample_proposal,
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
