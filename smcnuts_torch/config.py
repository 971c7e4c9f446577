"""Typed run configuration, field for field the JAX package's `SMCConfig`.

The validation is the same. Two fields are renamed for this backend:
`nuts_backend` takes "auto", "eager" or "cuda", and `pallas_compaction`
becomes `compaction`. `xla_block_size` becomes `eager_block_size`, with the
same default of 4096.

Every setting runs: the three L-kernel strategies (asymptotic, forwards,
Gaussian approximation), adaptive tempering, step-size and diagonal mass
adaptation, multinomial and systematic resampling, the whole-tree NUTS
proposal as one kernel or staged with lane compaction, the fused and the
unfused proposal paths, and the eager tree in blocks.

One deliberate difference: the JAX package's XLA backend is always unfused
(momenta drawn outside the tree, the asymptotic accept-reject outside it),
and only its Pallas backend honours `fused_epilogue`. Here the eager tree is
also the plain version of the whole-tree kernel, so both backends honour it,
and the kernel and its plain version keep agreeing to the bit; the
counterpart of the JAX XLA path is `nuts_backend="eager",
fused_epilogue=False`.
"""

from __future__ import annotations

import dataclasses

LKERNELS = ("asymptoticLKernel", "forwardsLKernel", "GaussianApproxLKernel")
RESAMPLERS = ("multinomial", "systematic")
NUTS_BACKENDS = ("auto", "eager", "cuda")


@dataclasses.dataclass(frozen=True)
class SMCConfig:
    n_particles: int
    n_iterations: int
    step_size: float
    lkernel: str = "forwardsLKernel"
    tempering: bool = False
    resampling: str = "multinomial"
    max_tree_depth: int = 10  # doublings 0..max_depth
    ess_threshold_frac: float = 0.5  # resample when ESS < N * frac
    tempering_alpha: float = 0.5
    # Keep x/logw per iteration. With the asymptotic strategy, False makes
    # the tempered-recycling estimates inside the loop (the same estimates,
    # O(N D) memory instead of (K+1) N D).
    save_history: bool = True
    adapt_step_size: bool = False
    adapt_mass_matrix: bool = False
    target_accept: float = 0.8
    adapt_warmup_frac: float = 0.5
    dtype: str = "float32"
    # "eager": the plain PyTorch tree (`ops.nuts_cuda.nuts_tree_plain`), on
    # the CPU or the card (there it runs the model's logp_and_grad once a
    # leaf: arma with fused="cuda" is one kernel launch); "cuda": the
    # hand-written whole-tree kernel; "auto": cuda for CUDA tensors and eager
    # for CPU tensors, never eager on a card. Never a fallback.
    nuts_backend: str = "auto"
    # Lockstep bound of the eager tree: the B x N lanes go through in
    # sequential blocks of this many, so one deep tree stalls only its block
    # and the live state is one block's (arma at N = 1,048,576 on an NVIDIA
    # H100: the tree's own peak 1.66 GiB in one block, 0.71 GiB in blocks of
    # 262,144; PERF.md); None = all lanes in one pass. Every output is equal
    # to the bit for any value. Ignored by the kernel.
    eager_block_size: int | None = 4096
    # Below this temperature the tempered non-asymptotic path evaluates the
    # log-likelihood directly instead of recovering it from the tree's cached
    # density (`sampler._recover_loglik`); 0.0 disables.
    cached_loglik_min_phi: float = 1e-2
    # The fused proposal path: momenta drawn inside the tree, the asymptotic
    # accept-reject in its epilogue, the reweight from its outputs. Used
    # where the JAX package's Pallas backend uses it: with mass adaptation or
    # the standard momentum proposal. False (or a custom momentum proposal):
    # momenta drawn outside and handed to the tree, the accept-reject and
    # the momentum densities outside (`sampler.smc_step`).
    fused_epilogue: bool = True
    # Doublings after which the tree build pauses and the lanes still at
    # work are packed densely (the staged dispatch of `ops.nuts_cuda`), on
    # both backends. "auto" takes the model's hint on the kernel
    # (`sampler.resolve_compaction`) and no splits on the eager tree; None or
    # () runs the single kernel.
    compaction: str | tuple | None = "auto"

    def __post_init__(self):
        if self.n_particles < 1:
            raise ValueError(f"n_particles must be >= 1, got {self.n_particles}")
        if self.n_iterations < 1:
            raise ValueError(
                f"n_iterations must be >= 1, got {self.n_iterations}"
            )
        if self.step_size <= 0:
            raise ValueError(f"step_size must be > 0, got {self.step_size}")
        if self.lkernel not in LKERNELS:
            raise ValueError(
                f"Unknown L-kernel '{self.lkernel}'; expected one of {LKERNELS}"
            )
        if self.resampling not in RESAMPLERS:
            raise ValueError(
                f"Unknown resampling scheme '{self.resampling}'; "
                f"expected one of {RESAMPLERS}"
            )
        if self.nuts_backend not in NUTS_BACKENDS:
            raise ValueError(
                f"Unknown nuts_backend '{self.nuts_backend}'; expected one of "
                f"{NUTS_BACKENDS}"
            )
        if self.eager_block_size is not None and self.eager_block_size < 1:
            raise ValueError(
                f"eager_block_size must be >= 1 or None, got "
                f"{self.eager_block_size}"
            )
        if not 0.0 <= self.cached_loglik_min_phi < 1.0:
            raise ValueError(
                "cached_loglik_min_phi must be in [0, 1), got "
                f"{self.cached_loglik_min_phi}"
            )
        pc = self.compaction
        if pc is not None and pc != "auto":
            if not (
                isinstance(pc, tuple)
                and all(isinstance(s, int) and s >= 1 for s in pc)
            ):
                raise ValueError(
                    "compaction must be 'auto', None, or a tuple of "
                    f"positive ints, got {pc!r}"
                )
        if not 0.0 < self.adapt_warmup_frac <= 1.0:
            raise ValueError(
                "adapt_warmup_frac must be in (0, 1], got "
                f"{self.adapt_warmup_frac}"
            )
        if self.max_tree_depth < 0:
            raise ValueError(
                f"max_tree_depth must be >= 0, got {self.max_tree_depth}"
            )
        if self.dtype not in ("float32", "float64"):
            raise ValueError(f"dtype must be float32 or float64, got {self.dtype}")

    @property
    def is_asymptotic(self) -> bool:
        return self.lkernel == "asymptoticLKernel"
