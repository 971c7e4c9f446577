"""smcnuts_torch: the SMC-NUTS sampler of `smcnuts_tpu`, ported to PyTorch
and to hand-written CUDA kernels for the NVIDIA H100 (sm_90a).

The JAX package stays the reference; this package imports neither it nor
jax. Ported so far: five models (arma, PRMwCD, the analytic Gaussian, eight
schools, logistic regression), B independent runs batched into one NUTS
launch per iteration (`run_smc_batched`), the three L-kernel strategies
(asymptotic with tempered recycling, forwards, Gaussian approximation),
adaptive tempering, step-size and diagonal mass adaptation, multinomial and
systematic resampling, the fused and the unfused proposal paths (momenta
drawn inside the tree, or outside it from a custom momentum proposal), and
the whole-tree NUTS proposal as a CUDA kernel per model (`ops/nuts_cuda.py`),
run whole or in stages with lane compaction inside the kernel, with its plain
PyTorch version, which is also the eager backend, run in blocks of lanes; for
arma that backend can take the likelihood's value and gradient from a fused
CUDA kernel (`make_arma(fused="cuda")`, `ops/arma_fused.py`); user-written
per-particle densities (`models.base.CallableModel`), eager by autograd or on
the kernel through a generated in-kernel model (`ops/generated.py`); and the
card's FP32 peak (`ops/peak.py`); chunked runs that checkpoint and resume
(`runner.ChunkedRunner`, `utils/checkpoint.py`), the reference's CSVs
(`utils/io.py`) and phase profiling (`utils/profiling.py`). The entry points
run on the card unless the caller asks for "cpu".
"""

__version__ = "0.1.0"

from .config import SMCConfig
from .proposals import DiagNormalProposal, FullNormalProposal
from .sampler import SMCSampler, run_smc, run_smc_batched

__all__ = [
    "DiagNormalProposal",
    "FullNormalProposal",
    "SMCConfig",
    "SMCSampler",
    "run_smc",
    "run_smc_batched",
    "__version__",
]
