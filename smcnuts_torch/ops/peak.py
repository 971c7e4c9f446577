"""The card's FP32 peaks (TPU kernel K8): fused and unfused multiply-adds.

The port of `experiments/bench_vpu_peak.py::make_kernel` (a Pallas kernel of
`nchains` independent multiply-add chains of 2,000 steps a lane): the kernel
of `csrc/fma_peak.cu`, in two variants, FMA (one fused multiply-add a step)
and FMUL+FADD (a multiply and an add, separately rounded, which is what the
port's NUTS kernels execute, built with -fmad=false). `peak_table` times both
for 4, 8, 16 and 32 chains a thread on a grid that fills every SM and counts
FLOPs as the JAX script does (`bench_vpu_peak.py:92`): 2 a step of a chain,
for the fused multiply-add as for the pair.

`fma_chains` launches the kernel for a CUDA tensor and runs
`fma_chains_plain`, the same chains as float32 tensor ops (a multiply and an
add a step, the FMUL+FADD variant's arithmetic), for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

CHAINS = (4, 8, 16, 32)
VARIANTS = ("fma", "fmul_fadd")
STEPS = 2000  # bench_vpu_peak.py's STEPS
# The launch shape: 8 blocks of 256 threads on every SM (2,048 threads, the
# most an SM holds), so each scheduler has 16 warps to hide latency with.
THREADS = 256
BLOCKS_PER_SM = 8


def coefficients(nchains: int) -> tuple:
    """(a, b) of the chains, as `bench_vpu_peak.py:42-43` sets them, rounded
    to float32: a_c = 1 + 1e-6 (c + 1), b_c = 1e-7 (c + 1)."""
    a = [float(np.float32(1.0 + 1e-6 * (c + 1))) for c in range(nchains)]
    b = [float(np.float32(1e-7 * (c + 1))) for c in range(nchains)]
    return a, b


def flops(n: int, nchains: int, steps: int) -> int:
    """FLOPs of one call, counted as `bench_vpu_peak.py:92` counts them:
    2 a step of each chain."""
    return n * nchains * steps * 2


def fma_chains_plain(x, nchains: int, steps: int):
    """The chains of x (n,) float32 as tensor ops: c <- a_c * c + b_c, a
    multiply and an add a step, then the chains summed in order."""
    a, b = coefficients(nchains)
    chains = [x + float(c) * 0.125 for c in range(nchains)]
    for _ in range(steps):
        chains = [a[c] * chains[c] + b[c] for c in range(nchains)]
    acc = chains[0]
    for c in range(1, nchains):
        acc = acc + chains[c]
    return acc


def fma_chains(x, nchains: int, steps: int = STEPS, variant: str = "fma"):
    """The chains of x (n,) float32 on x's device: the kernel for a CUDA
    tensor, `fma_chains_plain` for a CPU tensor (whose arithmetic is the
    FMUL+FADD variant's)."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    if nchains not in CHAINS:
        raise ValueError(f"nchains must be one of {CHAINS}, got {nchains}")
    if x.device.type == "cpu":
        return fma_chains_plain(x, nchains, steps)
    if x.device.type != "cuda":
        raise ValueError(f"fma_chains runs on cpu or cuda tensors, got {x.device}")
    if x.dtype != torch.float32 or x.dim() != 1 or not x.is_contiguous() or x.numel() < 1:
        raise ValueError("x must be a non-empty contiguous float32 vector")
    from .nuts_cuda import build_library

    lib = build_library().lib
    a, b = coefficients(nchains)
    out = torch.empty_like(x)
    err = lib.smcnuts_fma_peak(
        x.data_ptr(), out.data_ptr(), x.numel(), nchains, int(variant == "fma"),
        int(steps), (ctypes.c_float * nchains)(*a), (ctypes.c_float * nchains)(*b),
        THREADS, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fma_peak kernel launch failed: CUDA error {err}")
    fma_chains.launches += 1
    return out


fma_chains.launches = 0  # kernel launches, and nothing else


def launch_size(device) -> int:
    """Threads of one launch: BLOCKS_PER_SM blocks of THREADS on each SM."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * BLOCKS_PER_SM * THREADS


def peak_table(device, repeats: int = 5, reps: int = 20) -> list:
    """The peak rows on `device` (a CUDA device; the CPU has no peak to
    measure here): for each variant and chain count, the median over
    `repeats` of the device's time for `reps` launches at STEPS steps queued
    back to back (`utils.timing.device_ms`), per launch, and its TFLOP/s."""
    import statistics

    from ..utils.timing import device_ms

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"peak_table measures a CUDA device, got {device}")
    n = launch_size(device)
    x = torch.randn(n, generator=torch.Generator(device=device).manual_seed(0),
                    device=device)
    rows = []
    for variant in VARIANTS:
        for nchains in CHAINS:
            def run():
                fma_chains(x, nchains, STEPS, variant)

            ms = statistics.median(device_ms(run, repeats=reps) for _ in range(repeats))
            rows.append({"variant": variant, "nchains": nchains, "ms": ms,
                         "tflops": flops(n, nchains, STEPS) / (ms * 1e-3) / 1e12})
    return rows
