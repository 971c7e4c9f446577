"""Drive the PyTorch/CUDA port (`smcnuts_torch`) on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root; one GPU
    python3 chip_smoke.py --only autodiff,strategies,cli   # some phases, while
                                 # developing: prints no kernels line, no "ok"
    (phase keys: arma, prmwcd, main, batched, staged_times, cli, autodiff,
    gaussian, logistic, eightschools (phase 8 for one model alone),
    strategies, fused_kernel, eager, unfused, wide_eager, generated, runner,
    stan; device, build and peak always run first)

Phases, each printing its own lines; any failure raises (non-zero exit):

1. device: the GPU's name, `nvidia-smi` name and power limit, versions.
2. build: nvcc builds the kernels from smcnuts_torch/csrc (sm_90a), one nvcc
   a source, all at once: the NUTS kernel with two instantiations per entry
   (arma, PRMwCD, the Gaussian at D = 2, 3 and 5, eight schools, logistic):
   the first stage, which is the whole tree when nothing is staged, and the
   continuation stage; and the fused ARMA value and gradient. Prints ptxas's
   registers, stack frame and spills for each, and fails if the build took
   more than a minute. The kernel template is csrc/nuts_tree.cuh; the hand
   models' entries are csrc/nuts_tree.cu; the FP32 peak kernel
   (csrc/fma_peak.cu) builds beside them.
2b. peak (K8): the FP32 peak kernel (csrc/fma_peak.cu) against its plain
   chain at 64 steps (FMUL+FADD equal to the bit; FMA within one spacing of
   the chain's value a step and chain), then 4, 8, 16 and 32 chains of 2,000
   steps a thread, FMA and FMUL+FADD, on 8 blocks of 256 threads an SM (the
   device alone, median of 5 of 20 launches back to back, TFLOP/s counted as
   experiments/bench_vpu_peak.py:92 counts them). Every later bound divides
   by the card's FP32 rate (the data sheet's 67 TFLOP/s, which counts a
   fused multiply-add as two); its second bound, bound_unfused_ms, divides by
   the measured FMUL+FADD rate, the most the port's -fmad=false builds reach.
3. arma kernel vs plain: `nuts_tree` (the CUDA kernel, a group of
   models.arma.GROUP lanes a tree) and `nuts_tree_plain` (the model in the
   same group order) on the same CUDA inputs, with zero-bits and Philox
   draws, phi 1.0 and 0.4 (two runs in one launch), a non-unit inverse mass,
   the r-given variant at max_depth 0, each with lanes at log_sigma +-20,
   +-60 and |theta| >= 2 (a density that is not finite or nearly so), and the
   main path's shape (N=512, max_depth 10): every output equal to the bit
   (NaN equal to NaN), and the contract of the other models (below) too.
   Times both at N=512 and at the batched shape 25 x 512: the kernel on the
   device alone (utils/timing.device_ms: 20 launches queued back to back
   behind a device-side wait, events around them) and one call timed alone
   (the host's launch included), the plain version one call. Then the W = 1
   witness (`ops.nuts_cuda.ARMA_VARIANTS`, one thread a tree, the sequential
   order) equal to the bit to the plain version at group=1, timed in turns
   with the main entry at 25 x 512 and at 1,048,576 trees, with ptxas's
   lines for each.
   Then the staged dispatch at 25 x 512, depth 10: for Philox and zero bits,
   the accept-reject epilogue off and on (the zero-bits cloud holds a lane
   with a NaN density, the only kind zero bits reject), and r given, the
   kernel with the reference's splits, with one split at every depth 1..9
   and with all nine must equal the single kernel to the bit on every lane
   and output, and is held to the plain version to the bit. The staged
   dispatch (as above) and its plain version (one call) are timed.
   The contract of the kernels not held to the bit (phase 11's generated
   model against the hand kernel of the same density): fails when
   fewer than 99.9% of lanes agree on depth, leapfrogs and moved; when x, r,
   logp0, logp_prop or delta_h differ on agreeing lanes by more than
   atol 1e-4 + rtol 1e-4; or when an output is not finite.
4. PRMwCD kernel vs plain: the same cases for the PRMwCD instantiation (a
   group of 16 lanes a particle; a 13-vector inverse mass), plus the batched
   main path's shape, 25 runs x 512 at max_depth 10, where both are timed,
   each held to the plain version summing in the kernel's group order to
   the bit; then PRMwCD's measurement entries (`ops.nuts_cuda.
   PRMWCD_VARIANTS`: the W = 1 witness, one thread a particle; W = 32 in
   blocks of 64; the main path's W = 16 in blocks of 128), each equal to the
   bit to the plain version at its width or to the main entry, all timed in
   turns with the main entry (median of 6 device times) beside ptxas's
   registers, stack and spills for each; then the staged dispatch as in
   phase 3, every single kernel equal to its plain version to the bit.
5. arma main path, one run: SMCSampler(K=100, N=512, step 0.01, max depth 10)
   on the GPU, then `python -m smcnuts_torch` through its main(). Each run
   must launch the kernel exactly 100 times and the plain tree never; every
   series is finite with K+1 entries, acceptance[K] == 0, and each final
   posterior mean lies within one posterior sd of the reference ground truth.
6. the three batched workloads of bench.py, each 25 runs x N=512 x K=100
   through `run_smc_batched` (step 0.01, max depth 10): arma, PRMwCD, and
   PRMwCD with step-size and mass adaptation at target_accept 0.5. Each must
   launch its kernel exactly 100 times and the plain tree never; every series
   is finite with K+1 entries; the 25-run MC mean and variance of the final
   estimates lie in the PARITY bands of experiments/parity_summary.py
   (3 MC standard errors + 0.1 posterior sd; 3 MC standard errors + 40%);
   runs 0 and 24 equal single runs with their seeds, to the bit. The adapted
   run's step size is constant over the frozen iterations, and its mean
   leapfrogs per particle-iteration are below half the fixed run's. Prints
   wall time and particle-iterations/s of each workload. Then each workload
   again with compaction=None and with the staged dispatch in turns (none,
   staged, staged, none): every SMCResult field equal to the bit, K
   dispatches, K x stages kernel launches, no plain call, runs 0 and 24
   equal to their single runs with compaction on, wall beside wall; and the
   first 20 iterations of its loop under torch.profiler (device kernels an
   iteration, device busy time, idle share). Last,
   PRMwCD with 100 runs and compaction="auto" for 5 iterations: past
   the model's compaction_min_lanes "auto" takes the hint, and the runs equal
   those with compaction=None.
6b. times of the staged dispatch: each workload's K iterations are driven
   once more through init_state and smc_step, and on the population they
   end with, the single kernel and every candidate split tuple are timed
   (the device alone, 20 launches back to back), with the survivors after
   each split, the stage launches, and the per-warp lockstep waste (lane-steps
   a warp walks over lane-steps its trees need) from the kernel's own leapfrogs
   and depth outputs (the trees a warp holds: 32, arma's 4, PRMwCD's 2), and
   the block's tail
   (the same count at the trees a block holds). The first 2 and 5 runs of each
   population are timed alone, and each population is also tiled to 2, 4 and
   16 times the lanes: past the lanes the card holds at once, a warp or block
   that ends early makes room for a waiting one, and compaction has
   something to remove.
7. CLI: `python -m smcnuts_torch --model prmwcd --device cuda`, without and
   with --adapt-step-size --adapt-mass-matrix, through its main(): 100
   launches each and finite estimates; then `--model eightschools --lkernel
   asymptoticLKernel` (tempering on, as the CLI sets it): one launch per
   iteration and a schedule that ends at 1.
8. the Gaussian, eight-schools and logistic kernels vs plain: the contract
   and cases of phases 3 and 4 for each of the three models whose gradient
   the JAX package takes by autodiff inside its kernel and this port writes
   out by hand, on a dispersed synthetic cloud: zero bits and Philox, phi 1.0
   and 0.4, a non-unit inverse mass, r given at depth 0, the batched shape
   25 x 512 at depth 10 (timed), then the staged dispatch as in phase 3
   (accept-reject off and on, a lane with a -inf density, r given; every
   split tuple equal to the single kernel to the bit). Each kernel is held
   to its plain version to the bit in every case: the Gaussian's (one thread
   a tree), and the group kernels of logistic regression
   (models.logistic.GROUP lanes a tree) and eight schools
   (models.eightschools.GROUP) in their plain versions' group order; then
   the latter two's W = 1
   witness (`ops.nuts_cuda.LOGISTIC_VARIANTS`, `EIGHTSCHOOLS_VARIANTS`, one
   thread a tree, the sequential order) equal to the bit to the plain
   version at group=1, timed in turns with the main entry at 25 x 512 and at
   1,048,576 trees, with ptxas's lines for each. Last, each model's
   single kernel and a few split tuples timed at 100 x 512 lanes at the step
   size of its run in phase 9: what the models' compaction hints rest on.
9. the three strategies, full width, through `run_smc_batched` with 25 runs:
   arma and PRMwCD at N=512, K=100, depth 10 with the asymptotic L-kernel
   (tempering, saved history) and the Gaussian-approximation L-kernel, inside
   the PARITY bands; the tempered Gaussian (D=3, prior variance 9, N=2048,
   K=20, step 0.5, depth 5, forwards L-kernel) with final moments within
   4 standard errors / 25% of the closed form; eight schools (N=1024, K=30,
   step 0.2, depth 6, forwards L-kernel, tempered) with 3 < mu < 6 and
   2 < tau < 6; logistic regression (N=1024, K=30, step 0.1, depth 6,
   asymptotic) held, by the PARITY bands (3 MC standard errors + 0.1
   reference sd on the means, 3 MC se + 40% on the variances), to one long
   run of the plain tree on the card (N=4096, K=25, forwards L-kernel). The
   loop of the arma and PRMwCD runs is also profiled on its first 20
   iterations (device kernels an iteration, device busy time, idle share). Each run: exactly K
   dispatches and no plain call; a tempered schedule starts above 0, never
   decreases and ends at 1; runs 0 and 24 equal their single runs to the
   bit; for the asymptotic strategy the estimates made inside the loop
   (save_history=False) equal those from the saved history to the bit.
10. the eager backend on the card with the fused ARMA kernel, and the unfused
   proposal path. (a) The fused ARMA value and gradient (K5, models.arma.GROUP
   lanes a particle) against its plain version in the same order at 1, 513,
   4,096, 12,800 and 1,048,576 lanes, with lanes at log_sigma +-20, +-60 and
   |theta| >= 2: equal to the bit; its W = 1 witness likewise against the
   plain version at group=1; both timed in turns on the device alone, with
   the plain version, one call timed alone and the bound, at 4,096 (the
   eager tree's block), 12,800 and 1,048,576 lanes; the device-alone time
   beside torch.profiler's device time of the same launches. (b) The
   slice's path, run_smc_batched(make_arma(fused="cuda"), eager,
   fused_epilogue=False) at 25 x 512 x K=100, depth 10, blocks of 4,096: K5
   launched once per model evaluation of the tree, the whole-tree kernel and
   the plain K5 never; finite series, the PARITY bands, runs 0 and 24 equal
   their single runs; wall, and the profile of 2 iterations; then 3
   iterations beside the plain ARMA loop (fused=None). (c) The unfused path
   on the whole-tree kernel (momenta given, K1u), arma 25 x 512 x K=100:
   forwards with the standard, a diagonal (var 2) and a dense momentum
   proposal, and asymptotic with tempering; the bands, K dispatches with the
   momenta given and no plain tree, runs 0 and 24 equal their single runs;
   K1u against its plain version at 25 x 512 x depth 10, timed. (d) arma at
   N = 1,048,576, one run, K = 2, eager with K5, in one block and in blocks
   of 262,144: every field equal to the bit; wall and peak device memory of
   each call, then the peak of one eager tree alone at each block size.

11. user-written densities: arma written as a scalar torch density
   (`arma_model_fwd`, forward mode, T=200, 3,837 operations) and eight
   schools as a per-particle torch density (`make_eightschools_generated`,
   reverse mode, straight-line, one thread a particle), traced, simplified
   and built into one library each (each
   build's seconds, the values its program holds live at once in emission
   order (`ops.generated.peak_live`), ptxas's registers, stack and spills and
   its SASS instructions; fails past two minutes). K7f is emitted in
   (primal node, pass) order; its witness, the same program in the order it
   was built, is a library of its own; so is K7r split over 2 lanes a
   particle (group=2, its sums over the schools a loop). Each generated
   kernel (K7f, K7r) against its plain version (the program executed op by op
   in torch) at 25 x 512 x depth 10 under zero bits and Philox: equal to the
   bit, and phase 3's contract; staged with a split after every depth equal
   to the single kernel to the bit; against the hand kernel of the same
   density on identical inputs (logp0 at atol/rtol 1e-4, integer outputs on
   99.9% of lanes), both timed in turns. K7f's witness equal to its plain
   program and to K7f's kernel to the bit, and timed in turns with K7f and
   the hand kernel (median of 6); K7r at 2 lanes equal to its plain program
   to the bit, and timed in turns with K7r and the hand K6b at 25 x 512 x
   depth 10, at the tempered run's 25 x 1024 x depth 6, phi 1 and 0.1, and
   at 1,048,576 trees.
   The main path:
   run_smc_batched on the generated arma at 25 x 512 x K=100 inside the
   PARITY bands; the
   generated eight schools at phase 9's settings inside the bands of the hand
   kernel's 25 runs; after each, init_state alone and a profile of the first
   iterations (as phase 9's), generated and hand; the same eight-schools
   density without a generated model, eager by autograd, on the card (5
   iterations).

12. the runner, checkpoints, the CLI's output and phase profiling, on the
   card. (a) arma forwards at 25 x 512 x K=100 through `run_smc_batched`
   and `runner.ChunkedRunner` in chunks of 10, with a checkpoint after each
   and without, in turns (each order forwards, then backwards): every
   SMCResult field equal to the bit, K dispatches a call, no plain call,
   the walls (CUDA events) and what a checkpoint adds. (b) A K=30 run with a checkpoint, then the
   K=100 run from the file: 70 dispatches, equal to (a) to the bit; the
   file's version and k_done. (c) PRMwCD adapted (bench.py:176-178) at
   25 x 512 x K=100, stopped after iteration 40 (its progress callback
   raises) and resumed: equal to the bit, the kernel launches of both sides.
   (d) Eight schools, asymptotic with tempering, N=1024, K=30, step 0.2,
   depth 6, save_history on and off, stopped after iteration 10 and resumed:
   equal to the bit. (e) `python -m smcnuts_torch --model prmwcd -N 512 -K 100
   --checkpoint --chunk-size 10 --output` through its main(): the npz equal
   to the in-process run_smc result in every field, to the bit; run again,
   it resumes at k_done == K, launches no kernel and returns the same
   summary. (f) `utils.profiling.phase_timings` on arma, one run at N=512:
   milliseconds an iteration of each phase. The launches of (a)-(e) count on
   their rows of the kernels line.

13. Stan programs on the card, through the port's frontend (`stan/`):
   examples/stan/radon_intercepts (D = 9, reverse mode, K7r), examples/stan/
   irt_ar (D = 64, forward, K7f) and the AR(1)-error recurrence of
   tests/test_stan_frontend.py at T = 200 (D = 2, forward, K7f). (a), before
   phase 2: each parsed, interpreted and traced on the card's machine
   (seconds each, the mode tile_autodiff="auto" chose, operations a
   leapfrog), then one nvcc each, all at once in the background (beside
   phase 2's); phase 13 prints their seconds and ptxas's lines. (c) run_smc_batched at 25 x 512 x
   K=100, forwards, depth 10, each at its step (STAN_PROGRAMS): K launches,
   no plain call, finite series, runs 0 and 24 equal their single runs to the
   bit; wall and the 25-run means beside the values that generated the data.
   (b) Each kernel against its plain version at 25 x 512 x depth 10 on the
   population (c) ended with, zero bits and Philox: equal to the bit; its
   device time, the plain version's and the bound. (d) radon without a
   generated model, eager by autograd on the card (its logp_and_grad a graph
   traced once and replayed), at 5 x 512 x K=20, beside the kernel's run of
   the same shape: the means within 4 MC standard errors; ms a
   logp_and_grad call of each eager model at 512 particles, interpreted,
   and for radon replayed (equal to the bit). (e)
   `python -m smcnuts_torch --stan radon --data ... --stan-tile -N 512 -K 100
   --step-size 0.05` (K launches, the JAX CLI's keys) and the same without
   --stan-tile at K=10 (eager, no launch), each with acceptance above 0 and
   a final ESS below N (the particles moved).

The line before the last two repeats the card's name and power limit, the
second-to-last line is a JSON object describing the kernels (for each: the
launches on the main path, the error against its plain version, its time,
the plain version's, and the least time the card could take for the same
work, from this run's leapfrog count or particle count over the data
sheet's 67 TFLOP/s, and bytes over the data sheet's memory rate, and
bound_unfused_ms, the same with the FMUL+FADD peak measured in phase 2b for
the operations, what a build with -fmad=false can reach; no single PyTorch
call builds a NUTS tree,
computes the fused ARMA value and gradient or runs FMA chains, so there is no
library time). Every "ms" is the device's time alone (utils/timing.device_ms);
"host_call_ms" beside it is one call timed alone between two events, the
host's launch included, as the rows were timed before. The witnesses' rows
(the W = 1 NUTS kernels of arma, PRMwCD, logistic regression and eight
schools, K5's, K7f in the order it was built and K7r split over 2 lanes) are
measurement entries: 0 launches on the main path and "measurement_entry":
true. The
last line is {"ok": true, "device": {...}}. Without a CUDA device, or without the
repository beside it, the script fails before printing any result.
"""

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import time

import torch

ATOL = RTOL = 1e-4
MIN_AGREE = 0.999
POST_MODE = (0.007, 0.957, -0.034, math.log(0.166))
K, N, MAX_DEPTH, STEP, SEED = 100, 512, 10, 0.01, 0
RUNS = 25  # bench.py's runs per launch
SEEDS = list(range(RUNS))
ADAPT_TARGET = 0.5  # bench.py:176-178
# Mean leapfrogs per particle-iteration that the JAX package counted for
# PRMwCD at this config (experiments/output/adaptation.json): algorithmic
# counts, independent of the device.
JAX_LEAPFROGS = {"fixed": 322.13, "adapted": 62.74}
# The splits of the JAX package's tile models (nuts_pallas.py:1862-1864,
# :1985-1986): what the staged checks run with where a model's own hint for
# this card is empty. The JAX package gives the three autodiff models none;
# (3, 6) is this script's choice for them.
REFERENCE_SPLITS = {"arma": (4,), "prmwcd": (7, 8, 9), "prmwcd_adapted": (5, 6),
                    "gaussian": (3, 6), "eightschools": (3, 6), "logistic": (3, 6)}
CANDIDATE_SPLITS = (
    tuple((s,) for s in range(1, MAX_DEPTH))
    + ((5, 6), (6, 8), (7, 8, 9), (3, 5, 7), (2, 4, 6, 8),
       tuple(range(1, MAX_DEPTH)))
)
# Single splits timed on the tiled populations of phase 6b, beside the
# candidates of more than one split: the depths where each workload's trees end.
WIDE_SINGLES = {"arma": ((2,), (3,), (4,)), "prmwcd": ((6,), (7,), (8,)),
                "prmwcd_adapted": ((4,), (5,), (6,))}
# NVIDIA's data sheet for the H100 SXM at 700 W: FP32 outside the tensor
# cores (a multiply-add counts as two) and device memory.
PEAK_FP32, PEAK_BYTES = 67e12, 3.35e12
# Launches queued back to back behind a device-side wait for each device time
# of the kernels line (utils/timing.py::device_ms).
DEVICE_REPEATS = 20
# The FP32 rates this run measures (phase 2b, K8): "fmul_fadd", the rate of
# separately rounded multiplies and adds, the most a kernel built with
# -fmad=false reaches (every bound_unfused_ms divides by it); "fma" beside it.
MEASURED_PEAK = {}


def roofline(ops, nbytes):
    """The bound keys of the kernels line for work of `ops` FP32 operations
    and `nbytes` bytes moved: bound_ms, the larger of ops over the card's
    FP32 rate (the data sheet's, a multiply and an add fusing into one FMA)
    and bytes over its memory rate; bound_by, which of the two; and
    bound_unfused_ms, the same with the FMUL+FADD peak measured in phase 2b,
    what the port's -fmad=false builds can reach."""
    if "fmul_fadd" not in MEASURED_PEAK:
        raise AssertionError("the FP32 peak (phase 2b) has not been measured")
    t_ops, t_bytes = 1e3 * ops / PEAK_FP32, 1e3 * nbytes / PEAK_BYTES
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_unfused_ms": max(1e3 * ops / MEASURED_PEAK["fmul_fadd"], t_bytes)}
# FP32 operations of one leapfrog, counted from the sources: arma 19 a step
# of the T = 200 recurrence (csrc/arma_model.cuh) and ~100 for the closed
# forms and the leapfrog; PRMwCD 50 an observation x 100 (22 for eta, 22 for
# the covariate sums, 6 more, the expf as one; csrc/prmwcd_model.cuh) and
# ~230 for the prior, the leapfrog and the U-turn tests.
# The three autodiff models, with ~17 D + 30 for the leapfrog, the kinetic
# energy and the U-turn tests: Gaussian (D = 3, with a prior) 53 in the
# density and gradient (csrc/gaussian_model.cuh); eight schools 22 a school
# x 8 and ~25 around them (csrc/eightschools_model.cuh); logistic 44 an
# observation x 64 (15 for eta, 16 for the covariate sums, the expf, log1pf
# and division as one each) and ~60 for the prior and the gradient
# (csrc/logistic_model.cuh).
OPS_PER_LEAPFROG = {"arma": 19 * 200 + 100, "prmwcd": 50 * 100 + 230,
                    "gaussian": 53 + 81, "eightschools": 22 * 8 + 25 + 200,
                    "logistic": 44 * 64 + 60 + 166}
MODEL_DATA_FLOATS = {"arma": 200, "prmwcd": 100 * 12, "gaussian": 9,
                     "eightschools": 24, "logistic": 64 * 9}
# The three models whose in-kernel gradient is written out by hand (the JAX
# package differentiates the named tile density inside its kernel,
# nuts_pallas.py:1094): the step size of the synthetic cloud's trees, and the
# settings of the full-width run (tests/test_nuts_pallas.py:309-353 for the
# first two).
GAUSSIAN = dict(mean=(1.0, -2.0, 3.0), var=(0.5, 2.0, 1.0), prior_var=(9.0, 9.0, 9.0))
AUTODIFF_MODELS = {
    "gaussian": dict(density="smcnuts_tpu/models/gaussian.py:70", cloud_step=0.02,
                     n=2048, k=20, step=0.5, depth=5, lkernel="forwardsLKernel"),
    "eightschools": dict(density="smcnuts_tpu/models/eightschools.py:44",
                         cloud_step=0.02, n=1024, k=30, step=0.2, depth=6,
                         lkernel="forwardsLKernel"),
    "logistic": dict(density="smcnuts_tpu/models/logistic.py:44", cloud_step=0.01,
                     n=1024, k=30, step=0.1, depth=6, lkernel="asymptoticLKernel"),
}
REF_K = 25  # iterations of the logistic reference run on the plain tree
# (coordinate, value) that gives a lane a start density of -inf, per model.
NAN_LANE = {"arma": (3, 200.0), "prmwcd": (0, 200.0), "gaussian": (0, 1e20),
            "eightschools": (1, 200.0), "logistic": (0, 1e20)}


_PHASE_CLOCK = [time.perf_counter()]


def phase(name):
    now = time.perf_counter()
    print(f"\n== {name}  [+{now - _PHASE_CLOCK[0]:.0f} s since the last phase]",
          flush=True)
    _PHASE_CLOCK[0] = now


def device_phase():
    phase("1. device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {name}")
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, "
          f"matmul allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    return name, smi


def build_phase():
    from smcnuts_torch.ops.nuts_cuda import build_library

    phase("2. build")
    t0 = time.perf_counter()
    lib = build_library()
    print(f"built {os.path.relpath(lib.path)} in {lib.build_seconds:.1f} s "
          f"(load {time.perf_counter() - t0:.1f} s), kernel max_depth "
          f"{lib.max_depth}, PRMwCD covariates {lib.prmwcd_n_cov}, schools "
          f"{lib.eightschools_j}, logistic covariates {lib.logistic_dim}")
    n_inst = sum("Compiling entry" in line for line in lib.log.splitlines())
    if lib.build_seconds > 60.0:
        raise AssertionError(f"the build of {n_inst} kernels took "
                             f"{lib.build_seconds:.1f} s, more than a minute")
    print(f"{n_inst} kernels (the NUTS tree's first stage and continuation of "
          f"each entry, the fused ARMA value and gradient, and the FP32 peak's "
          f"eight), one nvcc a source, all at once")
    for line in lib.log.splitlines():
        if ("Compiling entry" in line or "registers" in line or "spill" in line
                or "stack frame" in line):
            print("  ptxas:", line.strip())
    return lib


# ---- phase 2b: the FP32 peak (K8), the denominator of every bound.

PEAK_CHECK_STEPS = 64  # steps of the kernel-vs-plain check


def peak_phase(smi):
    """Phase 2b: K8 against its plain chain, then its rows; sets
    MEASURED_PEAK and returns what the kernels line says of K8."""
    from smcnuts_torch.ops.peak import (
        BLOCKS_PER_SM, CHAINS, STEPS, THREADS, flops, fma_chains, fma_chains_plain,
        launch_size, peak_table)
    from smcnuts_torch.utils.timing import median_ms

    phase("2b. FP32 peak (K8)")
    dev = torch.device("cuda")
    n = launch_size(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"launch: {BLOCKS_PER_SM} blocks of {THREADS} threads on each of {sms} "
          f"SMs, {n} threads; {STEPS} steps a chain")
    x = torch.randn(n, generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    worst = 0.0
    for c in CHAINS:
        plain = fma_chains_plain(x, c, PEAK_CHECK_STEPS)
        sep = fma_chains(x, c, PEAK_CHECK_STEPS, "fmul_fadd")
        fused = fma_chains(x, c, PEAK_CHECK_STEPS, "fma")
        torch.cuda.synchronize()
        if not torch.equal(sep, plain):
            raise AssertionError(f"K8 FMUL+FADD, {c} chains: differs from the plain chain")
        # Each step of a chain rounds once less fused: at most one spacing of
        # the chain's value a step, c chains summed.
        tol = c * PEAK_CHECK_STEPS * 2.0 ** -23 * (float(x.abs().max()) + 0.125 * c + 1.0)
        err = float((fused - plain).abs().max())
        if not err <= tol:
            raise AssertionError(f"K8 FMA, {c} chains: |kernel - plain| {err:.3g} > {tol:.3g}")
        worst = max(worst, err)
        print(f"K8 {c} chains, {PEAK_CHECK_STEPS} steps: FMUL+FADD equal to the plain "
              f"chain to the bit; FMA within {err:.3g} of it (bound {tol:.3g})")
    reset_counts()
    rows = peak_table(dev)
    launches = fma_chains.launches
    for r in rows:
        print(f"peak {r['variant']:9s} {r['nchains']:2d} chains: {r['ms']:.4f} ms a "
              f"launch, {r['tflops']:.3f} TFLOP/s (device alone, median of 5 of 20 "
              f"launches back to back; {smi})")
    for variant in ("fma", "fmul_fadd"):
        MEASURED_PEAK[variant] = 1e12 * max(r["tflops"] for r in rows
                                            if r["variant"] == variant)
    print(f"peak: FMA {MEASURED_PEAK['fma'] / 1e12:.3f} TFLOP/s, FMUL+FADD "
          f"{MEASURED_PEAK['fmul_fadd'] / 1e12:.3f} TFLOP/s ({smi}); every bound "
          f"below divides by the data sheet's {PEAK_FP32 / 1e12:.0f}, every "
          f"bound_unfused_ms by the FMUL+FADD rate (the kernels are built with "
          f"-fmad=false)")
    best = max((r for r in rows if r["variant"] == "fma"), key=lambda r: r["tflops"])
    c = best["nchains"]
    plain_ms = median_ms(lambda: fma_chains_plain(x, c, STEPS), repeats=1, warmup=0)
    host_ms = median_ms(lambda: fma_chains(x, c, STEPS, "fma"), repeats=5)
    work = flops(n, c, STEPS)
    return {"launches": launches, "max_abs_err": worst, "ms": best["ms"],
            "host_call_ms": host_ms, "plain_ms": plain_ms, **roofline(work, 8 * n)}


def reset_counts():
    from smcnuts_torch.ops.arma_fused import arma_ll_vg, arma_ll_vg_plain
    from smcnuts_torch.ops.nuts_cuda import nuts_tree, nuts_tree_plain
    from smcnuts_torch.ops.peak import fma_chains

    nuts_tree.launches = 0
    nuts_tree.model_launches = {k: 0 for k in nuts_tree.model_launches}
    nuts_tree.r_given_launches = {k: 0 for k in nuts_tree.r_given_launches}
    nuts_tree.stage_launches = 0
    nuts_tree.cont_launches = {k: 0 for k in nuts_tree.cont_launches}
    nuts_tree_plain.calls = 0
    nuts_tree_plain.model_calls = 0
    arma_ll_vg.launches = 0
    arma_ll_vg_plain.calls = 0
    fma_chains.launches = 0


def read_counts():
    from smcnuts_torch.ops.nuts_cuda import nuts_tree, nuts_tree_plain

    return dict(nuts_tree.model_launches), nuts_tree_plain.calls


def read_stage_counts():
    """(kernel launches of every stage, launches of each model's
    continuation-stage kernel) since reset_counts."""
    from smcnuts_torch.ops.nuts_cuda import nuts_tree

    return nuts_tree.stage_launches, dict(nuts_tree.cont_launches)


def particles(n, seed, device):
    """arma: three quarters at POST_MODE +- 0.02, one quarter dispersed
    (+- 0.3)."""
    g = torch.Generator(device=device).manual_seed(seed)
    mode = torch.tensor(POST_MODE, device=device)
    x = mode + 0.02 * torch.randn(n, 4, generator=g, device=device)
    q = n // 4
    x[:q] = mode + 0.3 * torch.randn(q, 4, generator=g, device=device)
    return x


def prmwcd_particles(shape, seed, device):
    """PRMwCD: three quarters within 0.1 posterior sd of the posterior mean
    (Gamma on the log scale), one quarter within 1 sd."""
    from smcnuts_torch.models.prmwcd import ground_truth

    mean, var = ground_truth()
    centre = [float(v) for v in mean[:12]] + [math.log(float(mean[12]))]
    sd = [float(v) ** 0.5 for v in var[:12]] + [float(var[12]) ** 0.5 / float(mean[12])]
    g = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(*shape, 13, generator=g, device=device)
    scale = torch.full(shape, 0.1, device=device)
    scale[..., : shape[-1] // 4] = 1.0
    return (torch.tensor(centre, device=device)
            + scale[..., None] * torch.tensor(sd, device=device) * z).contiguous()


def compare(label, model, args, r=None, nan_lanes=False, bitwise=False):
    """Run kernel and plain version on the same inputs; return max abs err."""
    from smcnuts_torch.ops.nuts_cuda import nuts_tree, nuts_tree_plain

    return check_outputs(label, nuts_tree(model, *args, r=r),
                         nuts_tree_plain(model, *args, r=r), nan_lanes=nan_lanes,
                         bitwise=bitwise)


def check_outputs(label, out_k, out_p, nan_lanes=False, quiet=False, bitwise=False):
    """Hold a kernel's outputs to the plain version's by the contract of
    phase 3; return max abs err on agreeing lanes. With nan_lanes, a value
    that is not finite passes where the other side holds the same value.
    With bitwise, every output must also equal the plain version's to the
    bit (NaN equal to NaN)."""
    torch.cuda.synchronize()
    if bitwise:
        diff = bitwise_differences(out_k, out_p)
        if diff:
            raise AssertionError(f"{label}: the kernel differs from its plain "
                                 f"version in {diff}")
    xk, rk, sk = out_k
    xp, rp, sp = out_p
    agree = ((sk["depth"] == sp["depth"]) & (sk["leapfrogs"] == sp["leapfrogs"])
             & (sk["moved"] == sp["moved"]))
    share = float(agree.float().mean())
    if share < MIN_AGREE:
        raise AssertionError(f"{label}: only {100 * share:.3f}% of lanes agree")
    pairs = {"x": (xk, xp), "r": (rk, rp)}
    pairs.update({k: (sk[k], sp[k]) for k in sk})
    worst, diffs = 0.0, []
    for k, (a, b) in pairs.items():
        same = (a == b) | (torch.isnan(a) & torch.isnan(b))
        finite = torch.isfinite(a) & torch.isfinite(b)
        if not bool((finite | same).all() if nan_lanes else finite.all()):
            raise AssertionError(f"{label}: non-finite {k}")
        d = torch.where(same, torch.zeros_like(a), (a - b).abs())
        diffs.append(f"{k}={float(d.max()):.3g}")
        if k in ("x", "r", "logp0", "logp_prop", "delta_h"):
            lanes = agree if d.dim() == 2 else agree[..., None].expand_as(d)
            bad = lanes & ~same & (d > ATOL + RTOL * b.abs())
            if bad.any():
                raise AssertionError(
                    f"{label}: {k} differs beyond atol {ATOL} + rtol {RTOL} "
                    f"on {int(bad.sum())} values of agreeing lanes"
                )
            worst = max(worst, float(d[lanes].max()))
    if not quiet:
        print(f"{label}: {agree.numel()} lanes, mean depth "
              f"{float(sk['depth'].mean()):.3f}, integer outputs agree on "
              f"{100 * share:.3f}%; max |kernel - plain|: {', '.join(diffs)}")
    return worst


def bitwise_differences(a, b):
    """Names of the outputs of two tree calls that differ in any bit (NaN
    equal to NaN)."""
    pairs = {"x": (a[0], b[0]), "r": (a[1], b[1])}
    pairs.update({k: (a[2][k], b[2][k]) for k in a[2]})
    return [k for k, (u, v) in pairs.items()
            if not bool(((u == v) | (torch.isnan(u) & torch.isnan(v))).all())]


def equal_fields(a, b):
    """Names of the SMCResult fields in which a and b differ in any bit."""
    return [f for f, v in a._asdict().items()
            if v is not None and not torch.equal(v, getattr(b, f))]


def single_run_diff(one, res, b):
    """Names of the fields in which the single run `one` differs from run b
    of the batched result `res` in any bit (NaN equal to NaN: a particle
    whose density is NaN, as irt_ar's at a prior draw with |rho| > 1, has a
    NaN weight in both)."""
    def same(u, v):
        return torch.equal(u, v) or (u.is_floating_point() and u.shape == v.shape and bool(
            ((u == v) | (torch.isnan(u) & torch.isnan(v))).all()))

    return [f for f, v in one._asdict().items()
            if v is not None and not same(v, getattr(res, f)[b])]


def tree_roofline(name, out, survivors=(), bundle_rows=0, model=None):
    """The bound keys (`roofline`) for the trees of `out`: their model
    evaluations (the kernel's own leapfrogs output) x the model's
    operations, and the bytes moved (every input read once, every output
    written once, and for a staged dispatch every survivor's bundle column
    written once and read once). A generated `model` counts its program's
    operations, exact, and its data block."""
    x_out, _, st = out
    B, n, D = x_out.shape
    P = B * n
    per_leapfrog = OPS_PER_LEAPFROG[name] if model is None else model.n_ops
    data_floats = MODEL_DATA_FLOATS[name] if model is None else model.data.numel()
    ops = float(st["leapfrogs"].sum()) * per_leapfrog
    floats = (P * D + 3 * B + B * D + data_floats  # inputs
              + 2 * P * D + len(st) * P  # outputs
              + 2 * bundle_rows * sum(survivors))
    return roofline(ops, 4 * floats)


def kernel_times(fn):
    """What the kernels line says of a kernel's time: ms, the device's time a
    call of fn (`utils.timing.device_ms`: DEVICE_REPEATS calls back to back
    behind a device-side wait, events around them), and host_call_ms, the
    median of 5 calls each timed alone between two events on an idle
    stream, the host's launch included (how the rows were timed before
    device_ms; kept beside the device time so that the two compare)."""
    from smcnuts_torch.utils.timing import device_ms, median_ms

    return {"ms": device_ms(fn, repeats=DEVICE_REPEATS),
            "host_call_ms": median_ms(fn, repeats=5)}


def times_text(t):
    """A kernel's times (`kernel_times`) as one printed phrase."""
    return (f"kernel {t['ms']:.4f} ms on the device alone ({DEVICE_REPEATS} launches "
            f"back to back), {t['host_call_ms']:.4f} ms a call timed alone")


def time_pair(label, model, args, smi):
    """The kernel's times (`kernel_times`) and plain_ms, the plain version's
    one call (CUDA events; the caller has just run it on these inputs, and
    one run takes seconds)."""
    from smcnuts_torch.ops.nuts_cuda import nuts_tree, nuts_tree_plain
    from smcnuts_torch.utils.timing import median_ms

    t = kernel_times(lambda: nuts_tree(model, *args))
    t["plain_ms"] = median_ms(lambda: nuts_tree_plain(model, *args), repeats=1, warmup=0)
    print(f"time {label}: {times_text(t)}, plain {t['plain_ms']:.1f} ms ({smi})")
    return t


def staged_kernel_phase(name, model, batch_args, single_out, plain_out, smi,
                        bitwise=False):
    """The staged dispatch of one model at the batched main path's shape,
    against the single kernel (to the bit) and the plain version (by the
    contract; with bitwise, to the bit); returns what the kernels line says
    of it. single_out and plain_out are the outputs for batch_args, computed
    by the caller."""
    from smcnuts_torch.ops.draws import PHILOX, ZERO_BITS
    from smcnuts_torch.ops.nuts_cuda import build_library, nuts_tree, nuts_tree_plain
    from smcnuts_torch.utils.timing import median_ms

    x, seed, step, phi, im, depth, _ = batch_args
    dev = x.device
    own = model.compaction_hint or REFERENCE_SPLITS[name]
    split_sets = tuple(dict.fromkeys(
        (own, REFERENCE_SPLITS[name]) + tuple((s,) for s in range(1, depth))
        + (tuple(range(1, depth)),)))
    # A lane whose start density is -inf, so that its delta_h is NaN (arma:
    # sigma = e^200; PRMwCD: an intercept of 200; eight schools: tau = e^200;
    # Gaussian and logistic: a coordinate of 1e20, whose square overflows):
    # under zero bits u = 2^-24 and the slice lies 16.6 nats below the start,
    # so every finite delta_h accepts and only such a lane rejects.
    x_nan = x.clone()
    x_nan[0, 0, NAN_LANE[name][0]] = NAN_LANE[name][1]
    r = torch.randn(x.shape, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(7))
    cases = (
        ("philox", x, PHILOX, False, None, single_out, plain_out),
        ("philox, acc_rej", x, PHILOX, True, None, None, None),
        ("zero_bits", x_nan, ZERO_BITS, False, None, None, None),
        ("zero_bits, acc_rej", x_nan, ZERO_BITS, True, None, None, None),
        ("philox, acc_rej, r given", x, PHILOX, True, r, None, None),
    )
    worst = 0.0
    for label, xc, source, acc, rc, single, plain in cases:
        label = f"{name} staged [{label}]"
        args = (xc, seed, step, phi, im, depth, source)
        kw = dict(r=rc, acc_rej=acc)
        if single is None:
            single = nuts_tree(model, *args, **kw)
            plain = nuts_tree_plain(model, *args, **kw)
        worst = max(worst, check_outputs(f"{label} single kernel", single, plain,
                                         nan_lanes=True, bitwise=bitwise))
        dh, moved = single[2]["delta_h"], single[2]["moved"]
        if source == ZERO_BITS:
            nan = torch.isnan(dh)
            if not (bool(nan.any()) and bool((moved[nan] == 0).all())
                    and bool((moved[~nan] == 1).any())):
                raise AssertionError(f"{label}: the NaN lane must not move and "
                                     f"others must")
            if acc and not torch.equal(single[0][nan], xc[nan]):
                raise AssertionError(f"{label}: a rejected lane must keep its x")
        for splits in split_sets:
            staged = nuts_tree(model, *args, compaction=splits, **kw)
            if splits == own:
                survivors = survivor_counts()
            diff = bitwise_differences(staged, single)
            if diff:
                raise AssertionError(f"{label}: splits {splits} differ from the "
                                     f"single kernel in {diff}")
            worst = max(worst, check_outputs(f"{label} splits {splits}", staged,
                                             plain, nan_lanes=True, quiet=True,
                                             bitwise=bitwise))
        print(f"{label}: {len(split_sets)} split tuples ({own}, "
              f"{REFERENCE_SPLITS[name]}, one split at each depth "
              f"1..{depth - 1}, all of them) equal the single kernel "
              f"to the bit on every output; lanes that did not move "
              f"{int((moved == 0).sum())}, NaN delta_h {int(torch.isnan(dh).sum())}; "
              f"survivors after {own}: {survivors}")
    staged_out = nuts_tree(model, *batch_args, compaction=own)
    survivors = survivor_counts()
    t = kernel_times(lambda: nuts_tree(model, *batch_args, compaction=own))
    plain_ms = median_ms(
        lambda: nuts_tree_plain(model, *batch_args, compaction=own),
        repeats=1, warmup=0)
    bound = tree_roofline(name, staged_out, survivors,
                          build_library().bundle_rows(x.shape[2]))
    print(f"time {name} staged {own}, {RUNS} x {N} x depth {depth} [philox]: "
          f"{times_text(t)}, in {len(own) + 1} launches a call, plain {plain_ms:.1f} ms "
          f"(one call); {bound_text(bound)} ({smi})")
    return {"max_abs_err": worst, **t, "plain_ms": plain_ms, **bound}


def arma_cloud(n, seed, device):
    """arma particles (n, 4): the cloud of `particles`, and where n allows,
    lanes with log_sigma = +-20 and +-60 (inv_s2 of e^-40, e^40, 0 and inf
    in float32) and lanes with |theta| >= 2, where the error recurrence
    overflows (an inf in the sequential order, an inf or a NaN in the group
    order: a density that is not finite either way)."""
    x = particles(n, seed, device).contiguous()
    for i, (col, v) in enumerate(((3, 20.0), (3, -20.0), (3, 60.0), (3, -60.0),
                                  (2, 2.0), (2, -2.5), (2, 3.0), (2, -7.0))):
        if 4 * (i + 1) < n:
            x[4 * (i + 1), col] = v
    return x


# arma trees timed at the width where one thread a tree fills the card.
WIDE_TREES = 1 << 20


def arma_kernel_phase(smi):
    from smcnuts_torch.models import get_model
    from smcnuts_torch.models.arma import GROUP
    from smcnuts_torch.ops.draws import PHILOX, ZERO_BITS
    from smcnuts_torch.ops.nuts_cuda import build_library, nuts_tree, nuts_tree_plain

    phase("3. arma kernel vs plain")
    dev = torch.device("cuda")
    model = get_model("arma").to(dev)
    lib = build_library()
    print(f"arma entry: W={GROUP} lanes a tree, blocks of {lib.arma_block} threads, "
          f"{lib.arma_blocks_per_sm} blocks an SM at once")
    ones = torch.ones(4, device=dev)
    im = torch.tensor([0.5, 2.0, 1.5, 0.25], device=dev)
    seed2 = torch.tensor([11, 12], dtype=torch.int32, device=dev)
    phis = torch.tensor([1.0, 0.4], device=dev)
    worst = 0.0
    for source in (ZERO_BITS, PHILOX):
        x2 = arma_cloud(4096, 1, dev).view(2, 2048, 4)
        worst = max(worst, compare(
            f"[{source}] phi 1.0 | 0.4, 2 runs x 2048, depth 6", model,
            (x2, seed2, 0.01, phis, ones, 6, source), nan_lanes=True, bitwise=True))
        x1 = arma_cloud(4096, 2, dev)[None]
        worst = max(worst, compare(
            f"[{source}] inv_mass {im.tolist()}, 4096, depth 6", model,
            (x1, 13, 0.01, 1.0, im, 6, source), nan_lanes=True, bitwise=True))
    r = torch.randn(1, 4096, 4, generator=torch.Generator(device=dev).manual_seed(3),
                    device=dev)
    worst = max(worst, compare(
        "[zero_bits] r given, 4096, depth 0", model,
        (arma_cloud(4096, 4, dev)[None], 0, 0.01, 0.7, im, 0, ZERO_BITS), r=r,
        nan_lanes=True, bitwise=True))
    main_args = (particles(N, 5, dev)[None], 21, STEP, 1.0, ones, MAX_DEPTH, PHILOX)
    worst = max(worst, compare(
        f"[philox] main path shape, {N}, depth {MAX_DEPTH}", model, main_args,
        bitwise=True))
    batch_args = (particles(RUNS * N, 6, dev).view(RUNS, N, 4),
                  torch.arange(RUNS, dtype=torch.int32, device=dev), STEP, 1.0,
                  ones, MAX_DEPTH, PHILOX)
    single_out = nuts_tree(model, *batch_args)
    plain_out = nuts_tree_plain(model, *batch_args)
    worst = max(worst, check_outputs(
        f"[philox] batched main path shape, {RUNS} x {N}, depth {MAX_DEPTH}",
        single_out, plain_out, bitwise=True))
    print(f"arma: the group kernel (W={GROUP}) equals its plain version to the bit "
          f"in every case, the lanes whose density is not finite included")
    time_pair(f"arma {N} x depth {MAX_DEPTH} [philox]", model, main_args, smi)
    times = time_pair(f"arma {RUNS} x {N} x depth {MAX_DEPTH} [philox]",
                      model, batch_args, smi)
    bound = tree_roofline("arma", single_out)
    print(f"arma: max |kernel - plain| on agreeing lanes, all cases: {worst:.3g}; "
          f"at {RUNS} x {N}: {bound_text(bound)}")
    whole = {"max_abs_err": worst, **times, **bound}
    small = (arma_cloud(2048, 7, dev).view(2, 1024, 4), seed2, 0.01, phis, ones, 6,
             ZERO_BITS)
    wide = (particles(WIDE_TREES, 8, dev)[None], 31, STEP, 1.0, ones, MAX_DEPTH, PHILOX)
    witness = measurement_entries("arma", model, batch_args, single_out, small, smi,
                                  wide=(wide,))
    wide_out = nuts_tree(model, *wide)
    print(f"arma at {WIDE_TREES} trees, depth {MAX_DEPTH}: "
          f"{bound_text(tree_roofline('arma', wide_out))}")
    return whole, staged_kernel_phase("arma", model, batch_args, single_out,
                                      plain_out, smi, bitwise=True), witness


def prmwcd_kernel_phase(smi):
    from smcnuts_torch.models import get_model
    from smcnuts_torch.ops.draws import PHILOX, ZERO_BITS
    from smcnuts_torch.ops.nuts_cuda import nuts_tree, nuts_tree_plain

    phase("4. PRMwCD kernel vs plain")
    dev = torch.device("cuda")
    model = get_model("prmwcd").to(dev)
    ones = torch.ones(13, device=dev)
    im = torch.tensor([0.5, 2.0, 1.5, 0.25, 1.0, 0.8, 1.2, 0.6, 1.4, 0.9, 1.1,
                       0.7, 3.0], device=dev)
    seed2 = torch.tensor([11, 12], dtype=torch.int32, device=dev)
    phis = torch.tensor([1.0, 0.4], device=dev)
    worst = 0.0
    for source in (ZERO_BITS, PHILOX):
        worst = max(worst, compare(
            f"[{source}] phi 1.0 | 0.4, 2 runs x 1024, depth 6", model,
            (prmwcd_particles((2, 1024), 1, dev), seed2, STEP, phis, ones, 6, source),
            bitwise=True))
        worst = max(worst, compare(
            f"[{source}] 13-vector inv_mass, 2048, depth 6", model,
            (prmwcd_particles((1, 2048), 2, dev), 13, STEP, 1.0, im, 6, source),
            bitwise=True))
    r = torch.randn(1, 2048, 13, generator=torch.Generator(device=dev).manual_seed(3),
                    device=dev)
    worst = max(worst, compare(
        "[zero_bits] r given, 2048, depth 0", model,
        (prmwcd_particles((1, 2048), 4, dev), 0, STEP, 0.7, im, 0, ZERO_BITS), r=r,
        bitwise=True))
    batch_args = (prmwcd_particles((RUNS, N), 5, dev),
                  torch.arange(RUNS, dtype=torch.int32, device=dev), STEP, 1.0,
                  ones, MAX_DEPTH, PHILOX)
    single_out = nuts_tree(model, *batch_args)
    plain_out = nuts_tree_plain(model, *batch_args)
    worst = max(worst, check_outputs(
        f"[philox] batched main path shape, {RUNS} x {N}, depth {MAX_DEPTH}",
        single_out, plain_out, bitwise=True))
    print("PRMwCD: the group kernel equals its plain version to the bit in every case")
    times = time_pair(f"PRMwCD {RUNS} x {N} x depth {MAX_DEPTH} [philox]",
                      model, batch_args, smi)
    bound = tree_roofline("prmwcd", single_out)
    print(f"PRMwCD: max |kernel - plain| on agreeing lanes, all cases: {worst:.3g}; "
          f"at {RUNS} x {N}: {bound_text(bound)}")
    whole = {"max_abs_err": worst, **times, **bound}
    small = (prmwcd_particles((2, 1024), 1, dev),
             torch.tensor([11, 12], dtype=torch.int32, device=dev), STEP,
             torch.tensor([1.0, 0.4], device=dev), torch.ones(13, device=dev), 6,
             ZERO_BITS)
    witness = measurement_entries("prmwcd", model, batch_args, single_out, small, smi)
    return whole, staged_kernel_phase("prmwcd", model, batch_args, single_out,
                                      plain_out, smi, bitwise=True), witness


# Rounds of the timing in turns of phases 3, 4, 8 and 11: each round times
# every entry of a model (on the device alone, DEVICE_REPEATS launches), in
# the opposite order to the round before.
VARIANT_ROUNDS = 6


def timed_in_turns(calls):
    """(times, medians): each of `calls` (name -> function) timed on the
    device alone VARIANT_ROUNDS times, in turns."""
    import statistics

    from smcnuts_torch.utils.timing import device_ms

    names = list(calls)
    rounds = {k: [] for k in names}
    for i in range(VARIANT_ROUNDS):
        for k in (names if i % 2 == 0 else names[::-1]):
            rounds[k].append(device_ms(calls[k], repeats=DEVICE_REPEATS))
    return rounds, {k: statistics.median(v) for k, v in rounds.items()}


def model_ptxas(log, model):
    """ptxas's stack and register lines for every instantiation of the NUTS
    kernel with the model (`"arma"`, `"prmwcd"`, `"logistic"` or
    `"eightschools"`), by a readable name (group width, stage, threads a
    block)."""
    import re

    lines, name = {}, None
    for line in log.splitlines():
        if "Compiling entry" in line:
            name = line.split("'")[1] if "'" in line else line
            lines[name] = []
        elif name is not None and ("stack frame" in line or "registers" in line):
            lines[name].append(line.split(":", 1)[-1].strip())
    # nuts_tree_kernel<ArmaModel<W>, kCont, kBlock>,
    # nuts_tree_kernel<PrmwcdModel<NCov, W>, kCont, kBlock>,
    # nuts_tree_kernel<LogisticModel<Dim, W>, kCont, kBlock> or
    # nuts_tree_kernel<EightSchoolsModel<J, W>, kCont, kBlock>, mangled.
    pattern = re.compile({
        "arma": r"ArmaModelILi(\d+)EEELb([01])ELi(\d+)E",
        "prmwcd": r"PrmwcdModelILi\d+ELi(\d+)EEELb([01])ELi(\d+)E",
        "logistic": r"LogisticModelILi\d+ELi(\d+)EEELb([01])ELi(\d+)E",
        "eightschools": r"EightSchools(?:ModelILi\d+ELi(\d+)EE|Uncapped)ELb([01])ELi(\d+)E"}[model])
    out = {}
    for mangled, info in lines.items():
        m = pattern.search(mangled)
        if m is None:
            continue
        w, cont, block = m.groups()
        label = (f"W={w or '2 uncapped'}, {'continuation' if cont == '1' else 'first stage'}, "
                 f"{block} threads")
        out[label] = "; ".join(info)
    if not out:
        raise AssertionError(f"no {model} instantiation found in the nvcc log")
    return out


def measurement_entries(name, model, batch_args, single_out, small, smi, wide=()):
    """A model's measurement entries (`ops.nuts_cuda.ARMA_VARIANTS`,
    `PRMWCD_VARIANTS`, `LOGISTIC_VARIANTS` or `EIGHTSCHOOLS_VARIANTS`) at the
    batched main path's
    shape: each entry of another
    group width than the main path's equal to the plain version at its width
    (`model.at_group(W)`) to the bit, the W = 1 witness (one thread a particle,
    the sequential order) also on `small` (phi 1.0 and 0.4, zero bits); an
    entry of the main path's width equal to the main path's entry to the
    bit. Then every entry timed in turns (on the device alone, median of
    VARIANT_ROUNDS), with ptxas's lines; for each argument tuple of `wide`
    (other shapes, not checked against the plain version, which would take
    too long there) the main entry and the witness once more in turns there.
    Returns what the
    kernels line says of the witness: a measurement entry, which the main
    path launches no time."""
    from smcnuts_torch.models import arma, eightschools, logistic, prmwcd
    from smcnuts_torch.ops.nuts_cuda import (
        ARMA_VARIANTS, EIGHTSCHOOLS_VARIANTS, LOGISTIC_VARIANTS, PRMWCD_VARIANTS,
        build_library, nuts_tree, nuts_tree_plain, nuts_tree_variant)
    from smcnuts_torch.utils.timing import CudaTimer, median_ms

    variants, mod = {"arma": (ARMA_VARIANTS, arma), "prmwcd": (PRMWCD_VARIANTS, prmwcd),
                     "logistic": (LOGISTIC_VARIANTS, logistic),
                     "eightschools": (EIGHTSCHOOLS_VARIANTS, eightschools)}[name]
    group, block = mod.GROUP, mod.BLOCK
    witness_key = next(v for v, (_, g, _) in variants.items() if g == 1)
    for v in variants:
        nuts_tree_variant.launches[v] = 0
    errs = {witness_key: [check_outputs(
        f"{name} witness W=1 [zero_bits] phi 1.0 | 0.4, small cloud", nuts_tree_variant(
            witness_key, model, *small), nuts_tree_plain(model.at_group(1), *small),
        nan_lanes=True, bitwise=True)]}
    outs, plain_ms, plains = {}, {}, {}
    for variant, (_, w, b) in variants.items():
        out = nuts_tree_variant(variant, model, *batch_args)
        label = f"{name} {variant} (W={w}, {b} threads) {RUNS} x {N}, depth {MAX_DEPTH}"
        if w == group:
            diff = bitwise_differences(out, single_out)
            if diff:
                raise AssertionError(f"{label}: differs from the main entry in {diff}")
            print(f"{label}: equal to the main path's entry to the bit")
        else:
            if w not in plains:
                with CudaTimer() as t:
                    plains[w] = nuts_tree_plain(model.at_group(w), *batch_args)
                plain_ms[variant] = t.ms
            errs.setdefault(variant, []).append(check_outputs(
                f"{label} vs plain group={w}", out, plains[w], bitwise=True))
        outs[variant] = out
    witness_host = median_ms(lambda: nuts_tree_variant(witness_key, model, *batch_args),
                             repeats=5)

    def in_turns(calls, args_label):
        rounds, med = timed_in_turns(calls)
        for k in calls:
            print(f"time {name} {k} ({described[k]}), {args_label} [philox]: "
                  f"{med[k]:.4f} ms, {med[witness_key] / med[k]:.3f}x faster than the "
                  f"W=1 witness (device alone, {DEVICE_REPEATS} launches back to "
                  f"back; median of {VARIANT_ROUNDS} in turns: "
                  f"{', '.join(f'{v:.4f}' for v in rounds[k])}; {smi})")
        return med

    described = {"main": f"W={group}, {block} threads, the main path's entry"}
    described.update({v: f"W={w}, {b} threads" for v, (_, w, b) in variants.items()})
    calls = {"main": lambda: nuts_tree(model, *batch_args)}
    calls.update({v: (lambda v=v: nuts_tree_variant(v, model, *batch_args))
                  for v in variants})
    med = in_turns(calls, f"{RUNS} x {N} x depth {MAX_DEPTH}")
    for args in wide:
        x = args[0]
        in_turns({"main": lambda: nuts_tree(model, *args),
                  witness_key: lambda: nuts_tree_variant(witness_key, model, *args)},
                 f"{x.shape[0]} x {x.shape[1]} x depth {args[5]}, step {args[2]}")
    lib = build_library()
    for label, info in model_ptxas(lib.log, name).items():
        print(f"  ptxas {name} {label}: {info}")
    witness = outs[witness_key]
    bound = tree_roofline(name, witness)
    print(f"{name} witness W=1: {bound_text(bound)}; launches in this phase (not on "
          f"the main path) {nuts_tree_variant.launches[witness_key]}")
    return {"launches": 0, "measurement_entry": True,
            "max_abs_err": max(errs[witness_key]), "ms": med[witness_key],
            "host_call_ms": witness_host, "plain_ms": plain_ms[witness_key], **bound}


def check_run(label, mean, means_ok_sd):
    from smcnuts_torch.models.arma import ground_truth

    gt_mean, gt_var = ground_truth()
    sd = gt_var ** 0.5
    z = [(m - g) / s for m, g, s in zip(mean, gt_mean, sd)]
    print(f"{label}: final means {[round(m, 5) for m in mean]}, "
          f"ground truth {[round(float(g), 5) for g in gt_mean]}, "
          f"(mean - truth) / sd {[round(float(v), 3) for v in z]}")
    if not all(math.isfinite(v) and abs(v) <= means_ok_sd for v in z):
        raise AssertionError(f"{label}: a final mean is more than "
                             f"{means_ok_sd} posterior sd from the ground truth")


def check_series(label, res, k):
    """Every series finite with k+1 entries on its iteration axis (axis -2
    for the estimates, -1 for the scalar series)."""
    for name, v in res._asdict().items():
        if v is None or name in ("x_saved", "logw_saved", "x_final", "logw_final"):
            continue
        axis = -2 if name in ("mean_estimate", "variance_estimate") else -1
        if v.shape[axis] != k + 1 or not torch.isfinite(v.float()).all():
            raise AssertionError(f"{label}: series {name}: shape "
                                 f"{tuple(v.shape)} or not finite")


def quiet_cli(argv):
    """`python -m smcnuts_torch` through its main(); its JSON summary is
    returned, not printed."""
    from smcnuts_torch.__main__ import main as cli_main

    with contextlib.redirect_stdout(io.StringIO()):
        return cli_main(argv)


def main_path_phase(smi):
    from smcnuts_torch import SMCSampler
    from smcnuts_torch.models import get_model
    from smcnuts_torch.utils.timing import CudaTimer

    phase("5. arma main path, one run")
    sampler = SMCSampler(K=K, N=N, target=get_model("arma"), step_size=STEP,
                         device="cuda")
    reset_counts()
    with CudaTimer() as t:
        res = sampler.sample(seed=SEED)
    counts, plain_calls = read_counts()
    wall_ms = t.ms
    print(f"SMCSampler: kernel launches {counts}, plain calls {plain_calls}")
    if counts["arma"] != K or plain_calls != 0:
        raise AssertionError("the main path did not run the kernel once per iteration")
    check_series("SMCSampler", res, K)
    if float(res.acceptance_rate[K]) != 0.0:
        raise AssertionError("acceptance[K] must be 0")
    check_run("SMCSampler", res.mean_estimate[K].tolist(), 1.0)
    ess = res.ess.cpu()
    print(f"SMCSampler: ESS final {float(ess[K]):.1f}, min {float(ess.min()):.1f}; "
          f"resampled {int(res.resampled.sum())}/{K}; mean tree depth "
          f"{float(res.tree_depth[:K].mean()):.3f}, leapfrogs "
          f"{float(res.tree_leapfrogs[:K].mean()):.2f}; acceptance "
          f"{float(res.acceptance_rate[:K].mean()):.3f}")
    rate = N * K / (wall_ms / 1000.0)
    print(f"SMCSampler: wall {wall_ms:.1f} ms for K={K} (CUDA events, results "
          f"on the host), {rate:.0f} particle-iterations/s, host run_time "
          f"{sampler.run_time:.3f} s ({smi})")
    launches = counts["arma"]

    reset_counts()
    summary = quiet_cli(["--model", "arma", "-N", str(N), "-K", str(K),
                         "--step-size", str(STEP), "--max-tree-depth",
                         str(MAX_DEPTH), "--seed", str(SEED), "--device", "cuda"])
    counts, plain_calls = read_counts()
    print(f"CLI: kernel launches {counts}, plain calls {plain_calls}")
    if counts["arma"] != K or plain_calls != 0:
        raise AssertionError("the CLI run did not run the kernel once per iteration")
    if summary["phi_schedule"] != [1.0] * (K + 1):
        raise AssertionError("phi must stay 1 without tempering")
    check_run("CLI", summary["mean"], 1.0)
    return launches + counts["arma"]


def parity_bands(label, name, final_mean, final_var):
    """The PARITY verdict of experiments/parity_summary.py:45-54 over the
    runs' final estimates (R, D): |MC mean - truth| <= 3 MC se + 0.1
    posterior sd, and for the variances <= 3 MC se + 40%."""
    from smcnuts_torch.models import ground_truth

    gt_mean, gt_var = (torch.as_tensor(v, dtype=torch.float64)
                       for v in ground_truth(name))
    m, v = final_mean.double().cpu(), final_var.double().cpu()
    r = m.shape[0]
    mean_err = (m.mean(0) - gt_mean).abs()
    mean_band = 3.0 * m.std(0) / r ** 0.5 + 0.1 * gt_var.sqrt()
    var_err = (v.mean(0) - gt_var).abs()
    var_band = 3.0 * v.std(0) / r ** 0.5 + 0.40 * gt_var.abs()
    print(f"{label}: MC mean {[round(float(a), 4) for a in m.mean(0)]}")
    print(f"{label}: |MC mean - truth| / band "
          f"{[round(float(a), 3) for a in mean_err / mean_band]}")
    print(f"{label}: |MC var - truth| / band "
          f"{[round(float(a), 3) for a in var_err / var_band]}")
    if not (bool((mean_err <= mean_band).all()) and bool((var_err <= var_band).all())):
        raise AssertionError(f"{label}: outside the PARITY bands")


WORKLOADS = (  # label, model, adapted
    ("arma", "arma", False),
    ("prmwcd", "prmwcd", False),
    ("prmwcd_adapted", "prmwcd", True),
)


def workload_config(adapt):
    from smcnuts_torch import SMCConfig

    return SMCConfig(
        n_particles=N, n_iterations=K, step_size=STEP,
        max_tree_depth=MAX_DEPTH, save_history=False,
        adapt_step_size=adapt, adapt_mass_matrix=adapt,
        target_accept=ADAPT_TARGET if adapt else 0.8,
    )


def compaction_on(label, name, model, cfg, res_auto, smi):
    """One workload with compaction=None and with the staged dispatch, in
    turns (none, staged, staged, none), through run_smc_batched: every field
    of the results equal to the bit (and to the "auto" result), K dispatches
    and K x stages kernel launches with no plain call, runs 0 and the last
    equal to their single runs with compaction on. Returns the launches of
    the continuation-stage kernel in the first staged run."""
    import dataclasses

    from smcnuts_torch import run_smc, run_smc_batched
    from smcnuts_torch.sampler import resolve_compaction
    from smcnuts_torch.utils.timing import CudaTimer

    auto = resolve_compaction(cfg, model, RUNS * N)
    hint = (model.compaction_hint_adapted if cfg.adapt_step_size
            else model.compaction_hint)
    splits = hint or REFERENCE_SPLITS[label]
    stages = len(splits) + 1
    cfgs = {"none": dataclasses.replace(cfg, compaction=None),
            "staged": dataclasses.replace(cfg, compaction=splits)}
    walls, results, cont = {"none": [], "staged": []}, {}, None
    for turn in ("none", "staged", "staged", "none"):
        reset_counts()
        with CudaTimer() as t:
            res = run_smc_batched(model, cfgs[turn], SEEDS, "cuda")
            res.mean_estimate[:, K].cpu()
        walls[turn].append(t.ms)
        counts, plain_calls = read_counts()
        stage_launches, cont_counts = read_stage_counts()
        want = K * (stages if turn == "staged" else 1)
        if (counts[name] != K or plain_calls != 0 or stage_launches != want
                or cont_counts[name] != want - K):
            raise AssertionError(
                f"{label} compaction {turn}: {counts} dispatches, "
                f"{stage_launches} kernel launches ({cont_counts} of the "
                f"continuation kernel), {plain_calls} plain calls; expected "
                f"{K}, {want}, {want - K}, 0")
        if turn == "staged" and cont is None:
            cont = cont_counts
        results[turn] = res
    for turn, res in results.items():
        diff = equal_fields(res_auto, res)
        if diff:
            raise AssertionError(f"{label}: compaction {turn} differs from "
                                 f"\"auto\" in {diff}")
    for b in (0, RUNS - 1):
        diff = single_run_diff(run_smc(model, cfgs["staged"], SEEDS[b], "cuda"),
                               results["staged"], b)
        if diff:
            raise AssertionError(f"{label}: staged run {b} differs from its "
                                 f"single run in {diff}")
    print(f"{label}: \"auto\" at {RUNS * N} lanes is {auto or 'the single kernel'}"
          f", the model's hint {hint or 'none'}; staged with "
          f"{splits}: every SMCResult field equals compaction=None to the bit; "
          f"{K} dispatches, {K * stages} kernel launches, no plain call; runs 0 "
          f"and {RUNS - 1} equal their single runs")
    print(f"{label}: wall in turns, compaction=None "
          f"{', '.join(f'{v:.1f}' for v in walls['none'])} ms, staged {splits} "
          f"{', '.join(f'{v:.1f}' for v in walls['staged'])} ms (CUDA events, "
          f"results on the host; {smi})")
    return cont


def wide_auto_run(smi, tiles=4, k=5):
    """PRMwCD with tiles x RUNS runs and the default compaction="auto": past
    the model's compaction_min_lanes "auto" must take its hint, so k
    iterations are k dispatches of len(hint) + 1 kernel launches, and equal
    the same runs with compaction=None to the bit. Returns the launches of
    the continuation-stage kernel."""
    import dataclasses

    from smcnuts_torch import run_smc_batched
    from smcnuts_torch.models import get_model
    from smcnuts_torch.sampler import resolve_compaction
    from smcnuts_torch.utils.timing import CudaTimer

    model = get_model("prmwcd")
    cfg = dataclasses.replace(workload_config(False), n_iterations=k)
    seeds = list(range(tiles * RUNS))
    splits = resolve_compaction(cfg, model, len(seeds) * N)
    if len(seeds) * N <= model.compaction_min_lanes or splits != model.compaction_hint:
        raise AssertionError(f"\"auto\" at {len(seeds) * N} lanes gave {splits}")
    results, walls = {}, {}
    for compaction in ("auto", None, None, "auto"):
        reset_counts()
        with CudaTimer() as t:
            res = run_smc_batched(
                model, dataclasses.replace(cfg, compaction=compaction), seeds, "cuda")
            res.mean_estimate[:, k].cpu()
        walls.setdefault(compaction, []).append(t.ms)
        counts, plain_calls = read_counts()
        stage_launches, cont = read_stage_counts()
        want = k * (len(splits) + 1 if compaction else 1)
        if counts["prmwcd"] != k or stage_launches != want or plain_calls != 0:
            raise AssertionError(
                f"wide run, compaction={compaction}: {counts} dispatches, "
                f"{stage_launches} kernel launches, {plain_calls} plain calls")
        if compaction:
            cont_auto = cont["prmwcd"]
        results[compaction] = res
    diff = equal_fields(results[None], results["auto"])
    if diff:
        raise AssertionError(f"wide run: \"auto\" differs from None in {diff}")
    print(f"prmwcd, {len(seeds)} runs x N={N} x K={k} ({len(seeds) * N} lanes, "
          f"past the model's compaction_min_lanes {model.compaction_min_lanes}): "
          f"\"auto\" "
          f"is {splits}, {k} dispatches of {len(splits) + 1} kernel launches, "
          f"every field equal to compaction=None; wall in turns, auto "
          f"{', '.join(f'{v:.1f}' for v in walls['auto'])} ms, None "
          f"{', '.join(f'{v:.1f}' for v in walls[None])} ms (CUDA events; {smi})")
    return cont_auto


def batched_phase(smi):
    from smcnuts_torch import run_smc, run_smc_batched
    from smcnuts_torch.models import get_model
    from smcnuts_torch.utils.timing import CudaTimer

    phase(f"6. batched workloads, {RUNS} runs x N={N} x K={K}")
    launches, leapfrogs = {"arma": 0, "prmwcd": 0}, {}
    cont_launches = {"arma": 0, "prmwcd": 0}
    for label, name, adapt in WORKLOADS:
        cfg = workload_config(adapt)
        model = get_model(name)
        reset_counts()
        t0 = time.perf_counter()
        with CudaTimer() as t:
            res = run_smc_batched(model, cfg, SEEDS, "cuda")
            final_mean = res.mean_estimate[:, K].cpu()
        host_s = time.perf_counter() - t0
        counts, plain_calls = read_counts()
        _, cont_first = read_stage_counts()
        wall_ms = t.ms
        print(f"{label}: kernel launches {counts}, plain calls {plain_calls}, "
              f"continuation-stage launches {cont_first[name]}")
        if counts[name] != K or sum(counts.values()) != K or plain_calls != 0:
            raise AssertionError(f"{label}: not one kernel launch per iteration")
        launches[name] += counts[name]
        cont_launches[name] += cont_first[name]
        check_series(label, res, K)
        if res.mean_estimate.shape[0] != RUNS:
            raise AssertionError(f"{label}: expected {RUNS} runs")
        rate = RUNS * N * K / (wall_ms / 1000.0)
        lf = float(res.tree_leapfrogs[:, :K].mean())
        leapfrogs[label] = lf
        print(f"{label}: wall {wall_ms:.1f} ms (CUDA events, results on the "
              f"host; host clock {host_s:.3f} s), {rate:.0f} "
              f"particle-iterations/s ({smi})")
        print(f"{label}: mean tree depth {float(res.tree_depth[:, :K].mean()):.3f}, "
              f"leapfrogs per particle-iteration {lf:.2f}, acceptance "
              f"{float(res.acceptance_rate[:, :K].mean()):.3f}, resampled "
              f"{int(res.resampled.sum())}/{RUNS * K}, final ESS mean "
              f"{float(res.ess[:, K].mean()):.1f}, final step size mean "
              f"{float(res.step_size[:, K].mean()):.5f}")
        parity_bands(label, name, final_mean, res.variance_estimate[:, K])
        if adapt:
            w = max(1, round(cfg.adapt_warmup_frac * K))
            frozen = res.step_size[:, w:]
            if not bool((frozen == frozen[:, :1]).all()):
                raise AssertionError(f"{label}: step size moves after warmup")
            print(f"{label}: step size constant over iterations {w}..{K} of "
                  f"every run")
        for b in (0, RUNS - 1):
            diff = single_run_diff(run_smc(model, cfg, SEEDS[b], "cuda"), res, b)
            if diff:
                raise AssertionError(f"{label}: run {b} differs from its single "
                                     f"run in {diff}")
        print(f"{label}: runs 0 and {RUNS - 1} equal single runs with their "
              f"seeds, bit for bit")
        cont_launches[name] += compaction_on(label, name, model, cfg, res, smi)[name]
        profile_call(label, model, cfg, smi)
    cont_launches["prmwcd"] += wide_auto_run(smi)
    fixed, adapted = leapfrogs["prmwcd"], leapfrogs["prmwcd_adapted"]
    print(f"PRMwCD leapfrogs per particle-iteration: fixed {fixed:.2f}, adapted "
          f"{adapted:.2f} (the JAX package counted {JAX_LEAPFROGS['fixed']} and "
          f"{JAX_LEAPFROGS['adapted']}, experiments/output/adaptation.json)")
    if not adapted < 0.5 * fixed:
        raise AssertionError("adaptation did not shorten the PRMwCD trees")
    return launches, cont_launches


def survivor_counts():
    """Lanes still at work after each split of the last dispatch."""
    from smcnuts_torch.ops.nuts_cuda import nuts_tree

    return [] if nuts_tree.survivors is None else nuts_tree.survivors.tolist()


def tree_slots(model):
    """(trees a warp holds, trees a block holds) in the NUTS kernel: arma,
    PRMwCD, eight schools and logistic regression run a group of GROUP lanes
    a tree in blocks of BLOCK threads (their models/ modules), every other
    model one lane in blocks of 128 threads."""
    from smcnuts_torch.models import ArmaModel, LogisticModel, PrmwcdModel, arma, prmwcd
    from smcnuts_torch.models import eightschools, logistic
    from smcnuts_torch.models.eightschools import EightSchoolsModel

    for cls, mod in ((ArmaModel, arma), (PrmwcdModel, prmwcd), (LogisticModel, logistic),
                     (EightSchoolsModel, eightschools)):
        if isinstance(model, cls):
            return 32 // mod.GROUP, mod.BLOCK // mod.GROUP
    return 32, 128


def candidate_times(label, model, args, smi, candidates=None):
    """Time the single kernel and each candidate split tuple on one
    population (on the device alone, DEVICE_REPEATS launches back to back),
    the single kernel first and last; print survivors, launches, the
    per-warp lockstep waste and the block's tail (lockstep_waste at the
    trees a warp and a block hold)."""
    from smcnuts_torch.ops.nuts_cuda import lockstep_waste, nuts_tree
    from smcnuts_torch.utils.timing import device_ms

    warp, block = tree_slots(model)
    single = nuts_tree(model, *args)
    depth, leapfrogs = single[2]["depth"], single[2]["leapfrogs"]
    hist = torch.bincount(depth.reshape(-1).int()).tolist()
    print(f"{label}: {depth.numel()} lanes, mean depth {float(depth.mean()):.3f}, "
          f"leapfrogs per lane {float(leapfrogs.mean()):.2f}, lanes by depth {hist}")
    rows = []
    for splits in ((),) + tuple(candidates or CANDIDATE_SPLITS) + ((),):
        staged = nuts_tree(model, *args, compaction=splits)
        survivors = survivor_counts()
        if bitwise_differences(staged, single):
            raise AssertionError(f"{label}: splits {splits} differ from the "
                                 f"single kernel")
        ms = device_ms(lambda: nuts_tree(model, *args, compaction=splits),
                       repeats=DEVICE_REPEATS)
        walked, needed = lockstep_waste(leapfrogs, depth, splits, width=warp)
        tail, _ = lockstep_waste(leapfrogs, depth, splits, width=block)
        rows.append((splits, ms))
        print(f"  {label} splits {splits or 'none'}: {ms:.4f} ms, "
              f"{len(splits) + 1} launches, survivors {survivors}, waste of a "
              f"warp ({warp} trees) {walked / needed:.4f} ({walked} / {needed} "
              f"lane-steps), of a block ({block} trees) {tail / needed:.4f}")
    best = min(rows, key=lambda row: row[1])
    print(f"{label}: fastest {best[0] or 'none'} at {best[1]:.4f} ms; single "
          f"kernel {rows[0][1]:.4f} and {rows[-1][1]:.4f} ms ({smi})")


def staged_times_phase(smi):
    from smcnuts_torch.models import get_model
    from smcnuts_torch.ops.draws import PHILOX, run_draws
    from smcnuts_torch.sampler import init_state, smc_step

    phase(f"6b. times of the staged dispatch on each workload's population, "
          f"{RUNS} x {N}, depth {MAX_DEPTH}")
    dev = torch.device("cuda")
    seeds_t = torch.tensor(SEEDS, dtype=torch.int64, device=dev)
    for label, name, adapt in WORKLOADS:
        cfg = workload_config(adapt)
        model = get_model(name).to(dev)
        carry = init_state(model, cfg, SEEDS, dev)
        uniforms, tree_seeds = run_draws(seeds_t, range(K + 1), N, carry.x.dtype)
        for k in range(K):
            carry, _ = smc_step(model, cfg, carry, uniforms[k], tree_seeds[k], "cuda")
        print(f"{label}: population after {K} iterations, step size mean "
              f"{float(carry.step_size.mean()):.5f}, inverse mass from "
              f"{float(carry.inv_mass.min()):.4g} to {float(carry.inv_mass.max()):.4g}")
        args = (carry.x, tree_seeds[K], carry.step_size, 1.0, carry.inv_mass,
                MAX_DEPTH, PHILOX)
        candidate_times(label, model, args, smi)
        few = tuple(c for c in CANDIDATE_SPLITS if len(c) > 1) + WIDE_SINGLES[label]
        # The first runs of the population alone: around one block an SM of
        # the PRMwCD kernel (1,024 trees at 16 lanes a tree fill 128 blocks).
        for runs in (2, 5):
            part = (carry.x[:runs], tree_seeds[K][:runs], carry.step_size[:runs], 1.0,
                    carry.inv_mass[:runs], MAX_DEPTH, PHILOX)
            candidate_times(f"{label} runs 0..{runs - 1} ({runs} x {N})", model, part,
                            smi, few)
        # The same population tiled over more runs, each with its own seed.
        # Once the lanes exceed what the card holds at once, a warp that ends
        # early makes room for a waiting one.
        for tiles in (2, 4, 16):
            wide = (carry.x.repeat(tiles, 1, 1),
                    torch.arange(tiles * RUNS, dtype=torch.int32, device=dev),
                    carry.step_size.repeat(tiles), 1.0,
                    carry.inv_mass.repeat(tiles, 1), MAX_DEPTH, PHILOX)
            candidate_times(f"{label} x {tiles} ({tiles * RUNS} x {N})", model,
                            wide, smi, few)


def cli_phase():
    phase("7. CLI, PRMwCD and eight schools")
    launches = 0
    for extra in ([], ["--adapt-step-size", "--adapt-mass-matrix"]):
        reset_counts()
        summary = quiet_cli(["--model", "prmwcd", "-N", str(N), "-K", str(K),
                             "--device", "cuda", "--seed", "3"] + extra)
        counts, plain_calls = read_counts()
        print(f"CLI {' '.join(extra) or '(fixed step)'}: kernel launches "
              f"{counts}, plain calls {plain_calls}; final means "
              f"{[round(v, 4) for v in summary['mean']]}")
        if counts["prmwcd"] != K or plain_calls != 0:
            raise AssertionError("the CLI run did not run the kernel once per iteration")
        if not all(math.isfinite(v) for v in summary["mean"] + summary["variance"]):
            raise AssertionError("the CLI estimates are not finite")
        launches += counts["prmwcd"]
    # The asymptotic strategy through the CLI, which turns tempering on for it.
    k = 8
    reset_counts()
    summary = quiet_cli(["--model", "eightschools", "-N", "128", "-K", str(k),
                         "--lkernel", "asymptoticLKernel", "--step-size", "0.2",
                         "--max-tree-depth", "5", "--device", "cuda"])
    counts, plain_calls = read_counts()
    print(f"CLI --model eightschools --lkernel asymptoticLKernel: kernel launches "
          f"{counts}, plain calls {plain_calls}; phi schedule "
          f"{summary['phi_schedule']}; final mu {summary['mean'][0]:.3f}, tau "
          f"{summary['mean'][1]:.3f}")
    phis = summary["phi_schedule"]
    if counts["eightschools"] != k or sum(counts.values()) != k or plain_calls != 0:
        raise AssertionError("the CLI run did not run the kernel once per iteration")
    if not (0 < phis[0] and phis[-1] == 1.0 and phis == sorted(phis)
            and all(math.isfinite(v) for v in summary["mean"] + summary["variance"])):
        raise AssertionError("the CLI run's schedule or estimates are wrong")
    return launches, counts["eightschools"]


def autodiff_model(name):
    from smcnuts_torch.models import get_model, make_gaussian

    return make_gaussian(**GAUSSIAN) if name == "gaussian" else get_model(name)


def autodiff_cloud(name, shape, seed, device):
    """A dispersed cloud (..., D) for one of the three models: three quarters
    of each run at one scale around the centre, one quarter at three times
    it. Gaussian: the target's own mean and sd; eight schools: around
    mu 4.4, log tau 1.2, tt 0 with sd 3, 0.5, 1; logistic: N(0, 0.7^2)."""
    if name == "gaussian":
        centre = list(GAUSSIAN["mean"])
        sd = [v ** 0.5 for v in GAUSSIAN["var"]]
    elif name == "eightschools":
        centre, sd = [4.4, 1.2] + [0.0] * 8, [3.0, 0.5] + [1.0] * 8
    else:
        centre, sd = [0.0] * 8, [0.7] * 8
    g = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(*shape, len(centre), generator=g, device=device)
    scale = torch.ones(shape, device=device)
    scale[..., : shape[-1] // 4] = 3.0
    return (torch.tensor(centre, device=device)
            + scale[..., None] * torch.tensor(sd, device=device) * z).contiguous()


def autodiff_kernel_phase(name, smi):
    """Phase 8 for one model; returns what the kernels line says of it and,
    for logistic regression and eight schools, of its W = 1 witness (else
    None)."""
    from smcnuts_torch.models import eightschools, logistic
    from smcnuts_torch.ops.draws import PHILOX, ZERO_BITS
    from smcnuts_torch.ops.nuts_cuda import build_library, nuts_tree, nuts_tree_plain

    dev = torch.device("cuda")
    model = autodiff_model(name).to(dev)
    D = model.dim
    step = AUTODIFF_MODELS[name]["cloud_step"]
    ones = torch.ones(D, device=dev)
    im = torch.linspace(0.5, 2.0, D, device=dev)
    seed2 = torch.tensor([11, 12], dtype=torch.int32, device=dev)
    # Each kernel computes in the order of its plain version (the logistic
    # and eight-schools group kernels in their lanes' order): held to it to
    # the bit, lanes whose density is not finite included.
    group_mod = {"logistic": logistic, "eightschools": eightschools}.get(name)
    if group_mod is not None:
        lib = build_library()
        print(f"{name} entry: W={group_mod.GROUP} lanes a tree, blocks of "
              f"{group_mod.BLOCK} threads, {getattr(lib, f'{name}_blocks_per_sm')} "
              f"blocks an SM at once")
    worst = 0.0
    for source in (ZERO_BITS, PHILOX):
        worst = max(worst, compare(
            f"{name} [{source}] phi 1.0 | 0.4, 2 runs x 1024, depth 6", model,
            (autodiff_cloud(name, (2, 1024), 1, dev), seed2, step,
             torch.tensor([1.0, 0.4], device=dev), ones, 6, source), bitwise=True))
        worst = max(worst, compare(
            f"{name} [{source}] {D}-vector inv_mass, 2048, depth 6", model,
            (autodiff_cloud(name, (1, 2048), 2, dev), 13, step, 1.0, im, 6, source),
            bitwise=True))
    r = torch.randn(1, 2048, D, generator=torch.Generator(device=dev).manual_seed(3),
                    device=dev)
    worst = max(worst, compare(
        f"{name} [zero_bits] r given, 2048, depth 0", model,
        (autodiff_cloud(name, (1, 2048), 4, dev), 0, step, 0.7, im, 0, ZERO_BITS),
        r=r, bitwise=True))
    batch_args = (autodiff_cloud(name, (RUNS, N), 5, dev),
                  torch.arange(RUNS, dtype=torch.int32, device=dev), step, 1.0,
                  ones, MAX_DEPTH, PHILOX)
    single_out = nuts_tree(model, *batch_args)
    plain_out = nuts_tree_plain(model, *batch_args)
    worst = max(worst, check_outputs(
        f"{name} [philox] batched shape, {RUNS} x {N}, depth {MAX_DEPTH}",
        single_out, plain_out, bitwise=True))
    kernel = "the kernel" if group_mod is None else f"the group kernel (W={group_mod.GROUP})"
    print(f"{name}: {kernel} equals its plain version to the bit in every case")
    times = time_pair(f"{name} {RUNS} x {N} x depth {MAX_DEPTH} [philox]",
                      model, batch_args, smi)
    bound = tree_roofline(name, single_out)
    witness = None
    if group_mod is not None:
        small = (autodiff_cloud(name, (2, 1024), 7, dev), seed2, step,
                 torch.tensor([1.0, 0.4], device=dev), ones, 6, ZERO_BITS)
        small[0][0, 0, NAN_LANE[name][0]] = NAN_LANE[name][1]
        wide = (autodiff_cloud(name, (1, WIDE_TREES), 8, dev), 31, step, 1.0, ones,
                MAX_DEPTH, PHILOX)
        # Beside the 1,048,576 trees: the shapes of the model's own runs, at
        # their step and depth, 100 x 512 (the compaction hint's) and
        # RUNS x n (the full-width run of phase 9).
        cfg = AUTODIFF_MODELS[name]
        own = tuple((autodiff_cloud(name, (runs, n), 6, dev),
                     torch.arange(runs, dtype=torch.int32, device=dev), cfg["step"],
                     1.0, ones, cfg["depth"], PHILOX)
                    for runs, n in ((4 * RUNS, N), (RUNS, cfg["n"])))
        witness = measurement_entries(name, model, batch_args, single_out, small, smi,
                                      wide=own + (wide,))
        wide_out = nuts_tree(model, *wide)
        print(f"{name} at {WIDE_TREES} trees, depth {MAX_DEPTH}: "
              f"{bound_text(tree_roofline(name, wide_out))}")
    staged = staged_kernel_phase(name, model, batch_args, single_out, plain_out, smi,
                                 bitwise=True)
    worst = max(worst, staged["max_abs_err"])
    print(f"{name}: max |kernel - plain| on agreeing lanes, all cases, staged "
          f"included: {worst:.3g}; at {RUNS} x {N}: {bound_text(bound)}; staged "
          f"dispatch {staged['ms']:.4f} ms")
    # What the model's compaction hint rests on: 100 x 512 lanes at the step
    # size of the model's own run.
    cfg = AUTODIFF_MODELS[name]
    wide = (autodiff_cloud(name, (4 * RUNS, N), 6, dev),
            torch.arange(4 * RUNS, dtype=torch.int32, device=dev), cfg["step"],
            1.0, ones, cfg["depth"], PHILOX)
    candidate_times(f"{name} {4 * RUNS} x {N}, step {cfg['step']}, depth "
                    f"{cfg['depth']}", model, wide, smi,
                    ((1,), (2,), (3,), (1, 2), (2, 4), tuple(range(1, cfg["depth"]))))
    return {"max_abs_err": worst, **times, **bound}, witness


def autodiff_kernels_phase(smi):
    """Phase 8: what the kernels line says of each model, and of the W = 1
    witnesses of logistic regression and eight schools."""
    phase("8. Gaussian, eight-schools and logistic kernels vs plain")
    rows = {name: autodiff_kernel_phase(name, smi) for name in AUTODIFF_MODELS}
    return ({name: row for name, (row, _) in rows.items()},
            {name: w for name, (_, w) in rows.items() if w is not None})


def one_model_phase(name):
    """Phase 8 for one model alone (`--only logistic` or `--only
    eightschools`)."""
    def run(smi):
        phase(f"8. {name} kernel vs plain")
        return autodiff_kernel_phase(name, smi)
    return run


def estimates_band(label, got_mean, got_var, ref_mean, ref_var):
    """The PARITY bands of `parity_bands` against a reference run's moments."""
    m, v = got_mean.double().cpu(), got_var.double().cpu()
    ref_mean, ref_var = ref_mean.double().cpu(), ref_var.double().cpu()
    r = m.shape[0]
    mean_err = (m.mean(0) - ref_mean).abs()
    mean_band = 3.0 * m.std(0) / r ** 0.5 + 0.1 * ref_var.sqrt()
    var_err = (v.mean(0) - ref_var).abs()
    var_band = 3.0 * v.std(0) / r ** 0.5 + 0.40 * ref_var.abs()
    print(f"{label}: MC mean {[round(float(a), 4) for a in m.mean(0)]}, "
          f"reference {[round(float(a), 4) for a in ref_mean]}")
    print(f"{label}: |MC mean - reference| / band "
          f"{[round(float(a), 3) for a in mean_err / mean_band]}, variances "
          f"{[round(float(a), 3) for a in var_err / var_band]}")
    if not (bool((mean_err <= mean_band).all()) and bool((var_err <= var_band).all())):
        raise AssertionError(f"{label}: outside the bands (3 MC se + 0.1 sd; "
                             f"3 MC se + 40%)")


PROFILE_ITERATIONS = 20


def profile_call(label, model, cfg, smi, momentum_proposal=None,
                 iterations=PROFILE_ITERATIONS):
    """Where an iteration's time goes, for RUNS runs
    (`utils.profiling.profile_iterations`): prints the device kernels per
    iteration, the device's busy time, its idle share of the wall time, and
    the time of the port's own kernels. A measurement, not a check: without
    device events it says so and goes on."""
    from smcnuts_torch.utils.profiling import profile_iterations

    p = profile_iterations(model, cfg, SEEDS, iterations, momentum_proposal, "cuda")
    if p is None:
        print(f"{label}: torch.profiler recorded no device event; launches per "
              f"iteration and idle share not measured")
        return
    own = [f"{name} {launches:.1f} launches and {ms:.3f} ms an iteration, "
           f"{share:.3f} of the device time"
           for name, (launches, ms, share) in p["own"].items()]
    print(f"{label}: iterations 0..{p['iterations'] - 1} of the loop, {RUNS} runs: "
          f"{p['ms']:.3f} ms an iteration (CUDA events, unprofiled); under "
          f"torch.profiler {p['kernels']:.1f} device kernels an iteration, "
          f"device busy {p['busy_ms']:.3f} ms an iteration, idle share "
          f"{p['idle_share']:.3f}; {'; '.join(own) or 'no kernel of the port'} "
          f"({smi})")


def strategy_run(label, name, model, cfg, smi, profiled=False):
    """One full-width configuration through run_smc_batched with RUNS runs:
    K dispatches, no plain call, finite series, the tempered schedule, runs 0
    and the last equal to their single runs, and for the asymptotic strategy
    the estimates of the other save_history mode equal to the bit. Returns
    (result, dispatches of the batched run, its launches of the
    continuation-stage kernel)."""
    import dataclasses

    from smcnuts_torch import run_smc, run_smc_batched
    from smcnuts_torch.utils.timing import CudaTimer

    k = cfg.n_iterations
    reset_counts()
    t0 = time.perf_counter()
    with CudaTimer() as t:
        res = run_smc_batched(model, cfg, SEEDS, "cuda")
        res.mean_estimate[:, k].cpu()
    host_s = time.perf_counter() - t0
    counts, plain_calls = read_counts()
    stage_launches, cont = read_stage_counts()
    if counts[name] != k or sum(counts.values()) != k or plain_calls != 0:
        raise AssertionError(f"{label}: {counts} dispatches, {plain_calls} plain "
                             f"calls; expected {k} and 0")
    check_series(label, res, k)
    if float(res.acceptance_rate[:, k].abs().max()) != 0.0:
        raise AssertionError(f"{label}: acceptance[K] must be 0")
    phi = res.phi
    if cfg.tempering:
        if not (bool((phi[:, 0] > 0).all()) and bool((phi[:, 1:] >= phi[:, :-1]).all())
                and bool((phi[:, k] == 1).all())):
            raise AssertionError(f"{label}: the schedule must start above 0, "
                                 f"never decrease and end at 1")
        reached = (phi < 1).sum(1)
        sched = (f"phi[0] from {float(phi[:, 0].min()):.4g} to "
                 f"{float(phi[:, 0].max()):.4g}, 1 reached after "
                 f"{int(reached.min())} to {int(reached.max())} iterations")
    else:
        if not bool((phi == 1).all()):
            raise AssertionError(f"{label}: phi must stay 1 without tempering")
        sched = "phi = 1"
    rate = RUNS * cfg.n_particles * k / (t.ms / 1000.0)
    print(f"{label}: {k} dispatches ({stage_launches} kernel launches), no plain "
          f"call; wall {t.ms:.1f} ms (CUDA events, results on the host; host clock "
          f"{host_s:.3f} s), {rate:.0f} particle-iterations/s ({smi})")
    print(f"{label}: {sched}; mean tree depth "
          f"{float(res.tree_depth[:, :k].mean()):.3f}, leapfrogs per "
          f"particle-iteration {float(res.tree_leapfrogs[:, :k].mean()):.2f}, "
          f"acceptance {float(res.acceptance_rate[:, :k].mean()):.3f}, resampled "
          f"{int(res.resampled.sum())}/{RUNS * k}, final ESS mean "
          f"{float(res.ess[:, k].mean()):.1f}")
    for b in (0, RUNS - 1):
        diff = single_run_diff(run_smc(model, cfg, SEEDS[b], "cuda"), res, b)
        if diff:
            raise AssertionError(f"{label}: run {b} differs from its single run "
                                 f"in {diff}")
    same = f"runs 0 and {RUNS - 1} equal their single runs, bit for bit"
    if cfg.is_asymptotic:
        other = run_smc_batched(
            model, dataclasses.replace(cfg, save_history=not cfg.save_history),
            SEEDS, "cuda")
        diff = [f for f in ("mean_estimate", "variance_estimate", "phi", "x_final",
                            "logw_final", "ess")
                if not torch.equal(getattr(other, f), getattr(res, f))]
        if diff:
            raise AssertionError(f"{label}: save_history={not cfg.save_history} "
                                 f"differs in {diff}")
        same += ("; the recycled estimates made inside the loop equal those "
                 "from the saved history, bit for bit")
    print(f"{label}: {same}")
    if profiled:
        profile_call(label, model, cfg, smi)
    return res, counts[name], cont[name]


def strategies_phase(smi):
    from smcnuts_torch import SMCConfig, run_smc
    from smcnuts_torch.models import get_model, tempered_moments

    phase(f"9. the three strategies, full width, {RUNS} runs each")
    launches, cont = {}, {}

    def add(name, n, n_cont):
        launches[name] = launches.get(name, 0) + n
        cont[name] = cont.get(name, 0) + n_cont

    for name in ("arma", "prmwcd"):
        for lkernel in ("asymptoticLKernel", "GaussianApproxLKernel"):
            asym = lkernel == "asymptoticLKernel"
            cfg = SMCConfig(n_particles=N, n_iterations=K, step_size=STEP,
                            lkernel=lkernel, tempering=asym, save_history=asym,
                            max_tree_depth=MAX_DEPTH)
            label = f"{name} {lkernel}"
            res, n, n_cont = strategy_run(label, name, get_model(name), cfg, smi,
                                          profiled=True)
            add(name, n, n_cont)
            parity_bands(label, name, res.mean_estimate[:, K].cpu(),
                         res.variance_estimate[:, K])

    for name, c in AUTODIFF_MODELS.items():
        cfg = SMCConfig(n_particles=c["n"], n_iterations=c["k"], step_size=c["step"],
                        lkernel=c["lkernel"], tempering=True, save_history=False,
                        max_tree_depth=c["depth"])
        label = f"{name} {c['lkernel']} tempered"
        res, n, n_cont = strategy_run(label, name, autodiff_model(name), cfg, smi)
        add(name, n, n_cont)
        k = c["k"]
        mean, var = res.mean_estimate[:, k].double().cpu(), res.variance_estimate[:, k].double().cpu()
        if name == "gaussian":
            # tests/test_nuts_pallas.py:326-330, for every run.
            want_mean, want_var = tempered_moments(
                GAUSSIAN["mean"], GAUSSIAN["var"], GAUSSIAN["prior_var"], 1.0)
            want_mean, want_var = torch.as_tensor(want_mean), torch.as_tensor(want_var)
            ess = res.ess[:, k].double().cpu()
            se = (want_var.max() / ess).sqrt()
            z = ((mean - want_mean).abs() / se[:, None]).max()
            rel = ((var - want_var).abs() / want_var).max()
            print(f"{label}: closed-form mean {want_mean.tolist()}, variance "
                  f"{want_var.tolist()}; over {RUNS} runs the worst |mean error| "
                  f"is {float(z):.3f} se, the worst relative variance error "
                  f"{float(rel):.4f}, the least final ESS {float(ess.min()):.1f}")
            if not (float(ess.min()) > 1000 and float(z) <= 4.0 and float(rel) <= 0.25):
                raise AssertionError(f"{label}: outside ESS > 1000, 4 se, rtol 0.25")
        elif name == "eightschools":
            mu, tau = mean[:, 0], mean[:, 1]
            print(f"{label}: mu from {float(mu.min()):.3f} to {float(mu.max()):.3f}, "
                  f"tau from {float(tau.min()):.3f} to {float(tau.max()):.3f} "
                  f"over {RUNS} runs")
            if not (bool(((3.0 < mu) & (mu < 6.0)).all())
                    and bool(((2.0 < tau) & (tau < 6.0)).all())):
                raise AssertionError(f"{label}: outside 3 < mu < 6, 2 < tau < 6")
        else:
            # The reference: one long run of the plain tree on the card.
            long_cfg = SMCConfig(n_particles=4096, n_iterations=REF_K, step_size=c["step"],
                                 max_tree_depth=c["depth"], save_history=False,
                                 nuts_backend="eager")
            reset_counts()
            ref = run_smc(autodiff_model(name), long_cfg, 12345, "cuda")
            counts, plain_calls = read_counts()
            if sum(counts.values()) != 0 or plain_calls != REF_K:
                raise AssertionError(f"{label}: the reference run must take the "
                                     f"plain tree: {counts}, {plain_calls}")
            estimates_band(f"{label} vs plain-tree run (N=4096, K={REF_K}, forwards)",
                           mean, var, ref.mean_estimate[REF_K],
                           ref.variance_estimate[REF_K])
    return launches, cont

# ---- phase 10: the eager backend with the fused ARMA kernel (K5), the
# unfused proposal path on the whole-tree kernel (K1u), a wide eager run.

# FP32 operations of one particle in the fused ARMA kernel, counted from
# arma_loglik_grad (csrc/arma_model.cuh), the recurrence OPS_PER_LEAPFROG
# counts for the arma leapfrog: 19 a step of the T = 200 recurrence (3 for
# b_t, 2 each for the error and its three tangents, 2 each for the four sums;
# a negation folds into its FADD or FMUL and costs nothing) and 20 around it
# (8 for the first step, 12 for the loglik and gradient, expf as one).
ARMA_T = 200
ARMA_FUSED_OPS = 19 * (ARMA_T - 1) + 20
ARMA_FUSED_SIZES = (1, 513, 4096, RUNS * N, 1 << 20)
# The main path's shape: a leaf of the eager tree evaluates one block of
# eager_block_size = 4096 lanes (the last block of 25 x 512 holds 512).
EAGER_BLOCK = 4096
ARMA_FUSED_TIMED = (EAGER_BLOCK, RUNS * N, 1 << 20)
# Launches back to back for each device time of K5 (a few microseconds each).
FUSED_REPEATS = 200
WIDE_N, WIDE_K, WIDE_BLOCK = 1 << 20, 2, 1 << 18
FULL_COV = ((1.5, 0.3, 0.0, 0.0), (0.3, 1.0, 0.2, 0.0), (0.0, 0.2, 0.8, 0.0),
            (0.0, 0.0, 0.0, 1.2))


def fused_roofline(n):
    """The bound keys (`roofline`) of the fused kernel for n particles:
    n x ARMA_FUSED_OPS operations; 16 bytes in and 20 out a particle and y
    once."""
    return roofline(n * ARMA_FUSED_OPS, 36 * n + 4 * ARMA_T)


def bound_text(bound):
    """The bound keys as one printed phrase."""
    return (f"bound {bound['bound_ms']:.5f} ms by {bound['bound_by']} (FMUL+FADD: "
            f"{bound['bound_unfused_ms']:.5f} ms)")


def fused_equal(label, got, want):
    """Hold a fused kernel's (loglik, grad) to its plain version's to the bit
    (NaN equal to NaN); returns the non-finite values of each side."""
    for name, a, b in (("loglik", got[0], want[0]), ("grad", got[1], want[1])):
        if not bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all()):
            d = (a - b).abs().nan_to_num(nan=float("inf"))
            raise AssertionError(f"{label}: {name} differs from the plain version "
                                 f"(max |diff| {float(d.max()):.3g})")
    return int((~torch.isfinite(got[0])).sum() + (~torch.isfinite(got[1])).sum())


def profiled_device_ms(fn, kernel, repeats):
    """(ms, count): the mean device time of the CUDA kernels whose name holds
    `kernel` that torch.profiler records over `repeats` calls of fn (one
    warmup), and how many it recorded: the cross-check of
    utils/timing.device_ms, which also counts the device's gap between two
    launches back to back."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for evt in prof.key_averages():
        if kernel in evt.key:
            total_us += getattr(evt, "device_time_total", None) or evt.cuda_time_total
            count += evt.count
    if count == 0:
        raise AssertionError(f"the profile holds no device kernel named *{kernel}*")
    return total_us / 1000.0 / count, count


def arma_fused_kernel_phase(smi):
    """10a: the fused ARMA kernel (W = GROUP lanes a particle) against its
    plain version at the same width on the same CUDA inputs at five sizes,
    equal to the bit, the lanes at log_sigma +-20, +-60 and |theta| >= 2
    included; its measurement entries (`FUSED_VARIANTS`: the one-thread
    witness and other widths) equal to the bit to the plain version at their
    width. Then every entry timed in turns on the device alone at the main
    path's block, 4,096 lanes, at 25 x 512 and at 1,048,576, the main entry's
    host-inclusive call time beside it, and the device-alone time
    cross-checked against torch.profiler's."""
    import statistics

    from smcnuts_torch.models import get_model
    from smcnuts_torch.ops.arma_fused import (
        FUSED_VARIANTS, GROUP, arma_ll_vg, arma_ll_vg_plain, arma_ll_vg_variant)
    from smcnuts_torch.utils.timing import device_ms, median_ms

    phase("10a. fused ARMA value and gradient (K5) vs plain")
    dev = torch.device("cuda")
    y = get_model("arma").to(dev).y32
    for v in FUSED_VARIANTS:
        arma_ll_vg_variant.launches[v] = 0
    for n in ARMA_FUSED_SIZES:
        theta = arma_cloud(n, 40 + n % 97, dev)
        nonfinite = fused_equal(f"K5 (W={GROUP}) at {n} lanes", arma_ll_vg(theta, y),
                                arma_ll_vg_plain(theta, y))
        print(f"K5 (W={GROUP}) at {n} lanes: equal to the plain version at W={GROUP} "
              f"to the bit, {nonfinite} non-finite values on both sides alike")
    theta = arma_cloud(EAGER_BLOCK, 41, dev)
    for v, (_, w) in FUSED_VARIANTS.items():
        fused_equal(f"K5 {v} at {EAGER_BLOCK} lanes", arma_ll_vg_variant(theta, y, v),
                    arma_ll_vg_plain(theta, y, group=w))
    print(f"K5 entries {sorted(FUSED_VARIANTS)} at {EAGER_BLOCK} lanes: each equal to "
          f"the plain version at its width to the bit")
    names = ["main", *FUSED_VARIANTS]
    widths = {"main": GROUP, **{v: w for v, (_, w) in FUSED_VARIANTS.items()}}
    times = {}
    for n in ARMA_FUSED_TIMED:
        theta = arma_cloud(n, 7, dev)
        calls = {"main": lambda: arma_ll_vg(theta, y)}
        calls.update({v: (lambda v=v: arma_ll_vg_variant(theta, y, v))
                      for v in FUSED_VARIANTS})
        rounds = {k: [] for k in names}
        for i in range(VARIANT_ROUNDS):
            for k in (names if i % 2 == 0 else names[::-1]):
                rounds[k].append(device_ms(calls[k], repeats=FUSED_REPEATS))
        med = {k: statistics.median(v) for k, v in rounds.items()}
        host_ms = median_ms(calls["main"], repeats=5)
        plain_ms = median_ms(lambda: arma_ll_vg_plain(theta, y), repeats=5)
        bound = fused_roofline(n)
        times[n] = (med, host_ms, plain_ms, bound)
        for k in names:
            print(f"time K5 {k} (W={widths[k]}) at {n} lanes: {med[k]:.5f} ms on the "
                  f"device alone ({FUSED_REPEATS} launches back to back; median of "
                  f"{VARIANT_ROUNDS} in turns: {', '.join(f'{v:.5f}' for v in rounds[k])}),"
                  f" {med['w1'] / med[k]:.3f}x faster than the W=1 witness ({smi})")
        print(f"time K5 at {n} lanes: a call timed alone {host_ms:.5f} ms (median of 5, "
              f"the host's launch included), plain {plain_ms:.3f} ms; "
              f"{bound_text(bound)} ({smi})")
    theta = arma_cloud(EAGER_BLOCK, 7, dev)
    prof_ms, count = profiled_device_ms(lambda: arma_ll_vg(theta, y), "arma_ll_vg_kernel",
                                        FUSED_REPEATS)
    alone = device_ms(lambda: arma_ll_vg(theta, y), repeats=FUSED_REPEATS)
    print(f"K5 at {EAGER_BLOCK} lanes: torch.profiler's device time {prof_ms:.5f} ms a "
          f"kernel (mean of the {count} it recorded of {FUSED_REPEATS} calls) against "
          f"device_ms {alone:.5f} ms a call ({smi})")
    med, host_ms, plain_ms, bound = times[ARMA_FUSED_TIMED[0]]
    k5 = {"max_abs_err": 0.0, "ms": med["main"], "host_call_ms": host_ms,
          "plain_ms": plain_ms, **bound}
    witness = {"launches": 0, "measurement_entry": True, "max_abs_err": 0.0,
               "ms": med["w1"],
               "host_call_ms": median_ms(lambda: arma_ll_vg_variant(theta, y, "w1"),
                                         repeats=5),
               "plain_ms": median_ms(lambda: arma_ll_vg_plain(theta, y, group=1),
                                     repeats=5), **bound}
    return k5, witness


def eager_config(**kw):
    from smcnuts_torch import SMCConfig

    return SMCConfig(n_particles=N, n_iterations=K, step_size=STEP,
                     max_tree_depth=MAX_DEPTH, nuts_backend="eager",
                     fused_epilogue=False, **kw)


def eager_arma_phase(smi):
    """10b: the slice's path at full width, run_smc_batched(make_arma(
    fused="cuda"), eager, fused_epilogue=False) with 25 runs x 512 x K=100 at
    the default eager_block_size: K5 launched once per model evaluation of
    the tree, the whole-tree kernel and the plain K5 never; finite series,
    the PARITY bands, runs 0 and 24 equal to their single runs. Then 3
    iterations against the plain ARMA loop (fused=None). Returns K5's
    launches."""
    import dataclasses

    from smcnuts_torch import run_smc, run_smc_batched
    from smcnuts_torch.models import make_arma
    from smcnuts_torch.ops.arma_fused import arma_ll_vg, arma_ll_vg_plain
    from smcnuts_torch.ops.nuts_cuda import nuts_tree_plain
    from smcnuts_torch.utils.timing import CudaTimer

    phase(f"10b. eager arma path with K5, {RUNS} runs x N={N} x K={K}")
    cfg = eager_config()
    label = "arma eager, fused=\"cuda\", unfused proposal"
    reset_counts()
    t0 = time.perf_counter()
    with CudaTimer() as t:
        res = run_smc_batched(make_arma(fused="cuda"), cfg, SEEDS, "cuda")
        res.mean_estimate[:, K].cpu()
    host_s = time.perf_counter() - t0
    counts, plain_calls = read_counts()
    k5, evals = arma_ll_vg.launches, nuts_tree_plain.model_calls
    print(f"{label}: K5 launches {k5}, model evaluations of the tree {evals}, "
          f"plain tree calls {plain_calls}, whole-tree kernel {counts}, plain K5 "
          f"calls {arma_ll_vg_plain.calls}")
    if not (k5 == evals > 0 and plain_calls == K and sum(counts.values()) == 0
            and arma_ll_vg_plain.calls == 0):
        raise AssertionError(f"{label}: K5 must run every model evaluation of the "
                             f"eager tree, and nothing else may run")
    check_series(label, res, K)
    print(f"{label}: wall {t.ms:.1f} ms (CUDA events, results on the host; host "
          f"clock {host_s:.3f} s), {t.ms / K:.1f} ms an iteration, "
          f"{RUNS * N * K / (t.ms / 1000.0):.0f} particle-iterations/s, "
          f"{k5 / K:.1f} K5 launches an iteration ({smi})")
    print(f"{label}: mean tree depth {float(res.tree_depth[:, :K].mean()):.3f}, "
          f"leapfrogs per particle-iteration {float(res.tree_leapfrogs[:, :K].mean()):.2f}, "
          f"acceptance {float(res.acceptance_rate[:, :K].mean()):.3f}, resampled "
          f"{int(res.resampled.sum())}/{RUNS * K}")
    parity_bands(label, "arma", res.mean_estimate[:, K].cpu(), res.variance_estimate[:, K])
    for b in (0, RUNS - 1):
        diff = single_run_diff(run_smc(make_arma(fused="cuda"), cfg, SEEDS[b], "cuda"),
                               res, b)
        if diff:
            raise AssertionError(f"{label}: run {b} differs from its single run in {diff}")
    print(f"{label}: runs 0 and {RUNS - 1} equal their single runs, bit for bit")
    # Two iterations: an eager iteration takes seconds, and the profile runs three.
    profile_call(label, make_arma(fused="cuda"), dataclasses.replace(cfg, n_iterations=2),
                 smi, iterations=2)
    # What K5 removes: three iterations with the plain ARMA loop as the model.
    short = dataclasses.replace(cfg, n_iterations=3)
    walls = {}
    for name, fused in (("K5", "cuda"), ("plain ARMA loop", None)):
        with CudaTimer() as t:
            out = run_smc_batched(make_arma(fused=fused), short, SEEDS, "cuda")
            out.mean_estimate[:, 3].cpu()
        walls[name] = (t.ms, out)
    same = not equal_fields(walls["K5"][1], walls["plain ARMA loop"][1])
    print(f"{label}, K=3: {walls['K5'][0] / 3:.1f} ms an iteration with K5, "
          f"{walls['plain ARMA loop'][0] / 3:.1f} ms with the plain ARMA loop "
          f"(fused=None); results {'equal to the bit' if same else 'differ'} "
          f"(CUDA events; {smi})")
    return k5


def unfused_kernel_phase(smi):
    """10c: the unfused proposal path on the whole-tree kernel (momenta given,
    K1u): arma 25 x 512 x K=100 with fused_epilogue=False, forwards with the
    standard, a diagonal and a dense momentum proposal, and asymptotic with
    tempering: inside the bands, K dispatches with the momenta given and no
    plain tree, runs 0 and 24 equal their single runs. Then K1u against its
    plain version at 25 x 512, depth 10, timed. Returns (r-given launches,
    what the kernels line says of K1u)."""
    from smcnuts_torch import (
        DiagNormalProposal, FullNormalProposal, SMCConfig, run_smc, run_smc_batched)
    from smcnuts_torch.models import get_model
    from smcnuts_torch.ops.draws import PHILOX
    from smcnuts_torch.ops.nuts_cuda import nuts_tree, nuts_tree_plain
    from smcnuts_torch.utils.timing import CudaTimer, median_ms

    phase(f"10c. unfused proposal path on the kernel (K1u), {RUNS} runs x N={N} x K={K}")
    base = dict(n_particles=N, n_iterations=K, step_size=STEP,
                max_tree_depth=MAX_DEPTH, fused_epilogue=False)
    forwards = SMCConfig(**base)
    cases = (
        ("forwards, standard momentum", forwards, None),
        ("forwards, DiagNormalProposal(var=2)", forwards,
         DiagNormalProposal(4, var=(2.0, 2.0, 2.0, 2.0))),
        ("forwards, FullNormalProposal", forwards,
         FullNormalProposal(mean=(0.0,) * 4, cov=FULL_COV)),
        ("asymptotic, tempered", SMCConfig(**base, lkernel="asymptoticLKernel",
                                           tempering=True), None),
    )
    model = get_model("arma")
    r_given = 0
    for name, cfg, mp in cases:
        label = f"arma unfused, {name}"
        reset_counts()
        with CudaTimer() as t:
            res = run_smc_batched(model, cfg, SEEDS, "cuda", momentum_proposal=mp)
            res.mean_estimate[:, K].cpu()
        counts, plain_calls = read_counts()
        given = nuts_tree.r_given_launches["arma"]
        if counts["arma"] != K or given != K or plain_calls != 0:
            raise AssertionError(f"{label}: {counts} dispatches, {given} with the "
                                 f"momenta given, {plain_calls} plain calls")
        r_given += given
        check_series(label, res, K)
        print(f"{label}: {K} dispatches with the momenta given, no plain call; wall "
              f"{t.ms:.1f} ms (CUDA events, results on the host; {smi}); acceptance "
              f"{float(res.acceptance_rate[:, :K].mean()):.3f}, final ESS mean "
              f"{float(res.ess[:, K].mean()):.1f}")
        parity_bands(label, "arma", res.mean_estimate[:, K].cpu(), res.variance_estimate[:, K])
        for b in (0, RUNS - 1):
            diff = single_run_diff(
                run_smc(model, cfg, SEEDS[b], "cuda", momentum_proposal=mp), res, b)
            if diff:
                raise AssertionError(f"{label}: run {b} differs from its single run in {diff}")
        print(f"{label}: runs 0 and {RUNS - 1} equal their single runs, bit for bit")
    dev = torch.device("cuda")
    model = model.to(dev)
    args = (particles(RUNS * N, 8, dev).view(RUNS, N, 4),
            torch.arange(RUNS, dtype=torch.int32, device=dev), STEP, 1.0,
            torch.ones(4, device=dev), MAX_DEPTH, PHILOX)
    r = torch.randn(RUNS, N, 4, generator=torch.Generator(device=dev).manual_seed(9),
                    device=dev)
    out = nuts_tree(model, *args, r=r)
    worst = check_outputs(f"K1u [philox] r given, {RUNS} x {N}, depth {MAX_DEPTH}",
                          out, nuts_tree_plain(model, *args, r=r), bitwise=True)
    t = kernel_times(lambda: nuts_tree(model, *args, r=r))
    plain_ms = median_ms(lambda: nuts_tree_plain(model, *args, r=r), repeats=1, warmup=0)
    bound = tree_roofline("arma", out)
    print(f"time K1u {RUNS} x {N} x depth {MAX_DEPTH} [philox, r given]: "
          f"{times_text(t)}, plain {plain_ms:.1f} ms (one call); "
          f"{bound_text(bound)} ({smi})")
    return r_given, {"max_abs_err": worst, **t, "plain_ms": plain_ms, **bound}


def wide_eager_phase(smi):
    """10d: arma at N = 1,048,576, one run, K = 2, on the eager tree with K5,
    in one block and in blocks of WIDE_BLOCK: every field equal to the bit;
    the wall and the peak device memory of each call. Then the tree's own
    peak: one eager tree (momenta given, as on the unfused path) on the run's
    final particles at each block size, the peak counter reset just before
    it and read above the memory held at its start."""
    import dataclasses

    from smcnuts_torch import run_smc_batched
    from smcnuts_torch.models import make_arma
    from smcnuts_torch.ops.arma_fused import arma_ll_vg
    from smcnuts_torch.ops.draws import PHILOX
    from smcnuts_torch.ops.nuts_cuda import STAT_KEYS, nuts_tree_plain
    from smcnuts_torch.utils.timing import CudaTimer

    phase(f"10d. wide eager run, arma N={WIDE_N}, K={WIDE_K}")
    cfg = dataclasses.replace(eager_config(), n_particles=WIDE_N, n_iterations=WIDE_K)
    results = {}
    for block in (None, WIDE_BLOCK):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with CudaTimer() as t:
            res = run_smc_batched(make_arma(fused="cuda"),
                                  dataclasses.replace(cfg, eager_block_size=block),
                                  [SEED], "cuda")
            res.mean_estimate[:, WIDE_K].cpu()
        check_series(f"wide eager, block {block}", res, WIDE_K)
        print(f"arma eager N={WIDE_N} K={WIDE_K}, eager_block_size {block}: wall "
              f"{t.ms:.1f} ms (CUDA events), peak device memory of the call "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, K5 launches "
              f"{arma_ll_vg.launches}, mean tree depth "
              f"{float(res.tree_depth[:, :WIDE_K].mean()):.3f} ({smi})")
        results[block] = res
    diff = equal_fields(results[None], results[WIDE_BLOCK])
    if diff:
        raise AssertionError(f"wide eager run: blocks of {WIDE_BLOCK} differ from one "
                             f"block in {diff}")
    print(f"wide eager run: blocks of {WIDE_BLOCK} equal one block in every field, "
          f"bit for bit")
    model = make_arma(fused="cuda").to("cuda")
    x = results[None].x_final.contiguous()
    r = torch.randn(x.shape, generator=torch.Generator(device="cuda").manual_seed(3),
                    device="cuda")
    trees = {}
    for block in (None, WIDE_BLOCK):
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        trees[block] = nuts_tree_plain(model, x, torch.tensor([SEED], dtype=torch.int32,
                                                              device="cuda"),
                                       STEP, 1.0, None, MAX_DEPTH, PHILOX, r=r,
                                       block_size=block)
        torch.cuda.synchronize()
        print(f"eager tree N={WIDE_N}, eager_block_size {block}: its own peak "
              f"{(torch.cuda.max_memory_allocated() - held) / 2**30:.3f} GiB above the "
              f"{held / 2**30:.3f} GiB held before it ({smi})")
    a, b = trees[None], trees[WIDE_BLOCK]
    pairs = [(a[0], b[0]), (a[1], b[1])] + [(a[2][k], b[2][k]) for k in STAT_KEYS]
    if not all(bool(((u == v) | (u.isnan() & v.isnan())).all()) for u, v in pairs):
        raise AssertionError("wide eager tree: blocks differ from one block")
    print(f"eager tree N={WIDE_N}: blocks of {WIDE_BLOCK} equal one block, bit for bit")


def fused_phase(smi):
    """Phase 10: returns what the kernels line says of K5, its W = 1 witness
    and K1u."""
    k5, k5_w1 = arma_fused_kernel_phase(smi)
    k5["launches"] = eager_arma_phase(smi)
    r_given, k1u = unfused_kernel_phase(smi)
    k1u["launches"] = r_given
    wide_eager_phase(smi)
    return k5, k5_w1, k1u


# ---- phase 11: user-written densities, generated in-kernel models (K7).

GENERATED_BUILD_CAP_S = 120.0
EAGER_CARD_K = 5  # iterations of the eager (autograd) run on the card


def sass_instructions(path):
    """The SASS instructions of each kernel in the library at `path`
    (mangled name -> count, 16 bytes each), from the toolkit's cuobjdump; {}
    where the toolkit has none."""
    import re

    from torch.utils.cpp_extension import CUDA_HOME

    tool = os.path.join(CUDA_HOME or "", "bin", "cuobjdump")
    if not os.path.exists(tool):
        return {}
    out = subprocess.run([tool, "-sass", path], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name is not None and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            counts[name] += 1
    return counts


def sass_text(counts, match):
    """The instruction counts of the kernels whose mangled name contains
    `match`, as one printed phrase."""
    hits = [f"{n} ({16 * n / 1024:.1f} KB) in {name}" for name, n in sorted(counts.items())
            if match in name]
    return "; ".join(hits) if hits else "not measured (no cuobjdump)"


def generated_build(label, model):
    """Build one generated library; print its seconds, the values its
    program holds live at once in emission order, ptxas's lines and its
    kernels' SASS instructions."""
    from smcnuts_torch.ops.generated import build_generated, peak_live

    lib = build_generated(model.tile_model)
    tm = model.tile_model
    print(f"{label}: {tm.autodiff} mode, {tm.n_ops} operations, {tm.data.numel()} "
          f"data floats, at most {peak_live(tm.program)} values live at once in "
          f"emission order, source hash {tm.hash}; built {os.path.relpath(lib.path)} "
          f"in {lib.build_seconds:.1f} s")
    if lib.build_seconds > GENERATED_BUILD_CAP_S:
        raise AssertionError(f"{label}: the build took {lib.build_seconds:.1f} s, "
                             f"more than {GENERATED_BUILD_CAP_S:.0f}")
    for line in lib.log.splitlines():
        if ("Compiling entry" in line or "registers" in line or "spill" in line
                or "stack frame" in line):
            print("  ptxas:", line.strip())
    print(f"  SASS instructions: {sass_text(sass_instructions(lib.path), 'nuts_tree_kernel')}")


def generated_kernel_case(label, model, hand, x, step, smi):
    """K7 against its plain version at 25 x 512 x depth 10 under zero bits
    and Philox (to the bit, and phase 3's contract), the staged dispatch
    with a split after every depth against the single kernel (to the bit),
    and against the hand-written kernel of the same density on identical
    inputs (logp0 at atol/rtol 1e-4 on every lane, integer outputs on
    MIN_AGREE of the lanes); both timed in turns. Returns the kernels-line
    fields."""
    from smcnuts_torch.ops.draws import PHILOX, ZERO_BITS
    from smcnuts_torch.ops.nuts_cuda import nuts_tree, nuts_tree_plain
    from smcnuts_torch.utils.timing import device_ms, median_ms

    dev = x.device
    seeds = torch.arange(RUNS, dtype=torch.int32, device=dev)
    ones = torch.ones(x.shape[-1], device=dev)
    worst, plain_ms = 0.0, None
    for source in (ZERO_BITS, PHILOX):
        args = (x, seeds, step, 1.0, ones, MAX_DEPTH, source)
        out_k = nuts_tree(model, *args)
        t0 = time.perf_counter()
        out_p = nuts_tree_plain(model, *args)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        worst = max(worst, check_outputs(f"{label} [{source}] kernel vs plain", out_k,
                                         out_p, nan_lanes=True, bitwise=True))
        print(f"{label} [{source}]: kernel and plain version equal to the bit; plain "
              f"{plain_s:.1f} s")
        staged = nuts_tree(model, *args, compaction=tuple(range(1, MAX_DEPTH)))
        if bitwise_differences(staged, out_k):
            raise AssertionError(f"{label} [{source}]: staged differs from single")
        out_h = nuts_tree(hand, *args)
        torch.cuda.synchronize()
        lp_k, lp_h = out_k[2]["logp0"], out_h[2]["logp0"]
        bad = (lp_k - lp_h).abs() > ATOL + RTOL * lp_h.abs()
        if bad.any():
            raise AssertionError(f"{label} [{source}]: logp0 differs from the hand "
                                 f"kernel's on {int(bad.sum())} lanes")
        agree = float(((out_k[2]["depth"] == out_h[2]["depth"])
                       & (out_k[2]["leapfrogs"] == out_h[2]["leapfrogs"])
                       & (out_k[2]["moved"] == out_h[2]["moved"])).float().mean())
        if agree < MIN_AGREE:
            raise AssertionError(f"{label} [{source}]: integer outputs agree with the "
                                 f"hand kernel's on only {100 * agree:.3f}% of lanes")
        print(f"{label} [{source}]: staged (a split after every depth) equal to the "
              f"single kernel to the bit; against the hand kernel: logp0 within "
              f"{float((lp_k - lp_h).abs().max()):.3g}, integer outputs agree on "
              f"{100 * agree:.3f}% of lanes, max |x diff| "
              f"{float((out_k[0] - out_h[0]).abs().max()):.3g}, max |delta_h diff| "
              f"{float((out_k[2]['delta_h'] - out_h[2]['delta_h']).abs().nan_to_num().max()):.3g}")
        if source == PHILOX:
            plain_ms = median_ms(lambda: nuts_tree_plain(model, *args), repeats=1, warmup=0)
            single = out_k
    times = {"hand": [], "generated": []}
    for who in ("hand", "generated", "generated", "hand"):
        m = hand if who == "hand" else model
        times[who].append(device_ms(lambda: nuts_tree(m, *args), repeats=DEVICE_REPEATS))
    ms, hand_ms = min(times["generated"]), min(times["hand"])
    host_ms = median_ms(lambda: nuts_tree(model, *args), repeats=5)
    bound = tree_roofline("generated", single, model=model.tile_model)
    print(f"time {label}, {RUNS} x {N} x depth {MAX_DEPTH} [philox]: generated "
          f"{times['generated']} ms, hand {times['hand']} ms (device alone, "
          f"{DEVICE_REPEATS} launches back to back, in turns hand, generated, "
          f"generated, hand; a call of the generated timed alone {host_ms:.4f} ms): "
          f"{ms / hand_ms:.3f}x; plain "
          f"{plain_ms:.1f} ms; {bound_text(bound)} "
          f"({model.tile_model.n_ops} operations x "
          f"{float(single[2]['leapfrogs'].sum()):.0f} leapfrogs; {smi})")
    return {"max_abs_err": worst, "ms": ms, "host_call_ms": host_ms, "plain_ms": plain_ms,
            **bound}


def generated_builds(label, model, others, hand, x, step, smi, same_program=True):
    """Other builds of one generated density (`others`: a readable name ->
    a CallableModel of the same density, each its own library): each equal
    to its plain program to the bit, and with `same_program` (the same
    program in another emission order) to `model`'s kernel too, under zero
    bits and Philox at 25 x 512 x depth 10; then every build, `model` and the
    hand kernel timed in turns (the device alone, median of VARIANT_ROUNDS).
    Returns the kernels-line row of the first of `others`, a measurement
    entry that the main path never launches."""
    from smcnuts_torch.ops.draws import PHILOX, ZERO_BITS
    from smcnuts_torch.ops.nuts_cuda import nuts_tree, nuts_tree_plain
    from smcnuts_torch.utils.timing import CudaTimer, median_ms

    dev = x.device
    seeds = torch.arange(RUNS, dtype=torch.int32, device=dev)
    ones = torch.ones(x.shape[-1], device=dev)
    first = next(iter(others))
    errs, plain_ms, outs = [], None, {}
    for source in (ZERO_BITS, PHILOX):
        args = (x, seeds, step, 1.0, ones, MAX_DEPTH, source)
        main = nuts_tree(model, *args) if same_program else None
        for who, other in others.items():
            out = nuts_tree(other, *args)
            with CudaTimer() as t:
                plain = nuts_tree_plain(other, *args)
            err = check_outputs(f"{label} {who} [{source}] kernel vs plain", out, plain,
                                nan_lanes=True, bitwise=True)
            if same_program:
                diff = bitwise_differences(out, main)
                if diff:
                    raise AssertionError(f"{label} {who} [{source}]: differs from the "
                                         f"main build's kernel in {diff}")
            print(f"{label} {who} [{source}]: equal to its plain program"
                  + (" and to the main build's kernel" if same_program else "")
                  + " to the bit")
            if who == first:
                errs.append(err)
                if source == PHILOX:
                    plain_ms, outs[who] = t.ms, out
    calls = {"hand": lambda: nuts_tree(hand, *args),
             "main": lambda: nuts_tree(model, *args)}
    calls.update({who: (lambda m=m: nuts_tree(m, *args)) for who, m in others.items()})
    rounds, med = timed_in_turns(calls)
    for k in calls:
        print(f"time {label} {k}, {RUNS} x {N} x depth {MAX_DEPTH} [philox]: "
              f"{med[k]:.4f} ms, {med[k] / med['hand']:.3f}x the hand kernel's (device "
              f"alone, {DEVICE_REPEATS} launches back to back; median of "
              f"{VARIANT_ROUNDS} in turns: {', '.join(f'{v:.4f}' for v in rounds[k])}; "
              f"{smi})")
    host_ms = median_ms(calls[first], repeats=5)
    bound = tree_roofline("generated", outs[first], model=others[first].tile_model)
    return {"launches": 0, "measurement_entry": True, "max_abs_err": max(errs),
            "ms": med[first], "host_call_ms": host_ms, "plain_ms": plain_ms, **bound}


def generated_split(label, model, hand, cfg, smi):
    """Where a generated model's main-path call spends the time beside the
    hand model's: `init_state` of each alone (CUDA events, the second of two
    calls), then `profile_call` of each (the first iterations of the loop).
    A measurement, not a check."""
    from smcnuts_torch.sampler import init_state
    from smcnuts_torch.utils.timing import CudaTimer

    init_ms = {}
    for who, m in (("generated", model), ("hand", hand)):
        for _ in range(2):
            with CudaTimer() as t:
                init_state(m, cfg, SEEDS, "cuda").logw.sum().item()
        init_ms[who] = t.ms
    print(f"{label}: init_state {init_ms['generated']:.1f} ms generated, "
          f"{init_ms['hand']:.1f} ms hand (CUDA events, second call; {smi})")
    profile_call(f"{label} (generated)", model, cfg, smi)
    profile_call(f"{label} (hand)", hand, cfg, smi)


def generated_phase(smi):
    """Phase 11: returns what the kernels line says of K7f and K7r."""
    from smcnuts_torch import SMCConfig, run_smc, run_smc_batched
    from smcnuts_torch.models import get_model
    from smcnuts_torch.models.arma import arma_model_fwd
    from smcnuts_torch.models.base import CallableModel
    from smcnuts_torch.models.eightschools import make_eightschools_generated
    from smcnuts_torch.ops.draws import PHILOX
    from smcnuts_torch.ops.nuts_cuda import build_library, nuts_tree

    phase("11. user-written densities: generated in-kernel models (K7f, K7r)")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    arma = arma_model_fwd().to(dev)
    t1 = time.perf_counter()
    schools = make_eightschools_generated().to(dev)
    print(f"traced and simplified: arma (T=200, forward) in {t1 - t0:.1f} s, eight "
          f"schools (reverse) in {time.perf_counter() - t1:.1f} s; K7r "
          f"{schools.tile_model.group} lane(s) a particle")
    # K7r split over 2 lanes a particle, its sums over the schools a loop: a
    # measurement entry, a library of its own.
    schools_w2 = make_eightschools_generated(group=2).to(dev)
    # K7f's witness: the same program in the order it was built, the whole
    # primal before the first tangent pass (the emission before the
    # (primal node, pass) order).
    others = {"built order": arma_model_fwd(order="built").to(dev)}
    generated_build("K7f arma", arma)
    generated_build("K7f arma, built order (the witness)", others["built order"])
    generated_build("K7r eight schools", schools)
    generated_build("K7r eight schools, 2 lanes a particle", schools_w2)
    hand = sass_instructions(build_library().path)
    print(f"hand arma entries, SASS instructions: {sass_text(hand, 'ArmaModel')}")
    print(f"hand eight-schools entries, SASS instructions: "
          f"{sass_text(hand, 'EightSchoolsModel')}")

    x_arma = particles(RUNS * N, 6, dev).view(RUNS, N, 4)
    k7f = generated_kernel_case("K7f arma", arma, get_model("arma").to(dev), x_arma,
                                STEP, smi)
    k7f_built = generated_builds("K7f arma", arma, others, get_model("arma").to(dev),
                                 x_arma, STEP, smi)
    es = AUTODIFF_MODELS["eightschools"]
    x_schools = autodiff_cloud("eightschools", (RUNS, N), 5, dev)
    k7r = generated_kernel_case("K7r eight schools", schools,
                                get_model("eightschools").to(dev), x_schools,
                                es["cloud_step"], smi)
    k7r_w2 = generated_builds("K7r eight schools", schools,
                              {"2 lanes a particle": schools_w2},
                              get_model("eightschools").to(dev), x_schools,
                              es["cloud_step"], smi, same_program=False)

    # K7r at the shape of its main path's run below (RUNS x n trees at the
    # run's step and depth), phi 1.0 and 0.1, and at WIDE_TREES trees (where
    # one thread a particle fills the card), in turns with its split over 2
    # lanes and the hand kernel.
    ones = torch.ones(schools.dim, device=dev)
    shapes = [(f"{RUNS} x {es['n']} x depth {es['depth']}, step {es['step']}, phi {phi}",
               (autodiff_cloud("eightschools", (RUNS, es["n"]), 6, dev),
                torch.arange(RUNS, dtype=torch.int32, device=dev), es["step"], phi, ones,
                es["depth"], PHILOX)) for phi in (1.0, 0.1)]
    shapes.append((f"1 x {WIDE_TREES} x depth {MAX_DEPTH}, step {es['cloud_step']}, phi 1.0",
                   (autodiff_cloud("eightschools", (1, WIDE_TREES), 8, dev), 31,
                    es["cloud_step"], 1.0, ones, MAX_DEPTH, PHILOX)))
    hand_schools = get_model("eightschools").to(dev)
    for shape, args in shapes:
        calls = {"hand": lambda: nuts_tree(hand_schools, *args),
                 "main": lambda: nuts_tree(schools, *args),
                 "2 lanes a particle": lambda: nuts_tree(schools_w2, *args)}
        rounds, med = timed_in_turns(calls)
        for k in calls:
            print(f"time K7r eight schools {k}, {shape} [philox]: {med[k]:.4f} ms, "
                  f"{med['main'] / med[k]:.3f}x faster than the main entry "
                  f"(device alone, {DEVICE_REPEATS} launches back to back; median of "
                  f"{VARIANT_ROUNDS} in turns: {', '.join(f'{v:.4f}' for v in rounds[k])}; "
                  f"{smi})")

    # The main path: the generated arma at bench.py's configuration, inside
    # the PARITY bands.
    cfg = workload_config(False)
    res, k7f["launches"], _ = strategy_run("generated arma, forwards", "generated",
                                           arma, cfg, smi)
    parity_bands("generated arma, forwards", "arma", res.mean_estimate[:, K].cpu(),
                 res.variance_estimate[:, K])
    generated_split("arma, forwards", arma, get_model("arma").to(dev), cfg, smi)
    # Eight schools at phase 9's configuration, inside the bands of the hand
    # kernel's run with the same seeds.
    k = es["k"]
    cfg = SMCConfig(n_particles=es["n"], n_iterations=k, step_size=es["step"],
                    lkernel=es["lkernel"], tempering=True, save_history=False,
                    max_tree_depth=es["depth"])
    label = f"generated eight schools {es['lkernel']} tempered"
    res, k7r["launches"], _ = strategy_run(label, "generated", schools, cfg, smi)
    ref = run_smc_batched(get_model("eightschools"), cfg, SEEDS, "cuda")
    estimates_band(f"{label} vs the hand kernel's {RUNS} runs",
                   res.mean_estimate[:, k], res.variance_estimate[:, k],
                   ref.mean_estimate[:, k].double().mean(0),
                   ref.variance_estimate[:, k].double().mean(0))
    generated_split("eight schools, tempered", schools, get_model("eightschools").to(dev),
                    cfg, smi)

    # The same density without a generated model: eager, by autograd, on the card.
    eager = CallableModel("eightschools", schools.dim, schools._logprior, schools._loglik,
                          schools._constrain)
    cfg = SMCConfig(n_particles=es["n"], n_iterations=EAGER_CARD_K, step_size=es["step"],
                    max_tree_depth=es["depth"])
    reset_counts()
    t0 = time.perf_counter()
    res = run_smc(eager, cfg, 0, "cuda")
    wall = time.perf_counter() - t0
    counts, plain_calls = read_counts()
    check_series("eager eight schools (autograd) on the card", res, EAGER_CARD_K)
    if sum(counts.values()) != 0 or plain_calls != EAGER_CARD_K:
        raise AssertionError(f"the eager run must take the plain tree: {counts}, "
                             f"{plain_calls}")
    print(f"eager eight schools (autograd, no generated model) on the card: "
          f"{EAGER_CARD_K} iterations in {wall:.1f} s (host clock), no kernel launch, "
          f"final mean {[round(v, 3) for v in res.mean_estimate[EAGER_CARD_K].tolist()[:2]]}")
    return k7f, k7r, k7f_built, k7r_w2


# ---- phase 12: chunked runs that resume, checkpoints, the CLI's output,
# phase profiling.

class Crash(Exception):
    """Raised from a runner's progress callback: a run that stops after a
    chunk, its checkpoint written."""


def crash_after(k_stop):
    def progress(k_done, total):
        if k_done == k_stop:
            raise Crash
    return progress


class PhaseCounts:
    """The main-path launches of a phase: `run(fn)` resets the counters,
    calls fn and adds what it launched (dispatches and continuation-stage
    launches, per model) to the phase's totals."""

    def __init__(self):
        self.launches, self.cont = {}, {}

    def run(self, fn):
        reset_counts()
        try:
            out = fn()
        finally:
            counts, plain_calls = read_counts()
            stage_launches, cont = read_stage_counts()
            for name, n in counts.items():
                self.launches[name] = self.launches.get(name, 0) + n
                self.cont[name] = self.cont.get(name, 0) + cont.get(name, 0)
        return out, counts, plain_calls, stage_launches


def same_result(label, got, want):
    diff = equal_fields(got, want)
    if diff:
        raise AssertionError(f"{label}: differs from the uninterrupted run in {diff}")


def runner_phase(smi):
    """Phase 12: ChunkedRunner, checkpoints of the SMC state, the CLI's
    --checkpoint / --chunk-size / --output, and utils.profiling.phase_timings,
    on the card. Returns the main-path launches (PhaseCounts)."""
    import tempfile

    import numpy as np

    from smcnuts_torch import SMCConfig, run_smc, run_smc_batched
    from smcnuts_torch.models import default_step_size, get_model
    from smcnuts_torch.runner import ChunkedRunner
    from smcnuts_torch.utils.checkpoint import CHECKPOINT_VERSION
    from smcnuts_torch.utils.profiling import phase_timings
    from smcnuts_torch.utils.timing import CudaTimer

    phase("12. runner, checkpoint, CLI output, profiling")
    started = time.perf_counter()
    tally = PhaseCounts()
    tmp = tempfile.TemporaryDirectory()
    ck = os.path.join(tmp.name, "smc.npz")

    def fresh():
        if os.path.exists(ck):
            os.remove(ck)

    def timed(fn):
        with CudaTimer() as t:
            res = fn()
            res.mean_estimate[:, -1].cpu()
        return res, t.ms

    # (a) arma forwards, bench.py's config: run_smc_batched, and
    # ChunkedRunner in chunks of 10 with a checkpoint after each and without
    # one, in turns (each order forwards, then backwards).
    arma, cfg = get_model("arma"), workload_config(False)
    calls = {
        "run_smc_batched": lambda: run_smc_batched(arma, cfg, SEEDS, "cuda"),
        "ChunkedRunner with checkpoints": lambda: ChunkedRunner(
            arma, cfg, checkpoint_path=ck, chunk_size=10, device="cuda").run(SEEDS),
        "ChunkedRunner without": lambda: ChunkedRunner(
            arma, cfg, chunk_size=10, device="cuda").run(SEEDS),
    }
    walls, ref = [], None
    for turn in list(calls) + list(calls)[::-1]:
        fresh()
        (res, ms), counts, plain_calls, _ = tally.run(lambda: timed(calls[turn]))
        if counts["arma"] != K or sum(counts.values()) != K or plain_calls != 0:
            raise AssertionError(f"(a) {turn}: {counts} dispatches, {plain_calls} "
                                 f"plain calls; expected {K} and 0")
        walls.append((turn, ms))
        if os.path.exists(ck):
            size = os.path.getsize(ck)
        if ref is None:
            ref = res
        same_result(f"(a) arma forwards, {turn}", res, ref)
    print(f"(a) arma forwards {RUNS} x {N} x K={K}: ChunkedRunner (chunks of 10, with "
          f"a checkpoint after each and without) equals run_smc_batched in every "
          f"field, bit for bit; {K} kernel launches, no plain call, each call")
    mean = {turn: sum(ms for t, ms in walls if t == turn) / 2 for turn in calls}
    print(f"(a) walls in turns (CUDA events, results on the host): "
          + ", ".join(f"{turn} {ms:.1f}" for turn, ms in walls) + f" ms ({smi}); a "
          f"checkpoint ({size} bytes) adds "
          f"{(mean['ChunkedRunner with checkpoints'] - mean['ChunkedRunner without']) / 10:.1f} "
          f"ms, the mean difference over its 10 writes")

    # (b) A crash after 30 iterations: a K=30 run with the checkpoint, then
    # the K=100 run from the same file.
    import dataclasses

    fresh()
    k_crash = 30
    tally.run(lambda: ChunkedRunner(arma, dataclasses.replace(cfg, n_iterations=k_crash),
                                    checkpoint_path=ck, chunk_size=10,
                                    device="cuda").run(SEEDS))
    with np.load(ck) as data:
        version, k_done = int(data["version"]), int(data["k_done"])
    if (version, k_done) != (CHECKPOINT_VERSION, k_crash):
        raise AssertionError(f"(b) checkpoint version {version}, k_done {k_done}")
    res, counts, plain_calls, _ = tally.run(
        lambda: ChunkedRunner(arma, cfg, checkpoint_path=ck, chunk_size=10,
                              device="cuda").run(SEEDS))
    if counts["arma"] != K - k_crash or sum(counts.values()) != K - k_crash or plain_calls:
        raise AssertionError(f"(b) the resumed run: {counts} dispatches, {plain_calls} "
                             f"plain calls; expected {K - k_crash} and 0")
    same_result("(b) arma resumed after 30", res, ref)
    print(f"(b) checkpoint version {version}, k_done {k_done}; the K={K} run resumed "
          f"from it launched the kernel {counts['arma']} times and equals the "
          f"uninterrupted run in every field, bit for bit")

    # (c) PRMwCD adapted (bench.py:176-178), stopped after iteration 40.
    prmwcd, cfg_a = get_model("prmwcd"), workload_config(True)
    ref_a, counts, _, stages_ref = tally.run(
        lambda: run_smc_batched(prmwcd, cfg_a, SEEDS, "cuda"))
    fresh()
    runner = ChunkedRunner(prmwcd, cfg_a, checkpoint_path=ck, chunk_size=10, device="cuda")

    def stopped():
        try:
            runner.run(SEEDS, progress=crash_after(40))
        except Crash:
            return
        raise AssertionError("(c) the run did not stop after iteration 40")

    _, counts_1, _, stages_1 = tally.run(stopped)
    res, counts_2, plain_calls, stages_2 = tally.run(lambda: runner.run(SEEDS))
    if (counts_1["prmwcd"], counts_2["prmwcd"], plain_calls) != (40, K - 40, 0):
        raise AssertionError(f"(c) dispatches {counts_1}, {counts_2}, plain {plain_calls}")
    same_result("(c) PRMwCD adapted resumed after 40", res, ref_a)
    print(f"(c) PRMwCD adapted {RUNS} x {N} x K={K}, stopped after iteration 40 and "
          f"resumed: every field equal to the uninterrupted run, bit for bit; kernel "
          f"launches (stages) uninterrupted {stages_ref}, stopped + resumed "
          f"{stages_1} + {stages_2}")

    # (d) Eight schools, asymptotic with tempering (K6b), history on and off,
    # stopped after iteration 10.
    c = AUTODIFF_MODELS["eightschools"]
    schools = autodiff_model("eightschools")
    for history in (True, False):
        cfg_s = SMCConfig(n_particles=c["n"], n_iterations=c["k"], step_size=c["step"],
                          lkernel="asymptoticLKernel", tempering=True,
                          save_history=history, max_tree_depth=c["depth"])
        ref_s, counts, _, _ = tally.run(lambda: run_smc_batched(schools, cfg_s, SEEDS, "cuda"))
        fresh()
        runner = ChunkedRunner(schools, cfg_s, checkpoint_path=ck, chunk_size=10,
                               device="cuda")
        try:
            tally.run(lambda: runner.run(SEEDS, progress=crash_after(10)))
            raise AssertionError("(d) the run did not stop after iteration 10")
        except Crash:
            pass
        res, counts_2, plain_calls, _ = tally.run(lambda: runner.run(SEEDS))
        if counts_2["eightschools"] != c["k"] - 10 or plain_calls:
            raise AssertionError(f"(d) the resumed run: {counts_2}, plain {plain_calls}")
        same_result(f"(d) eight schools save_history={history}", res, ref_s)
        print(f"(d) eight schools asymptotic tempered {RUNS} x {c['n']} x K={c['k']}, "
              f"save_history={history}: resumed after iteration 10 ({counts_2['eightschools']} "
              f"dispatches), every field equal to the uninterrupted run, bit for bit")

    # (e) The CLI with a checkpoint, chunks and an output file, then again.
    fresh()
    npz = ck + ".out.npz"
    argv = ["--model", "prmwcd", "-N", str(N), "-K", str(K), "--max-tree-depth",
            str(MAX_DEPTH), "--checkpoint", ck, "--chunk-size", "10", "--output", npz,
            "--device", "cuda"]
    summary, counts, plain_calls, _ = tally.run(lambda: quiet_cli(argv))
    if counts["prmwcd"] != K or plain_calls:
        raise AssertionError(f"(e) the CLI run: {counts}, plain {plain_calls}")
    # The configuration the CLI builds for these flags.
    cfg_cli = SMCConfig(n_particles=N, n_iterations=K,
                        step_size=default_step_size("prmwcd"), max_tree_depth=MAX_DEPTH,
                        save_history=False)
    want, _, _, _ = tally.run(lambda: run_smc(prmwcd, cfg_cli, 0, "cuda"))
    with np.load(npz) as data:
        fields = {f for f, v in want._asdict().items() if v is not None}
        if set(data.files) != fields:
            raise AssertionError(f"(e) the npz holds {sorted(data.files)}, not "
                                 f"{sorted(fields)}")
        diff = [f for f in fields
                if not torch.equal(torch.from_numpy(data[f]), getattr(want, f).cpu())]
    if diff:
        raise AssertionError(f"(e) the npz differs from the in-process run in {diff}")
    again, counts, plain_calls, _ = tally.run(lambda: quiet_cli(argv))
    if sum(counts.values()) or plain_calls or again != summary:
        raise AssertionError(f"(e) the rerun at k_done == K: {counts}, plain "
                             f"{plain_calls}, the same summary: {again == summary}")
    print(f"(e) CLI {' '.join(argv[:8])} --checkpoint --chunk-size 10 --output: the "
          f"npz's {len(fields)} fields equal the in-process run_smc result, bit for "
          f"bit; run again, it resumed at k_done == K, launched no kernel and "
          f"printed the same summary")
    tmp.cleanup()

    # (f) Seconds an iteration of each SMC phase, arma, one run at N=512.
    t = phase_timings(arma, cfg, seed=SEED, device="cuda")
    print(f"(f) phase_timings arma, one run, N={N}, depth {MAX_DEPTH}, ms an "
          f"iteration (CUDA events, 20 calls back to back, best of 3): "
          + ", ".join(f"{k} {1e3 * v:.4f}" for k, v in t.items()) + f" ({smi})")
    print(f"phase 12 took {time.perf_counter() - started:.1f} s (host clock; its "
          f"budget is 90 s)")
    return tally


# ---- phase 13: Stan programs on the card, through the port's frontend.

# The slice's three programs: two examples of the repository and the AR(1)
# error recurrence of tests/test_stan_frontend.py:270-284 at T = 200, its
# data made by `_recurrence_data(T=200)` there (copied, as the port's test
# copies it). Step sizes: examples/stan/README.md's 0.2 for radon is its
# tempered asymptotic run's; under the forwards L-kernel without tempering
# the trees diverge at 0.2 (radon) and at the CLI's 0.5 (the other two):
# experiments/stan_step_sizes_torch.py (the port, on the card or the CPU) and
# experiments/stan_step_sizes_jax.py (the JAX frontend, on the CPU) print
# acceptance and depth at each step (PERF.md, §6).
STAN_RECURRENCE = """
data { int<lower=1> T; real y[T]; real phi; }
parameters { real a; real<lower=0> s; }
model {
  vector[T] e;
  real acc;
  acc = 0;
  e[1] = y[1];
  for (t in 2:T) {
    e[t] = y[t] - a * e[t-1];
    acc += e[t] * 0.001;
  }
  target += normal_lpdf(a | 0, 1);
  target += phi * (normal_lpdf(e | 0, s) + acc);
}
"""
STAN_PROGRAMS = {
    "radon_intercepts": dict(path="examples/stan/radon_intercepts.stan", step=0.05,
                             mode="reverse", replaces="smcnuts_tpu/ops/nuts_pallas.py:1126"),
    "irt_ar": dict(path="examples/stan/irt_ar.stan", step=0.1, mode="forward",
                   replaces="smcnuts_tpu/ops/nuts_pallas.py:1674"),
    "ar1_errors_t200": dict(path=None, step=0.05, mode="forward",
                            replaces="smcnuts_tpu/ops/nuts_pallas.py:1674"),
}
STAN_EAGER_RUNS, STAN_EAGER_K = 5, 20  # the eager radon run and its kernel twin
STAN_CLI_EAGER_K = 10


def stan_source(name):
    """(source, data) of one of STAN_PROGRAMS."""
    import numpy as np

    from smcnuts_torch.stan import load_stan_data

    path = STAN_PROGRAMS[name]["path"]
    if path is None:
        y = np.random.default_rng(3).normal(size=200)
        return STAN_RECURRENCE, {"T": 200, "y": y.tolist()}
    with open(path) as f:
        return f.read(), load_stan_data(path[: -len(".stan")] + ".json")


def stan_generating(name, dim):
    """The values that generated each program's data, in its parameters'
    order and constrained, as the estimates are: radon's from
    examples/stan/README.md (mu_a and sigma_a not stated), irt_ar's item
    difficulties from its data file's `_b_true`, the recurrence's a = 0 and
    s = 1 (its y are iid standard normals)."""
    import numpy as np

    if name == "radon_intercepts":
        return [1.56, 0.90, 0.54, 1.29, 1.29, 0.7, None, None, 0.4]
    if name == "irt_ar":
        _, data = stan_source(name)
        b = list(np.asarray(data["_b_true"], dtype=float))
        return b + [None] * (dim - len(b))
    return [0.0, 1.0]


def stan_means_text(label, name, res, k, smi):
    """The 25-run means of the final estimates beside the generating values
    (both constrained)."""
    m = res.mean_estimate[:, k].double().mean(0).tolist()
    gen = stan_generating(name, len(m))
    shown = min(len(m), 12)
    pairs = [f"{m[i]:.3f}" + (f" ({gen[i]:.3f})" if gen[i] is not None else "")
             for i in range(shown)]
    more = "" if shown == len(m) else f", ... ({len(m) - shown} more)"
    print(f"{label}: {RUNS}-run mean of the final estimates (generating value): "
          f"{', '.join(pairs)}{more} ({smi})")


def stan_prepare(smi):
    """Phase 13 (a), run before phase 2: the three programs parsed,
    interpreted (the eager model) and traced (tile=True) on the card's
    machine, then one nvcc each started in the background, so that the
    builds (irt_ar's takes about a minute) run beside phase 2's and later
    phases, not inside phase 13. Returns what stan_phase takes."""
    from concurrent.futures import ThreadPoolExecutor

    from smcnuts_torch.ops.generated import build_generated
    from smcnuts_torch.stan import compile_stan_program, parse

    phase("13 (a). Stan programs: parse, interpret, trace; their nvcc started in the "
          "background")
    started = time.perf_counter()
    dev = torch.device("cuda")
    models, eager_models = {}, {}
    for name in STAN_PROGRAMS:
        src, data = stan_source(name)
        t0 = time.perf_counter()
        parse(src)
        t1 = time.perf_counter()
        eager_models[name] = compile_stan_program(src, data, name=name).to(dev)
        t2 = time.perf_counter()
        models[name] = compile_stan_program(src, data, name=name, tile=True).to(dev)
        t3 = time.perf_counter()
        tm = models[name].tile_model
        if tm.autodiff != STAN_PROGRAMS[name]["mode"]:
            raise AssertionError(f"(a) {name}: tile_autodiff='auto' chose {tm.autodiff}")
        print(f"(a) {name}: D = {tm.dim}, {tm.autodiff} mode, {tm.n_ops} operations a "
              f"leapfrog, {tm.data.numel()} data floats; parse {t1 - t0:.3f} s, "
              f"interpret (the eager model) {t2 - t1:.3f} s, interpret and trace "
              f"(tile=True) {t3 - t2:.1f} s (host clock; {smi})")
    pool = ThreadPoolExecutor(len(models))
    builds = {name: pool.submit(build_generated, m.tile_model) for name, m in models.items()}
    return dict(models=models, eager_models=eager_models, builds=builds, pool=pool,
                seconds=time.perf_counter() - started, started=time.perf_counter())


def stan_phase(smi, prep):
    """Phase 13: Stan programs compiled by the port's frontend (`prep`, from
    stan_prepare), through the generated NUTS kernels (K7r, K7f). Returns
    the kernels-line rows."""
    from smcnuts_torch import SMCConfig, run_smc_batched
    from smcnuts_torch.models.base import CallableModel
    from smcnuts_torch.ops.draws import PHILOX, ZERO_BITS
    from smcnuts_torch.ops.nuts_cuda import nuts_tree, nuts_tree_plain
    from smcnuts_torch.utils.timing import CudaTimer, device_ms, median_ms

    phase("13. Stan programs on the card (K7r, K7f through the port's frontend)")
    started = time.perf_counter()
    dev = torch.device("cuda")
    models, eager_models, builds = prep["models"], prep["eager_models"], prep["builds"]
    pool = prep["pool"]

    rows, launches = {}, {name: 0 for name in models}
    finals = {}
    # (c) bench.py's shape: 25 runs x 512 x K=100, forwards, depth 10.
    for name in sorted(models, key=lambda n: models[n].tile_model.n_ops):
        m = models[name]
        lib = builds[name].result()
        print(f"(a) {name}: nvcc {lib.build_seconds:.1f} s (the three started at once, "
              f"{time.perf_counter() - prep['started']:.1f} s before it is read here; {smi})")
        generated_build(f"(a) {name}", m)
        cfg = SMCConfig(n_particles=N, n_iterations=K, step_size=STAN_PROGRAMS[name]["step"],
                        max_tree_depth=MAX_DEPTH)
        label = f"(c) {name}, forwards, step {cfg.step_size}"
        res, n_launch, _ = strategy_run(label, "generated", m, cfg, smi)
        launches[name] += n_launch
        stan_means_text(label, name, res, K, smi)
        finals[name] = res.x_final.contiguous()
    pool.shutdown()

    # (b) Each kernel against its plain version at 25 x 512 x depth 10, on
    # the posterior cloud (c) ended with, zero bits and Philox: to the bit.
    for name, m in models.items():
        x, step = finals[name], STAN_PROGRAMS[name]["step"]
        seeds = torch.arange(RUNS, dtype=torch.int32, device=dev)
        ones = torch.ones(x.shape[-1], device=dev)
        worst = 0.0
        for source in (ZERO_BITS, PHILOX):
            args = (x, seeds, step, 1.0, ones, MAX_DEPTH, source)
            out_k = nuts_tree(m, *args)
            with CudaTimer() as t:
                out_p = nuts_tree_plain(m, *args)
            worst = max(worst, check_outputs(f"(b) {name} [{source}] kernel vs plain",
                                             out_k, out_p, nan_lanes=True, bitwise=True))
            print(f"(b) {name} [{source}]: kernel and plain version equal to the bit; "
                  f"plain {t.ms:.1f} ms")
        call = lambda: nuts_tree(m, *args)  # noqa: E731 (Philox, the last args)
        ms = device_ms(call, repeats=DEVICE_REPEATS)
        host_ms = median_ms(call, repeats=5)
        bound = tree_roofline("generated", out_k, model=m.tile_model)
        print(f"(b) time {name}, {RUNS} x {N} x depth {MAX_DEPTH} [philox]: {ms:.4f} ms "
              f"(device alone, {DEVICE_REPEATS} launches back to back; a call timed "
              f"alone {host_ms:.4f} ms); plain {t.ms:.1f} ms; {bound_text(bound)} "
              f"({m.tile_model.n_ops} operations x {float(out_k[2]['leapfrogs'].sum()):.0f} "
              f"leapfrogs; {smi})")
        rows[name] = {"max_abs_err": worst, "ms": ms, "host_call_ms": host_ms,
                      "plain_ms": t.ms, **bound}

    # (d) radon eager by autograd on the card, beside its kernel run at the
    # same shape: the means within 4 MC standard errors.
    name = "radon_intercepts"
    cfg = SMCConfig(n_particles=N, n_iterations=STAN_EAGER_K,
                    step_size=STAN_PROGRAMS[name]["step"], max_tree_depth=MAX_DEPTH)
    seeds = SEEDS[:STAN_EAGER_RUNS]
    walls, res = {}, {}
    for who, m in (("eager", eager_models[name]), ("kernel", models[name])):
        reset_counts()
        with CudaTimer() as t:
            res[who] = run_smc_batched(m, cfg, seeds, "cuda")
            res[who].mean_estimate[:, -1].cpu()
        walls[who] = t.ms
        counts, plain_calls = read_counts()
        want = (0, STAN_EAGER_K) if who == "eager" else (STAN_EAGER_K, 0)
        if (sum(counts.values()), plain_calls) != want:
            raise AssertionError(f"(d) {name} {who}: {counts} launches, {plain_calls} "
                                 f"plain calls; expected {want}")
        check_series(f"(d) {name} {who}", res[who], STAN_EAGER_K)
        if who == "kernel":
            launches[name] += STAN_EAGER_K
    me, mk = (res[w].mean_estimate[:, STAN_EAGER_K].double() for w in ("eager", "kernel"))
    se = (me.var(0) / len(seeds) + mk.var(0) / len(seeds)).sqrt() + 1e-12
    z = ((me.mean(0) - mk.mean(0)).abs() / se)
    print(f"(d) {name} {len(seeds)} x {N} x K={STAN_EAGER_K}: eager (autograd, no kernel) "
          f"{walls['eager']:.1f} ms, kernel {walls['kernel']:.1f} ms (CUDA events); "
          f"|eager mean - kernel mean| / MC se {[round(float(v), 3) for v in z]} ({smi})")
    if not bool((z <= 4.0).all()):
        raise AssertionError(f"(d) {name}: the eager means are more than 4 MC standard "
                             f"errors from the kernel run's")
    # A logp_and_grad call of each eager model at 512 particles: interpreted
    # (CallableModel's, autograd of the interpretation) and, for radon, the
    # StanModel's replayed graph, equal to it to the bit.
    for prog, m in eager_models.items():
        xx = finals[prog][0].clone()
        phi = torch.full((N,), 1.0, device=dev)
        interpreted = median_ms(lambda: CallableModel.logp_and_grad(m, xx, phi), repeats=3)
        text = f"{interpreted:.3f} ms interpreted"
        if prog == name:
            def same(a, b):
                return torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])

            want = CallableModel.logp_and_grad(m, xx, phi)
            if not same(CallableModel.logp_and_grad(m, xx, phi), want):
                raise AssertionError(f"(d) {prog}: two interpretations differ (an op "
                                     f"that adds with atomics?)")
            if not same(m.logp_and_grad(xx, phi), want):
                raise AssertionError(f"(d) {prog}: the replayed graph differs from the "
                                     f"interpretation")
            replayed = median_ms(lambda: m.logp_and_grad(xx, phi), repeats=5)
            text += (f", {replayed:.3f} ms replayed (its graph, {len(m._graphs)} traced, "
                     f"equal to the interpretation to the bit)")
        print(f"(d) {prog}: a logp_and_grad call of the eager model at {N} particles: "
              f"{text} (CUDA events, median of 3 and 5; {smi})")

    # (e) The CLI, with --stan-tile at K=100 (the kernel) and without it at
    # K=10 (eager), through its main(), at (c)'s step: the particles must
    # move (acceptance above 0, from the --output file) and the weights
    # differ (final ESS below N).
    import tempfile

    import numpy as np

    base = ["--stan", STAN_PROGRAMS[name]["path"], "--data",
            STAN_PROGRAMS[name]["path"][: -len(".stan")] + ".json", "-N", str(N),
            "--step-size", str(STAN_PROGRAMS[name]["step"])]
    keys = {"model", "lkernel", "N", "K", "mean", "variance", "ess", "log_likelihood",
            "phi_schedule"}
    for argv, k, kernel in ((base + ["--stan-tile", "-K", str(K)], K, True),
                            (base + ["-K", str(STAN_CLI_EAGER_K)], STAN_CLI_EAGER_K, False)):
        reset_counts()
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "diagnostics.npz")
            t0 = time.perf_counter()
            summary = quiet_cli(argv + ["--device", "cuda", "--output", out])
            wall = time.perf_counter() - t0
            acceptance = float(np.load(out)["acceptance_rate"][:k].mean())
        counts, plain_calls = read_counts()
        want = (k, 0) if kernel else (0, k)
        if set(summary) != keys or (sum(counts.values()), plain_calls) != want:
            raise AssertionError(f"(e) {' '.join(argv)}: keys {sorted(summary)}, "
                                 f"{counts} launches, {plain_calls} plain calls")
        if not all(math.isfinite(v) for v in summary["mean"] + summary["variance"]):
            raise AssertionError(f"(e) {' '.join(argv)}: estimates not finite")
        if not (summary["ess"] < N and acceptance > 0.0):
            raise AssertionError(f"(e) {' '.join(argv)}: final ESS {summary['ess']} "
                                 f"(must be below N = {N}), acceptance {acceptance} "
                                 f"(must be above 0): the particles did not move")
        if kernel:
            launches[name] += k
        print(f"(e) python -m smcnuts_torch {' '.join(argv)}: the JAX CLI's keys, "
              f"{counts['generated']} kernel launches, {plain_calls} plain calls, "
              f"{wall:.1f} s (host clock, the trace included), model "
              f"{summary['model']}, acceptance {acceptance:.3f}, final ESS "
              f"{summary['ess']:.1f} ({smi})")
    for n in rows:
        rows[n]["launches"] = launches[n]
    print(f"phase 13 took {time.perf_counter() - started:.1f} s, and (a) before phase 2 "
          f"{prep['seconds']:.1f} s (host clock; the budget of both is 150 s; {smi})")
    return rows


def partial_run(only, smi, stan_prep):
    """The phases named in `only` (after device and build), for development:
    no kernels line and no "ok" line, so it cannot pass for the whole run."""
    phases = {"arma": arma_kernel_phase, "prmwcd": prmwcd_kernel_phase,
              "main": main_path_phase, "batched": batched_phase,
              "staged_times": staged_times_phase, "cli": lambda smi: cli_phase(),
              "autodiff": autodiff_kernels_phase, "gaussian": one_model_phase("gaussian"),
              "logistic": one_model_phase("logistic"),
              "eightschools": one_model_phase("eightschools"),
              "strategies": strategies_phase,
              "fused_kernel": arma_fused_kernel_phase, "eager": eager_arma_phase,
              "unfused": unfused_kernel_phase, "wide_eager": wide_eager_phase,
              "generated": generated_phase, "runner": runner_phase,
              "stan": lambda smi: stan_phase(smi, stan_prep)}
    for key in only:
        phases[key](smi)
    print(f"\nchip_smoke: partial run of {only} passed; no result line")


def main():
    started = time.perf_counter()
    name, smi = device_phase()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    only = sys.argv[2].split(",") if len(sys.argv) == 3 and sys.argv[1] == "--only" else None
    stan_prep = stan_prepare(smi) if only is None or "stan" in only else None
    build_phase()
    k8 = peak_phase(smi)
    if only is not None:
        return partial_run(only, smi, stan_prep)
    arma, arma_staged, arma_w1 = arma_kernel_phase(smi)
    prmwcd, prmwcd_staged, prmwcd_w1 = prmwcd_kernel_phase(smi)
    arma_launches = main_path_phase(smi)
    batched, cont = batched_phase(smi)
    staged_times_phase(smi)
    prm_cli, schools_cli = cli_phase()
    autodiff, witnesses = autodiff_kernels_phase(smi)
    strategies, strategies_cont = strategies_phase(smi)
    strategies["eightschools"] += schools_cli
    k5, k5_w1, k1u = fused_phase(smi)
    k7f, k7r, k7f_built, k7r_w2 = generated_phase(smi)
    tally = runner_phase(smi)
    stan = stan_phase(smi, stan_prep)
    source = "smcnuts_torch/csrc/nuts_tree.cuh"
    # No single PyTorch call builds a NUTS tree, computes the fused ARMA
    # value and gradient or runs FMA chains, so no kernel has a library time.
    kernels = [
        # K2, inlined into the K1 instantiation this entry launches.
        dict(name="nuts_tree_arma", route="cuda", source="smcnuts_torch/csrc/arma_model.cuh",
             replaces="smcnuts_tpu/ops/nuts_pallas.py:154",
             launches=arma_launches + batched["arma"] + strategies["arma"]
             + tally.launches["arma"], **arma),
        # K3, inlined into the K1 instantiation this entry launches.
        dict(name="nuts_tree_prmwcd", route="cuda",
             source="smcnuts_torch/csrc/prmwcd_model.cuh",
             replaces="smcnuts_tpu/ops/nuts_pallas.py:1803",
             launches=batched["prmwcd"] + prm_cli + strategies["prmwcd"]
             + tally.launches["prmwcd"], **prmwcd),
        # K4: the continuation-stage instantiations of the staged dispatch.
        dict(name="nuts_tree_arma_staged", route="cuda", source=source,
             replaces="smcnuts_tpu/ops/nuts_pallas.py:794",
             launches=cont["arma"] + strategies_cont["arma"] + tally.cont["arma"],
             **arma_staged),
        dict(name="nuts_tree_prmwcd_staged", route="cuda", source=source,
             replaces="smcnuts_tpu/ops/nuts_pallas.py:794",
             launches=cont["prmwcd"] + strategies_cont["prmwcd"] + tally.cont["prmwcd"],
             **prmwcd_staged),
        # The W = 1 witnesses of K1 + K2 and K1 + K3 (one thread a particle),
        # measurement entries that the main path never dispatches: 0
        # launches, and marked.
        dict(name="nuts_tree_arma_w1", route="cuda",
             source="smcnuts_torch/csrc/arma_variants.cu",
             replaces="smcnuts_tpu/ops/nuts_pallas.py:1931", **arma_w1),
        dict(name="nuts_tree_prmwcd_w1", route="cuda",
             source="smcnuts_torch/csrc/prmwcd_variants.cu",
             replaces="smcnuts_tpu/ops/nuts_pallas.py:1803", **prmwcd_w1),
    ]
    # K6: the densities the JAX package differentiates inside its kernel
    # (elementwise_tile_model), each inlined into its own K1 instantiation.
    kernels += [
        dict(name=f"nuts_tree_{model}", route="cuda",
             source=f"smcnuts_torch/csrc/{model}_model.cuh",
             replaces="smcnuts_tpu/ops/nuts_pallas.py:1094",
             launches=strategies[model] + tally.launches.get(model, 0), **autodiff[model])
        for model in AUTODIFF_MODELS
    ]
    # The W = 1 witnesses of K6c and K6b (one thread a particle):
    # measurement entries.
    kernels += [
        dict(name=f"nuts_tree_{model}_w1", route="cuda",
             source=f"smcnuts_torch/csrc/{model}_variants.cu",
             replaces="smcnuts_tpu/ops/nuts_pallas.py:1094", **witnesses[model])
        for model in ("logistic", "eightschools")
    ]
    kernels += [
        # K5: the fused ARMA value and gradient that the eager tree calls.
        dict(name="arma_ll_vg", route="cuda", source="smcnuts_torch/csrc/arma_fused.cu",
             replaces="smcnuts_tpu/ops/arma_fused.py:115", **k5),
        # K5's W = 1 witness (one thread a particle): a measurement entry.
        dict(name="arma_ll_vg_w1", route="cuda", source="smcnuts_torch/csrc/arma_fused.cu",
             replaces="smcnuts_tpu/ops/arma_fused.py:115", **k5_w1),
        # K1u: the whole-tree kernel with the momenta given (the unfused path).
        dict(name="nuts_tree_arma_r_given", route="cuda", source=source,
             replaces="smcnuts_tpu/ops/nuts_pallas.py:999", **k1u),
        # K7: generated models inlined into the K1 template, one library each.
        dict(name="nuts_tree_generated_arma_forward", route="cuda",
             source="smcnuts_torch/ops/generated.py",
             replaces="smcnuts_tpu/ops/nuts_pallas.py:1674", **k7f),
        # K7f's witness: the same program emitted in the order it was built,
        # its own library; a measurement entry.
        dict(name="nuts_tree_generated_arma_forward_built_order", route="cuda",
             source="smcnuts_torch/ops/generated.py",
             replaces="smcnuts_tpu/ops/nuts_pallas.py:1674", **k7f_built),
        dict(name="nuts_tree_generated_eightschools_reverse", route="cuda",
             source="smcnuts_torch/ops/generated.py",
             replaces="smcnuts_tpu/ops/nuts_pallas.py:1126", **k7r),
        # K7r split over 2 lanes a particle, its own library; a measurement
        # entry.
        dict(name="nuts_tree_generated_eightschools_reverse_w2", route="cuda",
             source="smcnuts_torch/ops/generated.py",
             replaces="smcnuts_tpu/ops/nuts_pallas.py:1126", **k7r_w2),
    ]
    # K7 through the Stan frontend: each program's generated model inlined
    # into the K1 template, one library each (phase 13).
    kernels += [
        dict(name=f"nuts_tree_generated_stan_{prog}_{STAN_PROGRAMS[prog]['mode']}",
             route="cuda", source="smcnuts_torch/ops/generated.py",
             replaces=STAN_PROGRAMS[prog]["replaces"], **row)
        for prog, row in stan.items()
    ]
    kernels += [
        # K8: the FP32 peak, through its own entry point (ops/peak.peak_table).
        dict(name="fma_peak", route="cuda", source="smcnuts_torch/csrc/fma_peak.cu",
             replaces="experiments/bench_vpu_peak.py:38", **k8),
    ]
    for kernel in kernels:
        kernel["library_ms"] = None
        if kernel["launches"] < 1 and not kernel.get("measurement_entry"):
            raise AssertionError(f"{kernel['name']}: the main path never launched it")
        print(f"{kernel['name']}: {kernel['ms']:.4f} ms on the device alone (a call "
              f"timed alone {kernel['host_call_ms']:.4f} ms), {bound_text(kernel)}, "
              f"{kernel['bound_ms'] / kernel['ms']:.3f} of it at the data sheet's "
              f"{PEAK_FP32 / 1e12:.0f} TFLOP/s, "
              f"{kernel['bound_unfused_ms'] / kernel['ms']:.3f} at the measured "
              f"FMUL+FADD {MEASURED_PEAK['fmul_fadd'] / 1e12:.3f} TFLOP/s ({smi})")
    print(f"\nchip_smoke: all phases passed in {time.perf_counter() - started:.0f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
