"""Drive the PyTorch/CUDA port (`smcnuts_torch`) on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root; one GPU

Phases, each printing its own lines; any failure raises (non-zero exit):

1. device: the GPU's name, `nvidia-smi` name and power limit, versions.
2. build: nvcc builds the NUTS kernel from smcnuts_torch/csrc (sm_90a), one
   instantiation per model (arma, PRMwCD); prints ptxas's registers, stack
   frame and spills for each.
3. arma kernel vs plain: `nuts_tree` (the CUDA kernel) and `nuts_tree_plain`
   on the same CUDA inputs, with zero-bits and Philox draws, phi 1.0 and 0.4
   (two runs in one launch), a non-unit inverse mass, the r-given variant at
   max_depth 0, and the main path's shape (N=512, max_depth 10). Fails when
   fewer than 99.9% of lanes agree on depth, leapfrogs and moved; when x, r,
   logp0, logp_prop or delta_h differ on agreeing lanes by more than
   atol 1e-4 + rtol 1e-4; or when an output is not finite. Times both
   (CUDA events, median of 5) at N=512 and at the batched shape 25 x 512.
4. PRMwCD kernel vs plain: the same contract and cases for the PRMwCD
   instantiation (a 13-vector inverse mass), plus the batched main path's
   shape, 25 runs x 512 at max_depth 10, where both are timed.
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
   wall time and particle-iterations/s of each workload.
7. CLI: `python -m smcnuts_torch --model prmwcd --device cuda`, without and
   with --adapt-step-size --adapt-mass-matrix, through its main(): 100
   launches each and finite estimates.

The second-to-last line is a JSON object describing the kernels; the last
line is {"ok": true, "device": {...}}. Without a CUDA device, or without the
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


def phase(name):
    print(f"\n== {name}", flush=True)


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
          f"{lib.max_depth}, PRMwCD covariates {lib.prmwcd_n_cov}")
    for line in lib.log.splitlines():
        if ("Compiling entry" in line or "registers" in line or "spill" in line
                or "stack frame" in line):
            print("  ptxas:", line.strip())
    return lib


def reset_counts():
    from smcnuts_torch.ops.nuts_cuda import nuts_tree, nuts_tree_plain

    nuts_tree.launches = 0
    nuts_tree.model_launches = {k: 0 for k in nuts_tree.model_launches}
    nuts_tree_plain.calls = 0


def read_counts():
    from smcnuts_torch.ops.nuts_cuda import nuts_tree, nuts_tree_plain

    return dict(nuts_tree.model_launches), nuts_tree_plain.calls


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


def compare(label, model, args, r=None):
    """Run kernel and plain version on the same inputs; return max abs err."""
    from smcnuts_torch.ops.nuts_cuda import nuts_tree, nuts_tree_plain

    out_k = nuts_tree(model, *args, r=r)
    out_p = nuts_tree_plain(model, *args, r=r)
    torch.cuda.synchronize()
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
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError(f"{label}: non-finite {k}")
        d = (a - b).abs()
        diffs.append(f"{k}={float(d.max()):.3g}")
        if k in ("x", "r", "logp0", "logp_prop", "delta_h"):
            lanes = agree if d.dim() == 2 else agree[..., None].expand_as(d)
            bad = lanes & (d > ATOL + RTOL * b.abs())
            if bad.any():
                raise AssertionError(
                    f"{label}: {k} differs beyond atol {ATOL} + rtol {RTOL} "
                    f"on {int(bad.sum())} values of agreeing lanes"
                )
            worst = max(worst, float(d[lanes].max()))
    print(f"{label}: {agree.numel()} lanes, mean depth "
          f"{float(sk['depth'].mean()):.3f}, integer outputs agree on "
          f"{100 * share:.3f}%; max |kernel - plain|: {', '.join(diffs)}")
    return worst


def time_pair(label, model, args, smi):
    """(kernel ms, plain ms): CUDA events, median of 5 after one warmup."""
    from smcnuts_torch.ops.nuts_cuda import nuts_tree, nuts_tree_plain
    from smcnuts_torch.utils.timing import median_ms

    k_ms = median_ms(lambda: nuts_tree(model, *args), repeats=5)
    p_ms = median_ms(lambda: nuts_tree_plain(model, *args), repeats=5)
    print(f"time {label}: kernel {k_ms:.4f} ms, plain {p_ms:.1f} ms "
          f"(CUDA events, median of 5; {smi})")
    return k_ms, p_ms


def arma_kernel_phase(smi):
    from smcnuts_torch.models import get_model
    from smcnuts_torch.ops.draws import PHILOX, ZERO_BITS

    phase("3. arma kernel vs plain")
    dev = torch.device("cuda")
    model = get_model("arma").to(dev)
    ones = torch.ones(4, device=dev)
    im = torch.tensor([0.5, 2.0, 1.5, 0.25], device=dev)
    seed2 = torch.tensor([11, 12], dtype=torch.int32, device=dev)
    worst = 0.0
    for source in (ZERO_BITS, PHILOX):
        x2 = particles(4096, 1, dev).view(2, 2048, 4)
        worst = max(worst, compare(
            f"[{source}] phi 1.0 | 0.4, 2 runs x 2048, depth 6", model,
            (x2, seed2, 0.01, torch.tensor([1.0, 0.4], device=dev), ones, 6,
             source)))
        x1 = particles(4096, 2, dev)[None]
        worst = max(worst, compare(
            f"[{source}] inv_mass {im.tolist()}, 4096, depth 6", model,
            (x1, 13, 0.01, 1.0, im, 6, source)))
    r = torch.randn(1, 4096, 4, generator=torch.Generator(device=dev).manual_seed(3),
                    device=dev)
    worst = max(worst, compare(
        "[zero_bits] r given, 4096, depth 0", model,
        (particles(4096, 4, dev)[None], 0, 0.01, 0.7, im, 0, ZERO_BITS), r=r))
    main_args = (particles(N, 5, dev)[None], 21, STEP, 1.0, ones, MAX_DEPTH, PHILOX)
    worst = max(worst, compare(
        f"[philox] main path shape, {N}, depth {MAX_DEPTH}", model, main_args))
    batch_args = (particles(RUNS * N, 6, dev).view(RUNS, N, 4),
                  torch.arange(RUNS, dtype=torch.int32, device=dev), STEP, 1.0,
                  ones, MAX_DEPTH, PHILOX)
    worst = max(worst, compare(
        f"[philox] batched main path shape, {RUNS} x {N}, depth {MAX_DEPTH}",
        model, batch_args))
    time_pair(f"arma {N} x depth {MAX_DEPTH} [philox]", model, main_args, smi)
    times = time_pair(f"arma {RUNS} x {N} x depth {MAX_DEPTH} [philox]", model,
                      batch_args, smi)
    print(f"arma: max |kernel - plain| on agreeing lanes, all cases: {worst:.3g}")
    return worst, times


def prmwcd_kernel_phase(smi):
    from smcnuts_torch.models import get_model
    from smcnuts_torch.ops.draws import PHILOX, ZERO_BITS

    phase("4. PRMwCD kernel vs plain")
    dev = torch.device("cuda")
    model = get_model("prmwcd").to(dev)
    ones = torch.ones(13, device=dev)
    im = torch.tensor([0.5, 2.0, 1.5, 0.25, 1.0, 0.8, 1.2, 0.6, 1.4, 0.9, 1.1,
                       0.7, 3.0], device=dev)
    seed2 = torch.tensor([11, 12], dtype=torch.int32, device=dev)
    worst = 0.0
    for source in (ZERO_BITS, PHILOX):
        worst = max(worst, compare(
            f"[{source}] phi 1.0 | 0.4, 2 runs x 1024, depth 6", model,
            (prmwcd_particles((2, 1024), 1, dev), seed2, STEP,
             torch.tensor([1.0, 0.4], device=dev), ones, 6, source)))
        worst = max(worst, compare(
            f"[{source}] 13-vector inv_mass, 2048, depth 6", model,
            (prmwcd_particles((1, 2048), 2, dev), 13, STEP, 1.0, im, 6, source)))
    r = torch.randn(1, 2048, 13, generator=torch.Generator(device=dev).manual_seed(3),
                    device=dev)
    worst = max(worst, compare(
        "[zero_bits] r given, 2048, depth 0", model,
        (prmwcd_particles((1, 2048), 4, dev), 0, STEP, 0.7, im, 0, ZERO_BITS), r=r))
    batch_args = (prmwcd_particles((RUNS, N), 5, dev),
                  torch.arange(RUNS, dtype=torch.int32, device=dev), STEP, 1.0,
                  ones, MAX_DEPTH, PHILOX)
    worst = max(worst, compare(
        f"[philox] batched main path shape, {RUNS} x {N}, depth {MAX_DEPTH}",
        model, batch_args))
    times = time_pair(f"PRMwCD {RUNS} x {N} x depth {MAX_DEPTH} [philox]", model,
                      batch_args, smi)
    print(f"PRMwCD: max |kernel - plain| on agreeing lanes, all cases: {worst:.3g}")
    return worst, times


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


def batched_phase(smi):
    from smcnuts_torch import SMCConfig, run_smc, run_smc_batched
    from smcnuts_torch.models import get_model
    from smcnuts_torch.utils.timing import CudaTimer

    phase(f"6. batched workloads, {RUNS} runs x N={N} x K={K}")
    workloads = (
        ("arma", "arma", False),
        ("prmwcd", "prmwcd", False),
        ("prmwcd_adapted", "prmwcd", True),
    )
    launches, leapfrogs = {"arma": 0, "prmwcd": 0}, {}
    for label, name, adapt in workloads:
        cfg = SMCConfig(
            n_particles=N, n_iterations=K, step_size=STEP,
            max_tree_depth=MAX_DEPTH, save_history=False,
            adapt_step_size=adapt, adapt_mass_matrix=adapt,
            target_accept=ADAPT_TARGET if adapt else 0.8,
        )
        model = get_model(name)
        reset_counts()
        t0 = time.perf_counter()
        with CudaTimer() as t:
            res = run_smc_batched(model, cfg, SEEDS, "cuda")
            final_mean = res.mean_estimate[:, K].cpu()
        host_s = time.perf_counter() - t0
        counts, plain_calls = read_counts()
        wall_ms = t.ms
        print(f"{label}: kernel launches {counts}, plain calls {plain_calls}")
        if counts[name] != K or sum(counts.values()) != K or plain_calls != 0:
            raise AssertionError(f"{label}: not one kernel launch per iteration")
        launches[name] += counts[name]
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
            one = run_smc(model, cfg, SEEDS[b], "cuda")
            diff = [f for f, v in one._asdict().items()
                    if v is not None and not torch.equal(v, getattr(res, f)[b])]
            if diff:
                raise AssertionError(f"{label}: run {b} differs from its single "
                                     f"run in {diff}")
        print(f"{label}: runs 0 and {RUNS - 1} equal single runs with their "
              f"seeds, bit for bit")
    fixed, adapted = leapfrogs["prmwcd"], leapfrogs["prmwcd_adapted"]
    print(f"PRMwCD leapfrogs per particle-iteration: fixed {fixed:.2f}, adapted "
          f"{adapted:.2f} (the JAX package counted {JAX_LEAPFROGS['fixed']} and "
          f"{JAX_LEAPFROGS['adapted']}, experiments/output/adaptation.json)")
    if not adapted < 0.5 * fixed:
        raise AssertionError("adaptation did not shorten the PRMwCD trees")
    return launches


def cli_phase():
    phase("7. CLI, PRMwCD")
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
    return launches


def main():
    name, smi = device_phase()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    build_phase()
    arma_worst, (arma_ms, arma_plain_ms) = arma_kernel_phase(smi)
    prm_worst, (prm_ms, prm_plain_ms) = prmwcd_kernel_phase(smi)
    arma_launches = main_path_phase(smi)
    batched = batched_phase(smi)
    prm_cli = cli_phase()
    print(json.dumps({"kernels": [
        {
            "name": "nuts_tree_arma",
            "route": "cuda",
            "source": "smcnuts_torch/csrc/nuts_tree.cu",
            "replaces": "smcnuts_tpu/ops/nuts_pallas.py:154",
            "launches": arma_launches + batched["arma"],
            "max_abs_err": arma_worst,
            "ms": arma_ms,
            "plain_ms": arma_plain_ms,
        },
        {
            "name": "nuts_tree_prmwcd",
            "route": "cuda",
            "source": "smcnuts_torch/csrc/prmwcd_model.cuh",
            # K3, inlined into the K1 instantiation this entry launches.
            "replaces": "smcnuts_tpu/ops/nuts_pallas.py:1803",
            "launches": batched["prmwcd"] + prm_cli,
            "max_abs_err": prm_worst,
            "ms": prm_ms,
            "plain_ms": prm_plain_ms,
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
