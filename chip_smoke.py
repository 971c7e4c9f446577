"""Drive the PyTorch/CUDA port (`smcnuts_torch`) on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root; one GPU

Phases, each printing its own lines; any failure raises (non-zero exit):

1. device: the GPU's name, `nvidia-smi` name and power limit, versions.
2. build: nvcc builds the NUTS kernel from smcnuts_torch/csrc (sm_90a).
3. kernel vs plain: `nuts_tree` (the CUDA kernel) and `nuts_tree_plain` on
   the same CUDA inputs, with zero-bits and Philox draws, phi 1.0 and 0.4
   (two runs in one launch), a non-unit inverse mass, the r-given variant at
   max_depth 0, and the main path's shape (N=512, max_depth 10). Fails when
   fewer than 99.9% of lanes agree on depth, leapfrogs and moved; when x, r,
   logp0, logp_prop or delta_h differ on agreeing lanes by more than
   atol 1e-4 + rtol 1e-4; or when an output is not finite. Times both
   (CUDA events, median of 5).
4. main path: SMCSampler(K=100, N=512, arma, step 0.01, max depth 10) on the
   GPU, then `python -m smcnuts_torch` through its main(). Each run must
   launch the kernel exactly 100 times and the plain tree never; every
   series is finite with K+1 entries, acceptance[K] == 0, and each final
   posterior mean lies within one posterior sd of the reference ground truth.

The second-to-last line is a JSON object describing the kernel; the last
line is {"ok": true, "device": {...}}. Without a CUDA device, or without the
repository beside it, the script fails before printing any result.
"""

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
          f"{lib.max_depth}")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line or "stack frame" in line:
            print("  ptxas:", line.strip())
    return lib


def particles(n, seed, device):
    """Three quarters at POST_MODE +- 0.02, one quarter dispersed (+- 0.3)."""
    g = torch.Generator(device=device).manual_seed(seed)
    mode = torch.tensor(POST_MODE, device=device)
    x = mode + 0.02 * torch.randn(n, 4, generator=g, device=device)
    q = n // 4
    x[:q] = mode + 0.3 * torch.randn(q, 4, generator=g, device=device)
    return x


def compare(label, model, args, smi, r=None):
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
    print(f"{label}: {agree.numel()} lanes, integer outputs agree on "
          f"{100 * share:.3f}%; max |kernel - plain|: {', '.join(diffs)}")
    return worst


def kernel_phase(smi):
    from smcnuts_torch.models import get_model
    from smcnuts_torch.ops.draws import PHILOX, ZERO_BITS
    from smcnuts_torch.ops.nuts_cuda import nuts_tree, nuts_tree_plain
    from smcnuts_torch.utils.timing import median_ms

    phase("3. kernel vs plain")
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
             source), smi))
        x1 = particles(4096, 2, dev)[None]
        worst = max(worst, compare(
            f"[{source}] inv_mass {im.tolist()}, 4096, depth 6", model,
            (x1, 13, 0.01, 1.0, im, 6, source), smi))
    r = torch.randn(1, 4096, 4, generator=torch.Generator(device=dev).manual_seed(3),
                    device=dev)
    worst = max(worst, compare(
        "[zero_bits] r given, 4096, depth 0", model,
        (particles(4096, 4, dev)[None], 0, 0.01, 0.7, im, 0, ZERO_BITS), smi,
        r=r))
    main_args = (particles(N, 5, dev)[None], 21, STEP, 1.0, ones, MAX_DEPTH, PHILOX)
    worst = max(worst, compare(
        f"[philox] main path shape, {N}, depth {MAX_DEPTH}", model, main_args, smi))

    times = {}
    big_args = (particles(4096, 2, dev)[None], 13, 0.01, 1.0, ones, 6, PHILOX)
    for label, args in (("4096 x depth 6", big_args),
                        (f"{N} x depth {MAX_DEPTH}", main_args)):
        k_ms = median_ms(lambda: nuts_tree(model, *args), repeats=5)
        p_ms = median_ms(lambda: nuts_tree_plain(model, *args), repeats=5)
        times[label] = (k_ms, p_ms)
        print(f"time {label} [philox]: kernel {k_ms:.4f} ms, plain {p_ms:.1f} ms "
              f"(CUDA events, median of 5; {smi})")
    print(f"max |kernel - plain| on agreeing lanes, all cases: {worst:.3g}")
    return worst, times[f"{N} x depth {MAX_DEPTH}"]


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


def main_path_phase(smi):
    from smcnuts_torch import SMCSampler
    from smcnuts_torch.__main__ import main as cli_main
    from smcnuts_torch.models import get_model
    from smcnuts_torch.ops.nuts_cuda import nuts_tree, nuts_tree_plain
    from smcnuts_torch.utils.timing import CudaTimer

    phase("4. main path")
    sampler = SMCSampler(K=K, N=N, target=get_model("arma"), step_size=STEP,
                         device="cuda")
    nuts_tree.launches = 0
    nuts_tree_plain.calls = 0
    with CudaTimer() as t:
        res = sampler.sample(seed=SEED)
    launches, plain_calls = nuts_tree.launches, nuts_tree_plain.calls
    wall_ms = t.ms
    print(f"SMCSampler: kernel launches {launches}, plain calls {plain_calls}")
    if launches != K or plain_calls != 0:
        raise AssertionError("the main path did not run the kernel once per iteration")
    for name, v in res._asdict().items():
        if v is None or name in ("x_saved", "logw_saved", "x_final", "logw_final"):
            continue
        if v.shape[0] != K + 1 or not torch.isfinite(v.float()).all():
            raise AssertionError(f"series {name}: shape {tuple(v.shape)} or not finite")
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

    nuts_tree.launches = 0
    nuts_tree_plain.calls = 0
    summary = cli_main(["--model", "arma", "-N", str(N), "-K", str(K),
                        "--step-size", str(STEP), "--max-tree-depth",
                        str(MAX_DEPTH), "--seed", str(SEED), "--device", "cuda"])
    print(f"CLI: kernel launches {nuts_tree.launches}, plain calls "
          f"{nuts_tree_plain.calls}")
    if nuts_tree.launches != K or nuts_tree_plain.calls != 0:
        raise AssertionError("the CLI run did not run the kernel once per iteration")
    if summary["phi_schedule"] != [1.0] * (K + 1):
        raise AssertionError("phi must stay 1 without tempering")
    check_run("CLI", summary["mean"], 1.0)
    return launches, wall_ms


def main():
    name, smi = device_phase()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    build_phase()
    worst, (k_ms, p_ms) = kernel_phase(smi)
    launches, _ = main_path_phase(smi)
    print(json.dumps({"kernels": [{
        "name": "nuts_tree_arma",
        "route": "cuda",
        "source": "smcnuts_torch/csrc/nuts_tree.cu",
        "replaces": "smcnuts_tpu/ops/nuts_pallas.py:154",
        "launches": launches,
        "max_abs_err": worst,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
