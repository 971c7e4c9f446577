"""The Gaussian L-kernel strategy on the card, end to end and alone, at the
configuration of chip_smoke.py phase 9: 25 runs x N=512 x K=100, step 0.01,
depth 10, "GaussianApproxLKernel", for arma and PRMwCD.

    PYTHONPATH=<tree> python experiments/gaussian_lkernel_walls_torch.py LABEL

prints one JSON line tagged LABEL, with the card's name and power limit and,
for each model:

- "wall_ms": `run_smc_batched` to the means on the host, CUDA events, each of
  two calls after a warm-up call;
- "loop": the first 20 iterations under `utils.profiling.profile_iterations`
  (ms an iteration unprofiled, device kernels and busy ms an iteration);
- "phase_timings_lkernel_ms": the "gaussian_lkernel" row of
  `utils.profiling.phase_timings` (one run of N=512);
- "lkernel_ms": `ops.lkernels.gaussian_lkernel_logpdf` on the loop's batch
  (25 x 512 x D) alone, CUDA events over 20 calls back to back, best of 3.

It imports the package from PYTHONPATH, so two trees (a parent unpacked with
`git archive` and the change) run in turns in one call compare on one card.
"""

import json
import subprocess
import sys

import torch

from smcnuts_torch import SMCConfig
from smcnuts_torch.models import get_model
from smcnuts_torch.ops.lkernels import gaussian_lkernel_logpdf
from smcnuts_torch.sampler import run_smc_batched
from smcnuts_torch.utils.profiling import phase_timings, profile_iterations

RUNS, N, K, STEP, DEPTH = 25, 512, 100, 0.01, 10


def _events_ms(fn, iters=1):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(label):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    out = {"label": label, "card": smi}
    for name in ("arma", "prmwcd"):
        model = get_model(name).to("cuda")
        cfg = SMCConfig(n_particles=N, n_iterations=K, step_size=STEP,
                        lkernel="GaussianApproxLKernel", max_tree_depth=DEPTH)
        seeds = list(range(RUNS))

        def call():
            run_smc_batched(model, cfg, seeds, "cuda").mean_estimate.cpu()

        call()
        walls = [_events_ms(call) for _ in range(2)]
        prof = profile_iterations(model, cfg, seeds, device="cuda") or {}
        lk = phase_timings(model, cfg, device="cuda")["gaussian_lkernel"]
        g = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn(RUNS, N, model.dim, generator=g, device="cuda")
        r = 0.4 * x + torch.randn(RUNS, N, model.dim, generator=g, device="cuda")
        alone = min(_events_ms(lambda: gaussian_lkernel_logpdf(r, x), 20) for _ in range(3))
        out[name] = {"dim": model.dim, "wall_ms": walls,
                     "loop": {k: prof.get(k) for k in ("ms", "kernels", "busy_ms",
                                                       "idle_share")},
                     "phase_timings_lkernel_ms": 1e3 * lk, "lkernel_ms": alone}
    print(json.dumps(out))


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    main(sys.argv[1] if len(sys.argv) > 1 else "tree")
