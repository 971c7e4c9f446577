"""The generated forward-mode models (K7f) with their recurrences emitted as
loops, at several unroll factors, against the same program straight-line.

    python experiments/generated_loop_unroll_torch.py     # on the card (one GPU)

The programs are chip_smoke.py's K7f cases: the generated arma at T=200
(`arma_model_fwd`), the Stan irt_ar and the Stan AR(1)-error recurrence at
T=200 (STAN_PROGRAMS). Each is built straight-line (`ops.generated.
straight_line`) and with its loops at `#pragma unroll` 1, 2, 4 and 8
(`ops.generated.REROLL_UNROLL` forced; the default build chooses one of them
by the size of the loop's body, and the script prints which), each build its
own library, all nvcc at once. Prints, for each build, nvcc's seconds, ptxas's registers,
stack and spills, the SASS instructions of the first-stage and continuation
kernels and a count of some opcodes in the first stage (shared, local and
global loads and stores, branches, FP32 adds and multiplies, MUFU). Then
each program's cloud: 25 runs x 512 particles after K_CLOUD iterations of
run_smc_batched (forwards, depth 10, the program's step), on which every
build must equal the straight-line build to the bit (zero bits and Philox,
25 x 512 x depth 10), and the builds timed in turns on the device alone
(`utils/timing.device_ms`, median of chip_smoke's VARIANT_ROUNDS) at
25 x 512 x depth 10, and for arma and the recurrence at WIDE trees (the
cloud repeated) too. Every line carries the card's name and power limit.
"""

import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (  # noqa: E402
    MAX_DEPTH, N, RUNS, STAN_PROGRAMS, STEP, bitwise_differences, stan_source,
    timed_in_turns)
from smcnuts_torch import SMCConfig, run_smc_batched  # noqa: E402
from smcnuts_torch.models.arma import arma_model_fwd  # noqa: E402
from smcnuts_torch.models.base import CallableModel  # noqa: E402
from smcnuts_torch.ops import generated  # noqa: E402
from smcnuts_torch.ops.draws import PHILOX, ZERO_BITS  # noqa: E402
from smcnuts_torch.ops.nuts_cuda import nuts_tree  # noqa: E402
from smcnuts_torch.stan import compile_stan_program  # noqa: E402

UNROLLS = (1, 2, 4, 8)
K_CLOUD = 20
WIDE = 262_144
OPCODES = ("LDS", "STS", "LDL", "STL", "LDG", "LD", "ST", "BRA", "FADD", "FMUL", "MUFU")


def card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def sass(path):
    """{kernel name: [opcode, ...]} of the library at `path` (cuobjdump)."""
    from torch.utils.cpp_extension import CUDA_HOME

    out = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", path],
                         capture_output=True, text=True, timeout=300, check=True).stdout
    kernels, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            kernels[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if name is not None and m:
            kernels[name].append(m.group(1))
    return kernels


def programs():
    """name -> (CallableModel with the re-rolled generated model, step)."""
    out = {"arma": (arma_model_fwd(), STEP)}
    for name in ("irt_ar", "ar1_errors_t200"):
        src, data = stan_source(name)
        out[name] = (compile_stan_program(src, data, name=name, tile=True),
                     STAN_PROGRAMS[name]["step"])
    return out


def builds(model):
    """Readable name -> CallableModel of the same density and program."""
    tm = model.tile_model
    if not tm.program.recurrences:
        raise AssertionError(f"{model.name}: no recurrence re-rolled")
    variants = {"straight-line": generated.straight_line(tm)}
    for u in UNROLLS:
        generated.REROLL_UNROLL = u
        try:
            variants[f"loop, unroll {u}"] = generated.GeneratedModel(tm.program, tm.autodiff,
                                                                     tm.name)
        finally:
            generated.REROLL_UNROLL = None
    return {k: CallableModel(model.name, model.dim, model._logprior, model._loglik,
                             model._constrain, tile_model=v).to("cuda")
            for k, v in variants.items()}


def report(label, lib, smi):
    print(f"{label}: nvcc {lib.build_seconds:.1f} s ({smi})")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    for name, ops in sorted(sass(lib.path).items()):
        if "nuts_tree_kernel" not in name:
            continue
        stage = "continuation" if "Lb1E" in name else "first stage"
        counts = ", ".join(f"{op} {ops.count(op)}" for op in OPCODES)
        print(f"  SASS, {stage}: {len(ops)} instructions ({counts})")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("a CUDA device is required")
    smi = card()
    dev = torch.device("cuda")
    seeds = torch.arange(RUNS, dtype=torch.int32, device=dev)
    progs = {name: (m.to(dev), step) for name, (m, step) in programs().items()}
    variants = {name: builds(m) for name, (m, _) in progs.items()}
    for name, (m, _) in progs.items():
        chosen = sorted(set(re.findall(r"#pragma unroll (\d+)", m.tile_model.source)))
        print(f"{name}: the default build unrolls its loops by {', '.join(chosen)}")
    started = time.perf_counter()
    with ThreadPoolExecutor(sum(len(v) for v in variants.values())) as pool:
        libs = {(name, k): pool.submit(generated.build_generated, v.tile_model)
                for name, vs in variants.items() for k, v in vs.items()}
        libs = {key: f.result() for key, f in libs.items()}
    print(f"{len(libs)} builds, all nvcc at once, in {time.perf_counter() - started:.1f} s "
          f"({smi})")
    for (name, k), lib in libs.items():
        report(f"{name}, {k}", lib, smi)

    for name, (model, step) in progs.items():
        cfg = SMCConfig(n_particles=N, n_iterations=K_CLOUD, step_size=step,
                        max_tree_depth=MAX_DEPTH)
        x = run_smc_batched(model, cfg, list(range(RUNS)), "cuda").x_final.contiguous()
        ones = torch.ones(x.shape[-1], device=dev)
        vs = variants[name]
        for source in (ZERO_BITS, PHILOX):
            args = (x, seeds, step, 1.0, ones, MAX_DEPTH, source)
            want = nuts_tree(vs["straight-line"], *args)
            for k, v in vs.items():
                diff = bitwise_differences(nuts_tree(v, *args), want)
                if diff:
                    raise AssertionError(f"{name}, {k} [{source}]: differs from the "
                                         f"straight line in {diff}")
        print(f"{name}: every build equal to the straight line to the bit [zero bits, "
              f"philox], {RUNS} x {N} x depth {MAX_DEPTH}")
        shapes = [(f"{RUNS} x {N}", (x, seeds, step, 1.0, ones, MAX_DEPTH, PHILOX))]
        if name != "irt_ar":
            reps = -(-WIDE // (RUNS * N))
            wide = x.reshape(-1, x.shape[-1]).repeat(reps, 1)[:WIDE][None].contiguous()
            shapes.append((f"1 x {WIDE}", (wide, 7, step, 1.0, ones, MAX_DEPTH, PHILOX)))
        for shape, args in shapes:
            calls = {k: (lambda v=v, a=args: nuts_tree(v, *a)) for k, v in vs.items()}
            rounds, med = timed_in_turns(calls)
            for k in calls:
                print(f"time {name} {k}, {shape} x depth {MAX_DEPTH} [philox]: {med[k]:.4f} ms, "
                      f"{med['straight-line'] / med[k]:.3f}x the straight line's speed "
                      f"(device alone; in turns: {', '.join(f'{t:.4f}' for t in rounds[k])}; "
                      f"{smi})")
    print(smi)


if __name__ == "__main__":
    main()
