"""The Gaussian NUTS kernel (K6a): the pipelined walk against the kernel before
it (its witness).

    python experiments/gaussian_pipelined_torch.py                 # on the card (one GPU)
    python experiments/gaussian_pipelined_torch.py --sass-against DIR

The entries: the main path's (`smcnuts_nuts_tree_gaussian{2,3,5}`, the
template's pipelined walk, `GaussianPipelined` of csrc/gaussian_model.cuh)
and the measurement entry of `ops.nuts_cuda.GAUSSIAN_VARIANTS` at D = 3, the
witness (`GaussianModel<3>`, the walk every other model runs, blocks of
128). Prints, each line with the card's name and power limit:
  - ptxas's registers, stack and spills, and the SASS instructions of the
    first stage and the continuation of each entry, with a count of some
    opcodes (branches, convergence regions, MUFU, FCHK, calls, local and
    shared loads and stores);
  - the fast division (`ops.nuts_cuda.quotient_sweep`) against `/` on every
    mantissa of b at the ends and the middle of the range the walk admits,
    against fixed and random a: equal to the bit;
  - the main entries (D = 2, 3, 5, with and without a prior) equal to their
    plain version to the bit (zero bits and Philox, phi 1.0 and 0.4, depth
    6, a lane whose density is -inf), and the witness equal to the main
    entry to the bit at every shape timed;
  - both entries timed in turns (device alone, `utils.timing.device_ms`,
    median of chip_smoke's VARIANT_ROUNDS) at 25 x 512 x depth 10 on phase
    8's cloud (step 0.02), at 1 x 2048 and 25 x 2048 (the tempered run of
    phase 9: one run, and the dispatch of its 25 runs), and at 100 x 512
    (the compaction hint's shape), the last three at step 0.5 and depth 5;
  - cycles a leaf of the main entry and of the witness at each shape: the
    device time over the leaves of the deepest tree of each warp (the
    kernel's own leapfrogs output; a warp is 32 neighbouring trees), at the
    SM clock nvidia-smi reads while the entries are timed (median of its
    readings); the least over warps is the warp that sets the time;
  - the lockstep waste of a warp (`ops.nuts_cuda.lockstep_waste`), a
    function of the trees alone, the same for both entries.
With --sass-against DIR (a checkout of another commit, e.g. the parent,
unpacked by `git archive`), the library and the generated K7f arma and K7r
eight-schools models are also built from DIR, and every kernel that is not
a pipelined Gaussian entry is compared, function by function, with this
tree's build (`cuobjdump -sass`, the instruction text): the witness by its
name, which is DIR's Gaussian entry of D = 3 where that is the kernel before
the pipelined walk.
"""

import argparse
import os
import re
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (  # noqa: E402
    GAUSSIAN, MAX_DEPTH, N, NAN_LANE, RUNS, VARIANT_ROUNDS, autodiff_cloud,
    bitwise_differences, timed_in_turns)
from smcnuts_torch.models import make_gaussian  # noqa: E402
from smcnuts_torch.ops.draws import PHILOX, ZERO_BITS  # noqa: E402
from smcnuts_torch.ops.nuts_cuda import (  # noqa: E402
    GAUSSIAN_DIMS, GAUSSIAN_VARIANTS, build_library, lockstep_waste, nuts_tree,
    nuts_tree_plain, nuts_tree_variant, quotient_sweep)

OPCODES = ("BRA", "BSSY", "MUFU", "FCHK", "CALL", "LDL", "STL", "LDS", "STS", "FFMA")
WITNESS = "gaussian3_witness"
CLOUD_STEP = 0.02  # phase 8's cloud step for the Gaussian
RUN_STEP, RUN_DEPTH = 0.5, 5  # the tempered run's (phase 9)


def card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def sass(path):
    """{kernel name: [instruction text, ...]} of the library at `path`
    (cuobjdump -sass; addresses and encodings dropped)."""
    from torch.utils.cpp_extension import CUDA_HOME

    out = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", path],
                         capture_output=True, text=True, timeout=600, check=True).stdout
    kernels, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            kernels[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;?\s*(?:/\*.*)?$", line)
        if name is not None and m:
            kernels[name].append(m.group(1))
    return kernels


def opcode(text):
    m = re.match(r"(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", text)
    return m.group(1) if m else ""


def entry_kernels(kernels, model_pattern):
    """{stage: instructions} of the NUTS kernels whose mangled name matches."""
    out = {}
    for name, ins in kernels.items():
        if "nuts_tree_kernel" in name and re.search(model_pattern, name):
            out[(name, "continuation" if "ELb1E" in name else "first stage")] = ins
    return out


class SmClock:
    """The SM clock (MHz) that nvidia-smi reads every 100 ms while the block
    runs; `mhz` is the median of its readings."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
             "-lms", "100"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out = self.proc.communicate(timeout=30)[0]
        self.readings = [float(v) for v in out.split() if v.replace(".", "").isdigit()]
        self.mhz = statistics.median(self.readings) if self.readings else float("nan")


def cycles_a_leaf(ms, mhz, leapfrogs):
    """(least, median, most) over warps of cycles a leaf: the device time
    over the leaves of the warp's deepest tree; and that warp's leaves."""
    leaves = leapfrogs.reshape(-1).to(torch.int64) - 1
    leaves = torch.nn.functional.pad(leaves, (0, (-leaves.numel()) % 32))
    deepest = leaves.view(-1, 32).amax(1)
    deepest = deepest[deepest > 0].double()
    cyc = ms * 1e-3 * mhz * 1e6 / deepest
    return (float(cyc.min()), float(cyc.median()), float(cyc.max()), int(deepest.max()))


def shapes(dev):
    """Readable name -> the nuts_tree arguments of each timed shape."""
    ones = torch.ones(3, device=dev)
    out = {f"{RUNS} x {N} x depth {MAX_DEPTH}, step {CLOUD_STEP}": (
        autodiff_cloud("gaussian", (RUNS, N), 5, dev),
        torch.arange(RUNS, dtype=torch.int32, device=dev), CLOUD_STEP, 1.0, ones,
        MAX_DEPTH, PHILOX)}
    for runs, n in ((1, 2048), (RUNS, 2048), (4 * RUNS, N)):
        out[f"{runs} x {n} x depth {RUN_DEPTH}, step {RUN_STEP}"] = (
            autodiff_cloud("gaussian", (runs, n), 6, dev),
            torch.arange(runs, dtype=torch.int32, device=dev), RUN_STEP, 1.0, ones,
            RUN_DEPTH, PHILOX)
    return out


def report_builds(lib, smi):
    kernels = sass(lib.path)
    log = lib.log.splitlines()
    for i, line in enumerate(log):
        if "Compiling entry" in line and "Gaussian" in line:
            info = "; ".join(l.split(":", 1)[-1].strip() for l in log[i + 1:i + 4]
                             if "registers" in l or "stack frame" in l)
            print(f"  ptxas {line.split(chr(39))[1]}: {info}")
    for (name, stage), ins in sorted(entry_kernels(kernels, r"Gaussian").items()):
        ops = [opcode(t) for t in ins]
        counts = ", ".join(f"{op} {ops.count(op)}" for op in OPCODES)
        print(f"  SASS {name} ({stage}): {len(ins)} instructions ({counts}) ({smi})")


def check_division(dev, smi):
    pairs, diff = quotient_sweep(dev, seed=3)
    if diff:
        raise AssertionError(f"the fast division differs from / on {diff} of {pairs} pairs")
    print(f"fast division: equal to / to the bit on {pairs} pairs, every mantissa of b "
          f"in the lowest, a middle and the highest binade of [2^-30, 2^30], a in "
          f"those of [2^-59, 2^57] ({smi})")


def check_main(dev, smi):
    """The main entries against their plain version to the bit."""
    cases = 0
    for d in GAUSSIAN_DIMS:
        for prior in (True, False):
            mean = [1.0, -2.0, 3.0, 0.5, -1.0][:d]
            var = [0.5, 2.0, 1.0, 1.5, 0.8][:d]
            model = make_gaussian(mean, var, [9.0] * d if prior else None).to(dev)
            g = torch.Generator(device=dev).manual_seed(d)
            x = (0.7 * torch.randn(2, 1024, d, generator=g, device=dev)).contiguous()
            x[0, 0, 0] = NAN_LANE["gaussian"][1]
            im = torch.linspace(0.5, 2.0, d, device=dev)
            for source in (ZERO_BITS, PHILOX):
                args = (x, torch.tensor([3, 4], dtype=torch.int32, device=dev), 0.1,
                        torch.tensor([1.0, 0.4], device=dev), im, 6, source)
                for comp in (None, (1, 2, 3)):
                    diff = bitwise_differences(nuts_tree(model, *args, compaction=comp),
                                               nuts_tree_plain(model, *args))
                    if diff:
                        raise AssertionError(f"gaussian{d} prior={prior} [{source}] "
                                             f"splits {comp}: differs from plain in {diff}")
                    cases += 1
    print(f"main entries D = {GAUSSIAN_DIMS}, with and without a prior: equal to the "
          f"plain version to the bit in {cases} cases (zero bits, philox, phi 1.0 and "
          f"0.4, depth 6, single and staged) ({smi})")


def time_entries(dev, smi):
    model = make_gaussian(**GAUSSIAN).to(dev)
    for label, args in shapes(dev).items():
        main = nuts_tree(model, *args)
        for v in GAUSSIAN_VARIANTS:
            diff = bitwise_differences(nuts_tree_variant(v, model, *args), main)
            if diff:
                raise AssertionError(f"{v}, {label}: differs from the main entry in {diff}")
        calls = {"main": lambda: nuts_tree(model, *args)}
        calls.update({v: (lambda v=v: nuts_tree_variant(v, model, *args))
                      for v in GAUSSIAN_VARIANTS})
        with SmClock() as clock:
            rounds, med = timed_in_turns(calls)
        lf = main[2]["leapfrogs"]
        walked, needed = lockstep_waste(lf, main[2]["depth"])
        print(f"{label}: every entry equal to the main entry to the bit; mean "
              f"leapfrogs {float(lf.mean()):.2f}, lockstep waste of a warp "
              f"{walked / needed:.4f}; SM clock {clock.mhz:.0f} MHz (median of "
              f"{len(clock.readings)} readings) ({smi})")
        for k in calls:
            print(f"  time {k}: {med[k]:.4f} ms, {med[WITNESS] / med[k]:.3f}x the "
                  f"witness's speed (device alone; median of {VARIANT_ROUNDS} in turns: "
                  f"{', '.join(f'{t:.4f}' for t in rounds[k])}; {smi})")
        for k in ("main", WITNESS):
            lo, mid, hi, deepest = cycles_a_leaf(med[k], clock.mhz, lf)
            print(f"  cycles a leaf, {k}: {lo:.0f} in the warp that sets the time "
                  f"(its deepest tree {deepest} leaves), median {mid:.0f}, most "
                  f"{hi:.0f} over warps, at {clock.mhz:.0f} MHz ({smi})")


def build_elsewhere(root):
    """Paths of the library and of the generated K7f arma and K7r
    eight-schools libraries built from the checkout at `root`."""
    code = ("import sys; sys.path.insert(0, '.');"
            "from smcnuts_torch.ops.nuts_cuda import build_library;"
            "from smcnuts_torch.ops.generated import build_generated;"
            "from smcnuts_torch.models.arma import arma_model_fwd;"
            "from smcnuts_torch.models.eightschools import make_eightschools_generated;"
            "print(build_library().path);"
            "print(build_generated(arma_model_fwd().tile_model).path);"
            "print(build_generated(make_eightschools_generated().tile_model).path)")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, check=True).stdout.split()
    return [os.path.join(root, p) if not os.path.isabs(p) else p for p in out[-3:]]


def compare_sass(other, smi):
    from concurrent.futures import ThreadPoolExecutor

    here_root = ROOT
    with ThreadPoolExecutor(2) as pool:
        theirs = pool.submit(build_elsewhere, other)
        mine = pool.submit(build_elsewhere, here_root)
        theirs, mine = theirs.result(), mine.result()
    same, differ, gone = 0, [], []
    for a, b in zip(mine, theirs):
        ka, kb = sass(a), sass(b)
        for name in sorted(set(ka) | set(kb)):
            if "GaussianPipelined" in name or "quotient_check" in name:
                continue
            if name not in ka:
                gone.append(name)
            elif ka[name] == kb.get(name):
                same += 1
            else:
                differ.append(name)
    witness = [n for n in sass(mine[0]) if "GaussianModelILi3EEE" in n]
    print(f"SASS against {other}: {same} kernels that are not a pipelined Gaussian entry "
          f"identical, instruction for instruction, the witness's {len(witness)} stages "
          f"(GaussianModel<3>, the other build's D = 3 entry) among them; {len(differ)} "
          f"differ{': ' + ', '.join(differ) if differ else ''}; only in {other}: "
          f"{', '.join(gone) or 'none'} ({smi})")
    if differ or len(witness) != 2 or any("GaussianModel" not in n for n in gone):
        raise AssertionError("kernels outside the pipelined Gaussian's, or the witness, "
                             "changed their SASS")


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--sass-against", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("a CUDA device is required")
    smi = card()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    lib = build_library()
    print(f"built in {lib.build_seconds:.1f} s (load {time.perf_counter() - t0:.1f} s); "
          f"Gaussian entries in blocks of {lib.gaussian_block} ({smi})")
    report_builds(lib, smi)
    check_division(dev, smi)
    check_main(dev, smi)
    time_entries(dev, smi)
    if args.sass_against:
        compare_sass(args.sass_against, smi)
    print(smi)


if __name__ == "__main__":
    main()
