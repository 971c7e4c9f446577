"""Condense a parity experiment of the PyTorch/CUDA port into one
committable JSON verdict: the counterpart of experiments/parity_summary.py
(the JAX package's) for `smcnuts_torch`.

Reads the per-run CSVs that experiments/run_experiments_torch.py wrote
under --output and writes <model>_summary.json there with, per strategy,
the final-iteration MC mean and MC sd of each parameter's mean and
variance estimates across the runs, their final MSE against the Stan
ground truth, and the PARITY verdict (`smcnuts_torch.utils.parity`: 3 MC se
+ 0.1 posterior sd on the means, 3 MC se + 40% on the variances). The keys
and their rounding are the JAX script's.

    python3 experiments/parity_summary_torch.py --model arma --runs 25 \\
        --output parity_torch/arma
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from smcnuts_torch.utils.parity import summarize


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default="arma")
    p.add_argument("--runs", type=int, default=25)
    p.add_argument("--output", required=True)
    args = p.parse_args(argv)
    out = summarize(args.model, args.output, args.runs)
    path = os.path.join(args.output, f"{args.model}_summary.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))
    print(f"wrote {path}", file=sys.stderr)
    return out


if __name__ == "__main__":
    main()
