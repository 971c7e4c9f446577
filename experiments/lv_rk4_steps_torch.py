"""The steps_per_interval of chip_smoke.py's `lv_rk4`: how close fixed-step
RK4 (`ode_rk4`, `ops/ode.odeint_rk4`) at s steps a year comes to the
adaptive solver of `lv_rk45` (`ops/ode.odeint_dopri5`, Stan's rk45 defaults,
rtol = atol = 1e-6), on the Lotka-Volterra system at the case study's 20
yearly output times, over a cloud of prior draws.

    python experiments/lv_rk4_steps_torch.py            # CPU, float64, ~30 s
    python experiments/lv_rk4_steps_torch.py --draws 1024 --seed 0

The prior is the case study's: theta[1], theta[3] ~ normal(1, 0.5) and
theta[2], theta[4] ~ normal(0.05, 0.05), each truncated at 0; z_init ~
lognormal(log 10, 1). A draw's error is the largest relative difference
|z_rk4 - z_rk45| / |z_rk45| over the 20 times and both species. One line an
s: the median, 90th percentile and largest error over the cloud, and the
draws above 1e-4. A last line compares lv_rk45 itself with the adaptive
solver at rtol = atol = 1e-10, the accuracy of the reference: on prior draws
whose populations explode or die out, lv_rk45 is itself off by more than
1e-4, so no s brings every draw within 1e-4 of it; the count chosen is the
smallest s whose median is (chip_smoke.py's LV_RK4_STEPS).
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from smcnuts_torch.ops.ode import odeint_dopri5, odeint_rk4  # noqa: E402

STEPS = (2, 4, 6, 8, 10, 12, 16, 20)


def truncated_normal(rng, mu, sd, n):
    """Normal(mu, sd) draws kept above 0, by rejection."""
    out = np.empty(0)
    while out.size < n:
        d = rng.normal(mu, sd, 4 * n)
        out = np.concatenate([out, d[d > 0]])
    return out[:n]


def prior_cloud(n, seed):
    rng = np.random.default_rng(seed)
    theta = np.stack([truncated_normal(rng, 1.0, 0.5, n), truncated_normal(rng, 0.05, 0.05, n),
                      truncated_normal(rng, 1.0, 0.5, n), truncated_normal(rng, 0.05, 0.05, n)],
                     1)
    return theta, np.exp(np.log(10.0) + rng.normal(size=(n, 2)))


def rhs(y, t, th):
    return torch.stack([(th[0] - th[1] * y[1]) * y[0], (-th[2] + th[3] * y[0]) * y[1]])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--draws", type=int, default=1024)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    theta, z0 = prior_cloud(args.draws, args.seed)
    th, y0 = torch.tensor(theta), torch.tensor(z0)
    ts = torch.arange(0, 21, dtype=torch.float64)
    ref = torch.func.vmap(lambda y, t: odeint_dopri5(rhs, y, ts, (t,)))(y0, th)[:, 1:]

    def errors(sol):
        return ((sol - ref).abs() / ref.abs()).amax((1, 2)).numpy()

    chosen = None
    for s in STEPS:
        err = errors(torch.func.vmap(lambda y, t: odeint_rk4(rhs, y, ts, (t,), s))(y0, th))
        median = float(np.nanmedian(err))
        if chosen is None and median <= 1e-4:
            chosen = s
        print(f"s = {s}: median {median:.3e}, 90th percentile {np.nanquantile(err, 0.9):.3e}, "
              f"largest {np.nanmax(err):.3e}, draws above 1e-4: {int((err > 1e-4).sum())} of "
              f"{args.draws} (cpu, float64)", flush=True)
    tight = torch.func.vmap(lambda y, t: odeint_dopri5(rhs, y, ts, (t,), 1e-10, 1e-10))(y0, th)
    err = ((ref - tight[:, 1:]).abs() / tight[:, 1:].abs()).amax((1, 2)).numpy()
    print(f"lv_rk45 against rtol = atol = 1e-10: median {np.median(err):.3e}, 90th percentile "
          f"{np.quantile(err, 0.9):.3e}, largest {err.max():.3e}, draws above 1e-4: "
          f"{int((err > 1e-4).sum())}")
    print(f"smallest s with the median within 1e-4: {chosen}")


if __name__ == "__main__":
    main()
