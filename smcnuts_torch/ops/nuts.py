"""NUTS constants and the accept-reject of the unfused proposal path (the JAX
package's `ops/nuts.py`).

The tree itself is `ops.nuts_cuda`: the CUDA kernel and its plain version
`nuts_tree_plain`, which is also the eager backend (the port of
`nuts_batch`), run in sequential blocks of lanes when given a block size.

`hmc_accept_reject_cached` and `hmc_accept_reject` are the asymptotic
strategy's accept-reject when it runs outside the tree: a particle keeps its
proposal where u <= min(1, exp(H' - H0)) and its proposal is finite in every
coordinate, else position and momentum go back to the start. The uniforms u
are given (the JAX package draws them from its key; the sampler from each
run's own stream). Every argument has a leading run axis: x and r (B, N, D),
densities and u (B, N), inv_mass (B, D) or None for the identity. The sums
over coordinates are taken in sequence, so a run does not depend on the runs
beside it.
"""

from __future__ import annotations

import torch

MAX_TREE_DEPTH = 10  # reference nuts.py:4; doublings 0..max_depth
DIVERGENCE_THRESHOLD = 100.0  # nats; reference nuts.py:125


def _kinetic(r, inv_mass):
    """0.5 sum_d r_d im_d r_d over the last axis, in sequence."""
    im = torch.ones_like(r[:, 0]) if inv_mass is None else inv_mass
    acc = r[..., 0] * im[:, None, 0] * r[..., 0]
    for d in range(1, r.shape[-1]):
        acc = acc + r[..., d] * im[:, None, d] * r[..., d]
    return 0.5 * acc


def hmc_accept_reject_cached(logp0, logp_prime, x, x_prime, r, r_prime, u,
                             inv_mass=None):
    """The accept-reject on the densities the tree already evaluated (its
    `logp0` and `logp_prop` outputs). Returns (x_out, r_out, accepted)."""
    H1 = logp_prime - _kinetic(r_prime, inv_mass)
    H0 = logp0 - _kinetic(r, inv_mass)
    ratio = torch.exp(H1 - H0)
    ok = torch.all(torch.isfinite(x_prime), dim=-1)
    # min(1, ratio) keeps a NaN ratio NaN, so u <= it is false and rejects.
    accepted = (u <= torch.clamp(ratio, max=1.0)) & ok
    keep = accepted[..., None]
    return (torch.where(keep, x_prime, x), torch.where(keep, r_prime, r),
            accepted)


def hmc_accept_reject(logp_fn, x, x_prime, r, r_prime, u, inv_mass=None):
    """The same with the densities evaluated here: logp_fn maps (B, N, D)
    positions to (B, N) log-densities."""
    return hmc_accept_reject_cached(logp_fn(x), logp_fn(x_prime), x, x_prime,
                                    r, r_prime, u, inv_mass)
