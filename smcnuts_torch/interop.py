"""SMC state carried between the JAX package and this one, as numpy arrays.

`carry_from_numpy` builds this package's `SMCCarry` from the fields the two
carries share (x, logw, phi, step_size, inv_mass, the dual-averaging state
da and, for the asymptotic strategy, loglik), for example those of a JAX
`SMCCarry` passed through `np.asarray`; `carry_to_numpy` gives them back. The run axis is optional: x
(N, D) is one run, x (B, N, D) is B runs (a `jax.vmap` of the JAX carry).
Both packages read the models' data from the same asset files, so no model
weights need converting.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.adaptation import DualAveragingState, da_init
from .sampler import SMCCarry

CARRY_FIELDS = ("x", "logw", "phi", "step_size", "inv_mass", "da")


def carry_from_numpy(x, logw, phi, step_size, inv_mass, da=None,
                     loglik=None, device="cuda") -> SMCCarry:
    """The carry on `device`, in the floating dtype of `x`; the card unless
    the caller passes "cpu", as in `run_smc_batched` and `run_smc`. `da` holds
    the five dual-averaging fields in `DualAveragingState` order (a JAX
    `DualAveragingState` will do); None starts them from the step size.
    `loglik` is the untempered log-likelihood of x that the asymptotic
    strategy carries (the JAX carry holds it with save_history=False; this
    package's always), None for the other strategies."""
    x = torch.tensor(np.asarray(x), device=device)
    if x.dim() == 2:
        x = x[None]
    if x.dim() != 3:
        raise ValueError(f"x must be (N, D) or (B, N, D), got {tuple(x.shape)}")
    B, N, D = x.shape

    def t(a, shape):
        return torch.tensor(np.asarray(a), dtype=x.dtype, device=device).reshape(shape)

    step = t(step_size, (B,))
    return SMCCarry(
        x=x, logw=t(logw, (B, N)), phi=t(phi, (B,)), step_size=step,
        inv_mass=t(inv_mass, (B, D)),
        da=da_init(step) if da is None
        else DualAveragingState(*(t(v, (B,)) for v in da)),
        loglik=None if loglik is None else t(loglik, (B, N)),
    )


def carry_to_numpy(carry: SMCCarry, run_axis: bool = True) -> dict:
    """The carry's fields as numpy arrays; `da` as a `DualAveragingState` of
    arrays, and `loglik` when the carry holds it. With run_axis=False the
    carry must hold one run, and its run axis is dropped."""
    if not run_axis and carry.x.shape[0] != 1:
        raise ValueError(f"run_axis=False needs one run, got {carry.x.shape[0]}")

    def a(v):
        v = v.detach().cpu().numpy()
        return v if run_axis else v[0]

    out = {k: a(getattr(carry, k)) for k in CARRY_FIELDS if k != "da"}
    out["da"] = DualAveragingState(*(a(v) for v in carry.da))
    if carry.loglik is not None:
        out["loglik"] = a(carry.loglik)
    return out
