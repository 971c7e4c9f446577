"""SMC state carried between the JAX package and this one, as numpy arrays.

`carry_from_numpy` builds this package's `SMCCarry` from the fields the two
carries share (x, logw, phi, step_size, inv_mass), for example those of a
JAX `SMCCarry` passed through `np.asarray`; `carry_to_numpy` gives them back.
The arma data come from the same asset file in both packages, so no model
weights need converting.
"""

from __future__ import annotations

import numpy as np
import torch

from .sampler import SMCCarry

CARRY_FIELDS = ("x", "logw", "phi", "step_size", "inv_mass")


def carry_from_numpy(x, logw, phi, step_size, inv_mass,
                     device="cpu") -> SMCCarry:
    """The carry on `device`, in the floating dtype of `x`."""
    x = torch.tensor(np.asarray(x), device=device)

    def t(a):
        return torch.tensor(np.asarray(a), dtype=x.dtype, device=device)

    logw = t(logw)
    if x.dim() != 2 or logw.shape != x.shape[:1]:
        raise ValueError(
            f"x must be (N, D) and logw (N,), got {tuple(x.shape)} and "
            f"{tuple(logw.shape)}"
        )
    return SMCCarry(
        x=x, logw=logw, phi=t(phi).reshape(()),
        step_size=t(step_size).reshape(()), inv_mass=t(inv_mass).reshape(-1),
    )


def carry_to_numpy(carry: SMCCarry) -> dict:
    return {k: getattr(carry, k).detach().cpu().numpy() for k in CARRY_FIELDS}
