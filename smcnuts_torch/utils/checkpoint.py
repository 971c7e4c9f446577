"""Checkpoints of B SMC runs between iterations (the JAX package's
`utils/checkpoint.py`, for this package's state).

A checkpoint is one .npz of host numpy arrays: the `SMCCarry` of the runs
(positions, log weights, phi, step size, inverse mass, the five
dual-averaging fields, and loglik where the strategy carries it), the count
of completed iterations `k_done`, the runs' seeds, the diagnostics of the
k_done iterations stacked (B, k_done, ...), and with saved history the
history lists stacked (B, k_done + 1, ...). There is no PRNG state to save:
every draw is addressed by run seed, kind and absolute iteration
(`ops/draws.py`). Used by `runner.ChunkedRunner` between chunks.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops.adaptation import DualAveragingState
from ..sampler import SMCCarry

# Bump when the layout of the file changes (the carry's fields, the naming of
# the diagnostics or histories). A checkpoint of another version is refused
# instead of being read into the wrong fields.
CHECKPOINT_VERSION = 1


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _carry_arrays(carry: SMCCarry) -> dict:
    out = {f"carry_{name}": getattr(carry, name)
           for name in ("x", "logw", "phi", "step_size", "inv_mass")}
    out.update({f"carry_da_{name}": v for name, v in carry.da._asdict().items()})
    if carry.loglik is not None:
        out["carry_loglik"] = carry.loglik
    return out


def save_checkpoint(path: str, carry: SMCCarry, k_done: int, diagnostics: dict,
                    history: dict | None = None, seeds=()):
    """Write the runs' state after k_done iterations to `path`, atomically: a
    `.tmp` file beside it, flushed and fsynced, then renamed over it, so a
    crash leaves the old checkpoint or the new one, never a torn file.
    diagnostics: name -> (B, k_done, ...) tensor; history: name -> (B,
    k_done + 1, ...) tensor, or None."""
    payload = {name: _host(t) for name, t in _carry_arrays(carry).items()}
    payload.update({f"diag_{name}": _host(t) for name, t in diagnostics.items()})
    if history is not None:
        payload.update({f"hist_{name}": _host(t) for name, t in history.items()})
    payload["version"] = np.int64(CHECKPOINT_VERSION)
    payload["k_done"] = np.int64(k_done)
    payload["seeds"] = np.asarray(seeds, dtype=np.int64)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _restore(data, key: str, path: str, dtype: torch.dtype, shape: tuple, device):
    if key not in data.files:
        raise ValueError(f"checkpoint {path!r} holds no {key!r}")
    arr = data[key]
    got = torch.from_numpy(np.ascontiguousarray(arr))
    if got.dtype != dtype or tuple(got.shape) != tuple(shape):
        raise ValueError(f"checkpoint {path!r}: {key} is {got.dtype} {tuple(got.shape)}, "
                         f"the run needs {dtype} {tuple(shape)}")
    return got.to(device)


def load_checkpoint(path: str, carry_template: SMCCarry, diag_template: dict, device):
    """Read a checkpoint of `save_checkpoint` onto `device`.

    carry_template is an SMCCarry whose tensors (meta tensors will do) give
    each field's dtype and shape, loglik None where the strategy carries
    none; diag_template maps each diagnostic's name to a tensor of one
    iteration's dtype and shape (B, ...). Every array is checked against
    them; a file of another CHECKPOINT_VERSION, or one that does not fit,
    raises ValueError. Returns (carry, k_done, diagnostics (name -> (B,
    k_done, ...)), history (name -> (B, k_done + 1, ...), or None when the
    file holds none), seeds (a list of ints))."""
    with np.load(path, allow_pickle=False) as data:
        version = int(data["version"]) if "version" in data.files else 0
        if version != CHECKPOINT_VERSION:
            raise ValueError(
                f"checkpoint {path!r} has version {version}, this build reads "
                f"version {CHECKPOINT_VERSION}; run again from the start (delete "
                "the checkpoint) or read it with a build of its version")
        k_done = int(data["k_done"])
        if ("carry_loglik" in data.files) != (carry_template.loglik is not None):
            raise ValueError(f"checkpoint {path!r} was written for another L-kernel "
                             "strategy (the carry's loglik)")
        restored = {
            key: _restore(data, key, path, t.dtype, t.shape, device)
            for key, t in _carry_arrays(carry_template).items()
        }
        carry = SMCCarry(
            **{name: restored[f"carry_{name}"]
               for name in ("x", "logw", "phi", "step_size", "inv_mass")},
            da=DualAveragingState(**{name: restored[f"carry_da_{name}"]
                                     for name in DualAveragingState._fields}),
            loglik=restored.get("carry_loglik"),
        )
        diagnostics = {
            name: _restore(data, f"diag_{name}", path, t.dtype,
                           (t.shape[0], k_done) + tuple(t.shape[1:]), device)
            for name, t in diag_template.items()
        }
        history = None
        hist_keys = [k for k in data.files if k.startswith("hist_")]
        if hist_keys:
            history = {}
            for key in hist_keys:
                name = key[len("hist_"):]
                t = getattr(carry_template, name, None)
                if t is None:
                    raise ValueError(f"checkpoint {path!r}: unknown history {name!r}")
                history[name] = _restore(data, key, path, t.dtype,
                                         (t.shape[0], k_done + 1) + tuple(t.shape[1:]),
                                         device)
        seeds = data["seeds"].tolist()
    return carry, k_done, diagnostics, history, seeds
