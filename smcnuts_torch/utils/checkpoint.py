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

Sharded runs (a `parallel.sharding.ParticleGroup`): every rank calls
`save_checkpoint` at the same point; the per-particle arrays (the carry's x,
logw and loglik, the histories) are gathered into the global particle order
and rank 0 writes the file an unsharded run writes, byte for byte in its
arrays; the others wait until it is on disk. `load_checkpoint` reads the
global file on every rank and keeps the rank's shard, so a file loads at
any number of ranks (or none).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops.adaptation import DualAveragingState
from ..ops.resampling import gather_particles
from ..sampler import SMCCarry

# Bump when the layout of the file changes (the carry's fields, the naming of
# the diagnostics or histories). A checkpoint of another version is refused
# instead of being read into the wrong fields.
CHECKPOINT_VERSION = 1


# The particle axis of each per-particle array of a checkpoint, counted from
# the end; every other array is the same on every rank.
_PARTICLE_DIM = {"carry_x": -2, "carry_logw": -1, "carry_loglik": -1,
                 "hist_x": -2, "hist_logw": -1, "hist_loglik": -1}


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
                    history: dict | None = None, seeds=(), group=None):
    """Write the runs' state after k_done iterations to `path`, atomically: a
    `.tmp` file beside it, flushed and fsynced, then renamed over it, so a
    crash leaves the old checkpoint or the new one, never a torn file.
    diagnostics: name -> (B, k_done, ...) tensor; history: name -> (B,
    k_done + 1, ...) tensor, or None. With a group every rank calls it with
    its shard; rank 0 writes the global file and every rank returns once it
    is written."""
    arrays = dict(_carry_arrays(carry))
    arrays.update({f"diag_{name}": t for name, t in diagnostics.items()})
    if history is not None:
        arrays.update({f"hist_{name}": t for name, t in history.items()})
    if group is not None:
        arrays = {key: gather_particles(t, group, _PARTICLE_DIM[key])
                  if key in _PARTICLE_DIM else t for key, t in arrays.items()}
        if group.rank != 0:
            group.barrier()
            return
    payload = {key: _host(t) for key, t in arrays.items()}
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
    if group is not None:
        group.barrier()


def _restore(data, key: str, path: str, dtype: torch.dtype, shape: tuple, device):
    if key not in data.files:
        raise ValueError(f"checkpoint {path!r} holds no {key!r}")
    arr = data[key]
    got = torch.from_numpy(np.ascontiguousarray(arr))
    if got.dtype != dtype or tuple(got.shape) != tuple(shape):
        raise ValueError(f"checkpoint {path!r}: {key} is {got.dtype} {tuple(got.shape)}, "
                         f"the run needs {dtype} {tuple(shape)}")
    return got.to(device)


def _shard(t, key: str, group):
    if group is None or key not in _PARTICLE_DIM:
        return t
    return group.take_shard(t, _PARTICLE_DIM[key])


def load_checkpoint(path: str, carry_template: SMCCarry, diag_template: dict, device,
                    group=None):
    """Read a checkpoint of `save_checkpoint` onto `device`.

    carry_template is an SMCCarry whose tensors (meta tensors will do) give
    each field's dtype and shape, loglik None where the strategy carries
    none; diag_template maps each diagnostic's name to a tensor of one
    iteration's dtype and shape (B, ...). Every array is checked against
    them; a file of another CHECKPOINT_VERSION, or one that does not fit,
    raises ValueError. Returns (carry, k_done, diagnostics (name -> (B,
    k_done, ...)), history (name -> (B, k_done + 1, ...), or None when the
    file holds none), seeds (a list of ints)). The templates are global;
    with a group the per-particle arrays returned are the rank's shard."""
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
            key: _shard(_restore(data, key, path, t.dtype, t.shape, device), key, group)
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
                history[name] = _shard(_restore(
                    data, key, path, t.dtype, (t.shape[0], k_done + 1) + tuple(t.shape[1:]),
                    device), key, group)
        seeds = data["seeds"].tolist()
    return carry, k_done, diagnostics, history, seeds
