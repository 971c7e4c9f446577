"""Resampling when the ESS falls below a threshold, per run: multinomial (the
reference's scheme) and systematic.

The reference resamples multinomially when ESS < N/2 (reference
smcnuts/samples/samples.py:116-146) and resets the log-weights to
log_likelihood - log(N), which keeps the normalising-constant accumulator.
Systematic resampling inverts the CDF at the positions (i + u) / N for one
shared u per run: lower variance at the same cost.

Ancestors come from inverting each run's weight CDF with
`torch.searchsorted(..., right=True)`: idx[i] = #{j : cdf[j] <= u[i]}. The
uniforms are an argument, so a test can hand in the JAX package's draws and
compare ancestors exactly. Shapes: wn and uniforms (N,) or (B, N), x
(..., N, D); every run decides and resamples on its own, with no host sync
and no loop over runs.

With a particle group (`parallel.sharding`) wn, uniforms and x hold the
rank's shard (rank i of P the particles i, i + P, ...). The N weights are
gathered (`gather_particles`) and every rank builds the same CDF, inverts it
at its own particles' uniforms (the systematic positions at their global
indices, with the one shared uniform the caller passes), and fetches the
ancestors' rows from their owners (`fetch_rows`: each rank sends the owners
the local rows it wants and gets those rows back, two all-to-alls and one
of the counts): the ancestors and rows of the unsharded resample, to the
bit. `resample_if_required` exchanges nothing in an iteration where no run
resamples (the decision is the same on every rank) and only the resampling
runs' rows otherwise.
"""

from __future__ import annotations

import math

import torch

from .reduce import row_cumsum

SCHEMES = ("multinomial", "systematic")


def _invert_cdf(cdf, u):
    idx = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    # u < cdf[-1] keeps idx < N; the clamp covers u rounding up onto cdf[-1].
    return torch.clamp(idx, max=cdf.shape[-1] - 1)


def multinomial_ancestors(wn, uniforms, group=None):
    """IID multinomial ancestors (global indices) from raw uniforms in
    [0, 1), per run."""
    cdf = row_cumsum(gather_particles(wn, group))
    return _invert_cdf(cdf, uniforms.to(wn.dtype) * cdf[..., -1:])


def systematic_ancestors(wn, u, group=None):
    """Systematic ancestors: the positions (i + u) / N for one shared uniform
    u per run (a number, or a tensor of wn's leading shape), inverted through
    the normalised CDF; i runs over the rank's global particle indices."""
    full = gather_particles(wn, group)
    n = full.shape[-1]
    i = (torch.arange(n, device=wn.device) if group is None
         else group.local_indices(n, wn.device))
    u = torch.as_tensor(u, dtype=wn.dtype, device=wn.device)[..., None]
    positions = (i.to(wn.dtype) + u) / n
    cdf = row_cumsum(full)
    return _invert_cdf(cdf / cdf[..., -1:], positions.expand(wn.shape))


def ancestors(scheme, wn, uniforms, group=None, shared_uniform=None):
    """The ancestors of `scheme` from a run's resampling uniforms; the
    systematic scheme uses `shared_uniform`, by default the first uniform
    (the draw of particle 0, which a sharded caller passes explicitly)."""
    if scheme == "multinomial":
        return multinomial_ancestors(wn, uniforms, group)
    if scheme == "systematic":
        if shared_uniform is None:
            if group is not None and group.size > 1:
                raise ValueError("a sharded systematic resample needs the shared "
                                 "uniform (the draw of global particle 0)")
            shared_uniform = uniforms[..., 0]
        return systematic_ancestors(wn, shared_uniform, group)
    raise ValueError(f"Unknown resampling scheme '{scheme}'; expected one of {SCHEMES}")


def take_rows(idx, arrays):
    """Each array of `arrays`, (..., N) or (..., N, D), gathered along its
    particle axis by the one index tensor idx (..., m)."""
    out = []
    for a in arrays:
        if a.dim() == idx.dim():
            out.append(torch.gather(a, -1, idx))
        else:
            out.append(torch.gather(a, -2, idx[..., None].expand(idx.shape + a.shape[-1:])))
    return out


def gather_particles(v, group, dim=-1):
    """The global tensor of a per-particle tensor sharded along `dim` (the
    particle axis), in global particle order, on every rank."""
    if group is None:
        return v
    dim = dim % v.dim()
    parts = group.all_gather(v)
    # (..., n_local, P, ...): global particle rank + P j sits at j * P + rank.
    stacked = torch.stack(parts, dim=dim + 1)
    shape = list(v.shape)
    shape[dim] *= group.size
    return stacked.reshape(shape)


def fetch_rows(idx, arrays, group):
    """Each array of `arrays`, (..., n_local) or (..., n_local, D) sharded
    on its particle axis, taken at the global particle indices idx
    (..., m): the rows of the ancestors, wherever they live.

    Global particle a of a run lives on rank a % P as its local row a // P.
    Each rank sorts its m wants a run by owner, tells every owner how many
    it wants (an all-to-all of P counts) and which (an all-to-all of the
    local row numbers), and gets the rows back (an all-to-all an array):
    about m (P - 1) / P rows of each array in, and as many out."""
    if group is None:
        return take_rows(idx, arrays)
    P, axis = group.size, idx.dim() - 1
    n_local, m = arrays[0].shape[axis], idx.shape[-1]
    flat = idx.reshape(-1, m)
    runs = torch.arange(flat.shape[0], device=idx.device)[:, None]
    owner = (flat % P).reshape(-1)
    row = (runs * n_local + flat // P).reshape(-1)
    order = torch.argsort(owner, stable=True)
    send = torch.bincount(owner, minlength=P)
    recv = group.all_to_all(send)
    send, recv = send.tolist(), recv.tolist()
    asked = group.all_to_all(row[order], send, recv)
    out = []
    for a in arrays:
        table = a.reshape((-1,) + a.shape[axis + 1:])
        got = group.all_to_all(table[asked], recv, send)
        rows = torch.empty_like(got)
        rows[order] = got
        out.append(rows.reshape(idx.shape + a.shape[axis + 1:]))
    return out


def multinomial_take_rows(wn, uniforms, arrays, group=None):
    """Resample every array by one shared multinomial ancestor draw."""
    return fetch_rows(multinomial_ancestors(wn, uniforms, group), arrays, group)


def resample_if_required(uniforms, x, logw, wn, log_likelihood, ess_val,
                         threshold_frac=0.5, scheme="multinomial", group=None,
                         shared_uniform=None):
    """Resample the runs whose ess_val < N * threshold_frac; returns (x,
    logw, did_resample). Unsharded, without a host sync: the resampled state
    is computed for every run and selected with `torch.where`. With a group
    the decision (the same on every rank) is read on the host: no exchange
    when no run resamples, and only the resampling runs' ancestors fetched
    otherwise."""
    n = x.shape[-2] * (1 if group is None else group.size)
    do = ess_val < n * threshold_frac
    logw_res = (log_likelihood - math.log(n))[..., None].expand(logw.shape)
    logw_out = torch.where(do[..., None], logw_res.to(logw.dtype), logw)
    if group is None:
        (x_res,) = fetch_rows(ancestors(scheme, wn, uniforms, group, shared_uniform),
                              [x], group)
        return torch.where(do[..., None, None], x_res, x), logw_out, do
    if not bool(do.any()):
        return x, logw_out, do
    # The resampling runs alone (rows of a run depend on that run alone).
    lead, n_local = wn.shape[:-1], wn.shape[-1]
    sel = do.reshape(-1).nonzero()[:, 0]
    su = shared_uniform
    if torch.is_tensor(su) and su.dim():
        su = su.reshape(-1)[sel]
    u = None if uniforms is None else uniforms.reshape(-1, n_local)[sel]
    idx = ancestors(scheme, wn.reshape(-1, n_local)[sel], u, group, su)
    x_flat = x.reshape((-1,) + x.shape[-2:])
    (rows,) = fetch_rows(idx, [x_flat[sel]], group)
    x_out = x_flat.clone()
    x_out[sel] = rows
    return x_out.reshape(lead + x.shape[-2:]), logw_out, do
