"""Sums over the last axis in a fixed order, the same for every batch shape.

PyTorch's `sum` and `cumsum` pick their summation order from the tensor's
shape and device (on CUDA a single row takes another kernel than many rows),
so a run summed inside a batch of B runs can round differently from the same
run alone. The SMC loop's sums over particles go through these two functions
instead: built from elementwise ops only, each row of a result depends on
that row alone, bit for bit, whatever B is.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def row_sum(v, group=None):
    """Sum over the last axis by a pairwise tree: zero-padded to a power of
    two, then halves added until one element is left. With a group
    (`parallel.sharding.ParticleGroup`, rank i holding the particles i,
    i + P, ...), the sum over the global particle axis of which v holds this
    rank's shard: the ranks' partials, gathered in rank order, folded on."""
    n = v.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    if width != n:
        v = F.pad(v, (0, width - n))
    while v.shape[-1] > 1:
        half = v.shape[-1] // 2
        v = v[..., :half] + v[..., half:]
    if group is None or group.size == 1:
        return v[..., 0]
    return row_sum(torch.stack(group.all_gather(v[..., 0]), dim=-1))


def row_mean(v, group=None):
    return row_sum(v, group) / (v.shape[-1] * (1 if group is None else group.size))


def row_cumsum(v):
    """Inclusive prefix sums over the last axis, in blocks of about sqrt(n):
    sequential sums inside each block, then each block's offset (the
    sequential sum of the block totals before it) added once.

    For non-negative v the result never decreases, and an element with v = 0
    repeats the one before it exactly: the last entry of block c is
    offset_c + total_c, which is offset_{c+1} itself."""
    n = v.shape[-1]
    length = max(1, math.isqrt(max(n - 1, 0)) + 1)
    blocks = -(-n // length)
    if blocks * length != n:
        v = F.pad(v, (0, blocks * length - n))
    v = v.reshape(v.shape[:-1] + (blocks, length))
    local = [v[..., 0]]
    for j in range(1, length):
        local.append(local[-1] + v[..., j])
    local = torch.stack(local, dim=-1)  # (..., blocks, length)
    offsets = [torch.zeros_like(local[..., 0, -1])]
    for c in range(1, blocks):
        offsets.append(offsets[-1] + local[..., c - 1, -1])
    out = torch.stack(offsets, dim=-1)[..., None] + local
    return out.reshape(out.shape[:-2] + (-1,))[..., :n]
