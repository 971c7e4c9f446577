"""Draw sources of the NUTS proposal, shared by the kernel and its plain version.

Every random number of a tree is addressed by its place in the tree, never by
a loop trip or a thread's position, so the CUDA kernel (one thread per
particle, each with its own early exit) and the plain version (all particles
in lockstep) draw the same bits:

    key     = (seed of the run's iteration, 0)
    counter = (particle index within its run, kind, doubling j, slot l)

with kind PROLOGUE (l = 0..2D-1 the Box-Muller uniforms of the momenta, l = 2D
the slice uniform), DIRECTION and ACCEPT (one per doubling j, l = 0) and LEAF
(the progressive-sampling uniform of leaf l of doubling j) and ACC_REJ (the
epilogue's accept-reject uniform of the asymptotic strategy, j = l = 0). One
Philox4x32-10 block is computed per draw and its first word is used. The key
holds no run index, so run b of a batch draws what it would draw alone.

Each run also has a stream of its own, keyed by the run's seed s as
(s mod 2^32, s div 2^32): per SMC iteration k, the N resampling uniforms
(counter (i, RESAMPLE, k, 0)) and the seed of the iteration's tree (counter
(0, TREE_SEED, k, 0)), and the N uniforms of the asymptotic strategy's
tempered-recycling estimate at index k (counter (i, RECYCLE, k, 0)), the same
whether the estimate is made inside the loop or from the saved history. On
the unfused proposal path the stream also holds the standard normals of the
momenta drawn outside the tree (Box-Muller of the uniforms at counters
(i, MOMENTUM, k, 2d) and (i, MOMENTUM, k, 2d + 1)) and the uniforms of the
accept-reject made outside it (counter (i, ACCEPT_UNIFORM, k, 0)).
`run_draws`, `recycle_draws`, `momentum_draws` and `accept_draws` compute
them for many iterations at once, so the SMC loop adds no launches for them.
Every counter holds the particle's global index: a rank that holds a shard
of the particles (`parallel.sharding`) passes its global indices (`index`)
and draws what the unsharded run draws at those particles, and the tree's
draws take the shard's particle map (`TreeDraws`' particle tensor; the
kernel's offset and stride).

Two sources:
- PHILOX: Philox4x32-10 (Salmon et al., SC'11), the stream of the real runs.
- ZERO_BITS: every word is 0, so every uniform is exactly 2^-24. That is what
  the TPU PRNG of the JAX package's Pallas kernel returns in interpret mode,
  so under this source the port reproduces that kernel's trajectories.

A word w maps to u = ((w >> 8) + 1) * 2^-24 in (0, 1] (never 0, so -log u is
finite), and normals come from the cosine branch of Box-Muller,
sqrt(-2 log u1) * cos(2 pi u2) -- the maps of the JAX kernel.

The torch version computes Philox on int64 tensors masked to 32 bits; the
32x32-bit products are split so no intermediate leaves int64.
"""

from __future__ import annotations

import math

import torch

PHILOX = "philox"
ZERO_BITS = "zero_bits"
SOURCES = (PHILOX, ZERO_BITS)

PROLOGUE, DIRECTION, ACCEPT, LEAF = 0, 1, 2, 3  # kinds of the tree's draws
RESAMPLE, TREE_SEED = 4, 5  # kinds of a run's own stream
ACC_REJ = 6  # the tree's accept-reject draw; 4 and 5 stay the run stream's
RECYCLE = 7  # a run's stream: the resampling of the recycled estimate
MOMENTUM, ACCEPT_UNIFORM = 8, 9  # a run's stream: the unfused path's draws

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF
_INV_2_24 = float(2.0**-24)
_TWO_PI = float(2.0 * math.pi)


def _mulhilo(m: int, c: torch.Tensor):
    """(hi, lo) 32-bit halves of m * c for a 32-bit constant m and int64 c in
    [0, 2^32): c is split into 16-bit halves so every partial product stays
    below 2^49."""
    a = m * (c & 0xFFFF)
    b = m * (c >> 16)
    s = a + ((b & 0xFFFF) << 16)
    return (s >> 32) + (b >> 16), s & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors (or ints) holding 32-bit words.

    Returns the four output words as int64 tensors in [0, 2^32)."""
    def word(v):
        return torch.as_tensor(v, dtype=torch.int64) & _MASK32

    c0, c1, c2, c3 = word(c0), word(c1), word(c2), word(c3)
    k0, k1 = word(k0), word(k1)
    for rnd in range(10):
        if rnd:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniform_from_words(w, dtype=torch.float32):
    """u = ((w >> 8) + 1) * 2^-24 in (0, 1]; exact in float32."""
    return ((w >> 8) + 1).to(dtype) * _INV_2_24


def box_muller(u1, u2):
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(_TWO_PI * u2)


class TreeDraws:
    """The draws of a batch of particles' trees.

    seed: (B,) integer tensor, the key word of each run's tree; run/particle:
    (P,) int64 run index and global particle index within the run of each
    flat lane."""

    def __init__(self, source, seed, run, particle, dtype=torch.float32):
        if source not in SOURCES:
            raise ValueError(f"Unknown draw source {source!r}; expected {SOURCES}")
        self.source = source
        self.dtype = dtype
        self.n = particle.shape[0]
        self.device = particle.device
        self.key0 = seed.to(torch.int64)[run]
        self.particle = particle.to(torch.int64)

    def uniform(self, kind: int, j: int, l: int):
        if self.source == ZERO_BITS:
            w = torch.zeros(self.n, dtype=torch.int64, device=self.device)
        else:
            w = philox4x32_10(
                self.particle, kind, j, l, self.key0, 0
            )[0]
        return uniform_from_words(w, self.dtype)

    def uniforms(self, kind: int, j, l):
        """The draws of every lane at m places of one kind, in one call: j
        and l are ints or sequences of m ints (broadcast against each
        other); returns (m, n). Row i is `uniform(kind, j[i], l[i])`, bit
        for bit."""
        j = torch.as_tensor(j, dtype=torch.int64, device=self.device).reshape(-1, 1)
        l = torch.as_tensor(l, dtype=torch.int64, device=self.device).reshape(-1, 1)
        if self.source == ZERO_BITS:
            m = max(j.shape[0], l.shape[0])
            w = torch.zeros((m, self.n), dtype=torch.int64, device=self.device)
        else:
            w = philox4x32_10(
                self.particle[None, :], kind, j, l, self.key0[None, :], 0
            )[0]
        return uniform_from_words(w, self.dtype)


def run_draws(seeds, iterations, n, dtype=torch.float32, index=None):
    """The resampling uniforms and tree seeds of B runs for a range of
    iterations, from each run's own stream.

    seeds: (B,) int64 tensor of run seeds in [0, 2^63); iterations: a range
    of iteration indices (K of them); index: the global indices (n,) of the
    particles drawn for, None for 0..n-1. Returns uniforms (K, B, n) in
    [0, 1), the map (w >> 8) * 2^-24, and tree seeds (K, B) int32 in
    [0, 2^31)."""
    k = torch.as_tensor(list(iterations), dtype=torch.int64, device=seeds.device)
    uniforms = _run_uniforms(seeds, RESAMPLE, iterations, n, dtype, index)
    s = philox4x32_10(0, TREE_SEED, k[:, None], 0, (seeds & _MASK32)[None, :],
                      (seeds >> 32)[None, :])[0]
    return uniforms, (s & 0x7FFFFFFF).to(torch.int32)


def _particles(n, index, device):
    if index is None:
        return torch.arange(n, dtype=torch.int64, device=device)
    if index.shape != (n,):
        raise ValueError(f"index must hold {n} particle indices, got {tuple(index.shape)}")
    return index.to(device=device, dtype=torch.int64)


def _run_uniforms(seeds, kind, iterations, n, dtype, index=None):
    """(K, B, n) uniforms in [0, 1), the map (w >> 8) * 2^-24, from each
    run's own stream at counters (i, kind, k, 0), i the particles' global
    indices."""
    dev = seeds.device
    k = torch.as_tensor(list(iterations), dtype=torch.int64, device=dev)
    i = _particles(n, index, dev)
    w = philox4x32_10(
        i[None, None, :], kind, k[:, None, None], 0,
        (seeds & _MASK32)[None, :, None], (seeds >> 32)[None, :, None],
    )[0]
    return (w >> 8).to(dtype) * _INV_2_24


def recycle_draws(seeds, iterations, n, dtype=torch.float32, index=None):
    """The uniforms (K, B, n) in [0, 1) of the tempered-recycling estimates at
    the given estimate indices, from each run's own stream."""
    return _run_uniforms(seeds, RECYCLE, iterations, n, dtype, index)


def momentum_draws(seeds, iterations, n, dim, dtype=torch.float32, index=None):
    """The standard normals (K, B, n, dim) of the momenta that the unfused
    proposal path draws outside the tree, from each run's own stream: the
    cosine branch of Box-Muller on two uniforms in (0, 1] a coordinate."""
    dev = seeds.device
    k = torch.as_tensor(list(iterations), dtype=torch.int64, device=dev)
    i = _particles(n, index, dev)
    slot = torch.arange(2 * dim, dtype=torch.int64, device=dev)
    w = philox4x32_10(
        i[None, None, :, None], MOMENTUM, k[:, None, None, None],
        slot[None, None, None, :],
        (seeds & _MASK32)[None, :, None, None], (seeds >> 32)[None, :, None, None],
    )[0]
    u = uniform_from_words(w, dtype)
    return box_muller(u[..., 0::2], u[..., 1::2])


def accept_draws(seeds, iterations, n, dtype=torch.float32, index=None):
    """The uniforms (K, B, n) in [0, 1) of the accept-reject that the unfused
    proposal path makes outside the tree, from each run's own stream."""
    return _run_uniforms(seeds, ACCEPT_UNIFORM, iterations, n, dtype, index)
