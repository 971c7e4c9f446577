"""The Gaussian NUTS kernel's pipelined walk (`csrc/nuts_tree.cuh`:
pipelined_walk) in the order the kernel runs it, and its plain version
`nuts_tree_plain`.

- Emulation: a torch float32 emulation of one thread's walk, written from
  the CUDA source, for every lane at once (as the threads of a warp, each
  lane at its own doubling and leaf): one loop over the leaves of every
  doubling, a doubling's end inside it; each leaf's leapfrog, then its
  bookkeeping; the U-turn test of the sub-tree an odd leaf closes first and
  the multinomial pick by selects, the other sub-trees a leaf closes tested
  after them; the checkpoint stack of kMaxDepth + 1 slots, an odd leaf's
  store going to the last, which no test reads; the density with the fast
  division's range check, evaluated again with `/` where it fails (the fast
  division's value is the division's own in its range: on the card,
  tests/test_torch_cuda.py holds one to the other). Every operation is a
  torch float32 operation in the kernel's order. It equals
  `nuts_tree_plain` to the bit for D = 2, 3 and 5, with and without a
  prior, under zero bits and Philox, at phi 1.0 and 0.4 and depth 6, with a
  lane whose density is -inf; with the momenta given at depth 0; and staged
  equal to the single walk.
- The registry: `GAUSSIAN_VARIANTS` names the witness (the walk every other
  model runs, blocks of 128); the main entries of every dimension in
  `GAUSSIAN_DIMS` run the pipelined walk (GaussianPipelined of
  csrc/gaussian_model.cuh) in blocks of `models.gaussian.BLOCK`; the
  witness's source instantiates the old walk (GaussianModel<3>).
The plain version is held to the JAX tile density and the interpreted
Pallas tree in tests/test_torch_elementwise_models.py.
"""

import os
import re
from types import SimpleNamespace

import pytest
import torch

from smcnuts_torch.models import gaussian, make_gaussian
from smcnuts_torch.ops.draws import (ACCEPT, DIRECTION, LEAF, PHILOX, PROLOGUE, ZERO_BITS,
                                     box_muller, philox4x32_10, uniform_from_words)
from smcnuts_torch.ops.nuts_cuda import (CSRC_DIR, GAUSSIAN_DIMS, GAUSSIAN_VARIANTS,
                                         STAT_KEYS, _hand_model_data, nuts_tree_plain)

torch.set_num_threads(2)

K_MAX_DEPTH = 10
DIVERGENCE = 100.0
MEAN = [1.0, -2.0, 3.0, 0.5, -1.0]
VAR = [0.5, 2.0, 1.0, 1.5, 0.8]


def _model(d, prior):
    return make_gaussian(MEAN[:d], VAR[:d], [9.0] * d if prior else None)


def _cloud(runs, n, d, seed):
    g = torch.Generator().manual_seed(seed)
    x = 0.7 * torch.randn(runs, n, d, generator=g)
    x[:, : n // 4] *= 3.0
    x[0, 3, 0] = 1e20  # a density of -inf, outside the fast division's range
    return x.contiguous()


class Draws:
    """The kernel's draws for each lane at its own place in the tree."""

    def __init__(self, source, seed, particle):
        self.source, self.seed, self.particle = source, seed, particle

    def __call__(self, kind, j, l):
        if self.source == ZERO_BITS:
            w = torch.zeros_like(self.particle)
        else:
            w = philox4x32_10(self.particle, kind, j, l, self.seed, 0)[0]
        return uniform_from_words(w)


def _density(model, x, phi, fast):
    """gaussian_logp_grad of csrc/gaussian_model.cuh, op for op: (logp,
    grad, in_range). With fast, in_range is False where an operand leaves
    the fast division's range (|dx| or, with a prior, |x| outside
    [2^-29, 2^29]); the quotients are the division's own there too."""
    mean, var = model.mean.float(), model.var.float()
    const_t, const_p = model._consts[torch.float32]
    in_range = torch.ones(x.shape[0], dtype=torch.bool)

    def inside(v):
        return (v.abs() >= 2.0 ** -29) & (v.abs() <= 2.0 ** 29)

    lt = x[:, 0] * 0.0
    glt = []
    for d in range(x.shape[1]):
        dx = x[:, d] - mean[d]
        in_range = in_range & inside(dx)
        lt = lt - ((0.5 * dx) * dx) / var[d]
        glt.append(-dx / var[d])
    lt = lt + const_t
    if not model.has_prior:
        return lt + phi * 0.0, torch.stack(glt, 1), in_range
    pvar = model.prior_var.float()
    lp = x[:, 0] * 0.0
    grad = []
    for d in range(x.shape[1]):
        in_range = in_range & inside(x[:, d])
        lp = lp - ((0.5 * x[:, d]) * x[:, d]) / pvar[d]
        glp = -x[:, d] / pvar[d]
        grad.append(glp + phi * (glt[d] - glp))
    lp = lp + const_p
    return lp + phi * (lt - lp), torch.stack(grad, 1), in_range


def _kinetic(im, r):
    acc = torch.zeros_like(r[:, 0])
    for d in range(r.shape[1]):
        acc = acc + (im[:, d] * r[:, d]) * r[:, d]
    return 0.5 * acc


def _dot_im(dx, im, v):
    acc = torch.zeros_like(dx[:, 0])
    for d in range(dx.shape[1]):
        acc = acc + (dx[:, d] * im[:, d]) * v[:, d]
    return acc


def _sel(mask, a, b):
    return torch.where(mask[:, None] if a.dim() == 2 else mask, a, b)


def _walk(model, s, draws, start_depth, stop_depth, fallbacks):
    """pipelined_walk over doublings start_depth..stop_depth for every lane of
    state `s` whose tree has not stopped; updates s in place."""
    im, phi, eps, logu, H0 = s["im"], s["phi"], s["eps"], s["logu"], s["H0"]
    P, D = s["xm"].shape
    act = ~s["stopped"]
    ck_x = torch.zeros(P, K_MAX_DEPTH + 1, D)
    ck_r = torch.zeros_like(ck_x)
    lanes = torch.arange(P)

    depth = torch.full((P,), start_depth, dtype=torch.int64)
    back = ~(draws(DIRECTION, depth, 0) < 0.5)
    direction = torch.where(back, -1.0, 1.0)
    deps = direction * eps
    half = 0.5 * deps
    # The state the next leaf's leapfrog starts from, then the leaf itself.
    x1 = _sel(back, s["xm"], s["xp"])
    r1 = _sel(back, s["rm"], s["rp"])
    g1 = _sel(back, s["gm"], s["gp"])
    xpr, rpr, lppr, nsub = x1, r1, s["lps"], torch.zeros(P)
    leaf = torch.zeros(P, dtype=torch.int64)
    while bool(act.any()):
        last = leaf == (1 << depth) - 1
        # This leaf's leapfrog; its density again with `/` where the fast
        # divisions' check failed.
        r_half = r1 + half[:, None] * g1
        x1 = x1 + (deps[:, None] * im) * r_half
        lp1, g1, ok = _density(model, x1, phi, fast=True)
        if bool((~ok & act).any()):
            fallbacks.append(int((~ok & act).sum()))
            lp_s, g_s, _ = _density(model, x1, phi, fast=False)
            lp1, g1 = _sel(ok, lp1, lp_s), _sel(ok, g1, g_s)
        r1 = r_half + half[:, None] * g1

        # The bookkeeping of this leaf, in the lanes still at work.
        joint = lp1 - _kinetic(im, r1)
        fin = torch.isfinite(joint)
        valid = fin & (logu < joint) & act
        div = ~fin | ((logu - DIVERGENCE) >= joint)
        nsub = nsub + valid.float()
        take = valid & (draws(LEAF, depth, leaf) * nsub < 1.0)
        xpr, rpr, lppr = _sel(take, x1, xpr), _sel(take, r1, rpr), _sel(take, lp1, lppr)
        ratio = torch.exp(joint - H0)
        alpha = torch.where(fin, torch.where(ratio > 1.0, 1.0, ratio), 0.0)
        s["alpha_sum"] = _sel(act, s["alpha_sum"] + alpha, s["alpha_sum"])
        s["alpha_cnt"] = s["alpha_cnt"] + act.float()
        s["lf_cnt"] = s["lf_cnt"] + act.float()
        idx_max = torch.tensor([bin(v).count("1") for v in (leaf >> 1).tolist()])
        odd = (leaf & 1) == 1
        put = torch.where(odd, K_MAX_DEPTH, idx_max)
        ck_x[lanes[act], put[act]] = x1[act]
        ck_r[lanes[act], put[act]] = r1[act]

        def turns(slot):
            dx = direction[:, None] * (x1 - ck_x[lanes, slot])
            return (_dot_im(dx, im, ck_r[lanes, slot]) < 0.0) | (_dot_im(dx, im, r1) < 0.0)

        turned = odd & turns(idx_max)
        closes = torch.tensor([(v ^ (v + 1)).bit_length() - 1 for v in leaf.tolist()])
        for k in range(2, int(closes.max()) + 1):
            more = closes >= k
            turned = turned | (more & turns((idx_max - k + 1).clamp(min=0)))
        sstop = div | turned

        # The doubling's end.
        end = (sstop | last) & act
        bk, fw = end & back, end & ~back
        for k, v in (("x", x1), ("r", r1), ("g", g1)):
            s[k + "m"] = _sel(bk, v, s[k + "m"])
            s[k + "p"] = _sel(fw, v, s[k + "p"])
        accept = end & ~sstop & (draws(ACCEPT, depth, 0) * s["n"] < nsub)
        s["xs"], s["rs"] = _sel(accept, xpr, s["xs"]), _sel(accept, rpr, s["rs"])
        s["lps"] = _sel(accept, lppr, s["lps"])
        s["n"] = torch.where(end, s["n"] + nsub, s["n"])
        s["depth_done"] = s["depth_done"] + end.float()
        dx = s["xp"] - s["xm"]
        stop = end & (sstop | (_dot_im(dx, im, s["rm"]) < 0.0)
                      | (_dot_im(dx, im, s["rp"]) < 0.0))
        s["stopped"] = s["stopped"] | stop
        goes_on = end & ~stop & (depth < stop_depth)
        act = act & ~stop & ~(end & (depth == stop_depth))
        # The next doubling, where the tree goes on, from the end it grows.
        depth = torch.where(goes_on, depth + 1, depth)
        leaf = torch.where(goes_on, 0, torch.where(end, leaf, leaf + 1))
        back = torch.where(goes_on, ~(draws(DIRECTION, depth, 0) < 0.5), back)
        direction = torch.where(back, -1.0, 1.0)
        deps = torch.where(goes_on, direction * eps, deps)
        half = torch.where(goes_on, 0.5 * deps, half)
        x1 = _sel(goes_on, _sel(back, s["xm"], s["xp"]), x1)
        r1 = _sel(goes_on, _sel(back, s["rm"], s["rp"]), r1)
        g1 = _sel(goes_on, _sel(back, s["gm"], s["gp"]), g1)
        xpr, rpr = _sel(goes_on, x1, xpr), _sel(goes_on, r1, rpr)
        lppr = _sel(goes_on, s["lps"], lppr)
        nsub = torch.where(goes_on, 0.0, nsub)


def _emulate(model, x, seed, step, phi, im, max_depth, source, r=None, stages=None):
    """The kernel's tree with the pipelined walk, for x (B, N, D): the
    prologue and epilogue of nuts_tree_body (template code the walk does not
    change) and the walk in each stage. Returns (x, r, stats, fallbacks)."""
    B, N, D = x.shape
    P = B * N
    run = torch.arange(P) // N
    seed = torch.as_tensor(seed, dtype=torch.int64).reshape(-1).expand(B)[run]
    phi = torch.as_tensor(phi, dtype=torch.float32).reshape(-1).expand(B)[run]
    im = torch.as_tensor(im, dtype=torch.float32).reshape(-1, D).expand(B, D)[run]
    draws = Draws(source, seed, torch.arange(P) % N)
    x0 = x.reshape(P, D)
    if r is None:
        r0 = torch.stack([box_muller(draws(PROLOGUE, 0, 2 * d), draws(PROLOGUE, 0, 2 * d + 1))
                          * torch.rsqrt(im[:, d]) for d in range(D)], 1)
    else:
        r0 = r.reshape(P, D)
    logp0, g0, _ = _density(model, x0, phi, fast=False)
    ke0 = _kinetic(im, r0)
    H0 = logp0 - ke0
    zeros = torch.zeros(P)
    s = {"xm": x0, "rm": r0, "gm": g0, "xp": x0, "rp": r0, "gp": g0, "xs": x0, "rs": r0,
         "lps": logp0, "n": torch.ones(P), "alpha_sum": zeros, "alpha_cnt": zeros,
         "lf_cnt": zeros, "depth_done": zeros, "stopped": torch.zeros(P, dtype=torch.bool),
         "im": im, "phi": phi, "eps": torch.full((P,), step), "H0": H0,
         "logu": H0 - (-torch.log(draws(PROLOGUE, 0, 2 * D)))}
    fallbacks = []
    for start, stop in stages or ((0, max_depth),):
        _walk(model, s, draws, start, stop, fallbacks)
    dh = (s["lps"] - _kinetic(im, s["rs"])) - H0
    stats = {"logp0": logp0, "logp_prop": s["lps"],
             "accept_stat": s["alpha_sum"] / torch.clamp(s["alpha_cnt"], min=1.0),
             "depth": s["depth_done"], "leapfrogs": s["lf_cnt"] + 1.0, "delta_h": dh,
             "ke0": ke0, "moved": torch.all(s["xs"] != x0, dim=1).float()}
    return (s["xs"].reshape(B, N, D), s["rs"].reshape(B, N, D),
            {k: v.reshape(B, N) for k, v in stats.items()}, fallbacks)


def _assert_same_bits(got, want):
    pairs = {"x": (got[0], want[0]), "r": (got[1], want[1])}
    pairs.update({k: (got[2][k], want[2][k]) for k in STAT_KEYS})
    for k, (a, b) in pairs.items():
        assert bool(((a == b) | (a.isnan() & b.isnan())).all()), k


@pytest.mark.parametrize("source", [ZERO_BITS, PHILOX])
@pytest.mark.parametrize("prior", [True, False])
@pytest.mark.parametrize("d", GAUSSIAN_DIMS)
def test_emulated_walk_equals_plain_to_the_bit(d, prior, source):
    model = _model(d, prior)
    x = _cloud(2, 64, d, seed=d)
    args = (x, torch.tensor([3, 4], dtype=torch.int32), 0.1, torch.tensor([1.0, 0.4]),
            torch.linspace(0.5, 2.0, d), 6, source)
    got = _emulate(model, *args)
    _assert_same_bits(got[:3], nuts_tree_plain(model, *args))
    assert got[3], "the lane at 1e20 takes the division's slow path"
    assert float(got[2]["depth"].max()) >= 5  # trees that reach deep doublings
    assert torch.isnan(got[2]["delta_h"][0, 3])


@pytest.mark.parametrize("d", GAUSSIAN_DIMS)
def test_emulated_walk_with_momenta_given_at_depth_0(d):
    model = _model(d, True)
    x = _cloud(1, 128, d, seed=10 + d)
    r = torch.randn(1, 128, d, generator=torch.Generator().manual_seed(d))
    args = (x, 5, 0.1, 0.7, torch.linspace(0.5, 2.0, d), 0, ZERO_BITS)
    _assert_same_bits(_emulate(model, *args, r=r)[:3], nuts_tree_plain(model, *args, r=r))


# Stages as the compaction splits them: after doubling 2, and after each of
# doublings 0, 1 and 4.
@pytest.mark.parametrize("stages", [((0, 2), (3, 6)), ((0, 0), (1, 1), (2, 4), (5, 6))])
def test_emulated_walk_staged_equals_single(stages):
    model = _model(3, True)
    args = (_cloud(2, 96, 3, seed=20), torch.tensor([7, 8], dtype=torch.int32), 0.1, 1.0,
            torch.ones(3), 6, PHILOX)
    staged = _emulate(model, *args, stages=stages)
    _assert_same_bits(staged[:3], _emulate(model, *args)[:3])
    splits = tuple(stop for _, stop in stages[:-1])
    _assert_same_bits(staged[:3], nuts_tree_plain(model, *args, compaction=splits))


def _source(name):
    with open(os.path.join(CSRC_DIR, name)) as f:
        return f.read()


def test_registry_names_the_witness_and_the_pipelined_entries():
    assert GAUSSIAN_VARIANTS == {
        "gaussian3_witness": ("smcnuts_nuts_tree_gaussian3_witness", 1, 128)}
    entries = _source("nuts_tree.cu")
    assert re.search(r"constexpr int kGaussianBlock = (\d+);", entries).group(1) == str(
        gaussian.BLOCK)
    lib = SimpleNamespace()
    for d in GAUSSIAN_DIMS:
        entry, data, scalars = _hand_model_data(_model(d, True), lib)
        assert entry == f"smcnuts_nuts_tree_gaussian{d}"
        # The pipelined walk, blocks of kGaussianBlock.
        assert (f"SMCNUTS_ENTRY({entry}, smcnuts::GaussianPipelined<{d}>,\n"
                "              smcnuts::kGaussianBlock)") in entries
        assert data.shape == (3 * d,) and scalars[2] == 1.0
    model = _source("gaussian_model.cuh")
    assert "struct GaussianPipelined : GaussianModel<Dim> {" in model
    assert "static constexpr bool kPipelined = true;" in model


def test_witness_source_instantiates_the_old_walk():
    src = _source("gaussian_variants.cu")
    # No kPipelined: nuts_tree_body's own walk; no block named: kThreads (128).
    assert "SMCNUTS_ENTRY(smcnuts_nuts_tree_gaussian3_witness, smcnuts::GaussianModel<3>)" in src
    assert src.count("SMCNUTS_ENTRY(") == 1
    tree = _source("nuts_tree.cuh")
    assert "if constexpr (Pipelined<Model>::value) {" in tree
    assert "constexpr int kThreads = 128;" in tree
    model = _source("gaussian_model.cuh")
    witness = model[model.index("struct GaussianModel {"):model.index("struct GaussianPipelined")]
    assert "kPipelined" not in witness
