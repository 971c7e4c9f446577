"""The staged NUTS dispatch with lane compaction, and the accept-reject
epilogue, on the CPU.

(a) The plain staged tree against the plain single tree, to the bit, under
    zero bits and under Philox: a lane's draws are addressed by its place in
    the tree, so neither the stage nor the slot it lands in can show.
(b) The plain staged tree against the JAX package's compacted dispatch in
    interpret mode (zero bits): integer outputs exactly on every lane, floats
    at atol 1e-4 / rtol 1e-4 (f32 rounding of the 200-step recurrence and the
    two libraries' exp/log differ in the last bits), with tree depths on both
    sides of every split. The cloud sits away from the posterior mode, so
    log-densities run to hundreds and thousands of nats: r (a sum of
    gradients) and delta_h (a difference of log-densities) are held to 1e-4
    of that scale, atol 1e-4 * (1 + |logp0|), which is what rtol 1e-4 grants
    the log-densities they are made of. The model runs its recurrence in the
    JAX kernel's sequential order (`ArmaModel().at_group(1)`): the dispersed
    lanes' |theta| > 1 overflows it, an inf there and, in the kernel's group
    order, an inf or a NaN (tests/test_torch_arma_group.py holds the group
    order to JAX, such lanes agreeing as not finite).
(c) The accept-reject epilogue against the JAX single kernel, and its
    meaning under Philox (rejected lanes go back to the start state).
(d) Splits at or above max_depth are dropped.
(e) Three SMC iterations with compaction equal the same without it.
(f) How "auto" resolves, the adapted-hint rule, the lockstep-waste count.

The CUDA kernel's staged form is held to these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smcnuts_torch import SMCConfig, run_smc_batched
from smcnuts_torch.models import ArmaModel, PrmwcdModel, get_model
from smcnuts_torch.models.base import ADAPTED_HINT_TARGET, COMPACTION_MIN_LANES
from smcnuts_torch.models.prmwcd import ground_truth as prmwcd_truth
from smcnuts_torch.ops.draws import PHILOX, ZERO_BITS
from smcnuts_torch.ops.nuts_cuda import (
    STAT_KEYS,
    lockstep_waste,
    nuts_tree,
    nuts_tree_plain,
    resolve_splits,
)
from smcnuts_torch.sampler import resolve_compaction
from smcnuts_tpu.models.arma import _ASSET
from smcnuts_tpu.ops.nuts_pallas import arma_tile_model, nuts_batch_pallas_fused

torch.set_num_threads(2)

INTEGER_STATS = ("depth", "leapfrogs", "moved")
STEP, MAX_DEPTH, SPLITS = 1e-3, 6, (2, 4)


def _cloud(n=1500, d=4):
    """A warm core plus dispersed lanes, as tests/test_compaction.py makes
    it: tree depths spread over 1..max_depth+1, so every stage sees lanes
    that have finished and lanes that go on."""
    rs = np.random.RandomState(0)
    x = np.concatenate(
        [0.1 * rs.randn(2 * n // 3, d), 2.0 * rs.randn(n - 2 * n // 3, d)]
    )
    return x.astype(np.float32)


def _assert_bitwise(a, b):
    assert torch.equal(a[0], b[0])
    assert torch.equal(a[1], b[1])
    for k in STAT_KEYS:
        # NaN == NaN here: a lane that starts outside the support has a NaN
        # density in both forms.
        torch.testing.assert_close(a[2][k], b[2][k], rtol=0, atol=0,
                                   equal_nan=True, msg=k)


def _assert_straddles(depth, splits):
    depth = np.asarray(depth).astype(int)
    assert depth.max() > max(splits) + 1, "continuation stages not exercised"
    assert depth.min() <= min(splits), "no finished lanes at the boundary"


# ---- (a) plain staged vs plain single, to the bit

def _arma_three_runs():
    x = torch.as_tensor(np.stack(
        [_cloud(400), _cloud(400) + 0.5, _cloud(400) - 0.5]))
    return ArmaModel(), x, torch.tensor([3, 5, 9], dtype=torch.int32), None


def _arma_r_given():
    x = torch.as_tensor(_cloud(400))[None]
    r = torch.as_tensor(
        np.random.RandomState(1).randn(1, 400, 4).astype(np.float32))
    return ArmaModel(), x, 7, r


def _prmwcd_small():
    mean, var = prmwcd_truth()
    centre = np.concatenate([mean[:12], [np.log(mean[12])]])
    sd = np.concatenate([var[:12] ** 0.5, [var[12] ** 0.5 / mean[12]]])
    rng = np.random.default_rng(2)
    scale = np.where(np.arange(48) < 12, 1.0, 0.1)[:, None]
    x = (centre + scale * sd * rng.normal(size=(48, 13))).astype(np.float32)
    return PrmwcdModel(), torch.as_tensor(x)[None], 11, None


PLAIN_CASES = {
    # name: (inputs, step, max_depth, splits, acc_rej)
    "arma_3runs_2_4": (_arma_three_runs, STEP, MAX_DEPTH, (2, 4), False),
    "arma_3runs_2_4_acc_rej": (_arma_three_runs, STEP, MAX_DEPTH, (2, 4), True),
    "arma_r_given_3": (_arma_r_given, STEP, MAX_DEPTH, (3,), False),
    "arma_r_given_1_acc_rej_step0.05": (_arma_r_given, 0.05, MAX_DEPTH, (1,), True),
    "prmwcd_1_3": (_prmwcd_small, 0.01, 4, (1, 3), False),
    "prmwcd_2_acc_rej": (_prmwcd_small, 0.01, 4, (2,), True),
}


@pytest.mark.parametrize("source", [ZERO_BITS, PHILOX])
@pytest.mark.parametrize("case", sorted(PLAIN_CASES))
def test_plain_staged_equals_plain_single_bitwise(case, source):
    inputs, step, max_depth, splits, acc_rej = PLAIN_CASES[case]
    model, x, seed, r = inputs()
    args = (model, x, seed, step, 1.0, None, max_depth, source)
    single = nuts_tree_plain(*args, r=r, acc_rej=acc_rej)
    staged = nuts_tree_plain(*args, r=r, acc_rej=acc_rej, compaction=splits)
    survivors = list(nuts_tree_plain.survivors)
    _assert_bitwise(single, staged)
    # Every split had lanes on both sides, and the counts are the lanes whose
    # tree ran past the split.
    depth = single[2]["depth"].reshape(-1)
    assert survivors == [int((depth > s + 1).sum()) for s in splits]
    assert 0 < survivors[-1] <= survivors[0] < depth.numel()


def test_nuts_tree_on_cpu_passes_compaction_and_acc_rej_on():
    x = torch.as_tensor(_cloud(64))[None]
    out = nuts_tree(ArmaModel(), x, 3, 0.05, 1.0, None, 4, PHILOX,
                    acc_rej=True, compaction=(1, 2))
    assert nuts_tree_plain.survivors and len(nuts_tree_plain.survivors) == 2
    ref = nuts_tree_plain(ArmaModel(), x, 3, 0.05, 1.0, None, 4, PHILOX,
                          acc_rej=True)
    _assert_bitwise(out, ref)


# ---- (b), (c) against the JAX package

def _as_numpy(out):
    x, r, st = out
    return (np.asarray(x).reshape(-1, x.shape[-1]),
            np.asarray(r).reshape(-1, r.shape[-1]),
            {k: np.asarray(v).reshape(-1) for k, v in st.items()})


def _assert_matches_jax(torch_out, jax_out):
    x_t, r_t, st_t = _as_numpy(torch_out)
    x_j, r_j, st_j = _as_numpy(jax_out)
    np.testing.assert_allclose(x_t, x_j, rtol=1e-4, atol=1e-4)
    scale = 1e-4 * (1.0 + np.abs(np.nan_to_num(st_j["logp0"], posinf=0.0,
                                               neginf=0.0)))
    assert np.all(np.abs(r_t - r_j) <= scale[:, None] + 1e-4 * np.abs(r_j))
    for k in STAT_KEYS:
        if k in INTEGER_STATS:
            np.testing.assert_array_equal(st_t[k], st_j[k], err_msg=k)
        elif k == "delta_h":
            err = np.abs(st_t[k] - st_j[k])
            same_nan = np.isnan(st_t[k]) & np.isnan(st_j[k])
            assert np.all(same_nan | (err <= scale + 1e-4 * np.abs(st_j[k]))), k
        else:
            np.testing.assert_allclose(st_t[k], st_j[k], rtol=1e-4, atol=1e-4,
                                       err_msg=k)


@pytest.fixture(scope="module")
def tile_model():
    return arma_tile_model(np.load(_ASSET)["y"])


@pytest.mark.parametrize("acc_rej", [False, True])
def test_plain_staged_matches_jax_compacted_dispatch(tile_model, acc_rej):
    x = _cloud()
    assert x.shape[0] > 1024  # more than one block, or JAX prunes the splits
    jax_out = nuts_batch_pallas_fused(
        tile_model, jnp.asarray(x), 7, STEP, 1.0, max_depth=MAX_DEPTH,
        acc_rej=acc_rej, interpret=True, compaction=SPLITS,
    )
    torch_out = nuts_tree_plain(
        ArmaModel().at_group(1), torch.as_tensor(x)[None], 7, STEP, 1.0, None,
        MAX_DEPTH, ZERO_BITS, acc_rej=acc_rej, compaction=SPLITS,
    )
    _assert_straddles(jax_out[2]["depth"], SPLITS)
    _assert_straddles(torch_out[2]["depth"], SPLITS)
    _assert_matches_jax(torch_out, jax_out)


def test_acc_rej_plain_matches_jax_single_kernel(tile_model):
    """Zero bits: u = 2^-24, so a finite dh always accepts (a selected leaf
    lies above the slice, which is 2^-24 of the start density) and a NaN dh
    rejects. The cloud holds lanes of both kinds."""
    rng = np.random.default_rng(3)
    x = np.concatenate([
        0.1 * rng.normal(size=(30, 4)),
        [[0.0, 0.0, 0.0, 200.0], [0.0, 0.0, 0.0, -200.0]],  # exp overflows
        2.0 * rng.normal(size=(8, 4)),
    ]).astype(np.float32)
    jax_out = nuts_batch_pallas_fused(
        tile_model, jnp.asarray(x), 5, 0.01, 1.0, max_depth=4, acc_rej=True,
        interpret=True,
    )
    torch_out = nuts_tree_plain(
        ArmaModel().at_group(1), torch.as_tensor(x)[None], 5, 0.01, 1.0, None, 4,
        ZERO_BITS, acc_rej=True,
    )
    dh = torch_out[2]["delta_h"].reshape(-1)
    assert bool(torch.isnan(dh).any()) and bool(torch.isfinite(dh).any())
    moved = torch_out[2]["moved"].reshape(-1)
    assert bool((moved[torch.isnan(dh)] == 0).all()) and bool(moved.any())
    _assert_matches_jax(torch_out, jax_out)


def test_acc_rej_rejected_lanes_return_to_the_start_state():
    """Philox at a coarse step: some proposals are rejected. A rejected lane
    has x, r and logp of the start state and moved 0; delta_h is the value
    from before the accept-reject; every other lane is untouched."""
    x = torch.as_tensor(_cloud(600))[None]
    r = torch.as_tensor(
        np.random.RandomState(4).randn(1, 600, 4).astype(np.float32))
    args = (ArmaModel(), x, 21, 0.08, 1.0, None, 5, PHILOX)
    off = nuts_tree_plain(*args, r=r)
    on = nuts_tree_plain(*args, r=r, acc_rej=True)
    rejected = (off[2]["moved"] == 1) & (on[2]["moved"] == 0)
    assert 0 < int(rejected.sum()) < int((off[2]["moved"] == 1).sum())
    assert bool((off[2]["delta_h"][rejected] < 0).all())
    assert torch.equal(on[0][rejected], x[rejected])
    assert torch.equal(on[1][rejected], r[rejected])
    assert torch.equal(on[2]["logp_prop"][rejected], on[2]["logp0"][rejected])
    kept = ~rejected
    assert torch.equal(on[0][kept], off[0][kept])
    for k in ("delta_h", "depth", "leapfrogs", "accept_stat", "ke0", "logp0"):
        torch.testing.assert_close(on[2][k], off[2][k], rtol=0, atol=0,
                                   equal_nan=True, msg=k)


# ---- (d) splits

@pytest.mark.parametrize("compaction,max_depth,expected", [
    ((3, 7), 3, ()),
    ((2, 4), 6, (2, 4)),
    ((4, 2, 4), 6, (2, 4)),
    ((0, 5, 6, 10), 6, (5,)),
    (None, 6, ()),
    ((), 6, ()),
])
def test_resolve_splits(compaction, max_depth, expected):
    assert resolve_splits(compaction, max_depth) == expected


def test_splits_at_or_above_max_depth_run_the_single_form():
    x = torch.as_tensor(_cloud(200))[None]
    args = (ArmaModel(), x, 7, 0.05, 1.0, None, 3, ZERO_BITS)
    single = nuts_tree_plain(*args)
    dropped = nuts_tree_plain(*args, compaction=(3, 7))
    assert nuts_tree_plain.survivors == []
    _assert_bitwise(single, dropped)


# ---- (e) the sampler

@pytest.mark.parametrize("name,adapt", [("arma", False), ("prmwcd", True)])
def test_smc_iterations_with_compaction_equal_those_without(name, adapt):
    def run(compaction):
        cfg = SMCConfig(
            n_particles=48, n_iterations=3, step_size=0.01, max_tree_depth=5,
            compaction=compaction, adapt_step_size=adapt,
            adapt_mass_matrix=adapt, target_accept=0.5,
        )
        return run_smc_batched(get_model(name), cfg, [3, 8], "cpu")

    nuts_tree_plain.survivors = []
    staged = run((2, 4))
    assert len(nuts_tree_plain.survivors) == 2 and nuts_tree_plain.survivors[0] > 0
    single = run(None)
    assert nuts_tree_plain.survivors == []
    for f, v in single._asdict().items():
        torch.testing.assert_close(getattr(staged, f), v, rtol=0, atol=0,
                                   equal_nan=True, msg=f)


# ---- (f) "auto", the adapted-hint rule, the waste count

class _Hinted:
    compaction_hint = (4,)
    compaction_hint_adapted = (2, 3)


def _cfg(**kw):
    return SMCConfig(n_particles=8, n_iterations=2, step_size=0.01, **kw)


@pytest.mark.parametrize("settings,expected", [
    (dict(), (4,)),  # "auto" is the default
    (dict(compaction="auto", adapt_mass_matrix=True), (4,)),
    (dict(adapt_step_size=True, target_accept=ADAPTED_HINT_TARGET), (2, 3)),
    # The adapted hint was measured at one target: at another, no hint.
    (dict(adapt_step_size=True, target_accept=0.8), ()),
    (dict(adapt_step_size=True), ()),  # target_accept defaults to 0.8
    (dict(compaction=None), ()),
    (dict(compaction=()), ()),
    (dict(compaction=(5, 1)), (5, 1)),
    (dict(compaction=(6,), adapt_step_size=True, target_accept=0.9), (6,)),
], ids=str)
def test_resolve_compaction(settings, expected):
    wide = COMPACTION_MIN_LANES + 1
    assert resolve_compaction(_cfg(**settings), _Hinted(), wide) == expected


@pytest.mark.parametrize("settings,expected", [
    (dict(), ()),  # a hint pays only past COMPACTION_MIN_LANES
    (dict(adapt_step_size=True, target_accept=ADAPTED_HINT_TARGET), ()),
    (dict(compaction=(5, 1)), (5, 1)),  # explicit splits hold at any width
], ids=str)
def test_resolve_compaction_at_or_below_min_lanes(settings, expected):
    assert resolve_compaction(
        _cfg(**settings), _Hinted(), COMPACTION_MIN_LANES) == expected


@pytest.mark.parametrize("name", ["arma", "prmwcd"])
def test_models_carry_their_hints(name):
    model = get_model(name)
    for hint in (model.compaction_hint, model.compaction_hint_adapted):
        assert isinstance(hint, tuple)
        assert all(isinstance(s, int) and 0 < s < 10 for s in hint)
        assert list(hint) == sorted(set(hint))
    # arma's kernel runs 8 lanes a tree and PRMwCD's 16, and each counts its
    # own blocks (models/base.py): arma twice the trees the card holds at
    # once, so bench.py's width runs its single kernel; PRMwCD once, so
    # bench.py's width stages it.
    narrow = getattr(model, "compaction_min_lanes", COMPACTION_MIN_LANES)
    assert narrow == {"arma": 2 * 132 * 12 * 8, "prmwcd": 132 * 6 * 4}[name]
    assert resolve_compaction(_cfg(), model, narrow) == ()
    wide = narrow + 1
    bench = resolve_compaction(_cfg(), model, 25 * 512)  # bench.py's width
    assert bench == {"arma": (), "prmwcd": model.compaction_hint}[name]
    assert resolve_compaction(_cfg(), model, wide) == model.compaction_hint
    assert resolve_compaction(
        _cfg(adapt_step_size=True, target_accept=ADAPTED_HINT_TARGET), model,
        wide,
    ) == model.compaction_hint_adapted


def test_a_model_without_hints_runs_the_single_kernel():
    assert resolve_compaction(_cfg(), object(), 10**6) == ()


def test_lockstep_waste_on_hand_made_counts():
    # Four lanes, groups of two. Depth d = doublings done; leapfrogs = leaves
    # + 1. Lane 0: depth 1, 1 leaf. Lane 1: depth 3, 1 + 2 + 4 = 7 leaves.
    # Lane 2: depth 2, 1 + 1 = 2 leaves. Lane 3: depth 3, 1 + 2 + 3 = 6.
    depth = torch.tensor([1.0, 3.0, 2.0, 3.0])
    leapfrogs = torch.tensor([2.0, 8.0, 3.0, 7.0])
    # Single: group (0, 1) walks 1 + 2 + 4 = 7 steps, group (2, 3) walks
    # 1 + 2 + 3 = 6; two lanes each.
    assert lockstep_waste(leapfrogs, depth, (), width=2) == (26, 16)
    # Split after doubling 1: stage 0 walks 1 + 2 in both groups (12 lane
    # steps); lanes 1 and 3 go on as one group and walk 4 (8 lane steps).
    assert lockstep_waste(leapfrogs, depth, (1,), width=2) == (20, 16)
    # Split after doubling 0 as well: stage 0 costs 2 + 2, then lanes 1, 2, 3
    # form groups (1, 2) and (3, pad): doubling 1 costs 2 * 2 + 2 * 2, and
    # after it lanes 1 and 3 walk 4 together.
    assert lockstep_waste(leapfrogs, depth, (0, 1), width=2) == (20, 16)
    # One lane a group wastes nothing.
    assert lockstep_waste(leapfrogs, depth, (), width=1) == (16, 16)


def test_lockstep_waste_of_real_trees_falls_with_compaction():
    x = torch.as_tensor(_cloud(400))[None]
    _, _, st = nuts_tree_plain(ArmaModel(), x, 7, STEP, 1.0, None, MAX_DEPTH,
                               PHILOX)
    single = lockstep_waste(st["leapfrogs"], st["depth"])
    staged = lockstep_waste(st["leapfrogs"], st["depth"], SPLITS)
    assert single[1] == staged[1] == int((st["leapfrogs"] - 1).sum())
    assert single[1] <= staged[0] < single[0]


# ---- the default device

def test_entry_points_default_to_the_card_and_never_fall_back(monkeypatch):
    """Without a CUDA device and without an explicit "cpu", every entry
    point raises before any tree is built."""
    from smcnuts_torch import SMCSampler, run_smc
    from smcnuts_torch.__main__ import main as cli_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _cfg()
    calls = nuts_tree_plain.calls
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_smc(get_model("arma"), cfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_smc_batched(get_model("arma"), cfg, [0, 1])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SMCSampler(2, 8, get_model("arma"), 0.01).sample()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["-N", "8", "-K", "1"])
    assert nuts_tree_plain.calls == calls


@pytest.mark.parametrize("entry", ["run_smc", "run_smc_batched", "SMCSampler"])
def test_default_device_is_cuda(entry):
    import inspect

    import smcnuts_torch

    fn = getattr(smcnuts_torch, entry)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
