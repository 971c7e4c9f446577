"""ChunkedRunner and checkpoints (the counterpart of tests/test_runner.py, on
the CPU through the eager tree): a chunked run equals the uninterrupted
`run_smc_batched` to the bit for any chunk size; a run stopped after a chunk
and resumed from its checkpoint equals it to the bit, for the forwards,
asymptotic (history saved and streaming) and adapted configurations; a
checkpoint of another version, seeds or strategy is refused; a checkpoint at
k_done == K runs nothing; `SMCSampler.sample(show_progress=True)` equals the
plain run; `utils.profiling.phase_timings` times every phase. (The mesh case
of the JAX file: tests/test_torch_multihost.py.)"""

import os
import sys

import numpy as np
import pytest
import torch

from smcnuts_torch import SMCConfig, SMCSampler, run_smc, run_smc_batched
from smcnuts_torch.models import make_gaussian
from smcnuts_torch.ops.adaptation import DualAveragingState
from smcnuts_torch.ops.nuts_cuda import nuts_tree_plain
from smcnuts_torch.runner import ChunkedRunner
from smcnuts_torch.sampler import SMCCarry
from smcnuts_torch.utils.checkpoint import CHECKPOINT_VERSION, load_checkpoint, save_checkpoint

torch.set_num_threads(2)

MEAN = np.array([1.0, -2.0])
VAR = np.array([0.5, 2.0])
SEEDS = [3, 11]


def _model(**kw):
    return make_gaussian(MEAN, VAR, **kw)


def _cfg(**kw):
    base = dict(n_particles=64, n_iterations=9, step_size=0.5, max_tree_depth=3)
    base.update(kw)
    return SMCConfig(**base)


ASYMPTOTIC = dict(lkernel="asymptoticLKernel", tempering=True)
CONFIGS = {
    "forwards": dict(save_history=False),
    "asymptotic_history": dict(ASYMPTOTIC, save_history=True),
    "asymptotic_streaming": dict(ASYMPTOTIC, save_history=False),
    "adapted": dict(adapt_step_size=True, adapt_mass_matrix=True, save_history=False),
}


def _differs(a, b):
    """Names of the fields in which two results differ in any bit."""
    return [f for f, v in a._asdict().items()
            if (v is None) != (getattr(b, f) is None)
            or (v is not None and not torch.equal(v, getattr(b, f)))]


class _Stop(Exception):
    pass


def _stop_after(k_stop):
    def progress(k_done, total):
        if k_done == k_stop:
            raise _Stop
    return progress


@pytest.mark.parametrize("chunk_size", [1, 3, 7, 20])
def test_chunked_equals_monolithic(chunk_size):
    """Chunks cut the loop only: the draw blocks clip at a chunk's end and
    every draw is addressed by its absolute iteration."""
    model, cfg = _model(prior_var=np.ones(2)), _cfg(**CONFIGS["asymptotic_streaming"])
    mono = run_smc_batched(model, cfg, SEEDS, "cpu")
    chunked = ChunkedRunner(model, cfg, chunk_size=chunk_size, device="cpu").run(SEEDS)
    assert not _differs(chunked, mono)


def test_single_seed_drops_the_run_axis():
    model, cfg = _model(), _cfg(n_iterations=4)
    one = ChunkedRunner(model, cfg, chunk_size=3, device="cpu").run(5)
    assert one.x_final.shape == (64, 2)
    assert not _differs(one, run_smc(model, cfg, 5, "cpu"))


def test_checkpoint_resume_after_a_shorter_run(tmp_path):
    """The JAX file's crash: a K=3 run writes the checkpoint, the K=9 run
    resumes from it."""
    model, cfg = _model(), _cfg()
    ckpt = os.path.join(tmp_path, "smc.npz")
    full = run_smc_batched(model, cfg, SEEDS, "cpu")
    ChunkedRunner(model, _cfg(n_iterations=3), checkpoint_path=ckpt, chunk_size=3,
                  device="cpu").run(SEEDS)
    assert os.path.exists(ckpt) and not os.path.exists(ckpt + ".tmp")
    calls = nuts_tree_plain.calls
    resumed = ChunkedRunner(model, cfg, checkpoint_path=ckpt, chunk_size=3,
                            device="cpu").run(SEEDS)
    assert nuts_tree_plain.calls == calls + 6
    assert not _differs(resumed, full)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_checkpoint_resume_after_a_stop(tmp_path, name):
    """A run stopped after iteration 4 (from its progress callback, after
    the checkpoint of the chunk) and resumed with the same configuration:
    the carry (the dual-averaging state and inverse mass included), the
    diagnostics and the histories come back exactly."""
    prior = np.ones(2) if name.startswith("asymptotic") else None
    model, cfg = _model(prior_var=prior), _cfg(**CONFIGS[name])
    ckpt = os.path.join(tmp_path, "smc.npz")
    full = run_smc_batched(model, cfg, SEEDS, "cpu")
    runner = ChunkedRunner(model, cfg, checkpoint_path=ckpt, chunk_size=2, device="cpu")
    with pytest.raises(_Stop):
        runner.run(SEEDS, progress=_stop_after(4))
    with np.load(ckpt) as data:
        assert int(data["k_done"]) == 4 and int(data["version"]) == CHECKPOINT_VERSION
        assert ("hist_x" in data.files) == cfg.save_history
        assert data["diag_mean"].shape == (2, 4, 2)
    seen = []
    resumed = runner.run(SEEDS, progress=lambda k, total: seen.append((k, total)))
    assert seen == [(4, 9), (6, 9), (8, 9), (9, 9)]
    assert not _differs(resumed, full)


def test_checkpoint_version_mismatch_fails_loudly(tmp_path):
    model, ckpt = _model(), os.path.join(tmp_path, "smc.npz")
    ChunkedRunner(model, _cfg(n_iterations=3), checkpoint_path=ckpt, chunk_size=3,
                  device="cpu").run(SEEDS)
    data = dict(np.load(ckpt, allow_pickle=False))
    data["version"] = np.int64(999)
    np.savez(ckpt, **data)
    with pytest.raises(ValueError, match="version"):
        ChunkedRunner(model, _cfg(), checkpoint_path=ckpt, chunk_size=3,
                      device="cpu").run(SEEDS)


@pytest.mark.parametrize("change, match", [
    (dict(seeds=[3, 12]), "seeds"),
    (dict(n_particles=32), "carry_x"),
    (dict(lkernel="asymptoticLKernel", tempering=True), "strategy"),
    (dict(save_history=True), "save_history"),
    (dict(n_iterations=2), "past"),
])
def test_checkpoint_of_another_run_is_refused(tmp_path, change, match):
    model, ckpt = _model(), os.path.join(tmp_path, "smc.npz")
    ChunkedRunner(model, _cfg(n_iterations=3, save_history=False), checkpoint_path=ckpt,
                  chunk_size=3, device="cpu").run(SEEDS)
    change = dict(change)
    seeds = change.pop("seeds", SEEDS)
    cfg = _cfg(**dict(dict(save_history=False), **change))
    with pytest.raises(ValueError, match=match):
        ChunkedRunner(model, cfg, checkpoint_path=ckpt, device="cpu").run(seeds)


def test_checkpoint_at_k_done_runs_nothing(tmp_path):
    model, cfg = _model(), _cfg(**CONFIGS["asymptotic_history"])
    ckpt = os.path.join(tmp_path, "smc.npz")
    first = ChunkedRunner(model, cfg, checkpoint_path=ckpt, chunk_size=4,
                          device="cpu").run(SEEDS)
    calls = nuts_tree_plain.calls
    seen = []
    again = ChunkedRunner(model, cfg, checkpoint_path=ckpt, chunk_size=4,
                          device="cpu").run(SEEDS, progress=lambda k, t: seen.append(k))
    assert nuts_tree_plain.calls == calls and seen == [9]
    assert not _differs(again, first)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_checkpoint_round_trip_keeps_dtype_and_device(tmp_path, dtype):
    g = torch.Generator().manual_seed(0)
    B, N, D, k = 2, 5, 3, 4

    def t(*shape):
        return torch.randn(*shape, generator=g, dtype=dtype)

    carry = SMCCarry(x=t(B, N, D), logw=t(B, N), phi=t(B), step_size=t(B),
                     inv_mass=t(B, D), da=DualAveragingState(*(t(B) for _ in range(5))),
                     loglik=t(B, N))
    diags = {"ess": t(B, k), "resampled": torch.rand(B, k, generator=g) < 0.5}
    history = {"x": t(B, k + 1, N, D), "logw": t(B, k + 1, N), "loglik": t(B, k + 1, N)}
    path = os.path.join(tmp_path, "sub", "ck.npz")
    save_checkpoint(path, carry, k, diags, history, seeds=[7, 8])
    template = SMCCarry(*(v.to("meta") if torch.is_tensor(v)
                          else DualAveragingState(*(u.to("meta") for u in v))
                          for v in carry))
    diag_t = {name: v[:, 0].to("meta") for name, v in diags.items()}
    got, k_done, got_diags, got_history, seeds = load_checkpoint(path, template, diag_t,
                                                                 torch.device("cpu"))
    assert k_done == k and seeds == [7, 8]
    for want, have in [(carry.x, got.x), (carry.da.count, got.da.count),
                       (carry.loglik, got.loglik)] + [
            (diags[n], got_diags[n]) for n in diags] + [
            (history[n], got_history[n]) for n in history]:
        assert have.dtype == want.dtype and have.device == want.device
        assert have.is_contiguous() and torch.equal(have, want)
    with pytest.raises(ValueError, match="float"):
        bad = template._replace(x=torch.empty(B, N, D, dtype=torch.float16, device="meta"))
        load_checkpoint(path, bad, diag_t, torch.device("cpu"))


def test_show_progress_equals_the_plain_run(capsys):
    model, cfg = _model(), _cfg(n_iterations=5)
    plain = SMCSampler(5, 64, model, 0.5, config=cfg, seed=4, device="cpu").sample()
    shown = SMCSampler(5, 64, model, 0.5, config=cfg, seed=4, device="cpu")
    got = shown.sample(show_progress=True)
    assert not _differs(got, plain)
    assert shown.ess.shape == (6,) and len(shown.resampled) == 6


def test_show_progress_without_tqdm_writes_lines(capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "tqdm", None)
    model, cfg = _model(), _cfg(n_iterations=3)
    plain = run_smc(model, cfg, 2, "cpu")
    got = SMCSampler(3, 64, model, 0.5, config=cfg, seed=2, device="cpu").sample(
        show_progress=True)
    assert not _differs(got, plain)
    # Chunks of ceil(3 / 20) = 1 iteration.
    assert capsys.readouterr().err.splitlines() == [
        "SMC iteration 1/3", "SMC iteration 2/3", "SMC iteration 3/3"]


def test_phase_timings_on_the_cpu():
    from smcnuts_torch.models import get_model
    from smcnuts_torch.utils.profiling import phase_timings

    t = phase_timings(get_model("arma"), _cfg(n_particles=32, step_size=0.01, max_tree_depth=2),
                      repeats=1, iters=2, device="cpu")
    assert set(t) == {"propose_nuts", "normalise_resample", "reweight_target_evals",
                      "gaussian_lkernel", "temper_bisect"}
    assert all(np.isfinite(v) and v >= 0 for v in t.values())


def test_trace_writes_a_chrome_trace(tmp_path):
    from smcnuts_torch.utils.profiling import trace

    with trace(str(tmp_path)) as prof:
        torch.ones(4).cumsum(0)
    assert os.path.getsize(os.path.join(tmp_path, "trace.json")) > 0
    assert prof.key_averages()


def test_entry_points_default_to_the_card():
    """Without a CUDA device the runner and phase_timings raise unless the
    CPU is asked for; they never carry on there."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from smcnuts_torch.models import get_model
    from smcnuts_torch.utils.profiling import phase_timings, profile_iterations

    model, cfg = _model(), _cfg(n_iterations=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ChunkedRunner(model, cfg).run(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        phase_timings(get_model("arma"), cfg)
    with pytest.raises(ValueError, match="times the card"):
        profile_iterations(model, cfg, [0], device="cpu")
