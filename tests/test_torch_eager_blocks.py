"""The eager tree in blocks of lanes (`eager_block_size`), and the fused ARMA
model end to end.

Blocked equals unblocked to the bit in every output of the tree, for block
sizes 1, 7, 64 and None at B = 2 runs of N = 50, with and without compaction
and the accept-reject epilogue, with and without given momenta (a lane's draws
are addressed by its run's seed, its particle and their place in the tree,
and every operation is per lane). Through the sampler, a blocked run equals an
unblocked one in every field, and the block size defaults to the JAX
package's `xla_block_size`. Last, as the JAX package's
`test_fused_model_end_to_end_matches_plain`: a run with
`make_arma(fused="plain")` on the eager tree against one of the plain model
with its gradient from torch autograd, from the same seed, the means at rtol
1e-3 and atol 1e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch

from smcnuts_torch import SMCConfig, run_smc, run_smc_batched
from smcnuts_torch.models import make_arma, make_gaussian
from smcnuts_torch.models.arma import ArmaModel
from smcnuts_torch.ops.draws import PHILOX
from smcnuts_torch.ops.nuts_cuda import STAT_KEYS, nuts_tree_plain
from smcnuts_tpu import SMCConfig as JaxSMCConfig

torch.set_num_threads(2)

B, N, DEPTH = 2, 50, 3
G_MEAN, G_VAR, G_PRIOR = (1.0, -2.0, 0.5), (0.5, 2.0, 1.0), (4.0, 4.0, 4.0)


@pytest.fixture(scope="module")
def tree_inputs():
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(0, 1.5, (B, N, 3)).astype(np.float32))
    r = torch.as_tensor(rng.normal(0, 1.0, (B, N, 3)).astype(np.float32))
    model = make_gaussian(G_MEAN, G_VAR, G_PRIOR)
    args = (model, x, torch.tensor([5, 6], dtype=torch.int32), 0.4,
            torch.tensor([1.0, 0.6]), torch.tensor([[1.0, 0.5, 2.0], [1.5, 1.0, 0.7]]),
            DEPTH, PHILOX)
    return args, r


def _assert_equal(a, b):
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    for k in STAT_KEYS:
        assert torch.equal(a[2][k], b[2][k]), k


CASES = {"single": ((), False), "acc_rej": ((), True), "staged": ((1, 2), False),
         "staged_acc_rej": ((1, 2), True)}


# Blocks of one lane walk the tree lane by lane (seconds on the CPU), so they
# take the case that runs every part: stages and the accept-reject.
@pytest.mark.parametrize("block,case", [
    (1, "staged_acc_rej"), *((b, c) for b in (7, 64, None) for c in CASES),
])
def test_blocked_tree_equals_unblocked(tree_inputs, block, case):
    _check_blocked(tree_inputs, block, *CASES[case], False)


@pytest.mark.parametrize("block,compaction", [(7, ()), (64, (1, 2))])
def test_blocked_tree_with_given_momenta_equals_unblocked(tree_inputs, block, compaction):
    _check_blocked(tree_inputs, block, compaction, False, True)


def _check_blocked(tree_inputs, block, compaction, acc_rej, given_r):
    args, r = tree_inputs
    kw = dict(r=r if given_r else None, acc_rej=acc_rej, compaction=compaction)
    whole = nuts_tree_plain(*args, **kw)
    survivors = nuts_tree_plain.survivors
    calls = nuts_tree_plain.model_calls
    blocked = nuts_tree_plain(*args, block_size=block, **kw)
    _assert_equal(blocked, whole)
    # Compaction stages within each block: the survivors add up.
    assert nuts_tree_plain.survivors == survivors
    assert whole[2]["depth"].max() > 2  # the trees are not all shallow
    assert whole[2]["depth"].min() < whole[2]["depth"].max()
    # A block evaluates its start and one leaf a lockstep step.
    n_blocks = 1 if block is None else -(-B * N // block)
    assert nuts_tree_plain.model_calls - calls >= n_blocks


def test_block_size_must_be_positive(tree_inputs):
    args, _ = tree_inputs
    with pytest.raises(ValueError, match="block_size"):
        nuts_tree_plain(*args, block_size=0)


def test_eager_block_size_default_matches_jax():
    cfg = SMCConfig(n_particles=8, n_iterations=1, step_size=0.1)
    jax_cfg = JaxSMCConfig(n_particles=8, n_iterations=1, step_size=0.1)
    assert cfg.eager_block_size == jax_cfg.xla_block_size == 4096


@pytest.mark.parametrize("settings", [
    dict(), dict(fused_epilogue=False, lkernel="asymptoticLKernel", tempering=True),
], ids=["fused", "unfused_asymptotic"])
def test_blocked_runs_equal_unblocked_runs(settings):
    model = make_gaussian(G_MEAN, G_VAR, G_PRIOR)
    cfg = SMCConfig(n_particles=40, n_iterations=3, step_size=0.4,
                    max_tree_depth=DEPTH, **settings)
    seeds = [11, 12]
    whole = run_smc_batched(model, dataclasses.replace(cfg, eager_block_size=None),
                            seeds, "cpu")
    blocked = run_smc_batched(model, dataclasses.replace(cfg, eager_block_size=9),
                              seeds, "cpu")
    for f, v in whole._asdict().items():
        if v is not None:
            assert torch.equal(v, getattr(blocked, f)), f


class _AutogradArma(ArmaModel):
    """The plain ARMA model with its gradient from torch autograd of
    logprior + phi * loglik (`ArmaModel.loglik`'s own error loop), as the
    JAX package's plain model takes `jax.value_and_grad`: a derivation apart
    from the fused value and gradient."""

    def logp_and_grad(self, x, phi=1.0):
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            lp = self.logp(xg, phi)
            (g,) = torch.autograd.grad(lp.sum(), xg)
        return lp.detach(), g


def test_fused_model_end_to_end_matches_plain():
    cfg = SMCConfig(n_particles=64, n_iterations=3, step_size=0.01,
                    save_history=False, max_tree_depth=4, nuts_backend="eager",
                    fused_epilogue=False, eager_block_size=48)
    plain = run_smc(_AutogradArma(), cfg, 0, "cpu")
    fused = run_smc(make_arma(fused="plain"), cfg, 0, "cpu")
    np.testing.assert_allclose(fused.mean_estimate.numpy(), plain.mean_estimate.numpy(),
                               rtol=1e-3, atol=1e-4)
    assert torch.isfinite(fused.mean_estimate).all()
    assert not torch.equal(fused.mean_estimate, plain.mean_estimate)  # two derivations


def test_eager_tree_stages_only_at_named_splits(monkeypatch):
    # "auto" resolves the kernel's hint; the eager tree, as the JAX package's
    # XLA backend, stages nothing unless the caller names splits.
    import smcnuts_torch.sampler as sampler

    model = make_arma()
    monkeypatch.setattr(model, "compaction_min_lanes", 0)  # "auto" takes the hint
    base = SMCConfig(n_particles=48, n_iterations=1, step_size=0.01, max_tree_depth=4,
                     nuts_backend="eager")
    assert sampler.resolve_compaction(base, model, 48) == model.compaction_hint != ()
    nuts_tree_plain.survivors = ["unset"]
    run_smc_batched(model, base, [1], "cpu")
    assert nuts_tree_plain.survivors == []
    run_smc_batched(model, dataclasses.replace(base, compaction=(1, 2)), [1], "cpu")
    assert len(nuts_tree_plain.survivors) == 2
