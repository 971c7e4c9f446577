"""Chunked runs with checkpoint and resume (the JAX package's `runner.py`).

`run_smc_batched` runs all K iterations in one call, and a crash loses the
run (the reference has the same failure mode, SURVEY.md §5 "Checkpoint /
resume: Absent"). ChunkedRunner runs the same loop (`sampler.SMCRun`)
`chunk_size` iterations at a time and, with a checkpoint path, writes the
runs' state to an atomic .npz after every chunk (`utils.checkpoint`); a run
that finds the file resumes after its last chunk, without init_state and
its tempering bisection. The chunks run by absolute iteration index, since
every draw (the resampling uniforms, the trees' seeds, the recycling
uniforms of the asymptotic strategy) is addressed by it: the result equals
the uninterrupted run's to the bit, resumed or not.

With a particle group (`parallel.sharding`) every rank runs the same chunks
on its shard; the checkpoint is the global file rank 0 writes (the one an
unsharded run writes), and a resume at any number of ranks takes its shard
of it (`utils.checkpoint`).
"""

from __future__ import annotations

import numbers
import os

import torch

from .config import SMCConfig
from .ops.adaptation import DualAveragingState
from .sampler import _SERIES, RunState, SMCCarry, SMCResult, SMCRun
from .utils.checkpoint import load_checkpoint, save_checkpoint


class ChunkedRunner:
    """`run(seed)` is `run_smc` (no run axis), `run([seeds])`
    `run_smc_batched` (every field leads with the run axis), in chunks of
    `chunk_size` iterations, checkpointed to `checkpoint_path` when one is
    given. The device defaults to the card, as everywhere in the package;
    `group` shards the particles (every rank of it calls `run` alike)."""

    def __init__(self, model, cfg: SMCConfig, checkpoint_path=None, chunk_size=10,
                 sample_proposal=None, momentum_proposal=None, device="cuda",
                 group=None):
        self.model = model
        self.group = group
        self.cfg = cfg
        self.checkpoint_path = checkpoint_path
        self.chunk_size = max(1, int(chunk_size))
        self.sample_proposal = sample_proposal
        self.momentum_proposal = momentum_proposal
        self.device = device

    def run(self, seed, progress=None) -> SMCResult:
        """Run to K iterations, resuming from the checkpoint if it exists.
        `progress`, if given, is called as progress(k_done, K) after every
        chunk (after its checkpoint is written), and once at the start of a
        resumed run."""
        single = isinstance(seed, numbers.Integral)
        seeds = [int(seed)] if single else [int(s) for s in seed]
        run = SMCRun(self.model, self.cfg, seeds, self.device, self.momentum_proposal,
                     group=self.group)
        K = self.cfg.n_iterations
        path = self.checkpoint_path
        if path and os.path.exists(path):
            state = self._resume(run, path)
            if progress is not None:
                progress(state.k_done, K)
        else:
            state = run.init(self.sample_proposal)
        while state.k_done < K:
            run.iterate(state, min(state.k_done + self.chunk_size, K))
            if path:
                history = None
                if state.history is not None:
                    history = {name: torch.stack(seq, dim=1)
                               for name, seq in state.history.items()}
                save_checkpoint(path, state.carry, state.k_done,
                                _stacked(state.diags), history, seeds, self.group)
            if progress is not None:
                progress(state.k_done, K)
        result = run.finalize(state)
        if single:
            result = SMCResult(*(None if v is None else v[0] for v in result))
        return result

    def _resume(self, run: SMCRun, path: str) -> RunState:
        cfg, model = self.cfg, run.model
        B, N, D = len(run.seeds), cfg.n_particles, model.dim

        def like(*shape, dtype=run.dtype):
            return torch.empty(shape, dtype=dtype, device="meta")

        carry_t = SMCCarry(
            x=like(B, N, D), logw=like(B, N), phi=like(B), step_size=like(B),
            inv_mass=like(B, D),
            da=DualAveragingState(*(like(B) for _ in DualAveragingState._fields)),
            loglik=like(B, N) if cfg.is_asymptotic else None,
        )
        cd = model.constrain(torch.zeros(1, D, dtype=run.dtype, device=run.device)).shape[-1]
        diag_t = {name: like(B, cd) if name in ("mean", "var")
                  else like(B, dtype=torch.bool) if name == "resampled" else like(B)
                  for name in _SERIES}
        carry, k_done, diags, history, seeds = load_checkpoint(path, carry_t, diag_t,
                                                               run.device, self.group)
        if seeds != run.seeds:
            raise ValueError(f"checkpoint {path!r} holds the runs of seeds {seeds}, "
                             f"not {run.seeds}")
        if k_done > cfg.n_iterations:
            raise ValueError(f"checkpoint {path!r} is {k_done} iterations in, past "
                             f"this run's K = {cfg.n_iterations}")
        if (history is not None) != cfg.save_history:
            raise ValueError(f"checkpoint {path!r} was written with save_history="
                             f"{history is not None}, this run has {cfg.save_history}")
        return RunState(
            carry, k_done,
            [{name: v[:, i] for name, v in diags.items()} for i in range(k_done)],
            None if history is None
            else {name: list(v.unbind(1)) for name, v in history.items()},
        )


def _stacked(diags: list) -> dict:
    """The diagnostics of the iterations done, name -> (B, k, ...)."""
    return {name: torch.stack([d[name] for d in diags], dim=1) for name in _SERIES}
