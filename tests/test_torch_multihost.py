"""Checkpoints of sharded runs, the elastic gang and the multi-process
entries of the port (`smcnuts_torch.parallel`), on the CPU with gloo: the
counterpart of tests/test_multihost.py and of the dryrun phase (e) of
MULTICHIP_r05.json.

The ranks run port code only (`smcnuts_torch.parallel.gang`, the multihost
entry, the CLI); this process computes the unsharded references:

- a sharded `ChunkedRunner` (P = 2, asymptotic with tempering and saved
  history, B = 2) stopped after chunk 1 and resumed equals the
  uninterrupted sharded run and the unsharded run to the bit; the chunk-1
  file rank 0 wrote holds the arrays of the unsharded run's chunk-1 file,
  and resumes at P = 1 and P = 4 to the same result; a file of another
  version is refused loudly;
- the elastic gang: `Supervisor` over 2 ranks of the multihost entry with a
  checkpoint, rank 1 of the first incarnation exiting after chunk 1 (its
  recovery drill), the gang restarted and resumed: the result equals the
  uninterrupted unsharded run to the bit;
- `python -m smcnuts_torch --mesh` over 2 ranks started as torchrun starts
  them (RANK, WORLD_SIZE, MASTER_ADDR in the environment) prints the JSON of
  the same run without --mesh, and its --output holds that run's arrays;
- the multihost entry's default N is 1 << 20 (parsed, not run);
- the parallel package imports neither jax nor smcnuts_tpu; nothing falls
  back: NCCL without a card raises, a tensor of another device handed to a
  group raises, a group of a size that is not a power of two or that does
  not divide N raises.
"""

import json
import os
import re
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from smcnuts_torch import SMCConfig, run_smc
from smcnuts_torch.__main__ import main as torch_main
from smcnuts_torch.models import get_model
from smcnuts_torch.parallel import ParticleGroup, Supervisor, gang, multihost
from smcnuts_torch.runner import ChunkedRunner
from smcnuts_torch.utils import checkpoint as cp

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The multihost entry's run in the elastic gang: arma forwards, one seed.
ELASTIC = dict(N=64, K=4, chunk=2, depth=3, seed=5)


def bits_equal(got, want):
    got, want = np.atleast_1d(got), np.atleast_1d(want)
    return got.shape == want.shape and got.dtype == want.dtype and np.array_equal(
        got.view(np.uint8), want.view(np.uint8))


def _in_thread(fn):
    box = {}

    def target():
        try:
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised by the getter
            box["error"] = e

    thread = threading.Thread(target=target)
    thread.start()

    def result():
        thread.join()
        if "error" in box:
            raise box["error"]
        return box["value"]

    return result


def _elastic_cmd(ckpt, output):
    def make_cmd(pid, coordinator, attempt):
        argv = [sys.executable, "-m", "smcnuts_torch.parallel.multihost",
                "--backend", "gloo", "--device", "cpu", "--model", "arma",
                "-N", str(ELASTIC["N"]), "-K", str(ELASTIC["K"]),
                "--max-tree-depth", str(ELASTIC["depth"]), "--seed", str(ELASTIC["seed"]),
                "--checkpoint", ckpt, "--chunk-size", str(ELASTIC["chunk"]),
                "--output", output, "--coordinator", coordinator,
                "--num-processes", "2", "--process-id", str(pid)]
        if pid == 1 and attempt == 0:
            argv += ["--crash-after-chunk", "1"]
        return argv
    return make_cmd


def _cli_mesh_cmd(output):
    def make_cmd(pid, coordinator, attempt):
        host, port = coordinator.rsplit(":", 1)
        return ["env", f"RANK={pid}", f"LOCAL_RANK={pid}", "WORLD_SIZE=2",
                f"MASTER_ADDR={host}", f"MASTER_PORT={port}", "OMP_NUM_THREADS=1",
                sys.executable, "-m", "smcnuts_torch", "--mesh", "--device", "cpu",
                "-N", "64", "-K", "3", "--max-tree-depth", "3", "--seed", "4",
                "--output", output]
    return make_cmd


class _Stop(Exception):
    pass


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    out = tmp_path_factory.mktemp("gangs")
    ckpt_gang = _in_thread(lambda: gang.launch(out, 4, ["checkpoint"], timeout=300))
    elastic = Supervisor(_elastic_cmd(str(out / "elastic.npz"), str(out / "elastic_out.npz")),
                         2, env=dict(os.environ, OMP_NUM_THREADS="1"), max_restarts=2,
                         cwd=REPO)
    elastic_run = _in_thread(lambda: elastic.run(timeout=300))
    cli = Supervisor(_cli_mesh_cmd(str(out / "cli_out.npz")), 2, max_restarts=0, cwd=REPO)
    cli_run = _in_thread(lambda: cli.run(timeout=300))

    ref = {}
    try:
        cfg, model = SMCConfig(**gang.CKPT_CONFIG), get_model("arma")
        seeds = list(gang.CKPT_SEEDS)
        ref["ckpt_run"] = gang.result_arrays(
            ChunkedRunner(model, cfg, chunk_size=gang.CKPT_CHUNK, device="cpu").run(seeds))

        def stop(k_done, total):
            if k_done == gang.CKPT_CHUNK:
                raise _Stop

        with pytest.raises(_Stop):
            ChunkedRunner(model, cfg, checkpoint_path=str(out / "unsharded.npz"),
                          chunk_size=gang.CKPT_CHUNK, device="cpu").run(seeds, progress=stop)
        ref["ckpt_file"] = dict(np.load(out / "unsharded.npz"))
        e = ELASTIC
        ref["elastic_run"] = gang.result_arrays(run_smc(
            get_model("arma"), SMCConfig(n_particles=e["N"], n_iterations=e["K"],
                                         step_size=0.01, max_tree_depth=e["depth"],
                                         save_history=False),
            e["seed"], "cpu"))
        cli_argv = ["--device", "cpu", "-N", "64", "-K", "3", "--max-tree-depth", "3",
                    "--seed", "4", "--output", str(out / "cli_plain.npz")]
        ref["cli_summary"] = torch_main(cli_argv)
        ref["cli_plain"] = dict(np.load(out / "cli_plain.npz"))
    finally:
        ckpt_gang()
        ref["elastic"] = (elastic, elastic_run())
        ref["cli"] = cli_run()
    ref["gang"] = {p.stem: dict(np.load(p)) for p in out.glob("*.npz")}
    ref["out"] = out
    return ref


@pytest.mark.parametrize("case", ["checkpoint_resumed_P2", "checkpoint_uninterrupted_P2",
                                  "checkpoint_from_P2_P1", "checkpoint_from_P2_P4"])
def test_sharded_chunked_runs_equal_unsharded(gangs, case):
    got, want = gangs["gang"][case], gangs["ckpt_run"]
    assert set(got) == set(want)
    differing = [k for k in want if not bits_equal(got[k], want[k].numpy())]
    assert not differing, differing


def test_sharded_checkpoint_is_the_unsharded_file(gangs):
    got, want = gangs["gang"]["ckpt_P2_chunk1"], gangs["ckpt_file"]
    assert sorted(got) == sorted(want)
    assert int(got["k_done"]) == gang.CKPT_CHUNK
    differing = [k for k in want if not bits_equal(got[k], want[k])]
    assert not differing, differing


def test_checkpoint_version_mismatch_fails_loudly(gangs, tmp_path):
    """A file of another version is refused, sharded or not, before any
    array is read into the carry."""
    data = dict(gangs["ckpt_file"])
    data["version"] = np.asarray(cp.CHECKPOINT_VERSION + 1)
    path = str(tmp_path / "v.npz")
    np.savez(path, **data)
    cfg = SMCConfig(**gang.CKPT_CONFIG)
    for group in (None, ParticleGroup(None, 1, 2, torch.device("cpu"))):
        runner = ChunkedRunner(get_model("arma"), cfg, checkpoint_path=path,
                               chunk_size=gang.CKPT_CHUNK, device="cpu", group=group)
        with pytest.raises(ValueError, match="version"):
            runner.run(list(gang.CKPT_SEEDS))


def test_elastic_gang_resumes_to_the_uninterrupted_run(gangs):
    sup, inc = gangs["elastic"]
    assert len(sup.incarnations) == 2, [i.returncodes for i in sup.incarnations]
    assert 17 in sup.incarnations[0].returncodes
    assert "recovery drill" in sup.incarnations[0].outputs[1]
    assert inc.ok and "resumed=True" in inc.outputs[0], inc.outputs[0]
    got, want = gangs["gang"]["elastic_out"], gangs["elastic_run"]
    assert set(got) == set(want)
    differing = [k for k in want if not bits_equal(got[k], want[k].numpy())]
    assert not differing, differing


def test_cli_mesh_two_ranks_prints_the_unsharded_json(gangs):
    inc = gangs["cli"]
    assert inc.ok
    printed = json.loads(re.search(r"^\{.*^\}", inc.outputs[0], re.M | re.S).group(0))
    assert printed == gangs["cli_summary"]
    assert '"phi_schedule"' not in inc.outputs[1]  # rank 1 prints no result
    got, want = gangs["gang"]["cli_out"], gangs["cli_plain"]
    assert sorted(got) == sorted(want)
    assert all(bits_equal(got[k], want[k]) for k in want)


def test_cli_mesh_world_size_one_equals_unsharded(capsys):
    argv = ["--device", "cpu", "-N", "32", "-K", "2", "--max-tree-depth", "2",
            "--lkernel", "GaussianApproxLKernel", "--resampling", "systematic"]
    assert torch_main(argv + ["--mesh"]) == torch_main(argv)
    assert not torch.distributed.is_initialized()


def test_multihost_main_default_n():
    args = multihost.parse_args([])
    assert args.particles == 1 << 20
    assert args.backend == "nccl" and args.model == "arma" and args.iterations == 100
    assert multihost.parse_args(["--backend", "gloo"]).backend == "gloo"


def test_parallel_imports_neither_jax_nor_the_jax_package():
    code = ("import sys, smcnuts_torch.parallel, smcnuts_torch.parallel.gang, "
            "smcnuts_torch.parallel.multihost, smcnuts_torch.__main__\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', "
            "'jaxlib', 'smcnuts_tpu'))]\n"
            "assert not bad, bad\nprint('clean')")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr
    pkg = os.path.join(REPO, "smcnuts_torch", "parallel")
    for name in sorted(os.listdir(pkg)):
        if name.endswith(".py"):
            src = open(os.path.join(pkg, name)).read()
            assert not re.search(r"^\s*(import|from)\s+(jax|smcnuts_tpu)\b", src, re.M), name


def test_nothing_falls_back():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            multihost.initialize(backend="nccl")
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="not initialised"):
        from smcnuts_torch.parallel import particle_group

        particle_group()
    group = ParticleGroup(None, 0, 2, torch.device("cpu"))
    with pytest.raises(ValueError, match="handed to a particle group"):
        group.max(torch.zeros(2, device="meta"))
    with pytest.raises(ValueError, match="power-of-two"):
        ParticleGroup(None, 0, 3, torch.device("cpu"))
    with pytest.raises(ValueError, match="do not divide"):
        group.local_count(33)
    with pytest.raises(ValueError, match="backend"):
        multihost.initialize(backend="mpi")
