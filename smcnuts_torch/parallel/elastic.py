"""Elastic recovery of a gang of ranks: supervision + checkpoint resume (the
port's own copy of the JAX package's `parallel/elastic.py`, which imports
nothing of JAX; this package imports nothing of that one).

A torch.distributed gang is all-or-nothing: one lost process stalls every
collective of the others. So recovery is RESTART, not repair:

  1. a Supervisor owns the worker processes of one machine and polls them;
  2. when ANY worker dies, it terminates the remaining workers by EXACT pid
     (never by a pattern), ending the stalled collectives cleanly;
  3. it picks a fresh coordinator port and relaunches the whole gang;
  4. the workers resume from the latest checkpoint written by
     runner.ChunkedRunner (utils/checkpoint.py under a particle group: the
     shards gathered, rank 0 writes, every rank takes its shard on load), so
     at most one chunk of iterations is done again, and the result equals
     the uninterrupted run's to the bit.

The workers are typically the port's multihost entry
(`python -m smcnuts_torch.parallel.multihost --coordinator ADDR
--num-processes P --process-id I --checkpoint PATH`). On a cluster each host
runs one Supervisor over its local workers; the coordinator address handed
to `make_cmd` then comes from the cluster's scheduler instead of a local
free port. The failure-detection latency is the poll interval.
"""

from __future__ import annotations

import socket
import subprocess
import time
from dataclasses import dataclass, field


def free_port(host="127.0.0.1") -> int:
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


@dataclass
class Incarnation:
    """One launch attempt of the gang: per-worker outputs + return codes."""

    coordinator: str
    outputs: list[str] = field(default_factory=list)
    returncodes: list[int] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return all(rc == 0 for rc in self.returncodes)


class Supervisor:
    """Launch `n_processes` gang workers, restart the gang on any failure.

    make_cmd(process_id, coordinator, attempt) -> argv for one worker. The
    worker must be idempotent-with-checkpoint: attempt > 0 re-runs the same
    program, which resumes from the checkpoint it wrote before the crash.

    Worker stdout/stderr stream to per-worker temp files (a pipe would fill
    and deadlock a chatty worker), read back into Incarnation.outputs after the gang settles.
    `timeout` is PER INCARNATION: a slow first attempt must not starve the
    restarts this class exists to provide.
    """

    def __init__(self, make_cmd, n_processes: int, env=None,
                 max_restarts: int = 2, poll_interval: float = 0.25,
                 coordinator_host: str = "127.0.0.1", cwd=None):
        self.make_cmd = make_cmd
        self.n_processes = n_processes
        self.env = env
        self.max_restarts = max_restarts
        self.poll_interval = poll_interval
        self.coordinator_host = coordinator_host
        self.cwd = cwd
        self.incarnations: list[Incarnation] = []

    def run(self, timeout: float = 600.0) -> Incarnation:
        """Run until one incarnation of the gang exits fully clean; returns
        it. Raises RuntimeError after max_restarts failed relaunches or
        TimeoutError if an incarnation neither finishes nor fails within its
        own `timeout` budget."""
        import tempfile

        for attempt in range(self.max_restarts + 1):
            coordinator = (
                f"{self.coordinator_host}:{free_port(self.coordinator_host)}"
            )
            logs = [
                tempfile.TemporaryFile(mode="w+")
                for _ in range(self.n_processes)
            ]
            procs = [
                subprocess.Popen(
                    self.make_cmd(pid, coordinator, attempt),
                    env=self.env, cwd=self.cwd, text=True,
                    stdout=logs[pid], stderr=subprocess.STDOUT,
                )
                for pid in range(self.n_processes)
            ]
            inc = Incarnation(coordinator=coordinator)
            failed = self._poll_gang(procs, time.monotonic() + timeout)
            if failed:
                # Terminate survivors by exact pid; their collectives are
                # stalled on the dead peer and will never finish on their own.
                for p in procs:
                    if p.poll() is None:
                        p.terminate()
                for p in procs:
                    try:
                        p.wait(timeout=10)
                    except subprocess.TimeoutExpired:
                        p.kill()
                        p.wait()
            for p, log in zip(procs, logs):
                log.seek(0)
                inc.outputs.append(log.read())
                log.close()
                inc.returncodes.append(p.returncode)
            self.incarnations.append(inc)
            if inc.ok:
                return inc
        raise RuntimeError(
            f"gang failed {self.max_restarts + 1} incarnations; last return "
            f"codes {self.incarnations[-1].returncodes}"
        )

    def _poll_gang(self, procs, deadline) -> bool:
        """Poll until the whole gang exits cleanly (False) or any worker
        fails (True). TimeoutError past the deadline."""
        while True:
            codes = [p.poll() for p in procs]
            if any(c is not None and c != 0 for c in codes):
                return True
            if all(c == 0 for c in codes):
                return False
            if time.monotonic() > deadline:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                raise TimeoutError("gang did not finish before the deadline")
            time.sleep(self.poll_interval)
