"""Device timing with CUDA events.

PyTorch returns before the device finishes, so a host clock around a launch
measures the enqueue. Events recorded on the stream before and after the work
measure the device's time for it. `median_ms` times one call at a time, the
host's time to launch it included when the device is idle; `device_ms` times
a kernel alone, many launches queued back to back behind a device-side wait.
"""

from __future__ import annotations

import statistics
import time

import torch


class CudaTimer:
    """Context manager: `with CudaTimer() as t: work()`, then `t.ms`."""

    def __init__(self, stream: torch.cuda.Stream | None = None):
        self.stream = stream
        self._start = torch.cuda.Event(enable_timing=True)
        self._end = torch.cuda.Event(enable_timing=True)

    def __enter__(self):
        self._start.record(self.stream)
        return self

    def __exit__(self, *exc):
        self._end.record(self.stream)

    @property
    def ms(self) -> float:
        self._end.synchronize()
        return self._start.elapsed_time(self._end)


def median_ms(fn, repeats: int = 5, warmup: int = 1) -> float:
    """Median device milliseconds of `repeats` calls of fn, each timed alone
    on the current stream, after `warmup` untimed calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        with CudaTimer() as t:
            fn()
        times.append(t.ms)
    return statistics.median(times)


def device_ms(fn, repeats: int = 20, warmup: int = 2) -> float:
    """Device milliseconds a call of fn, from `repeats` calls launched back
    to back on the current stream and bracketed by two events.

    fn launches work and returns without synchronising, and allocates its
    outputs from PyTorch's caching allocator (no device work). The calls are
    queued behind a device-side wait (`torch.cuda._sleep`), so the start
    event fires only when the device reaches it, after the host has queued
    every call: the host's time between calls is hidden, and what is left is
    the device's time for the work itself. The wait is sized from the host
    time of the untimed calls; if the start event has fired before the last
    call was queued, the wait was too short, and the measurement is taken
    again with a wait four times as long."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # Cycles of the device's clock: at most ~2 GHz on the cards this runs on.
    cycles = int(2e9 * max(4.0 * host_s, 1e-3))
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(repeats):
            fn()
        end.record()
        queued_in_time = not start.query()
        end.synchronize()
        if queued_in_time:
            return start.elapsed_time(end) / repeats
        cycles *= 4
    raise RuntimeError("device_ms: the device reached the start event before the "
                       "host had queued the calls, four times")
