"""Device timing with CUDA events.

PyTorch returns before the device finishes, so a host clock around a launch
measures the enqueue. Events recorded on the stream before and after the work
measure the device's time for it.
"""

from __future__ import annotations

import statistics

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
