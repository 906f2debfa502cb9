"""Wall-clock and per-stage timers.

Analog of utils/timer.h (CPUTimer gettimeofday pair, GPUTimer
cudaEvent pair): device work is timed by bracketing with
`jax.block_until_ready`, which is the faithful equivalent of an event pair on
the dispatch stream. Stage breakdowns mirror the reference's 8/9-bucket report
(BANG_Base/bang_search.cu:1028-1051; BANG_Inmemory/parANN.cu:803-823).
"""

from __future__ import annotations

import collections
import contextlib
import time


class CPUTimer:
    """Start/stop accumulating wall-clock timer (milliseconds)."""

    def __init__(self) -> None:
        self.total_ms = 0.0
        self._t0 = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = (time.perf_counter() - self._t0) * 1000.0
        self.total_ms += dt
        self._t0 = None
        return dt


class StageTimers:
    """Named stage accumulator with an enable flag (ENABLE_GPU_STATS analog)."""

    def __init__(self, enabled: bool = True) -> None:
        self.enabled = enabled
        self.ms = collections.defaultdict(float)

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        yield
        if block_on is not None:
            import jax

            jax.block_until_ready(block_on)
        self.ms[name] += (time.perf_counter() - t0) * 1000.0

    def report(self) -> str:
        lines = [f"{name:32s} {ms:10.3f} ms" for name, ms in sorted(self.ms.items())]
        return "\n".join(lines)
