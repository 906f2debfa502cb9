"""Device time from a profiler trace.

`trace_device_time` runs a function under `jax.profiler.trace` and reads the
GPU planes of the trace it wrote: busy time is the union of the intervals of
the events on the device's stream lines (kernels and copies), and each
event name's summed duration is that kernel's time.
"""

from __future__ import annotations

import collections
import glob
import os


def union_ns(intervals) -> float:
    """Total length covered by (start_ns, end_ns) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def device_events(xplane_path: str):
    """(name, start_ns, end_ns) of every event on a GPU stream line."""
    from jax.profiler import ProfileData

    out = []
    for plane in ProfileData.from_file(xplane_path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if line.name.startswith("Stream"):
                out += [(e.name, e.start_ns, e.end_ns) for e in line.events]
    return out


def trace_device_time(fn, reps: int, logdir: str) -> dict:
    """Run `fn` (which must block on its result) `reps` times under the
    profiler. Returns busy ms per call, the traced window's ms per call and
    the top kernels' ms per call. Raises if no device event was recorded."""
    import jax

    with jax.profiler.trace(logdir):
        for _ in range(reps):
            fn()
    path = max(
        glob.glob(os.path.join(logdir, "plugins", "profile", "*", "*.xplane.pb")),
        key=os.path.getmtime,
    )
    events = device_events(path)
    if not events:
        from jax.profiler import ProfileData

        lines = [(p.name, [ln.name for ln in p.lines])
                 for p in ProfileData.from_file(path).planes]
        raise RuntimeError(f"no GPU stream events in {path}: {lines}")
    per_name = collections.Counter()
    for name, s, e in events:
        per_name[name] += (e - s) / 1e6 / reps
    return {
        "busy_ms": union_ns((s, e) for _, s, e in events) / 1e6 / reps,
        "window_ms": (max(e for *_, e in events) - min(s for _, s, _ in events))
        / 1e6 / reps,
        "kernels_ms": dict(per_name.most_common(8)),
    }
