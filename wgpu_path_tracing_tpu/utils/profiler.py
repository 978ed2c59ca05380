"""Profiling / observability.

Equivalent of the reference's two-tier instrumentation (SURVEY.md §5):

* ``PassProfiler`` replaces WebGPUProfiler (src/utils/profiler.ts:45-140):
  named per-pass wall timings via ``block_until_ready`` fences, exposed as
  rolling statistics. Where the reference injects GPU timestamp queries per
  pass, here each profiled section forces device completion, so timings are
  true device wall-clock.
* ``FrameMeter`` replaces the FPS meter (src/ui/fps-meter.tsx:3-141): a
  rolling window (default 100 samples, as the reference) of frame times with
  fps/avg/min/max.
* ``trace_annotation`` bridges to jax.profiler for xprof/perfetto capture.
"""

from __future__ import annotations

import collections
import contextlib
import time

import jax


class PassProfiler:
    def __init__(self, window: int = 100):
        self.window = window
        self._samples: dict[str, collections.deque] = {}

    @contextlib.contextmanager
    def section(self, label: str, sync=None):
        """Time a named pass. ``sync``: value(s) to block_until_ready on exit
        (pass the pass's outputs for accurate device timing)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                jax.block_until_ready(sync)
            self.add(label, time.perf_counter() - t0)

    def add(self, label: str, seconds: float) -> None:
        self._samples.setdefault(
            label, collections.deque(maxlen=self.window)
        ).append(seconds)

    def stats(self) -> dict:
        """Per-label {last, avg, min, max} in milliseconds (profiler.ts:138
        getStats equivalent)."""
        out = {}
        for label, q in self._samples.items():
            ms = [s * 1e3 for s in q]
            out[label] = {
                "last_ms": ms[-1],
                "avg_ms": sum(ms) / len(ms),
                "min_ms": min(ms),
                "max_ms": max(ms),
                "count": len(ms),
            }
        return out


class FrameMeter:
    """Rolling FPS / frame-time meter (fps-meter.tsx semantics: 100-sample
    buffer, stats over the window)."""

    def __init__(self, window: int = 100):
        self._times = collections.deque(maxlen=window)
        self._last = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
        self._last = now

    def stats(self) -> dict:
        if not self._times:
            return {"fps": 0.0, "frame_ms": 0.0, "min_ms": 0.0, "max_ms": 0.0}
        avg = sum(self._times) / len(self._times)
        return {
            "fps": 1.0 / avg if avg > 0 else 0.0,
            "frame_ms": avg * 1e3,
            "min_ms": min(self._times) * 1e3,
            "max_ms": max(self._times) * 1e3,
        }


@contextlib.contextmanager
def trace_annotation(name: str):
    """Annotate a region for jax.profiler captures (xprof/perfetto)."""
    with jax.profiler.TraceAnnotation(name):
        yield


def mrays_per_sec(ray_count: int, seconds: float) -> float:
    return ray_count / max(seconds, 1e-12) / 1e6
