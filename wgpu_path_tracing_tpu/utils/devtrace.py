"""Device time from a ``jax.profiler`` trace (GPU device planes).

``trace_device(fn)`` runs ``fn`` (which must end synced) under the
profiler and returns the device events of the trace: every event on a
``/device:GPU:N`` plane's kernel lines (the stream lines; the derived
"XLA Modules" / "XLA Ops" lines repeat the same time and are skipped).
``busy_ms`` merges their intervals. Event names are the kernels' (a
Pallas kernel keeps the ``name=`` given to ``pallas_call``).

A trace with no device events raises: a number from a host-only trace
must never be read as device time.
"""

from __future__ import annotations

import glob
import os
import shutil
import tempfile
from typing import Callable, NamedTuple

import jax

DEVICE_PLANE_PREFIX = "/device:GPU:"
DERIVED_LINES = ("XLA Modules", "XLA Ops", "Steps", "Framework Ops",
                 "Launch Stats", "Source code")


class DeviceEvent(NamedTuple):
    name: str
    start_ns: float
    dur_ns: float


def device_events(xplane_path: str) -> list[DeviceEvent]:
    """Kernel events of every GPU device plane in one ``.xplane.pb``."""
    data = jax.profiler.ProfileData.from_file(xplane_path)
    out = []
    for plane in data.planes:
        if not plane.name.startswith(DEVICE_PLANE_PREFIX):
            continue
        for line in plane.lines:
            if line.name.startswith(DERIVED_LINES):
                continue
            out.extend(DeviceEvent(ev.name, ev.start_ns, ev.duration_ns)
                       for ev in line.events)
    return out


def describe(xplane_path: str) -> list[str]:
    """Plane and line names with event counts, for reading a trace by hand."""
    data = jax.profiler.ProfileData.from_file(xplane_path)
    rows = []
    for plane in data.planes:
        for line in plane.lines:
            evs = list(line.events)
            names = sorted({e.name for e in evs})[:6]
            rows.append(f"{plane.name} | {line.name} | {len(evs)} | {names}")
    return rows


def trace_device(fn: Callable[[], object]) -> list[DeviceEvent]:
    """Run ``fn`` under the profiler; return its device events."""
    d = tempfile.mkdtemp(prefix="devtrace_", dir=os.environ.get("TMPDIR"))
    try:
        with jax.profiler.trace(d):
            fn()
        paths = glob.glob(os.path.join(d, "plugins", "profile", "*",
                                       "*.xplane.pb"))
        events = [e for p in paths for e in device_events(p)]
        if not events:
            planes = [row for p in paths for row in describe(p)]
            raise RuntimeError(
                "profiler trace holds no GPU device events (no device "
                f"plane named {DEVICE_PLANE_PREFIX}*): device time not "
                "measured. Planes | lines | events: " + "; ".join(planes))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return events


def busy_ms(events: list[DeviceEvent]) -> float:
    """Union of the event intervals, in ms."""
    spans = sorted((e.start_ns, e.start_ns + e.dur_ns) for e in events)
    busy = 0.0
    end = float("-inf")
    for s, e in spans:
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e6
