"""Reduction of a torch.profiler trace of one whole segment.

A traced run profiles one segment for device activity only, which barely
slows the host. From it ``device_summary`` takes the union of device
intervals (kernels, copies, sets) as ``busy_s``, the segment's wall time as
``window_s``, and each kernel's device time and launches; ``idle_gaps``
takes the gaps between device intervals, each named by the device
operation that ended it (what the card waited for), summed by name.

No trace file is written.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

from torch.autograd import DeviceType

NAME_CHARS = 80


def _is_device(ev) -> bool:
    return ev.device_type == DeviceType.CUDA and not getattr(ev, "is_user_annotation", False)


def _union(intervals):
    """(busy length, gaps) of intervals sorted by start."""
    busy, gaps = 0.0, []
    cursor = intervals[0][0] if intervals else None
    for s, e in intervals:
        if s > cursor:
            gaps.append((cursor, s))
        if e > cursor:
            busy += e - max(s, cursor)
            cursor = e
    return busy, gaps


def device_summary(events, window_s: float) -> dict:
    device = sorted((ev.time_range.start, ev.time_range.end, ev.name)
                    for ev in events if _is_device(ev))
    kernels = defaultdict(lambda: [0.0, 0])
    for s, e, name in device:
        k = kernels[name]
        k[0] += (e - s) * 1e-6
        k[1] += 1
    busy, _ = _union([(s, e) for s, e, _ in device])
    return {"busy_s": busy * 1e-6, "window_s": window_s,
            "kernels": {n: {"seconds": v[0], "count": v[1]} for n, v in kernels.items()}}


def idle_gaps(events) -> dict:
    """Seconds of device idle between the segment's first and last device
    operation, by the operation that ended each gap."""
    device = sorted((ev.time_range.start, ev.time_range.end, ev.name)
                    for ev in events if _is_device(ev))
    _, gaps = _union([(s, e) for s, e, _ in device])
    starts = [s for s, _, _ in device]
    idle = defaultdict(float)
    for g0, g1 in gaps:
        idle[device[bisect.bisect_left(starts, g1)][2][:NAME_CHARS]] += (g1 - g0) * 1e-6
    return dict(idle)


def kernel_time(summary: dict, name: str):
    """(seconds, launches) of the device kernels whose name contains `name`."""
    sel = [v for k, v in summary["kernels"].items() if name in k]
    return sum(v["seconds"] for v in sel), sum(v["count"] for v in sel)


def breakdown(summary: dict, gaps: dict, top: int = 10) -> dict:
    ops = sorted(summary["kernels"].items(), key=lambda kv: -kv[1]["seconds"])[:top]
    worst = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:160], v["seconds"]] for n, v in ops],
            "idle_gaps": [[n[:160], s] for n, s in worst]}
