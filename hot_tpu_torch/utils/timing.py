"""Per-phase timers.

Counterpart of ``hot_tpu.utils.timing``. Device work is asynchronous, so on
a CUDA device a scope is timed with CUDA events recorded on the current
stream and the end event is synchronised when the scope closes; on the CPU
it is timed with the host clock.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


class PhaseTimer:
    """Aggregates seconds per named phase on one device."""

    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def scope(self, name: str):
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            try:
                yield
            finally:
                end.record()
                end.synchronize()
                self.totals[name] += start.elapsed_time(end) / 1e3
                self.counts[name] += 1
        else:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.totals[name] += time.perf_counter() - t0
                self.counts[name] += 1

    def snapshot(self) -> dict:
        return {k: {"total_s": self.totals[k], "count": self.counts[k]} for k in self.totals}

    def reset(self):
        self.totals.clear()
        self.counts.clear()

    def report(self) -> str:
        lines = ["phase                          total(s)    count   mean(ms)"]
        for name in sorted(self.totals, key=lambda k: -self.totals[k]):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name:<30} {t:9.3f} {c:8d} {1e3 * t / max(c, 1):10.2f}")
        return "\n".join(lines)
