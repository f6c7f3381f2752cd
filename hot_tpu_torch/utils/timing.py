"""The program's tracer: spans around the step's layers, and counters.

Counterpart of ``hot_tpu.utils.timing``. One tracer, ``TRACER``, holds
every span and counter of the process.

Spans. ``span(name)`` is a context manager around one piece of the step.
While tracing is off (the default) it checks one flag and returns a shared
no-op object: no clock is read, no event made, nothing kept. While it is
on, each span keeps its name, its start and end on ``CLOCK``, its parent
(the span open around it), the step and attempt it ran in (so a dt
retry's spans stay apart) and, where the state lives on the card, a pair
of CUDA events recorded on the stream current when the step began. The
events are resolved to device milliseconds after the fact (``device_ms``),
never by a synchronise inside a span, and go back to a pool when their
spans are folded or cleared (making and recording a new event costs about
four times what recording a pooled one does). A root span (one with no parent) also keeps
the counters' increase inside it. Spans stay in memory until the caller
takes them (``take``) or folds them into totals per name (``fold``).

``CLOCK`` is the clock of torch.profiler's events: an event's relative time
plus ``prof.profiler.kineto_results.trace_start_ns()`` is a ``CLOCK``
reading, so a device interval of a profiler trace can be set against the
spans open on the host at that moment.

Tracing is on while a caller has turned it on (``TRACER.enable()``) and,
with ``TRACER.follow_profiler`` (the default), while torch.profiler
records: ``Simulation.step`` looks once per step (``TRACER.begin_step``),
so a profiled stretch of steps carries the program's spans and a new
profiled stretch starts from none.

Counters. ``count(name, n)`` adds to one dict, whether tracing is on or
not. Two helpers mark the sites on the step's path:

  * ``synced(value)``: the host waits for the device here: a read-back
    (``.tolist()``, ``.item()``, ``float()``, ``int()``, ``bool()`` of a
    device tensor) or an operation whose output size the host has to know
    (``torch.nonzero``, ``torch.unique``, ``unique_consecutive``,
    boolean-mask indexing, a checked factorisation). It counts
    ``host_syncs``.
  * ``h2d(tensor)``: host data copied to the device (``torch.tensor(list,
    device=...)``, ``torch.as_tensor(ndarray, device=...)``). It counts
    ``h2d_copies``, and ``host_syncs`` too: a copy from pageable memory
    waits for the stream.

The kernels' wrappers count their launches (``launches.fused_apply``,
``launches.fused_linearize``, ``launches.bsr_spmv``). A site counts
whether its tensors live on the card or not; on the CPU the kernels' plain
versions run in their place, launch nothing and build stencils, whose
copies count.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

# the clock of torch.profiler's events (see the module doc)
CLOCK = time.time_ns


class Span:
    """One recorded span: host times in ns on CLOCK; parent is the index of
    the enclosing span in the tracer's list (-1 for a root)."""

    __slots__ = ("name", "start", "end", "parent", "step", "attempt", "events", "counts")

    def __init__(self, name: str, start: int, parent: int, step: int, attempt: int, events):
        self.name, self.start, self.end, self.parent = name, start, start, parent
        self.step, self.attempt, self.events, self.counts = step, attempt, events, None

    @property
    def host_ms(self) -> float:
        return (self.end - self.start) * 1e-6


class _NoSpan:
    """The span of tracing off: enters and leaves, and keeps nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


class _Open:
    """An open span of tracing on."""

    __slots__ = ("tracer", "index")

    def __init__(self, tracer: "Tracer", index: int):
        self.tracer, self.index = tracer, index

    def __enter__(self):
        return self.tracer.spans[self.index]

    def __exit__(self, *exc):
        self.tracer._close(self.index)
        return False


NO_SPAN = _NoSpan()


class Tracer:
    """Spans and counters of the process (see the module doc)."""

    def __init__(self):
        self.on = False
        self.follow_profiler = True
        self._explicit = False
        self._by_profiler = False
        self.events = False           # record CUDA events (the state is on the card)
        self.stream = None
        self._pool: list = []         # CUDA events of dropped spans, for reuse
        self.step = 0
        self.attempt = 0
        self.spans: List[Span] = []
        self.counts: Dict[str, int] = defaultdict(int)
        self.totals: Dict[str, List[float]] = {}
        self._stack: List[int] = []
        self._root_counts: Optional[dict] = None

    # ---- switching
    def enable(self):
        """Turn spans on until ``disable``."""
        self._explicit = True
        self.on = True

    def disable(self):
        self._explicit = False
        self.on = self._by_profiler

    def begin_step(self, step: int, on_card: bool):
        """Called once per step, outside every span: the step's number,
        whether to record CUDA events, and (with follow_profiler) whether
        torch.profiler records. A profiled stretch that starts here starts
        from no spans."""
        self.step, self.attempt, self.events = step, 0, on_card
        self.stream = torch.cuda.current_stream() if on_card else None
        profiling = self.follow_profiler and torch.autograd._profiler_enabled()
        if profiling and not self._by_profiler and not self._explicit:
            self.clear()
        self._by_profiler = profiling
        self.on = self._explicit or profiling

    # ---- spans
    def open(self, name: str):
        parent = self._stack[-1] if self._stack else -1
        events = None
        if self.events:
            pool = self._pool
            events = ((pool.pop(), pool.pop()) if len(pool) >= 2 else
                      (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)))
            events[0].record(self.stream)
        if parent < 0:
            self._root_counts = dict(self.counts)
        index = len(self.spans)
        self.spans.append(Span(name, CLOCK(), parent, self.step, self.attempt, events))
        self._stack.append(index)
        return _Open(self, index)

    def _close(self, index: int):
        s = self.spans[index]
        if s.events is not None:
            s.events[1].record(self.stream)
        s.end = CLOCK()
        self._stack.pop()
        if s.parent < 0:
            before = self._root_counts
            s.counts = {k: v - before.get(k, 0) for k, v in self.counts.items()
                        if v != before.get(k, 0)}

    def clear(self):
        """Drop the recorded spans (none may be open); their events go
        back to the pool."""
        self._recycle(self.take())

    def take(self) -> List[Span]:
        """Hand out the recorded spans (with their events) and start from
        none."""
        if self._stack:
            raise RuntimeError(f"{len(self._stack)} spans are open")
        spans, self.spans = self.spans, []
        return spans

    def _recycle(self, spans: List[Span]):
        self._pool.extend(e for s in spans if s.events is not None for e in s.events)

    def device_ms(self, s: Span) -> Optional[float]:
        """Device milliseconds between a span's events (None without
        events); its end event must have completed."""
        return None if s.events is None else s.events[0].elapsed_time(s.events[1])

    def wait_for_events(self, spans: List[Span]):
        """Wait for the last span's end event (after the spans, never
        inside one), so that every span's events can be read."""
        last = next((s.events[1] for s in reversed(spans) if s.events is not None), None)
        if last is not None:
            last.synchronize()

    def fold(self):
        """Add the recorded spans into ``totals`` (per name: count, host
        ms, self ms, device ms) and drop them, so a long run keeps a table
        and not every span."""
        spans = self.take()
        self.wait_for_events(spans)
        child_ms = [0.0] * len(spans)
        for s in spans:
            if s.parent >= 0:
                child_ms[s.parent] += s.host_ms
        for s, inner in zip(spans, child_ms):
            row = self.totals.setdefault(s.name, [0, 0.0, 0.0, 0.0])
            row[0] += 1
            row[1] += s.host_ms
            row[2] += s.host_ms - inner
            row[3] += self.device_ms(s) or 0.0
        self._recycle(spans)

    def report(self) -> str:
        """The totals per span name (the recorded spans folded in first),
        longest first, and the counters."""
        self.fold()
        lines = [f"{'span':<22} {'count':>8} {'total_ms':>12} {'self_ms':>12} {'device_ms':>12}"]
        for name, (n, total, own, dev) in sorted(self.totals.items(), key=lambda kv: -kv[1][1]):
            lines.append(f"{name:<22} {n:8d} {total:12.3f} {own:12.3f} {dev:12.3f}")
        lines.append("")
        lines.append(f"{'counter':<30} {'count':>12}")
        for name in sorted(self.counts):
            lines.append(f"{name:<30} {self.counts[name]:12d}")
        return "\n".join(lines) + "\n"


TRACER = Tracer()


def span(name: str):
    """A span around a block (see the module doc)."""
    if not TRACER.on:
        return NO_SPAN
    return TRACER.open(name)


def count(name: str, n: int = 1):
    """Add n to the counter `name`."""
    TRACER.counts[name] += n


def synced(value):
    """Mark a point where the host waits for the device; returns value."""
    TRACER.counts["host_syncs"] += 1
    return value


def h2d(tensor):
    """Mark a copy of host data to the device (which waits for the stream);
    returns the tensor."""
    counts = TRACER.counts
    counts["h2d_copies"] += 1
    counts["host_syncs"] += 1
    return tensor
