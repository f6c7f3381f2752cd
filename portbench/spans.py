"""The program's spans and counters, set against the device trace.

The program (``hot_tpu_torch.utils.timing``) records spans and counters
while torch.profiler records, so a traced run's profiled segment leaves
them in the program's tracer. ``program`` gives them to the per-layer
metric readers as ``trace.program``:

* ``spans``: one dict per span, in the order they opened: ``name``,
  ``start`` and ``end`` (ns on the profiler's clock), ``parent`` (index,
  -1 for a root), ``step``, ``attempt`` and ``device_ms`` (None without
  CUDA events);
* ``counts``: each counter's increase over the recorded steps
  (``host_syncs``, ``h2d_copies``, ``launches.<kernel>``).

A reader takes ``trace.program`` where the harness sets it, else this
module builds it from the tracer. Where the program has no tracer, or
recorded no span, it is None and the readers return None.

``trace.device`` is the profiled segment's device intervals on the same
clock (``device_intervals``): ``[(start ns, end ns, name)]``, sorted. The
harness does not set it yet; ``main`` below does, for its own runs.
``idle_by_span`` puts each idle gap of the device down to the innermost
span open on the host at that time.

    python3 portbench/spans.py --workload bar128-mg.twist --seed 7 --seconds 51 [--spans 0]

runs one traced run of the cell (``--trace 1``), with ``trace.device`` and
``trace.program`` given to the readers, and the readers of the idle
metrics that have no entry in ``BENCHMARK.json`` read too. It prints the
result line, and on standard error a ``trace: idle by span`` line: the
profiled segment's idle seconds by innermost span, top 10, and their sum
beside ``idle_share`` x window. ``--spans 0`` keeps the program's spans off
(the tracer does not follow the profiler), to measure what they cost.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import bisect  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from pathlib import Path  # noqa: E402

NO_SPAN = "(no span)"
# per-layer metrics that read trace.device, which the harness does not set
IDLE_METRICS = ({"name": "build_idle_ms", "unit": "ms"}, {"name": "cg_idle_ms", "unit": "ms"})


def tracer():
    """The program's tracer, or None where the program has none."""
    try:
        from hot_tpu_torch.utils import timing
    except ImportError:
        return None
    return getattr(timing, "TRACER", None)


def program_of(tr) -> dict | None:
    """trace.program (see the module doc) from the tracer's recorded spans,
    their events waited for and read; None without spans."""
    spans = list(getattr(tr, "spans", None) or [])
    if not spans:
        return None
    tr.wait_for_events(spans)
    counts = defaultdict(int)
    for s in spans:
        for k, v in (s.counts or {}).items():
            counts[k] += v
    return {"spans": [{"name": s.name, "start": s.start, "end": s.end, "parent": s.parent,
                       "step": s.step, "attempt": s.attempt, "device_ms": tr.device_ms(s)}
                      for s in spans],
            "counts": dict(counts)}


def program(trace) -> dict | None:
    """trace.program, built from the program's tracer where the harness
    did not set it (and kept on the trace for the next reader)."""
    given = getattr(trace, "program", None)
    if given is not None:
        return given
    tr = tracer()
    got = program_of(tr) if tr is not None else None
    if got is not None:
        try:
            trace.program = got
        except AttributeError:
            pass
    return got


def named(prog: dict, name: str, parent: str | None = None) -> list:
    """The spans called `name` (whose parent is called `parent`, if given)."""
    spans = prog["spans"]
    return [s for s in spans if s["name"] == name
            and (parent is None or (s["parent"] >= 0 and spans[s["parent"]]["name"] == parent))]


def device_intervals(events, trace_start_ns: int) -> list:
    """[(start ns, end ns, name)] of the device operations of a profiler's
    events, on the profiler's clock, sorted."""
    from portbench import trace as trace_mod

    return sorted((trace_start_ns + int(ev.time_range.start * 1e3),
                   trace_start_ns + int(ev.time_range.end * 1e3), ev.name)
                  for ev in events if trace_mod._is_device(ev))


def _own_time(spans: list) -> list:
    """(start, end, span index) pieces of time in which each span is the
    innermost open one, sorted by start (spans nest, in the order opened)."""
    children = defaultdict(list)
    for i, s in enumerate(spans):
        if s["parent"] >= 0:
            children[s["parent"]].append(i)
    pieces = []
    for i, s in enumerate(spans):
        cursor = s["start"]
        for c in children[i]:
            if spans[c]["start"] > cursor:
                pieces.append((cursor, spans[c]["start"], i))
            cursor = max(cursor, spans[c]["end"])
        if s["end"] > cursor:
            pieces.append((cursor, s["end"], i))
    pieces.sort()
    return pieces


def idle_gaps(device: list, w0: int, w1: int) -> list:
    """(start, end) of the times in [w0, w1] at which no device operation ran."""
    gaps, cursor = [], w0
    for s, e, _ in device:
        if e <= cursor:
            continue
        if s >= w1:
            break
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if cursor < w1:
        gaps.append((cursor, w1))
    return gaps


def idle_by_span(spans: list, device: list, window=None) -> tuple:
    """(idle ns per span index, idle ns under no span): each idle gap of the
    device inside `window` (default: the first root span's start to the last
    root span's end) split over the spans innermost on the host during it."""
    roots = [s for s in spans if s["parent"] < 0]
    if window is None:
        window = (roots[0]["start"], max(s["end"] for s in roots)) if roots else (0, 0)
    pieces = _own_time(spans)
    starts = [p[0] for p in pieces]
    per_span = defaultdict(int)
    outside = 0
    for g0, g1 in idle_gaps(device, *window):
        covered = 0
        k = max(bisect.bisect_right(starts, g0) - 1, 0)
        while k < len(pieces) and pieces[k][0] < g1:
            s, e, i = pieces[k]
            overlap = min(e, g1) - max(s, g0)
            if overlap > 0:
                per_span[i] += overlap
                covered += overlap
            k += 1
        outside += (g1 - g0) - covered
    return dict(per_span), outside


def inside(spans: list, name: str) -> list:
    """Per span: it or an enclosing span is called `name`."""
    out = []
    for s in spans:
        out.append(s["name"] == name or (s["parent"] >= 0 and out[s["parent"]]))
    return out


def idle_table(spans: list, device: list, top: int = 10) -> list:
    """[[innermost span name, idle seconds]], top `top` by idle seconds."""
    per_span, outside = idle_by_span(spans, device)
    by_name = defaultdict(int)
    for i, ns in per_span.items():
        by_name[spans[i]["name"]] += ns
    if outside:
        by_name[NO_SPAN] += outside
    return [[n, ns * 1e-9] for n, ns in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]


def idle_ms_per(trace, under: str, per: list, outside: tuple = ()) -> float | None:
    """Device idle ms with the host inside a span called `under` and inside
    none called as in `outside`, over len(per) (None where the trace lacks
    the device intervals or the spans)."""
    prog, device = program(trace), getattr(trace, "device", None)
    if prog is None or not device or not per:
        return None
    spans = prog["spans"]
    per_span, _ = idle_by_span(spans, device)
    keep = inside(spans, under)
    for name in outside:
        keep = [k and not o for k, o in zip(keep, inside(spans, name))]
    return sum(ns for i, ns in per_span.items() if keep[i]) * 1e-6 / len(per)


# ---------------------------------------------------------------------------
# one traced run with trace.device and trace.program set
# ---------------------------------------------------------------------------


def traced_run(resolved: dict, seed: int, seconds: float, device, t0: float,
               spans_on: bool = True):
    """harness.run_cell's traced run of the resolved cell, with
    trace.device and trace.program set for the readers and the idle
    metrics read too: (result line, idle table line or None). spans_on
    False keeps the program's spans off."""
    import torch

    from portbench import harness

    tr = tracer()
    kept = {}

    class KeepingProfile(torch.profiler.profile):
        """The harness's profiler, keeping the device intervals on exit."""

        def __exit__(self, *exc):
            out = super().__exit__(*exc)
            kept["device"] = device_intervals(
                self.events(), self.profiler.kineto_results.trace_start_ns())
            return out

    class Trace(harness.Trace):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.device = kept.get("device", [])
            self.program = program_of(tr) if tr is not None else None
            kept["trace"] = self

    resolved = dict(resolved)
    have = {m["name"] for m in resolved["per_layer"]}
    resolved["per_layer"] = resolved["per_layer"] + [m for m in IDLE_METRICS
                                                     if m["name"] not in have]
    saved = torch.profiler.profile, harness.Trace, getattr(tr, "follow_profiler", None)
    torch.profiler.profile, harness.Trace = KeepingProfile, Trace
    if tr is not None:
        tr.follow_profiler = spans_on
    try:
        result = harness.run_cell(resolved, seed, seconds, True, device, t0)
    finally:
        torch.profiler.profile, harness.Trace = saved[:2]
        if tr is not None:
            tr.follow_profiler = saved[2]
    trace = kept.get("trace")
    if trace is None or trace.program is None:
        return result, None
    spans = trace.program["spans"]
    every = idle_table(spans, trace.device, top=len(spans) + 1)
    share = result["metrics"].get("idle_share", {}).get("value")
    return result, {"top": every[:10], "sum_s": sum(s for _, s in every),
                    "idle_share_x_window_s": None if share is None
                    else share / 100 * result["device"]["window_s"]}


def main(argv, t0: float) -> int:
    import argparse

    import torch

    from portbench import cells

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--spans", type=int, choices=(0, 1), default=1)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench/spans.py needs a CUDA device", file=sys.stderr)
        return 2
    result, table = traced_run(cells.resolve(args.workload), args.seed, args.seconds,
                               torch.device("cuda", 0), t0, bool(args.spans))
    if table is not None:
        print(f"trace: idle by span {json.dumps(table)}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    sys.exit(main(sys.argv[1:], T0))
