"""The port's tracer (hot_tpu_torch.utils.timing) on the CPU: off, it
records nothing and costs one flag check; on, spans nest with parents and
self times, one step's spans match its StepStats under block-Jacobi and
under config 3 (and the lagged Galerkin refresh), the read-backs are
counted, spans follow torch.profiler and stand on its clock, and the CLI
writes its timers.txt from the tracer. The card's checks are in
tests/test_torch_tracing_card.py."""

import collections
import time

import pytest
import torch

from hot_tpu_torch import cli
from hot_tpu_torch.scenes import build_scene
from hot_tpu_torch.sim import Simulation
from hot_tpu_torch.utils import timing
from hot_tpu_torch.utils.config import config_from_overrides
from hot_tpu_torch.utils.timing import span

from test_torch_ref import one_torch_thread  # noqa: F401

CONFIG3 = {"solver.preconditioner": "multigrid", "solver.multigrid.levels": 3,
           "solver.multigrid.smoother": "chebyshev", "solver.multigrid.coarse_solver": "direct",
           "solver.multigrid.assembled": True}
CASES = {"block_jacobi": ({}, 0),
         "config3": (CONFIG3, 0),
         "config3_lagged": (dict(CONFIG3, **{"solver.multigrid.rap_refresh": "lagged"}), 1)}


@pytest.fixture(autouse=True)
def fresh_tracer(monkeypatch):
    """Each test on a tracer of its own, off, following the profiler."""
    tracer = timing.Tracer()
    monkeypatch.setattr(timing, "TRACER", tracer)
    for mod in ("hot_tpu_torch.sim.simulation", "hot_tpu_torch.cli"):
        module = __import__(mod, fromlist=["x"])
        if hasattr(module, "TRACER"):
            monkeypatch.setattr(module, "TRACER", tracer)
    return tracer


def _bar(overrides=None):
    scene = build_scene("twisting_bar_3d", device="cpu", res=16, ppc=2, dtype=torch.float64)
    cfg = config_from_overrides(scene["cfg"], overrides or {})
    return Simulation(cfg, scene["state"], scene["model"], scene["colliders"])


def test_off_records_nothing_and_costs_a_flag_check(fresh_tracer, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("tracing off read a clock or made an event")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(timing, "CLOCK", refuse)
    sim = _bar()
    before = dict(fresh_tracer.counts)
    stats = sim.step(8e-3)
    assert stats.cg_iters > 0 and fresh_tracer.spans == []
    # the counters count with spans off
    assert fresh_tracer.counts["host_syncs"] > before.get("host_syncs", 0)
    assert span("a") is span("b") is timing.NO_SPAN

    n = 20000

    def loop(make):
        t0 = time.perf_counter()
        for _ in range(n):
            with make("x"):
                pass
        return (time.perf_counter() - t0) / n

    cost = min(loop(span) for _ in range(5))
    print(f"span() with tracing off: {cost * 1e9:.0f} ns a call")
    assert cost < 2e-6, cost


def test_nesting_parents_self_time_and_fold(fresh_tracer, monkeypatch):
    ticks = iter(range(0, 10 ** 9, 10 ** 6))          # 1 ms a reading
    monkeypatch.setattr(timing, "CLOCK", lambda: next(ticks))
    fresh_tracer.enable()
    fresh_tracer.step, fresh_tracer.attempt = 7, 1
    with span("outer") as outer:
        timing.synced(None)
        with span("inner"):
            timing.h2d(None)
        with span("inner"):
            pass
    with span("second"):
        pass
    spans = list(fresh_tracer.spans)
    assert [(s.name, s.parent) for s in spans] == [("outer", -1), ("inner", 0), ("inner", 0),
                                                    ("second", -1)]
    assert spans[0] is outer and all((s.step, s.attempt) == (7, 1) for s in spans)
    assert [s.host_ms for s in spans] == [5.0, 1.0, 1.0, 1.0]
    # a root span keeps the counters' increase inside it
    assert spans[0].counts == {"host_syncs": 2, "h2d_copies": 1} and spans[3].counts == {}
    assert spans[1].counts is None and all(s.events is None for s in spans)
    fresh_tracer.fold()
    assert fresh_tracer.spans == []
    assert fresh_tracer.totals == {"outer": [1, 5.0, 3.0, 0.0], "inner": [2, 2.0, 2.0, 0.0],
                                   "second": [1, 1.0, 1.0, 0.0]}
    with pytest.raises(RuntimeError, match="open"):
        with span("open"):
            fresh_tracer.clear()


@pytest.mark.parametrize("case", list(CASES))
def test_one_step_spans_match_step_stats(fresh_tracer, case):
    overrides, base_builds = CASES[case]
    sim = _bar(overrides)
    fresh_tracer.enable()
    stats = sim.step(8e-3)
    spans = fresh_tracer.take()
    names = collections.Counter(s.name for s in spans)
    assert stats.converged and stats.newton_iters >= 1
    assert names["step"] == names["attempt"] == names["newton"] == 1
    assert names["newton.iter"] == stats.newton_iters
    assert names["cg.iter"] == stats.cg_iters
    assert names["cg"] == stats.newton_iters
    assert names["linearize"] == stats.newton_iters + 1
    assert names["precond_build"] == stats.newton_iters + base_builds
    for layer in ("p2g", "grid_bc", "g2p", "diagnostics"):
        assert names[layer] == 1, (layer, names)
    if case != "block_jacobi":
        assert names["mg_static"] == 1 and names["vcycle"] >= stats.cg_iters
        assert names["mg.assemble"] == names["precond_build"]
        assert names["mg.rap"] >= stats.newton_iters and names["mg.smoother_data"] > 0
    by_index = {i: s for i, s in enumerate(spans)}
    for s in spans:
        if s.name == "cg.iter":
            assert by_index[s.parent].name == "cg"
        if s.name.startswith("mg."):
            assert by_index[s.parent].name == "precond_build"
    # the step's read-backs: at least one per CG and per Newton iteration
    (root,) = [s for s in spans if s.parent < 0]
    assert root.name == "step" and (root.step, root.attempt) == (1, 0)
    assert root.counts["host_syncs"] >= stats.cg_iters + stats.newton_iters
    assert root.counts["h2d_copies"] > 0


def test_host_syncs_rise_by_one_per_cg_iteration(fresh_tracer):
    from hot_tpu_torch.solver.cg import cg_solve

    A = torch.diag(torch.arange(1.0, 41.0, dtype=torch.float64))
    b = torch.ones(40, dtype=torch.float64)
    before = fresh_tracer.counts["host_syncs"]
    res = cg_solve(lambda x: A @ x, b, tol=1e-10, max_iters=30)
    # one read-back per iteration and one for the result's flag
    assert res.iters == 30
    assert fresh_tracer.counts["host_syncs"] - before == res.iters + 1


def test_spans_follow_the_profiler_on_its_clock(fresh_tracer):
    scene = build_scene("block_drop_2d", device="cpu", res=16, dtype=torch.float64)
    sim = Simulation(scene["cfg"], scene["state"], scene["model"], scene["colliders"])
    sim.step(8e-3)
    assert fresh_tracer.spans == [] and not fresh_tracer.on
    a = torch.rand(200, 200, dtype=torch.float64)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        sim.step(8e-3)                                    # recorded: the profiler is on
        with span("mm"):
            a @ a
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    spans = list(fresh_tracer.spans)
    assert spans[0].name == "step" and spans[-1].name == "mm" and spans[0].step == 2
    # the step's own products come first; the last is the span's
    mm = max((ev for ev in prof.events() if ev.name == "aten::mm"),
             key=lambda ev: ev.time_range.start)
    lo, hi = start_ns + mm.time_range.start * 1e3, start_ns + mm.time_range.end * 1e3
    assert spans[-1].start <= lo <= hi <= spans[-1].end
    # the next step, with the profiler off, turns spans off and keeps them
    sim.step(8e-3)
    assert not fresh_tracer.on and len(fresh_tracer.spans) == len(spans)


def test_cli_writes_timers_from_the_tracer(fresh_tracer, tmp_path):
    out = tmp_path / "run"
    rc = cli.main(["--scene", "block_drop_2d", "--device", "cpu", "--max-steps", "2",
                   "--scene-arg", "res=16", "--frames", "1", "-o", str(out), "--quiet",
                   "--frame-format", "npz", "--checkpoint-every", "0"])
    assert rc == 0 and not fresh_tracer.on and fresh_tracer.spans == []
    lines = (out / "timers.txt").read_text().splitlines()
    assert lines[0].split() == ["span", "count", "total_ms", "self_ms", "device_ms"]
    rows = {ln.split()[0]: ln.split()[1:] for ln in lines[1:] if ln.strip()}
    steps = int(rows["step"][0])
    assert steps >= 2 and int(rows["attempt"][0]) >= steps
    assert float(rows["step"][1]) >= float(rows["attempt"][1]) > 0
    assert int(rows["host_syncs"][0]) > 0
