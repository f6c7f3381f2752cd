"""The program's spans and counters in the benchmark (portbench/spans.py):
an idle gap goes to the innermost span open on the host, the five readers
read a traced run (the card's device milliseconds and idle gaps only on the
card), and every reader returns None for a program without a tracer."""

import pytest
import torch

from portbench import cells, spans
from portbench.tests.small import run_small, small_cell

READERS = ("precond_build_ms", "host_syncs_per_newton", "h2d_copies_per_newton",
           "build_idle_ms", "cg_idle_ms")


def _span(name, start, end, parent=-1):
    return {"name": name, "start": start, "end": end, "parent": parent, "step": 1,
            "attempt": 0, "device_ms": None}


def test_idle_gap_goes_to_the_innermost_open_span():
    # step [0, 100] > newton [10, 90] > cg [20, 80] > cg.iter [30, 50]; build [60, 70] in cg
    tree = [_span("step", 0, 100), _span("newton", 10, 90, 0), _span("cg", 20, 80, 1),
            _span("cg.iter", 30, 50, 2), _span("precond_build", 60, 70, 2)]
    device = [(0, 5, "a"), (8, 32, "b"), (45, 62, "c"), (68, 95, "d")]
    per_span, outside = spans.idle_by_span(tree, device)
    # gaps: [5, 8] in step; [32, 45] in cg.iter; [62, 68] in the build; [95, 100] in step
    assert per_span == {0: 3 + 5, 3: 13, 4: 6} and outside == 0
    table = spans.idle_table(tree, device)
    assert [n for n, _ in table] == ["cg.iter", "step", "precond_build"]
    assert [s for _, s in table] == pytest.approx([13e-9, 8e-9, 6e-9])
    # a gap past the spans is under no span
    per_span, outside = spans.idle_by_span(tree, device, window=(0, 110))
    assert outside == 10 and per_span[0] == 8
    prog = {"spans": tree, "counts": {}}
    trace = type("T", (), {"program": prog, "device": device})()
    assert spans.idle_ms_per(trace, "precond_build",
                             spans.named(prog, "precond_build")) == pytest.approx(6e-6)
    # cg's idle outside its build, per CG iteration
    assert spans.idle_ms_per(trace, "cg", spans.named(prog, "cg.iter", parent="cg"),
                             outside=("vcycle", "precond_build")) == pytest.approx(13e-6)


def test_readers_find_nothing_without_the_programs_tracer(monkeypatch):
    monkeypatch.setattr(spans, "tracer", lambda: None)
    trace = type("T", (), {})()
    for name in READERS:
        assert cells.load_reader(name)(trace) is None


def test_traced_small_run_reads_the_programs_counters():
    out = run_small("bar128-bj.twist", trace=True)
    got = out["metrics"]
    # on the CPU the spans carry no CUDA events: no device milliseconds
    assert "precond_build_ms" not in got
    assert got["host_syncs_per_newton"]["value"] >= 1
    assert got["h2d_copies_per_newton"]["value"] > 0


@pytest.mark.cuda
def test_traced_small_run_on_the_card_reports_the_five_metrics(cuda_device):
    import time

    from hot_tpu_torch.ops import cuda_lib

    cuda_lib.load()
    resolved = small_cell("bar128-mg.twist", res=32, dtype="float32")
    result, table = spans.traced_run(resolved, 11, 0.5, cuda_device, time.perf_counter())
    got = result["metrics"]
    assert set(READERS) <= set(got), got
    assert got["precond_build_ms"]["value"] > 0 and table["sum_s"] > 0
    assert got["mg_build_ms"]["value"] <= got["precond_build_ms"]["value"]
    print(table)
