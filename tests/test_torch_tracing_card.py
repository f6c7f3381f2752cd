"""The tracer (hot_tpu_torch.utils.timing) on the card: its clock is the
profiler's, and every point where the step makes the host wait counts.

Run on a machine with a CUDA card and no jax (tests/conftest.py imports
jax, so leave it out):

    python -m pytest --noconftest -m cuda -q -s tests/test_torch_tracing_card.py

Without a card the tests skip.
"""

import ast
import collections
import linecache
import time
import traceback
import warnings
from pathlib import Path

import pytest
import torch

PACKAGE = Path(__file__).resolve().parents[1] / "hot_tpu_torch"
HELPERS = ("synced(", "h2d(")
# the warning of torch.cuda.set_sync_debug_mode("warn") at a synchronising call
SYNC_WARNING = "called a synchronizing cuda operation"
# each cell's configuration (portbench/configs/bar128-*.json) on the port's bar
CELLS = {
    "bar128-bj": {"grid_backend": "sparse"},
    "bar128-mg": {"grid_backend": "sparse", "solver.preconditioner": "multigrid",
                  "solver.multigrid.levels": 4, "solver.multigrid.smoother": "chebyshev",
                  "solver.multigrid.coarse_solver": "direct",
                  "solver.multigrid.assembled": True},
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture
def tracer(monkeypatch):
    from hot_tpu_torch.sim import simulation
    from hot_tpu_torch.utils import timing

    fresh = timing.Tracer()
    monkeypatch.setattr(timing, "TRACER", fresh)
    monkeypatch.setattr(simulation, "TRACER", fresh)
    return fresh


@pytest.mark.cuda
def test_span_holds_the_kernel_on_the_profilers_clock(cuda_device, tracer):
    from torch.autograd import DeviceType

    from hot_tpu_torch.utils.timing import span

    torch.cuda._sleep(1000)                       # the context and the spin kernel, warm
    torch.cuda.synchronize()
    tracer.enable()
    tracer.events = True
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        with span("sleep") as s:
            torch.cuda.synchronize()
            torch.cuda._sleep(2_000_000)
            torch.cuda.synchronize()
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    kernels = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA
               and not getattr(ev, "is_user_annotation", False)]
    k = max(kernels, key=lambda ev: ev.time_range.end - ev.time_range.start)
    k0, k1 = start_ns + k.time_range.start * 1e3, start_ns + k.time_range.end * 1e3
    print(f"kernel {k.name}: {(k1 - k0) * 1e-6:.3f} ms; span {(s.end - s.start) * 1e-6:.3f} ms; "
          f"kernel start - span start {(k0 - s.start) * 1e-3:.1f} us, span end - kernel end "
          f"{(s.end - k1) * 1e-3:.1f} us; time_ns - monotonic_ns "
          f"{(time.time_ns() - time.monotonic_ns()) * 1e-9:.0f} s; "
          f"device ms {tracer.device_ms(s):.3f}")
    assert s.start - 20e3 <= k0 < k1 <= s.end + 20e3
    assert tracer.device_ms(s) >= 0.9 * (k1 - k0) * 1e-6


def _site(stack):
    """(file, line, statement source) of the innermost frame in the package."""
    for frame in reversed(stack):
        path = Path(frame.filename).resolve()
        if path.is_relative_to(PACKAGE) and path.name != "timing.py":
            return path, frame.lineno, _statement(path, frame.lineno)
    return None


def _statement(path: Path, lineno: int) -> str:
    """Source of the innermost simple statement holding the line."""
    source = "".join(linecache.getlines(str(path)))
    best = None
    for node in ast.walk(ast.parse(source)):
        if (isinstance(node, ast.stmt) and not hasattr(node, "body")
                and node.lineno <= lineno <= node.end_lineno):
            if best is None or node.end_lineno - node.lineno < best.end_lineno - best.lineno:
                best = node
    return ast.get_source_segment(source, best) if best is not None else ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(CELLS))
def test_every_sync_of_a_step_is_a_counted_site(cuda_device, tracer, cell):
    from hot_tpu_torch.ops import cuda_lib
    from hot_tpu_torch.scenes import build_scene
    from hot_tpu_torch.sim import Simulation
    from hot_tpu_torch.utils.config import config_from_overrides

    cuda_lib.load()
    scene = build_scene("twisting_bar_3d", device=cuda_device, res=128, ppc=8)
    cfg = config_from_overrides(scene["cfg"], CELLS[cell])
    sim = Simulation(cfg, scene["state"], scene["model"], scene["colliders"])
    sim.step(2e-3)                                # warm: kernels, handles, allocator
    seen = []

    def record(message, category, filename, lineno, file=None, line=None):
        stack = traceback.extract_stack()[:-1]
        where = [f"{f.filename}:{f.lineno}" for f in stack[-6:]]
        seen.append((str(message), _site(stack), where))

    before = tracer.counts["host_syncs"]
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            stats = sim.step(2e-3)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [s for m, s, _ in seen if SYNC_WARNING in m.lower()]
    outside = [(m, where) for m, s, where in seen if SYNC_WARNING in m.lower() and s is None]
    counted = tracer.counts["host_syncs"] - before
    sites = collections.Counter((str(p.relative_to(PACKAGE.parent)), n) for p, n, _ in
                                filter(None, syncs))
    print(f"{cell}: newton {stats.newton_iters}, cg {stats.cg_iters}; {len(syncs)} sync "
          f"warnings at {len(sites)} sites; host_syncs counted {counted}")
    missing = sorted({(str(p.relative_to(PACKAGE.parent)), n, st.splitlines()[0])
                      for p, n, st in filter(None, syncs)
                      if not any(h in st for h in HELPERS)})
    assert syncs and not missing and not outside, (missing, outside)
