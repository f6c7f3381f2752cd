"""A run from the outside: the result line's shape, the refusals
(no card, a checkout without the program), the import guard, and the
frozen roofline arithmetic against the bounds PERF.md recorded."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import cells, harness, roofline
from portbench.tests.small import run_small, small_cell

ROOT = cells.ROOT


def test_result_line_shape():
    out = run_small("bar128-bj.twist")
    assert list(out)[:3] == ["correct", "attempted", "failed"]
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"sim_rate", "peak_mem_gb", "setup_s"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] >= 0
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert out["attempted"] >= 6 and out["failed"] == 0
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    w = out["window"]
    assert len(w["segment_newton_cg"]) == len(w["segment_s"]) == w["segments"]
    assert w["newton"] == sum(n for n, _ in w["segment_newton_cg"]) > 0
    assert w["cg"] == sum(c for _, c in w["segment_newton_cg"]) >= w["newton"]
    json.loads(json.dumps(out, allow_nan=False))


def test_traced_result_line_shape(monkeypatch):
    class Event:
        def __init__(self, enable_timing=False):
            self.t = 0.0

        def record(self):
            import time
            self.t = time.perf_counter()

        def elapsed_time(self, other):
            return (other.t - self.t) * 1e3

    monkeypatch.setattr(torch.cuda, "Event", Event)
    out = run_small("bar128-mg.twist", trace=True)
    names = {m["name"] for m in cells.resolve("bar128-mg.twist")["per_layer"]}
    assert set(out["metrics"]) <= names
    assert {"newton_per_step", "cg_per_newton", "mg_build_ms"} <= set(out["metrics"])
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in out["breakdown"].values())


def test_idle_gaps_named_by_the_operation_that_ends_them():
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    from portbench import trace

    def ev(name, start, end, device=DeviceType.CUDA):
        return NS(name=name, device_type=device, time_range=NS(start=start, end=end))

    events = [ev("k1", 0, 10), ev("k2", 30, 40), ev("k1", 45, 50), ev("k2", 90, 95),
              ev("host_op", 0, 100, DeviceType.CPU)]
    # gaps 10-30 and 50-90 before k2, 40-45 before k1
    assert trace.idle_gaps(events) == pytest.approx({"k2": 60e-6, "k1": 5e-6})
    summary = trace.device_summary(events, 1e-4)
    assert summary["busy_s"] == pytest.approx(30e-6)
    assert summary["kernels"]["k1"] == {"seconds": pytest.approx(15e-6), "count": 2}


def test_placements_draw_the_jitter_and_keep_the_count():
    from portbench import placements, scene

    r = small_cell("bar128-bj.twist")
    xs = [scene.particles(placements.placed(r, s)["config"], 5, torch.device("cpu"))[0]
          for s in (21, 22)]
    assert r["config"]["scene"]["jitter_seed"] == cells.resolve("bar128-bj.twist")[
        "config"]["scene"]["jitter_seed"]
    assert xs[0].shape == xs[1].shape and not torch.equal(xs[0], xs[1])


def _run(cwd, *args, env=None):
    return subprocess.run([sys.executable, "portbench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300, env=env)


ARGS = ("--workload", "bar128-bj.twist", "--seed", "3000000001", "--seconds", "1",
        "--trace", "0")


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = _run(ROOT, *ARGS, env=env)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_benchmark_files_alone_do_not_run(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = _run(tmp_path, *ARGS)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "hot_tpu_torch_extra.sub", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "hot_tpu.sim", sys)
    assert harness.forbidden_modules() == ["hot_tpu"]
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert harness.forbidden_modules() == ["hot_tpu", "jax"]


GUARD = """
import sys
sys.path.insert(0, {root!r})
for name in {mods!r}:
    __import__(name)
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


@pytest.mark.parametrize("mods,banned", [
    (["portbench.harness", "portbench.capture", "portbench.scene", "portbench.control",
      "hot_tpu_torch.sim.simulation"], {"jax", "jaxlib", "flax", "hot_tpu"}),
    (["portbench.reference.mpm", "portbench.reference.judge", "portbench.reference.control"],
     {"jax", "jaxlib", "flax", "hot_tpu", "hot_tpu_torch"}),
])
def test_import_guard(mods, banned):
    code = GUARD.format(root=str(ROOT), mods=mods)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr
    loaded = set(eval(p.stdout.strip().splitlines()[-1]))
    assert not loaded & banned, loaded & banned


@pytest.mark.parametrize("res,n,bounds", [
    # PERF.md §6: bounds in ms of fused_apply and fused_linearize, fp32
    (64, 52052, {"fused_apply": 0.00293, "fused_linearize": 0.00306}),
    (128, 400554, {"fused_apply": 0.0225, "fused_linearize": 0.0234}),
])
def test_roofline_reproduces_recorded_bounds(res, n, bounds):
    from hot_tpu_torch.scenes import build_scene

    x = build_scene("twisting_bar_3d", device="cpu", res=res, ppc=8)["state"].x
    assert x.shape[0] == n
    touched = harness.touched_nodes(x.t().contiguous(), 1.0 / res, (res,) * 3)
    for name, want in bounds.items():
        got, by = roofline.bound(roofline.particle_kernel_bytes(name, n, touched, 3, 4),
                                 roofline.particle_kernel_flops(name, n))
        assert by == "bytes" and float(f"{got:.3g}") == want


def test_spmv_arithmetic():
    # 10 rows of K = 4 slots, 25 stored 3x3 blocks, fp32
    assert roofline.spmv_bytes(25, 10, 4, 3, 4) == 25 * 36 + 10 * 4 * 4 + 2 * 10 * 3 * 4
    assert roofline.spmv_flops(25, 3, 4) == 450 and roofline.spmv_flops(25, 3, 8) == 900
    ms, by = roofline.bound(3.35e9, 1.0)
    assert by == "bytes" and abs(ms - 1.0) < 1e-12


@pytest.mark.cuda
def test_cell_on_the_card(cuda_device):
    p = _run(ROOT, "--workload", "bar128-bj.twist", "--seed", "3000000009", "--seconds", "5",
             "--trace", "0")
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
