"""One run of one cell: set-up, the measured window, the comparison and the
result line.

Set-up makes the inputs from the seed on the device, builds (or loads from
the checkout's ``build/hot_tpu_torch/``) the port's kernels, takes the mix's
loading steps from rest and one warm segment. The window replays the mix's
segment (``segment_steps`` steps of ``Simulation.step(dt)`` from the state
saved after loading, with t reset) and starts whole segments while fewer
than ``--seconds`` have passed. ``sim_rate`` is all simulated time of the
window's steps, summed over a batch's members, over the wall time from the
window's start to the end of its last step. A traced run profiles its
first segment for device activity only (``trace.py``) and reports the
per-layer metrics; the rest of its window runs untraced. Every run's
``window`` also gives each segment's Newton and CG iterations.

After the window the program's state is freed and the reference judges
the loading steps and one segment drawn from the seed
(``reference/judge.py``).
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import random
import sys
import time

import torch

from portbench import cells
from portbench import roofline
from portbench import trace as trace_mod

# a traced run profiles its first segment, device activity only (trace.py)
PROFILED = 1
# the judged segment is drawn from the seed among the window's first two
JUDGED_AMONG = 2
FORBIDDEN = ("jax", "jaxlib", "flax", "hot_tpu")
FIELDS = ("x", "v", "Cf", "Ff")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules():
    """Loaded modules whose top-level name is that of JAX or the JAX
    package (whole names: hot_tpu_torch is not hot_tpu)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _members(value):
    return value if isinstance(value, list) else [value]


def _host(t):
    return t.detach().to("cpu", copy=True)


def _counts(stats) -> list:
    """[Newton, CG] iterations of the steps `stats`, summed over members."""
    return [sum(sum(_members(s.newton_iters)) for s in stats),
            sum(sum(_members(s.cg_iters)) for s in stats)]


def touched_nodes(x, dx: float, res) -> int:
    """Unique quadratic-stencil nodes of the particles x (d, n)."""
    base = torch.floor(x.t().double() / dx - 0.5).long()
    off = torch.tensor([(a, b, c) for a in range(3) for b in range(3) for c in range(3)],
                       device=x.device)
    hi = torch.tensor(res, device=x.device) - 1
    coords = torch.minimum((base[:, None, :] + off).clamp(min=0), hi)
    ids = (coords[..., 0] * res[1] + coords[..., 1]) * res[2] + coords[..., 2]
    return int(torch.unique(ids).numel())


class Trace:
    """What a traced window gives the per-layer metric readers: the steps'
    counts, the spans, the profiler's summary and each kernel's bounds."""

    def __init__(self, steps, spans_ms, summary, bounds):
        self.steps = steps            # [{"newton": int, "cg": int}] per member-step
        self.spans_ms = spans_ms      # {"mg_build": [ms], "vcycle": [ms]}
        self.summary = summary        # trace.device_summary(...)
        self.bounds = bounds          # {kernel: [bound ms per recorded launch]}

    def roofline_share(self, kernel: str):
        """100 x the mean bound over the mean device time per launch, or
        None where the window launched no such kernel or the profiler saw
        none."""
        bounds = self.bounds.get(kernel) or []
        seconds, count = trace_mod.kernel_time(self.summary, kernel)
        if not bounds or not count or seconds <= 0:
            return None
        return 100.0 * (sum(bounds) / len(bounds)) / (seconds * 1e3 / count)


def kernel_bounds(instruments) -> dict:
    """Each recorded launch's least time (ms), from the frozen arithmetic."""
    touched = {}
    nnz = {}
    out = {}
    for name, launches in instruments.launches.items():
        out[name] = []
        for ln in launches:
            if name == "bsr_spmv":
                key = ln["col_row"]
                if key not in nnz:
                    nnz[key] = int((instruments.tensors[key] >= 0).sum())
                nbytes = roofline.spmv_bytes(nnz[key], ln["rows"], ln["K"], ln["d"],
                                             ln["itemsize"])
                flops = roofline.spmv_flops(nnz[key], ln["d"], ln["itemsize"])
            else:
                key = (ln["x"], ln["dx"], ln["res"])
                if key not in touched:
                    x = instruments.tensors[ln["x"]]
                    xs = [x] if x.ndim == 2 else list(x)
                    touched[key] = [touched_nodes(xb, ln["dx"], ln["res"]) for xb in xs]
                d = instruments.tensors[ln["x"]].shape[-2]
                nbytes = sum(roofline.particle_kernel_bytes(name, ln["n"], t, d, ln["itemsize"])
                             for t in touched[key]) + 4 * ln["tiles"]
                flops = ln["members"] * roofline.particle_kernel_flops(name, ln["n"])
            out[name].append(roofline.bound(nbytes, flops)[0])
    return out


def _judge(config, material, start, records, expected, device):
    """The comparison's verdict, the reference run member by member, and
    each judged member-step's CN norm as the program reported it beside the
    reference's."""
    from portbench.reference import judge, mpm

    worst, pairs = None, []
    batch = start["x"].ndim == 3
    members = range(start["x"].shape[0]) if batch else [None]
    for b in members:
        pick = (lambda t: t[b]) if batch else (lambda t: t)
        mat = {k: pick(v) for k, v in material.items()}
        sc = mpm.scene_from(config["scene"], mat, device, torch.float64)
        recs = []
        for r in records:
            node_pos = r["node_pos"]
            recs.append({"dt": r["dt"],
                         "node_pos": pick(node_pos) if node_pos.ndim == 3 else node_pos,
                         "v_star": pick(r["v_star"]), "v_new": pick(r["v_new"]),
                         "out": {k: pick(v) for k, v in r["out"].items()}})
        got = judge.judge(sc, {k: pick(start[k]) for k in FIELDS}, recs, expected, device)
        nums = got["numbers"]
        worst = nums if worst is None else {k: max(worst[k], nums[k]) for k in nums}
        pairs.extend([_members(r["program_cn"])[b or 0], s["cn"]]
                     for r, s in zip(records, got["per_step"]))
    return judge.verdict(worst, config["check"]), pairs


def run_cell(resolved: dict, seed: int, seconds: float, trace: bool, device, t0: float):
    """One run of the resolved cell on `device`: the result line, as a dict
    whose last key holds the comparison's checks."""
    from portbench import capture, scene
    from hot_tpu_torch.ops import cuda_lib
    from hot_tpu_torch.sim.simulation import Simulation

    config, traffic = resolved["config"], resolved["traffic"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device.type == "cuda":
        cuda_lib.load()
    cfg, state, model, colliders, material = scene.build(config, traffic, seed, device)
    start = {k: _host(getattr(state, k)) for k in FIELDS}
    material = {k: _host(v) for k, v in material.items()}
    members = state.batch or 1
    dt, n_load, n_seg = traffic["dt"], traffic["loading_steps"], traffic["segment_steps"]

    answers = capture.Answers()
    instruments = capture.Instruments() if trace else None
    try:
        sim = Simulation(cfg, state, model, colliders)
        del state

        def segment(saved, t_saved, collect):
            sim.state, sim.t = saved, t_saved
            for _ in range(n_seg):
                stats = sim.step(dt)
                answers.commit(stats)
                collect.append(stats)
            return sim.t - t_saved

        answers.on = True
        for _ in range(n_load):
            answers.commit(sim.step(dt))
        answers.on = False
        saved, t_saved = sim.state, sim.t
        _sync(device)
        t_warm = time.perf_counter()
        segment(saved, t_saved, [])
        _sync(device)
        warm_s = time.perf_counter() - t_warm
        setup_s = time.perf_counter() - t0

        # the judged segment, drawn from the seed among those every window holds
        sure = max(1, min(JUDGED_AMONG, int(seconds // max(warm_s, 1e-9))))
        judged = random.Random(seed).randrange(sure)
        least = max(judged, PROFILED - 1 if trace else 0)
        steps, traced_steps, seg_counts = [], [], []
        summary, gaps, timings = None, {}, []
        sim_time, n_segments, seg_s = 0.0, 0, []
        _sync(device)
        w0 = time.perf_counter()
        while n_segments <= least or time.perf_counter() - w0 < seconds:
            answers.on = n_segments == judged
            profiled = trace and n_segments < PROFILED
            if profiled:
                acts = ([torch.profiler.ProfilerActivity.CUDA] if device.type == "cuda"
                        else [torch.profiler.ProfilerActivity.CPU])
                prof = torch.profiler.profile(activities=acts)
                prof.__enter__()
                instruments.on = True
                _sync(device)
            t_seg = time.perf_counter()
            collect = traced_steps if profiled else steps
            before = len(collect)
            sim_time += segment(saved, t_saved, collect)
            seg_s.append(time.perf_counter() - t_seg)
            seg_counts.append(_counts(collect[before:]))
            answers.on = False
            if profiled:
                _sync(device)
                t_b = time.perf_counter()
                prof.__exit__(None, None, None)
                instruments.on = False
                events = prof.events()
                summary = trace_mod.device_summary(events, t_b - t_seg)
                gaps = trace_mod.idle_gaps(events)
                timings = [t_b - t_seg, time.perf_counter() - t_b]
                del prof, events
            n_segments += 1
        _sync(device)
        wall = time.perf_counter() - w0
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        steps = steps + traced_steps

        found = forbidden_modules()
        if found:
            raise SystemExit(f"modules of JAX or the JAX package loaded: {found}")

        per_layer = None
        if trace:
            counts = [{"newton": nw, "cg": cg} for s in traced_steps
                      for nw, cg in zip(_members(s.newton_iters), _members(s.cg_iters))]
            per_layer = Trace(counts, instruments.span_ms(), summary, kernel_bounds(instruments))
        records = list(answers.records)
    finally:
        answers.remove()
        if instruments is not None:
            instruments.remove()
    del sim, saved, instruments, answers
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    member_steps = [c for s in steps for c in _members(s.converged)]
    failed = sum(1 for c in member_steps if not c)
    result = {"correct": False, "attempted": len(member_steps), "failed": failed}
    if trace:
        metrics = {}
        for m in resolved["per_layer"]:
            value = cells.load_reader(m["name"])(per_layer)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
    else:
        values = {"sim_rate": 1e3 * sim_time * members / wall, "peak_mem_gb": peak / 1e9,
                  "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in resolved["end_to_end"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": resolved["cell"]["chips"], "memory_peak_bytes": peak}
    if trace:
        dev["busy_s"], dev["window_s"] = summary["busy_s"], summary["window_s"]
        result["breakdown"] = trace_mod.breakdown(summary, gaps)
        print(f"trace: profiled segment seconds and processing seconds {timings}",
              file=sys.stderr)
    result["device"] = dev
    result["window"] = {"segments": n_segments, "seconds": wall, "sim_s": sim_time,
                        "segment_s": seg_s,
                        "newton": sum(c[0] for c in seg_counts),
                        "cg": sum(c[1] for c in seg_counts),
                        "segment_newton_cg": seg_counts,
                        "judged_segment": judged, "warm_segment_s": warm_s}

    verdict, pairs = _judge(config, material, start, records, n_load + n_seg, device)
    result["cn_program_reference"] = pairs
    result["correct"] = verdict["correct"] and failed == 0
    # a number that is not finite failed; it is printed as the largest float
    result["checks"] = {
        k: {"value": c["value"] if math.isfinite(c["value"]) else sys.float_info.max,
            "limit": c["limit"]} for k, c in verdict["checks"].items()}
    return result


def main(argv, t0: float) -> int:
    args = parse(argv)
    resolved = cells.resolve(args.workload)
    chips = resolved["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"have {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(resolved, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), t0)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package loaded: {found}")
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0
