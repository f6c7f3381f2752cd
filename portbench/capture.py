"""Wrappers around the program's calls, installed by the benchmark.

``Answers`` keeps what the timed path produced on the steps the comparison
judges: the grid after P2G (node positions and v*, as the step hands them to
its boundary conditions), the solved grid velocities and the particles after
G2P (as the step hands them to and gets them from ``update_particles``).
It copies them to the host while it is on, which is for the loading steps
and for one segment of the window drawn from the seed.

``Instruments`` (traced runs only) records spans with CUDA events around
the calls into ``solver.multigrid`` and the shapes of each launch of the
three CUDA kernels, from which the rooflines are worked out after the
window.

Both patch module attributes that the program looks up at call time and
put the originals back on ``remove``.
"""

from __future__ import annotations

import torch

from hot_tpu_torch.ops import bsr as bsr_mod
from hot_tpu_torch.sim import collision
from hot_tpu_torch.sim import objective as obj_mod
from hot_tpu_torch.sim import simulation as sim_mod
from hot_tpu_torch.solver import multigrid as mg_mod


def _host(t):
    return t.detach().to("cpu", copy=True)


class _Patches:
    def __init__(self):
        self._saved = []

    def patch(self, module, name, make):
        orig = getattr(module, name)
        self._saved.append((module, name, orig))
        setattr(module, name, make(orig))

    def remove(self):
        for module, name, orig in reversed(self._saved):
            setattr(module, name, orig)
        self._saved.clear()


class Answers(_Patches):
    """The judged steps' records: dt, t, node_pos, v_star, v_new and out
    (x, v, Cf, Ff), each with a leading member dimension in a batch."""

    def __init__(self):
        super().__init__()
        self.on = False
        self.records = []
        self._grid = None
        self._attempt = None
        self.patch(collision, "grid_boundary_conditions", self._wrap_bc)
        self.patch(sim_mod, "update_particles", self._wrap_update)

    def _wrap_bc(self, orig):
        def grid_boundary_conditions(node_pos, t, colliders, grid_v=None, *a, **kw):
            if self.on:
                self._grid = {"t": t, "node_pos": _host(node_pos), "v_star": _host(grid_v)}
            return orig(node_pos, t, colliders, grid_v, *a, **kw)
        return grid_boundary_conditions

    def _wrap_update(self, orig):
        def update_particles(state, st, v_new, v_grid, dt, cfg, plasticity):
            out = orig(state, st, v_new, v_grid, dt, cfg, plasticity)
            if self.on:
                self._attempt = dict(self._grid, dt=dt, v_new=_host(v_new),
                                     out={k: _host(getattr(out, k))
                                          for k in ("x", "v", "Cf", "Ff")})
            return out
        return update_particles

    def commit(self, stats):
        """Keep the last attempt of the step that just ended (the one the
        step accepted), with the CN norm the program reported for it."""
        if self.on and self._attempt is not None:
            self.records.append(dict(self._attempt, program_cn=stats.cn_residual))
        self._attempt = self._grid = None


class Instruments(_Patches):
    """Spans and launch shapes of a traced window (see the module doc)."""

    KERNELS = ("fused_apply", "fused_linearize", "bsr_spmv")

    def __init__(self):
        super().__init__()
        self.on = False
        self.spans = {"mg_build": [], "vcycle": []}
        self.launches = {k: [] for k in self.KERNELS}
        self.tensors = {}          # id -> tensor kept for the after-window reckoning
        self.patch(mg_mod, "build_precond", lambda f: self._span("mg_build", f))
        self.patch(mg_mod, "mg_precondition", lambda f: self._span("vcycle", f))
        self.patch(obj_mod, "fused_apply", lambda f: self._particle("fused_apply", f))
        self.patch(obj_mod, "fused_linearize", lambda f: self._particle("fused_linearize", f))
        self.patch(bsr_mod, "bsr_spmv", self._spmv)

    def _keep(self, t):
        self.tensors.setdefault(id(t), t)
        return id(t)

    def _span(self, name, orig):
        def wrapped(*a, **kw):
            if not self.on:
                return orig(*a, **kw)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = orig(*a, **kw)
            end.record()
            self.spans[name].append((start, end))
            return out
        return wrapped

    def _particle(self, name, orig):
        # both kernels take (grid vector, x (d, n), dx, res, ...); the tile
        # grid is fused_apply's 14th argument or a keyword
        def wrapped(*a, **kw):
            x = a[1]
            n = x.shape[-1]
            if self.on and n:
                tgrid = kw.get("tgrid", a[13] if len(a) > 13 else None)
                members = x.shape[0] if x.ndim == 3 else 1
                self.launches[name].append({
                    "x": self._keep(x), "dx": float(a[2]), "res": tuple(a[3]), "n": n,
                    "members": members, "itemsize": x.element_size(),
                    "tiles": 0 if tgrid is None else tgrid.n_active * members})
            return orig(*a, **kw)
        return wrapped

    def _spmv(self, orig):
        def bsr_spmv(vals, col_row, x):
            if self.on and vals.shape[0]:
                self.launches["bsr_spmv"].append({
                    "col_row": self._keep(col_row), "rows": vals.shape[0], "K": vals.shape[1],
                    "d": x.shape[-1], "itemsize": x.element_size()})
            return orig(vals, col_row, x)
        return bsr_spmv

    def span_ms(self):
        """Each span's device milliseconds (after a synchronise)."""
        return {k: [s.elapsed_time(e) for s, e in v] for k, v in self.spans.items()}
