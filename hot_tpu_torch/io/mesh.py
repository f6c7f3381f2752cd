"""Triangle meshes: OBJ loading, the inside test and sampling inside.

Counterpart of ``hot_tpu.io.mesh``. The inside test counts the crossings
of a ray from each point (ray parity; the mesh must be watertight) with
the rules of hot_tpu's: the same irrational ray direction, faces whose
|det| <= 1e-12 skipped, closed barycentric bounds and t > 1e-12. hot_tpu
loops over the points on the host (or in its OpenMP library); here the
Moller-Trumbore test runs batched over points x faces on the points'
device, in chunks of points so memory stays bounded, always in float64 so
the mask is the same whatever the scene's dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from hot_tpu_torch.sim import seeding

# point x face pairs per chunk of the inside test
CHUNK_PAIRS = 1 << 22


def load_obj(path: str):
    """Minimal OBJ reader: (vertices (V, 3) float64, triangles (F, 3) int64);
    polygons are fan-triangulated."""
    verts = []
    faces = []
    with open(path) as fh:
        for line in fh:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) - 1 for tok in line.split()[1:]]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, np.float64), np.asarray(faces, np.int64)


def _dot3(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross3(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def points_inside_mesh(points, verts, faces):
    """(n,) bool on the points' device: the points (n, 3) inside the
    watertight triangle mesh (verts, faces)."""
    p = torch.as_tensor(points)
    device = p.device
    p = p.to(torch.float64)
    f64 = dict(dtype=torch.float64, device=device)
    # per face, as hot_tpu computes it
    d = np.array([0.577350269, 0.211324865, 0.788675134])
    d = d / np.linalg.norm(d)
    v0 = verts[faces[:, 0]]
    e1 = verts[faces[:, 1]] - v0
    e2 = verts[faces[:, 2]] - v0
    h = np.cross(np.broadcast_to(d, e2.shape), e2)
    a = np.einsum("fj,fj->f", e1, h)
    ok = np.abs(a) > 1e-12
    inv_a = np.where(ok, 1.0 / np.where(ok, a, 1.0), 0.0)
    v0, e1, e2, h, d, inv_a = (torch.as_tensor(t, **f64) for t in (v0, e1, e2, h, d, inv_a))
    ok = torch.as_tensor(ok, device=device)
    inside = torch.empty(p.shape[0], dtype=torch.bool, device=device)
    chunk = max(1, CHUNK_PAIRS // max(len(faces), 1))
    for start in range(0, p.shape[0], chunk):
        s = p[start:start + chunk, None, :] - v0[None]             # (c, F, 3)
        u = inv_a * _dot3(s, h)
        q = _cross3(s, e1)
        vv = inv_a * _dot3(q, d)
        t = inv_a * _dot3(e2, q)
        hit = ok & (u >= 0) & (u <= 1) & (vv >= 0) & (u + vv <= 1) & (t > 1e-12)
        inside[start:start + chunk] = hit.sum(dim=1) % 2 == 1
    return inside


def sample_mesh(generator: torch.Generator, obj_path: str, dx: float,
                particles_per_cell: int, scale: float = 1.0, translate=(0.0, 0.0, 0.0),
                dtype=torch.float32, device="cuda"):
    """Jittered-lattice samples inside an OBJ mesh: (positions (n, 3), volume)."""
    verts, faces = load_obj(obj_path)
    verts = verts * scale + np.asarray(translate)[None, :]
    x, vol = seeding.sample_box(generator, verts.min(axis=0), verts.max(axis=0), dx,
                                particles_per_cell, dtype, device)
    return x[points_inside_mesh(x, verts, faces)], vol
