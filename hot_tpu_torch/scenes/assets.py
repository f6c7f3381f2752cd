"""Procedural scene assets: a watertight faceless-character OBJ.

Counterpart of ``hot_tpu.scenes.assets`` (the port's own copy; it writes
the same bytes). No mesh asset ships with the repo, so the mesh of
``faceless_mesh_3d`` is generated: a humanoid silhouette polygon (head,
arms, torso, two legs) extruded to a slab and closed with ear-clipped caps,
one watertight 2-manifold that drives the OBJ -> inside test -> sampling
pipeline of ``io.mesh``.

The file is cached under $HOT_TPU_ASSET_DIR (as faceless_torch.obj) or
~/.cache/hot_tpu_torch (as faceless.obj), never in the repository.
"""

from __future__ import annotations

import os

import numpy as np


def _silhouette() -> np.ndarray:
    """(V, 2) CCW humanoid outline in [0, 1]^2 (head up, arms out,
    legs down). Not star-shaped (crotch notch), so caps need ear clipping.
    """
    pts = [
        # left leg, outer -> down -> inner -> crotch
        (0.40, 0.36), (0.40, 0.02), (0.47, 0.02), (0.47, 0.30),
        (0.53, 0.30),
        # right leg
        (0.53, 0.02), (0.60, 0.02), (0.60, 0.36),
        # right torso -> right arm
        (0.58, 0.40), (0.58, 0.52), (0.78, 0.50), (0.80, 0.58),
        (0.58, 0.60),
        # neck -> head (octagon-ish) -> neck left
        (0.56, 0.66), (0.60, 0.72), (0.58, 0.80), (0.50, 0.84),
        (0.42, 0.80), (0.40, 0.72), (0.44, 0.66),
        # left arm -> left torso
        (0.42, 0.60), (0.20, 0.58), (0.22, 0.50), (0.42, 0.52),
        (0.42, 0.40),
    ]
    poly = np.asarray(pts, np.float64)
    # enforce CCW
    area2 = np.sum(
        poly[:, 0] * np.roll(poly[:, 1], -1) - np.roll(poly[:, 0], -1) * poly[:, 1]
    )
    if area2 < 0:
        poly = poly[::-1]
    return poly


def _ear_clip(poly: np.ndarray) -> list:
    """O(V^2) ear clipping of a simple CCW polygon -> triangle index list."""
    n = len(poly)
    idx = list(range(n))

    def cross(o, a, b):
        return (poly[a, 0] - poly[o, 0]) * (poly[b, 1] - poly[o, 1]) - (
            poly[a, 1] - poly[o, 1]
        ) * (poly[b, 0] - poly[o, 0])

    def point_in_tri(p, a, b, c):
        def s(u, v):
            return (poly[v, 0] - poly[u, 0]) * (poly[p, 1] - poly[u, 1]) - (
                poly[v, 1] - poly[u, 1]
            ) * (poly[p, 0] - poly[u, 0])

        d1, d2, d3 = s(a, b), s(b, c), s(c, a)
        neg = (d1 < 0) or (d2 < 0) or (d3 < 0)
        pos = (d1 > 0) or (d2 > 0) or (d3 > 0)
        return not (neg and pos)

    tris = []
    guard = 0
    while len(idx) > 3 and guard < 10 * n * n:
        guard += 1
        m = len(idx)
        clipped = False
        for k in range(m):
            a, b, c = idx[(k - 1) % m], idx[k], idx[(k + 1) % m]
            if cross(a, b, c) <= 1e-14:       # reflex or degenerate
                continue
            if any(
                point_in_tri(j, a, b, c)
                for j in idx
                if j not in (a, b, c)
            ):
                continue
            tris.append((a, b, c))
            idx.pop(k)
            clipped = True
            break
        if not clipped:                        # numeric stalemate: fan rest
            for k in range(1, len(idx) - 1):
                tris.append((idx[0], idx[k], idx[k + 1]))
            return tris
    tris.append(tuple(idx))
    return tris


def faceless_mesh(thickness: float = 0.16):
    """(verts (2V, 3), faces (F, 3)) watertight extruded character mesh,
    silhouette in the x-y plane, extruded along z over
    [0.5 - t/2, 0.5 + t/2]."""
    poly = _silhouette()
    V = len(poly)
    z0, z1 = 0.5 - thickness / 2.0, 0.5 + thickness / 2.0
    verts = np.concatenate(
        [
            np.concatenate([poly, np.full((V, 1), z0)], axis=1),
            np.concatenate([poly, np.full((V, 1), z1)], axis=1),
        ]
    )
    faces = []
    # side walls: outward orientation (CCW silhouette, +z extrusion)
    for i in range(V):
        j = (i + 1) % V
        faces.append((i, j, V + j))
        faces.append((i, V + j, V + i))
    caps = _ear_clip(poly)
    for a, b, c in caps:
        faces.append((a, c, b))                # z0 cap faces -z
        faces.append((V + a, V + b, V + c))    # z1 cap faces +z
    return verts, np.asarray(faces, np.int64)


def write_faceless_obj(path: str, thickness: float = 0.16) -> str:
    """Write (and cache) the procedural character OBJ; returns the path."""
    if os.path.exists(path):
        return path
    verts, faces = faceless_mesh(thickness)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        # the header names the JAX package's module: the two files are identical
        fh.write("# procedural faceless character (hot_tpu.scenes.assets)\n")
        for v in verts:
            fh.write(f"v {v[0]:.9f} {v[1]:.9f} {v[2]:.9f}\n")
        for f in faces:
            fh.write(f"f {f[0] + 1} {f[1] + 1} {f[2] + 1}\n")
    os.replace(tmp, path)
    return path


def faceless_obj_path() -> str:
    """The cached asset's path, written on first use (module doc)."""
    cache = os.environ.get("HOT_TPU_ASSET_DIR")
    if cache:
        return write_faceless_obj(os.path.join(cache, "faceless_torch.obj"))
    return write_faceless_obj(os.path.join(os.path.expanduser("~"), ".cache", "hot_tpu_torch",
                                           "faceless.obj"))
