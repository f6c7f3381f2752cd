"""Render-frame writers: classic Houdini BGEO (what partio writes), binary
little-endian PLY and legacy binary VTK point clouds.

Counterpart of the writers of ``hot_tpu.native``, in numpy: the same bytes
as hot_tpu's compiled ones. Positions and velocities are written as
float32; 2D inputs are zero-padded to 3D.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np


def _to3(a):
    """(n, 2 or 3) -> contiguous (n, 3) float32, zero-padded."""
    a = np.asarray(a, np.float32)
    out = np.zeros((a.shape[0], 3), np.float32)
    out[:, : a.shape[1]] = a
    return out


def write_bgeo(path: str, x, v=None):
    """Classic Houdini BGEO v5: x (n, d) positions, optional v (n, d)."""
    x3 = _to3(x)
    n = x3.shape[0]
    out = bytearray(b"BgeoV")
    out += struct.pack(">iiiiiiiii", 5, n, 0, 0, 0, 0 if v is None else 1, 0, 0, 0)
    pts = np.concatenate([x3, np.ones((n, 1), np.float32)], axis=1)
    if v is not None:
        out += struct.pack(">H", 1) + b"v" + struct.pack(">Hi", 3, 0)
        out += struct.pack(">fff", 0.0, 0.0, 0.0)
        pts = np.concatenate([pts, _to3(v)], axis=1)
    out += pts.astype(">f4").tobytes() + bytes([0x00, 0xFF])
    Path(path).write_bytes(bytes(out))


def write_ply(path: str, x, v=None):
    """Binary little-endian PLY point cloud (x y z [vx vy vz])."""
    x3 = _to3(x)
    props = "property float x\nproperty float y\nproperty float z\n"
    data = x3
    if v is not None:
        props += "property float vx\nproperty float vy\nproperty float vz\n"
        data = np.concatenate([x3, _to3(v)], axis=1)
    header = (f"ply\nformat binary_little_endian 1.0\nelement vertex {x3.shape[0]}\n"
              f"{props}end_header\n").encode()
    Path(path).write_bytes(header + np.ascontiguousarray(data, "<f4").tobytes())


def write_vtk(path: str, x, v=None):
    """Legacy binary VTK POLYDATA: POINTS, one VERTICES cell per point and
    optional velocity VECTORS."""
    x3 = _to3(x)
    n = x3.shape[0]
    out = bytearray(b"# vtk DataFile Version 3.0\nhot_tpu particles\nBINARY\n"
                    b"DATASET POLYDATA\n")
    out += f"POINTS {n} float\n".encode() + x3.astype(">f4").tobytes()
    cells = np.empty((n, 2), ">i4")
    cells[:, 0] = 1
    cells[:, 1] = np.arange(n)
    out += f"\nVERTICES {n} {2 * n}\n".encode() + cells.tobytes()
    if v is not None:
        out += f"\nPOINT_DATA {n}\nVECTORS v float\n".encode() + _to3(v).astype(">f4").tobytes()
    out += b"\n"
    Path(path).write_bytes(bytes(out))


def read_bgeo(path: str):
    """(x (n, 3) float32, v (n, 3) float32 or None) of a BGEO written by
    write_bgeo."""
    raw = Path(path).read_bytes()
    if raw[:5] != b"BgeoV":
        raise ValueError(f"{path} is not a classic BGEO file")
    version, n, _, _, _, n_point_attrs = struct.unpack(">iiiiii", raw[5:29])
    if version != 5:
        raise ValueError(f"{path}: BGEO version {version}, expected 5")
    off, width, have_v = 41, 4, False
    for _ in range(n_point_attrs):
        (length,) = struct.unpack(">H", raw[off:off + 2])
        name = raw[off + 2:off + 2 + length].decode()
        size, _ = struct.unpack(">Hi", raw[off + 2 + length:off + 8 + length])
        off += 8 + length + 4 * size
        width += size
        have_v = have_v or name == "v"
    data = np.frombuffer(raw, ">f4", count=n * width, offset=off).reshape(n, width)
    data = data.astype(np.float32)
    return data[:, :3], data[:, 4:7] if have_v else None
