"""Checkpoints, resume and render frames of hot_tpu_torch (io/checkpoint.py,
io/frames.py, the CLI's --resume, --frame-format and --checkpoint-every),
against hot_tpu's io and native writers. Mirrors tests/test_native.py.

  * the frame writers write the bytes of hot_tpu.native's, 2D and 3D, with
    and without velocities; read_bgeo returns float32 x bit for bit and
    refuses a file that is not a classic BGEO v5;
  * checkpoints carry every ParticleState field and the clock under
    hot_tpu's keys: one written by hot_tpu loads in the port and the other
    way round, bit for bit;
  * the CLI resumed from a checkpoint writes the uninterrupted run's next
    frame and checkpoint bit for bit on the CPU.
"""

import dataclasses
import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hot_tpu import native as jnative
from hot_tpu.io import checkpoint as jckpt
from hot_tpu.scenes import build_scene as jbuild
from hot_tpu_torch import cli
from hot_tpu_torch.io import checkpoint as tckpt
from hot_tpu_torch.io import frames
from hot_tpu_torch.sim.state import FIELDS

from test_torch_ref import carry_state, one_torch_thread, t2n  # noqa: F401

WRITERS = {"bgeo": (frames.write_bgeo, jnative.write_bgeo),
           "ply": (frames.write_ply, jnative.write_ply),
           "vtk": (frames.write_vtk, jnative.write_vtk)}


@pytest.mark.parametrize("with_v", [True, False])
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("fmt", list(WRITERS))
def test_frame_writers_match_hot_tpu(tmp_path, rng, fmt, d, with_v):
    n = 257
    x = rng.standard_normal((n, d)).astype(np.float32)
    v = rng.standard_normal((n, d)).astype(np.float32) if with_v else None
    files = []
    for who, write in zip(("port", "hot_tpu"), WRITERS[fmt]):
        path = str(tmp_path / f"{who}.{fmt}")
        write(path, x, v)
        files.append(open(path, "rb").read())
    assert files[0] == files[1]
    if fmt == "bgeo":
        x2, v2 = frames.read_bgeo(str(tmp_path / "hot_tpu.bgeo"))
        assert x2.dtype == np.float32 and x2.shape == (n, 3)
        np.testing.assert_array_equal(x2[:, :d], x)
        np.testing.assert_array_equal(x2[:, d:], 0.0)
        if with_v:
            np.testing.assert_array_equal(v2[:, :d], v)
        else:
            assert v2 is None


@pytest.mark.parametrize("header, match", [(b"PLY\n", "not a classic BGEO"),
                                           (b"BgeoV" + struct.pack(">i", 4), "version 4")])
def test_read_bgeo_refuses_other_files(tmp_path, header, match):
    path = tmp_path / "f.bgeo"
    path.write_bytes(header + bytes(64))
    with pytest.raises(ValueError, match=match):
        frames.read_bgeo(str(path))


def _assert_states_equal(got, want):
    for f in FIELDS:
        a = t2n(getattr(got, f)) if isinstance(getattr(got, f), torch.Tensor) \
            else np.asarray(getattr(got, f))
        b = t2n(getattr(want, f)) if isinstance(getattr(want, f), torch.Tensor) \
            else np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b)


def test_checkpoints_cross_load(tmp_path, rng):
    """hot_tpu's checkpoint loads in the port, the port's in hot_tpu; a
    checkpoint loads on the device and in the dtype asked for."""
    js = jbuild("twisting_bar_3d", res=16, ppc=2, dtype=jnp.float64)["state"]
    js = js.replace(v=jnp.asarray(rng.standard_normal(js.v.shape)),
                    F=jnp.asarray(np.asarray(js.F) + 0.1 * rng.standard_normal(js.F.shape)))
    jckpt.save_checkpoint(str(tmp_path / "j.npz"), js, 0.125, 7)
    ts, t, k = tckpt.load_checkpoint(str(tmp_path / "j.npz"), device="cpu")
    assert (t, k) == (0.125, 7)
    _assert_states_equal(ts, js)

    tckpt.save_checkpoint(str(tmp_path / "t.npz"), carry_state(js), 0.25, 9)
    with np.load(tmp_path / "t.npz") as data:
        assert sorted(data.files) == sorted(["__t", "__step_count", *FIELDS])
    js2, t2, k2 = jckpt.load_checkpoint(str(tmp_path / "t.npz"))
    assert (t2, k2) == (0.25, 9)
    _assert_states_equal(js2, js)

    ts32, _, _ = tckpt.load_checkpoint(str(tmp_path / "t.npz"), device="cpu",
                                       dtype=torch.float32)
    assert all(getattr(ts32, f).dtype == torch.float32 for f in FIELDS)
    assert ts32.x.device.type == "cpu"


def test_save_frame_formats(tmp_path, rng):
    js = jbuild("block_drop_2d", res=16, dtype=jnp.float64)["state"]
    ts = carry_state(js)
    for fmt in ("bgeo", "ply", "vtk", "npz"):
        tckpt.save_frame(str(tmp_path / "t" / f"f.{fmt}"), ts)
        jckpt.save_frame(str(tmp_path / "j" / f"f.{fmt}"), js)
        if fmt != "npz":
            assert (open(tmp_path / "t" / f"f.{fmt}", "rb").read()
                    == open(tmp_path / "j" / f"f.{fmt}", "rb").read())
    with np.load(tmp_path / "t" / "f.npz") as data:
        np.testing.assert_array_equal(data["x"], np.asarray(js.x))
        np.testing.assert_array_equal(data["v"], np.asarray(js.v))


def _cli(out, *extra):
    return cli.main(["--scene", "block_drop_2d", "--device", "cpu", "--f64", "--frames", "2",
                     "--scene-arg", "res=16", "--set", "frame_dt=0.01", "-o", str(out),
                     "--quiet", *extra])


def test_cli_resume_is_bitwise(tmp_path):
    """Frame 1 and its checkpoint from a resumed run equal the
    uninterrupted run's, byte for byte; the resumed run starts at frame 1."""
    full, resumed = tmp_path / "full", tmp_path / "resumed"
    assert _cli(full) == 0
    assert sorted(os.listdir(full)) == ["ckpt_00000.npz", "ckpt_00001.npz", "config.json",
                                        "frame_00000.bgeo", "frame_00001.bgeo",
                                        "metrics.jsonl", "timers.txt"]
    assert _cli(resumed, "--resume", str(full / "ckpt_00000.npz")) == 0
    assert not (resumed / "frame_00000.bgeo").exists()
    for name in ("frame_00001.bgeo", "ckpt_00001.npz"):
        assert (full / name).read_bytes() == (resumed / name).read_bytes(), name
    a, b = (tckpt.load_checkpoint(str(p / "ckpt_00001.npz"), device="cpu")
            for p in (full, resumed))
    _assert_states_equal(a[0], b[0])
    assert a[1:] == b[1:] and a[2] > 0
    x, _ = frames.read_bgeo(str(full / "frame_00001.bgeo"))
    np.testing.assert_array_equal(x[:, :2], t2n(a[0].x).astype(np.float32))


def test_cli_max_steps_stops_on_the_frame_grid(tmp_path, monkeypatch):
    """--max-steps stops after the whole frame in which the step count
    reaches it, as hot_tpu's CLI does: both write frame 0 and its checkpoint
    at t = frame_dt (fp64, the same t), and a run resumed from that
    checkpoint writes frames 1 and 2 at 2 and 3 frame_dt, at hot_tpu's t.
    hot_tpu's CLI would turn on jax's persistent compilation cache for the
    rest of the test process; it stays off here."""
    from hot_tpu import cli as jcli
    from hot_tpu.utils import cache as jcache

    monkeypatch.setattr(jcache, "enable_compilation_cache", lambda path=None: None)

    common = ["--scene", "block_drop_2d", "--scene-arg", "res=16", "--frames", "3", "--f64",
              "--quiet", "--frame-format", "npz"]
    runs = {}
    for name, main, device in (("port", cli.main, ["--device", "cpu"]),
                               ("hot_tpu", jcli.main, ["--cpu"])):
        out = tmp_path / name
        assert main(common + device + ["--max-steps", "2", "-o", str(out / "stopped")]) == 0
        assert main(common + device + ["--resume", str(out / "stopped" / "ckpt_00000.npz"),
                                       "-o", str(out / "resumed")]) == 0
        runs[name] = [tckpt.load_checkpoint(str(out / run / f"ckpt_{k:05d}.npz"), device="cpu")[1:]
                      for run, k in (("stopped", 0), ("resumed", 1), ("resumed", 2))]
        assert sorted(os.listdir(out / "stopped")) == [
            "ckpt_00000.npz", "config.json", "frame_00000.npz", "metrics.jsonl", "timers.txt"]
        assert not (out / "resumed" / "frame_00000.npz").exists()
    frame_dt = 1.0 / 24.0
    for k, (t, steps) in enumerate(runs["port"]):
        assert abs(t - (k + 1) * frame_dt) <= 1e-12, runs
        assert (t, steps) == runs["hot_tpu"][k], runs
    assert runs["port"][0][1] > 2, runs


def test_cli_frame_format_and_checkpoint_every(tmp_path):
    out = tmp_path / "ply"
    assert _cli(out, "--frame-format", "ply", "--checkpoint-every", "2") == 0
    assert sorted(f for f in os.listdir(out) if f.endswith((".ply", ".npz"))) == [
        "ckpt_00001.npz", "frame_00000.ply", "frame_00001.ply"]
    out = tmp_path / "npz"
    assert _cli(out, "--frame-format", "npz", "--checkpoint-every", "0") == 0
    assert sorted(f for f in os.listdir(out) if f.endswith(".npz")) == [
        "frame_00000.npz", "frame_00001.npz"]


def test_checkpoint_dataclass_fields_match():
    """The keys are hot_tpu's ParticleState fields."""
    from hot_tpu.sim.state import ParticleState

    assert tuple(f.name for f in dataclasses.fields(ParticleState)) == FIELDS
