"""The port's real-data observations and TUM format against the JAX
package's (``icp_tpu.sensors.realdata``, ``icp_tpu.sensors.tum``).

Tolerances: bitwise for everything that is numpy on both sides (the photo
fixture, the DEM surface, the wall, ``observe``, the sequence indexes, the
association and the loaded clouds). ``evaluate_trajectory`` composes poses
in float32 in both packages, each with its own quaternion algebra: within
1e-6 m and 1e-4 deg.
"""

import tests.torch_one_thread  # noqa: F401  (torch on one CPU thread)
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from icp_tpu.sensors import realdata as JR
from icp_tpu.sensors import tum as JT
from icp_tpu_torch.sensors import realdata as TR
from icp_tpu_torch.sensors import tum as TT

ROOT = Path(__file__).resolve().parent.parent


def test_photo_fixture_is_the_jpeg_decoded():
    """The committed PNG holds the JPEG's pixels as PIL decodes them."""
    Image = pytest.importorskip("PIL.Image")
    want = np.asarray(Image.open(ROOT / "data" / "real" / "grace_hopper.jpg"),
                      dtype=np.float32) / 255.0
    got = TR.load_photo()
    assert got.shape == (600, 512, 3) and got.dtype == np.float32
    assert np.array_equal(got, want)


def test_no_image_library_on_the_path():
    """With PIL and matplotlib unimportable, every module of the port and
    chip_smoke.py import (and none of them imports jax, icp_tpu or
    __graft_entry__), the photo loads and a TUM sequence round-trips."""
    code = """
import importlib, pkgutil, sys, tempfile
sys.modules["PIL"] = None
sys.modules["matplotlib"] = None
import icp_tpu_torch
for m in pkgutil.walk_packages(icp_tpu_torch.__path__, "icp_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
from icp_tpu_torch.sensors import realdata, tum
assert realdata.load_photo().shape == (600, 512, 3)
root = tempfile.mkdtemp()
seq = tum.write_synthetic_sequence(root, n_frames=1, device="cpu")
assert tum.load_cloud(seq.rgb_files[0], seq.depth_files[0]).shape == (480, 640, 8)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("PIL", "matplotlib", "jax", "icp_tpu", "__graft_entry__")
             and sys.modules[m] is not None)
assert not bad, bad
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_terrain_and_wall_surfaces_bitwise():
    for j, t in zip(JR.terrain_surface(samples_per_axis=200),
                    TR.terrain_surface(samples_per_axis=200)):
        assert t.dtype == np.float32 and np.array_equal(j, t)
    for j, t in zip(JR.wall_surface(samples_per_axis=150, z_wall=1800.0),
                    TR.wall_surface(samples_per_axis=150, z_wall=1800.0)):
        assert np.array_equal(j, t)
    assert np.array_equal(JR.load_dem(), TR.load_dem())


@pytest.mark.parametrize("pose", [(0.0, (0.0, 0.0, 0.0)), (0.012, (15.0, -6.0, 9.0)),
                                  (0.25, (-40.0, 10.0, 60.0))])
def test_observe_bitwise(pose):
    """``observe`` of the terrain (200 samples a side, so most pixels are
    holes) at 640 x 480, and through ``terrain_frames``."""
    ang, t = pose
    q = np.array([0.0, np.sin(ang / 2), 0.0, np.cos(ang / 2)], np.float32)
    t = np.asarray(t, np.float32)
    surf = TR.terrain_surface(samples_per_axis=200)
    want = JR.observe(*surf, q, t)
    got = TR.observe(*surf, q, t)
    assert np.array_equal(want, got)
    assert (got[..., 2] == 0).any() and (got[..., 2] > 0).any()
    frames = list(TR.terrain_frames([(torch.from_numpy(q), torch.from_numpy(t))], surf))
    assert np.array_equal(frames[0], JR.observe(*surf, q, t))


@pytest.fixture(scope="module")
def sequences(tmp_path_factory):
    """A 2-frame synthetic sequence written by each package (the port's
    rendered on the CPU)."""
    root = tmp_path_factory.mktemp("tum")
    JT.write_synthetic_sequence(str(root / "jax"), n_frames=2)
    TT.write_synthetic_sequence(str(root / "port"), n_frames=2, device="cpu")
    return root


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others_sequence(sequences, writer):
    """Indexes, ground truth and every cloud bitwise, whichever package
    wrote the PNGs and whichever reads them."""
    root = str(sequences / writer)
    sj, st = JT.load_sequence(root), TT.load_sequence(root)
    assert len(st) == len(sj) == 2
    assert st.timestamps == sj.timestamps
    assert st.rgb_files == sj.rgb_files and st.depth_files == sj.depth_files
    assert np.array_equal(st.gt_t, sj.gt_t) and np.array_equal(st.gt_q, sj.gt_q)
    for ct, cj in zip(TT.sequence_clouds(st, fx=595.0, fy=595.0),
                      JT.sequence_clouds(sj, fx=595.0, fy=595.0)):
        assert ct.shape == (480, 640, 8) and ct.dtype == np.float32
        assert np.array_equal(ct, cj)


def test_write_sequence_bytes_and_ground_truth(sequences):
    """The port's writer: its ground truth is the port's trajectory, and its
    PNGs decode to the 5000-scale depth of its own render."""
    from icp_tpu_torch.sensors import _png, synthetic

    seq = TT.load_sequence(str(sequences / "port"))
    poses = synthetic.orbit_trajectory(2, radius_mm=50.0, yaw_rad=0.04, device="cpu")
    depth, rgb = synthetic.render(synthetic.default_scene(device="cpu"), poses[1])
    want = np.clip(depth.numpy() / 1000.0 * 5000.0, 0, 65535).astype(np.uint16)
    assert np.array_equal(_png.read_png(seq.depth_files[1]), want)
    assert np.array_equal(_png.read_png(seq.rgb_files[1]),
                          np.clip(rgb.numpy() * 255, 0, 255).astype(np.uint8))
    np.testing.assert_allclose(seq.gt_t[1], poses[1].t.numpy() / 1000.0, atol=1e-6)


@pytest.mark.parametrize("case", ["dropped", "nearest", "empty", "dense"])
def test_associate_matches_jax(case):
    """The JAX tests' cases (tests/test_tum.py) and a jittered stream."""
    rng = np.random.default_rng(11)
    a, b = {
        "dropped": ([(0.000, "r0"), (0.033, "r1"), (0.066, "r2")],
                    [(0.016, "d0"), (0.067, "d2")]),
        "nearest": ([(10.011, "r")], [(10.010, "lo"), (10.020, "hi")]),
        "empty": ([(1.0, "rgb/a.png")], []),
        "dense": ([(i / 30 + rng.uniform(-0.01, 0.01), f"r{i}") for i in range(40)],
                  [(i / 30 + rng.uniform(-0.02, 0.02), f"d{i}") for i in range(40)
                   if i % 7]),
    }[case]
    for max_dt in (0.005, 0.02):
        assert TT._associate(a, b, max_dt) == JT._associate(a, b, max_dt)


def test_degenerate_sequence(tmp_path):
    (tmp_path / "rgb.txt").write_text("# only comments\n1.0 rgb/a.png\n")
    (tmp_path / "depth.txt").write_text("# empty\n")
    (tmp_path / "groundtruth.txt").write_text("# no rows\n")
    seq = TT.load_sequence(str(tmp_path))
    assert len(seq) == 0 and seq.gt_t is None


def test_evaluate_trajectory_matches_jax(sequences):
    """ATE and RPE of a noisy estimate against the ground truth, as JAX
    scores it; a drifted copy scores worse; no ground truth raises."""
    root = str(sequences / "jax")
    sj, st = JT.load_sequence(root), TT.load_sequence(root)
    rng = np.random.default_rng(12)
    est_t = sj.gt_t * 1000.0 + rng.normal(0, 2.0, sj.gt_t.shape).astype(np.float32)
    est_q = sj.gt_q + rng.normal(0, 1e-3, sj.gt_q.shape).astype(np.float32)
    est_q /= np.linalg.norm(est_q, axis=1, keepdims=True)
    want = JT.evaluate_trajectory(sj, jnp.asarray(est_q), jnp.asarray(est_t))
    got = TT.evaluate_trajectory(st, torch.from_numpy(est_q), torch.from_numpy(est_t))
    np.testing.assert_allclose(got[:2], want[:2], atol=1e-6)
    assert abs(got[2] - want[2]) <= 1e-4
    drifted = TT.evaluate_trajectory(st, est_q, est_t + np.arange(2)[:, None] * 50.0)
    assert drifted[0] > got[0] and drifted[1] > got[1]
    with pytest.raises(ValueError):
        TT.evaluate_trajectory(TT.TumSequence(root=root, rgb_files=[], depth_files=[],
                                              timestamps=[]), est_q, est_t)
