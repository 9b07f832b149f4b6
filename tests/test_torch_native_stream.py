"""The port's native host library loader, frame stream and metrics sink
against the JAX package's (``icp_tpu.runtime.native``,
``icp_tpu.sensors.stream``, ``icp_tpu.runtime.metrics``).

The port compiles ``native/*.cpp`` with the flags of ``native/Makefile``
into ``build/icp_tpu_torch/host/<hash>/`` and never writes under
``native/``. Tolerances: bitwise (both libraries are built from the same
sources with the same flags), but the metrics' rotation angle, which each
package computes with its own ``qangle_deg``: within 1e-6 deg.
"""

import tests.torch_one_thread  # noqa: F401  (torch on one CPU thread)
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from icp_tpu.runtime import metrics as JM
from icp_tpu.runtime import native as JN
from icp_tpu_torch.runtime import metrics as TM
from icp_tpu_torch.runtime import native as TN
from icp_tpu_torch.sensors.io import write_cloud_bin
from tests.utils import make_cloud8

ROOT = Path(__file__).resolve().parent.parent


def _snapshot(directory: Path) -> dict:
    return {p.name: (p.stat().st_size, p.stat().st_mtime_ns) for p in directory.iterdir()}


@pytest.fixture(scope="module")
def lib():
    before = _snapshot(ROOT / "native")
    lib = TN.load()
    if lib is None:
        pytest.skip(f"no C++ compiler: {TN.build_info.get('error')}")
    assert _snapshot(ROOT / "native") == before
    return lib


def test_library_lives_under_build(lib):
    path = Path(TN.build_info["path"])
    assert path.is_file() and path.name == "libicp_host.so"
    assert path.parent.parent == ROOT / "build" / "icp_tpu_torch" / "host"
    assert path != (ROOT / "native" / "libicp_host.so")


def test_build_compiles_the_sources(tmp_path):
    """A build from scratch into a fresh directory, with nothing written
    under native/."""
    if TN.load() is None:
        pytest.skip("no C++ compiler")
    before = _snapshot(ROOT / "native")
    out = tmp_path / "libicp_host.so"
    TN._build(out)
    assert out.is_file() and out.stat().st_size > 0
    assert _snapshot(ROOT / "native") == before
    assert sorted(p.name for p in tmp_path.iterdir()) == ["libicp_host.so"]


def test_cloud_codec(lib, tmp_path):
    rng = np.random.default_rng(1)
    cloud = make_cloud8(rng, 2048)
    p = str(tmp_path / "c.bin")
    TN.write_cloud(p, cloud)
    assert np.array_equal(TN.read_cloud(p, max_points=4096), cloud)
    write_cloud_bin(tmp_path / "d.bin", cloud[:512])
    assert np.array_equal(TN.read_cloud(str(tmp_path / "d.bin"), max_points=512), cloud[:512])
    bad = cloud[:100].copy()
    bad[:10, :3] = 0.0
    assert TN.validate_cloud(bad) == 90
    bad[5, 2] = np.nan
    with pytest.raises(ValueError):
        TN.validate_cloud(bad)


def test_golden_oracles_equal_jax(lib):
    """golden_nn and golden_solve bitwise the JAX package's wrappers."""
    if JN.load() is None:
        pytest.skip("the JAX package's native library is unavailable")
    rng = np.random.default_rng(2)
    q, db = make_cloud8(rng, 128), make_cloud8(rng, 256)
    for got, want in zip(TN.golden_nn(q, db, 150.0), JN.golden_nn(q, db, 150.0)):
        assert np.array_equal(got, want)
    fixed = make_cloud8(rng, 512)
    moving = fixed.copy()
    moving[:, :3] += np.array([4.0, -2.0, 3.0], np.float32)
    moving[:, :3] += rng.normal(0, 0.5, (512, 3)).astype(np.float32)
    idx, d2 = TN.golden_nn(moving, fixed, 150.0)
    for weighted in (True, False):
        for scale in (True, False):
            assert np.array_equal(
                TN.golden_solve(moving, fixed[idx], d2, weighted, scale),
                JN.golden_solve(moving, fixed[idx], d2, weighted, scale))


def test_numpy_fallbacks(monkeypatch, tmp_path):
    """Without the library, the documented numpy paths; golden_solve has
    none and raises."""
    monkeypatch.setattr(TN, "load", lambda: None)
    rng = np.random.default_rng(3)
    cloud = make_cloud8(rng, 64)
    p = str(tmp_path / "f.bin")
    TN.write_cloud(p, cloud)
    assert np.array_equal(TN.read_cloud(p), cloud)
    assert TN.validate_cloud(cloud) == 64
    q, db = make_cloud8(rng, 16), make_cloud8(rng, 40)
    idx, d2 = TN.golden_nn(q, db, 150.0)
    w = np.array([1, 1, 1, 0, 150, 150, 150, 0], np.float32)
    full = (((q[:, None] - db[None]) ** 2) * w).sum(-1)
    assert np.array_equal(idx, full.argmin(1)) and np.array_equal(d2, full.min(1))
    with pytest.raises(RuntimeError):
        TN.golden_solve(q, db[:16], d2)


def _frames(tmp_path, n):
    rng = np.random.default_rng(42)
    frames = []
    for i in range(5):
        cloud = rng.normal(size=(n, 8)).astype(np.float32)
        cloud.tofile(tmp_path / f"frame_{i:04d}.bin")
        frames.append(cloud)
    frames[3][: n // 2].tofile(tmp_path / "frame_0003.bin")  # a truncated file
    return frames


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_frame_source_streams(lib, tmp_path, monkeypatch, path):
    """Sorted order and exact contents, a truncated file zero-padded, as
    tests/test_native.py holds the JAX package's source; the native ring
    and the numpy path give the same frames as JAX's."""
    from icp_tpu.sensors.stream import FrameSource as JFrameSource
    from icp_tpu_torch.sensors import stream as TS

    n = 256
    frames = _frames(tmp_path, n)
    if path == "numpy":
        monkeypatch.setattr(TS._native, "load", lambda: None)
    with TS.FrameSource(str(tmp_path), n_points=n, ring=2) as src:
        assert src.native == (path == "native")
        assert len(src) == 5
        got = list(src)
    with JFrameSource(str(tmp_path), n_points=n, ring=2) as src:
        want = list(src)
    assert [i for i, _ in got] == [0, 1, 2, 3, 4]
    for (i, cloud), want_frame, (_, jax_cloud) in zip(got, frames, want):
        assert np.array_equal(cloud, jax_cloud)
        if i == 3:
            assert np.array_equal(cloud[: n // 2], want_frame[: n // 2])
            assert np.all(cloud[n // 2:] == 0)
        else:
            assert np.array_equal(cloud, want_frame)
    src2 = TS.FrameSource(str(tmp_path), n_points=n, ring=1)
    src2.next_frame()
    src2.close()  # early close while the prefetch thread may hold frames


def test_metrics_sink_equals_jax(tmp_path):
    """The same logs give the same records (but the clock) and summary."""
    from icp_tpu.icp.state import ICPState as JState
    from icp_tpu_torch.icp.state import ICPState as TState

    q = np.array([0.01, -0.02, 0.005, 0.9997], np.float32)
    q /= np.linalg.norm(q)
    vals = dict(q=q, t=np.array([3.0, -4.0, 12.0], np.float32), s=np.float32(1.001),
                qk=q, tk=np.zeros(3, np.float32), sk=np.float32(1.0), k=np.int32(7))
    js = JState(**{k: jnp.asarray(v) for k, v in vals.items()})
    ts = TState(**{k: torch.as_tensor(v) for k, v in vals.items()})
    sinks = []
    for mod, state in ((JM, js), (TM, ts)):
        sink = mod.MetricsSink(run_id="r1")
        sink.log("fps", 30.5, config="flagship")
        sink.log("fps", np.float32(29.5))
        sink.log("ate_mm", torch.tensor(4.25) if mod is TM else jnp.float32(4.25))
        sink.log_registration(state, 12.5, pair="a-b")
        sinks.append(sink)
    jr, tr = ([{k: v for k, v in r.items() if k != "ts"} for r in s.records] for s in sinks)
    assert [r["metric"] for r in tr] == [r["metric"] for r in jr]
    for a, b in zip(tr, jr):
        assert a.keys() == b.keys()
        tol = 1e-6 if a["metric"] == "icp.angle_deg" else 0.0
        assert abs(a["value"] - b["value"]) <= tol and type(a["value"]) is float
        assert {k: v for k, v in a.items() if k != "value"} == \
            {k: v for k, v in b.items() if k != "value"}
    js_sum, ts_sum = sinks[0].summary(), sinks[1].summary()
    assert js_sum.keys() == ts_sum.keys()
    assert ts_sum["fps"] == js_sum["fps"]
    p = str(tmp_path / "m.jsonl")
    sinks[1].dump_jsonl(p)
    back = TM.MetricsSink.load_jsonl(p)
    assert back.records == sinks[1].records
