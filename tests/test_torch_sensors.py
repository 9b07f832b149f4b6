"""The port's sensor layer against ``icp_tpu.sensors``: the PNG codec that
stands in for PIL, the cloud IO, ``pinhole.project``,
``synthetic.orbit_trajectory`` and the guided filter.

Tolerances: the PNG codec, the IO, ``project`` and ``orbit_trajectory``
are bitwise. The guided filter's box sums are float32 cumulative sums; the
two packages add in different orders (torch's CPU cumsum runs
sequentially, XLA's is a tree), so a box mean differs by up to a few ulps of
the largest running sum over the window's area. The test images are 96 x 128
crops of a rendered frame, where the measured gap is far below the bounds
stated at each test: the box filter within 4 eps32 * sum|x| / (smallest
window area), the filtered depth within 0.05 mm, the filtered colour
within 1e-4.
"""

import tests.torch_one_thread  # noqa: F401  (torch on one CPU thread)
import zlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from icp_tpu.sensors import guided_filter as JGF
from icp_tpu.sensors import io as JIO
from icp_tpu.sensors import pinhole as JPH
from icp_tpu.sensors import synthetic as JY
from icp_tpu_torch.sensors import _png
from icp_tpu_torch.sensors import guided_filter as TGF
from icp_tpu_torch.sensors import io as TIO
from icp_tpu_torch.sensors import pinhole as TPH
from icp_tpu_torch.sensors import synthetic as TY
from tests.utils import make_cloud8

EPS32 = float(np.finfo(np.float32).eps)


def _filters(path) -> set:
    """The row filter types a PNG file uses (8-bit RGB or 16-bit gray)."""
    data = open(path, "rb").read()
    w, h, depth, ctype = np.frombuffer(data[16:26], ">u4", 2).tolist() + list(data[24:26])
    idat, pos = b"", 8
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    bpp = {0: 1, 2: 3, 6: 4}[ctype] * depth // 8
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w * bpp + 1)
    return set(raw[:, 0].tolist())


@pytest.fixture(scope="module")
def photo():
    """A textured 8-bit RGB image: a crop of the repository's photograph
    with noise, so PIL's optimizer picks every row filter."""
    Image = pytest.importorskip("PIL.Image")
    img = np.asarray(Image.open("data/real/grace_hopper.jpg"))[100:220, 50:210]
    rng = np.random.default_rng(3)
    noisy = img.astype(np.int16) + rng.integers(-3, 4, img.shape)
    return np.clip(noisy, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("optimize", [False, True])
def test_png_reads_pil_rgb(tmp_path, photo, optimize):
    """PIL-written 8-bit RGB read bitwise; PIL's encoder filters the rows
    (Sub, Up and Paeth on this image)."""
    Image = pytest.importorskip("PIL.Image")
    p = tmp_path / "rgb.png"
    Image.fromarray(photo).save(p, optimize=optimize)
    assert len(_filters(p) - {0}) >= 2
    got = _png.read_png(p)
    assert got.dtype == np.uint8 and np.array_equal(got, photo)


@pytest.mark.parametrize("optimize", [False, True])
def test_png_reads_pil_depth16(tmp_path, optimize):
    """PIL-written 16-bit gray (TUM depth) read bitwise, filters in use."""
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(4)
    depth = (1000 + 4000 * rng.random((60, 80))).astype(np.uint16)
    depth[:, 40:] = np.cumsum(rng.integers(0, 9, (60, 40)), axis=1).astype(np.uint16)
    depth[10:20, 10:30] = 0
    p = tmp_path / "d.png"
    Image.fromarray(depth).save(p, optimize=optimize)
    assert len(_filters(p) - {0}) >= 2
    got = _png.read_png(p)
    assert got.dtype == np.uint16 and np.array_equal(got, depth)


def _filter_rows(img: np.ndarray, bpp: int) -> bytes:
    """PNG image data with row y filtered by type y % 5 (None, Sub, Up,
    Average, Paeth), as the PNG specification defines the filters."""
    rows = np.ascontiguousarray(img).view(np.uint8).reshape(img.shape[0], -1).astype(np.int32)
    out, prev = [], np.zeros(rows.shape[1], np.int32)
    for y, x in enumerate(rows):
        a = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        b = prev
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = [0, a, b, (a + b) // 2, paeth][y % 5]
        out.append(bytes([y % 5]) + ((x - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = x
    return b"".join(out)


@pytest.mark.parametrize("kind", ["rgb8", "gray16"])
def test_png_reads_every_row_filter(tmp_path, photo, kind):
    """Rows filtered by each of the five filters in turn: PIL's decoder and
    _png's give the same pixels, the image's own."""
    Image = pytest.importorskip("PIL.Image")
    import struct

    img = photo if kind == "rgb8" else (photo[..., 0].astype(np.uint16) * 257 + 7)
    bpp, ctype, depth = (3, 2, 8) if kind == "rgb8" else (2, 0, 16)
    body = img if kind == "rgb8" else img.astype(">u2")

    def chunk(k, payload):
        return struct.pack(">I", len(payload)) + k + payload + struct.pack(
            ">I", zlib.crc32(k + payload))

    p = tmp_path / "filters.png"
    p.write_bytes(b"\x89PNG\r\n\x1a\n"
                  + chunk(b"IHDR", struct.pack(">IIBBBBB", img.shape[1], img.shape[0],
                                               depth, ctype, 0, 0, 0))
                  + chunk(b"IDAT", zlib.compress(_filter_rows(body, bpp)))
                  + chunk(b"IEND", b""))
    assert _filters(p) == {0, 1, 2, 3, 4}
    assert np.array_equal(np.asarray(Image.open(p)).astype(img.dtype), img)
    assert np.array_equal(_png.read_png(p), img)


@pytest.mark.parametrize("kind", ["gray8", "rgb8", "rgba8", "gray16"])
def test_png_written_reads_in_pil(tmp_path, kind):
    """_png-written files read bitwise by PIL and by _png."""
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(5)
    img = {"gray8": rng.integers(0, 256, (33, 47), dtype=np.uint8),
           "rgb8": rng.integers(0, 256, (33, 47, 3), dtype=np.uint8),
           "rgba8": rng.integers(0, 256, (33, 47, 4), dtype=np.uint8),
           "gray16": rng.integers(0, 65536, (33, 47), dtype=np.uint16)}[kind]
    p = tmp_path / f"{kind}.png"
    _png.write_png(p, img)
    back = np.asarray(Image.open(p))
    assert back.shape == img.shape and np.array_equal(back.astype(img.dtype), img)
    assert np.array_equal(_png.read_png(p), img)


@pytest.mark.parametrize("kind", ["interlaced", "palette"])
def test_png_refuses_unsupported(tmp_path, kind):
    """Interlaced (Adam7: the header's interlace byte set, its CRC
    repaired) and palette (PIL's "P" mode) images raise instead of decoding
    wrongly."""
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(6)
    img = Image.fromarray(rng.integers(0, 256, (16, 16, 3), dtype=np.uint8))
    p = tmp_path / f"{kind}.png"
    if kind == "interlaced":
        img.save(p)
        data = bytearray(p.read_bytes())
        data[28] = 1  # IHDR: 8 signature + 8 chunk head + 12 -> interlace byte
        data[29:33] = zlib.crc32(bytes(data[12:29])).to_bytes(4, "big")
        p.write_bytes(bytes(data))
        assert Image.open(p).info.get("interlace") == 1
    else:
        img.convert("P").save(p)
    with pytest.raises(ValueError):
        _png.read_png(p)


def test_png_refuses_other_depths(tmp_path):
    with pytest.raises(ValueError):
        _png.write_png(tmp_path / "f.png", np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError):
        _png.write_png(tmp_path / "g.png", np.zeros((4, 4, 3), np.uint16))


def test_cloud_io_bitwise(tmp_path):
    """The port's .bin writer and reader against the JAX package's."""
    cloud = make_cloud8(np.random.default_rng(7), 1000)
    pj, pt = tmp_path / "j.bin", tmp_path / "t.bin"
    JIO.write_cloud_bin(pj, cloud)
    TIO.write_cloud_bin(pt, cloud)
    assert pj.read_bytes() == pt.read_bytes()
    assert np.array_equal(TIO.read_cloud_bin(pj), JIO.read_cloud_bin(pt))
    with pytest.raises(ValueError):
        TIO.write_cloud_bin(tmp_path / "bad.bin", cloud[:, :7])


def test_write_ply_bitwise(tmp_path):
    cloud = make_cloud8(np.random.default_rng(8), 50)
    cloud[:5, :3] = 0.0
    for skip in (True, False):
        JIO.write_ply(tmp_path / "j.ply", cloud, skip_invalid=skip)
        TIO.write_ply(tmp_path / "t.ply", cloud, skip_invalid=skip)
        assert (tmp_path / "j.ply").read_text() == (tmp_path / "t.ply").read_text()


def test_project_bitwise():
    """``project`` equals JAX's, invalid (z <= 0) points included."""
    cloud = make_cloud8(np.random.default_rng(9), 500)
    cloud[:20, 2] = 0.0
    cloud[20:25, 2] = -5.0
    for j, t in zip(JPH.project(jnp.asarray(cloud)), TPH.project(torch.from_numpy(cloud))):
        assert np.array_equal(np.asarray(j), t.numpy())


@pytest.mark.parametrize("n, radius, yaw", [(1, 60.0, 0.06), (4, 40.0, 0.03),
                                            (100, 120.0, 0.12), (100, 60.0, 0.5)])
def test_orbit_trajectory_bitwise(n, radius, yaw):
    """Every pose's q and t bitwise the JAX package's, on the requested
    device."""
    jp = JY.orbit_trajectory(n, radius_mm=radius, yaw_rad=yaw)
    tp = TY.orbit_trajectory(n, radius_mm=radius, yaw_rad=yaw, device="cpu")
    assert len(tp) == n
    for a, b in zip(jp, tp):
        assert b.q.device.type == "cpu" and b.q.dtype == torch.float32
        assert np.array_equal(np.asarray(a.q), b.q.numpy())
        assert np.array_equal(np.asarray(a.t), b.t.numpy())


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the no-GPU default")
def test_constructors_default_to_the_card():
    """With no device named, the scene and pose constructors go to the
    card; without one they raise rather than fall back to the CPU."""
    for make in (TY.default_scene, TY.wall_scene, TY.CameraPose.identity,
                 lambda: TY.orbit_trajectory(2)):
        with pytest.raises((AssertionError, RuntimeError)):
            make()


@pytest.fixture(scope="module")
def images():
    """96 x 128 crops of a rendered frame's depth and colour (JAX's
    renderer), with a hole of invalid depth."""
    depth, rgb = JY.render(JY.default_scene(), JY.CameraPose.identity())
    d = np.array(depth)[200:296, 260:388].copy()
    d[30:45, 50:70] = 0.0
    return d, np.array(rgb)[200:296, 260:388].copy()


@pytest.mark.parametrize("r", [1, 2, 5])
def test_box_filter_matches_jax(images, r):
    """Within 4 eps32 * sum|x| over the smallest window's area ((r+1)^2,
    the corner's): the float32 cumsum bound."""
    d = images[0]
    got = TGF.box_filter(torch.from_numpy(d), r).numpy()
    want = np.asarray(JGF.box_filter(jnp.asarray(d), r))
    assert np.abs(got - want).max() <= 4 * EPS32 * np.abs(d).sum() / (r + 1) ** 2


@pytest.mark.parametrize("r", [2, 5])
def test_guided_filters_match_jax(images, r):
    """filter_depth within 0.05 mm and filter_rgb within 1e-4 of JAX's
    (a = cov / (var + eps) divides the box error of var by eps = 0.005);
    the same pixels invalid."""
    d, rgb = images
    td = TGF.filter_depth(torch.from_numpy(d), r).numpy()
    jd = np.asarray(JGF.filter_depth(jnp.asarray(d), r))
    assert np.array_equal(td == 0, d == 0)
    assert np.abs(td - jd).max() <= 0.05
    tr = TGF.filter_rgb(torch.from_numpy(rgb), r).numpy()
    jr = np.asarray(JGF.filter_rgb(jnp.asarray(rgb), r))
    assert np.abs(tr - jr).max() <= 1e-4


def test_guided_filter_properties():
    """The JAX tests' properties (tests/test_sensors.py): a constant is
    kept, noise is smoothed, an edge survives, invalid depth stays 0."""
    rng = np.random.default_rng(42)
    out = TGF.box_filter(torch.full((64, 64), 3.5), 5).numpy()
    np.testing.assert_allclose(out, 3.5, rtol=1e-6)

    clean = np.tile(np.linspace(0, 1, 64, dtype=np.float32), (64, 1))
    noisy = clean + rng.normal(0, 0.05, clean.shape).astype(np.float32)
    out = TGF.guided_filter(torch.from_numpy(noisy), torch.from_numpy(noisy),
                            radius=5, eps=0.01).numpy()
    assert np.abs(out - clean).mean() < np.abs(noisy - clean).mean() * 0.6

    step = np.zeros((64, 64), np.float32)
    step[:, 32:] = 1.0
    out = TGF.guided_filter(torch.from_numpy(step), torch.from_numpy(step),
                            radius=5, eps=1e-4).numpy()
    assert out[:, 40].mean() - out[:, 24].mean() > 0.9

    d = rng.uniform(800, 1200, (32, 32)).astype(np.float32)
    d[5:10, 5:10] = 0.0
    assert (TGF.filter_depth(torch.from_numpy(d)).numpy()[5:10, 5:10] == 0).all()
