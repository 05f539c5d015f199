"""The port's native PNG loader and prefetcher (lldslam_tpu_torch/native,
io/datasets.py) and its PNG writer (io/png.py, io/synthetic.py) against PIL
and the JAX package's native loader.

The port decodes PNGs with its own chunk parser, zlib inflate and scanline
filters (the machine with the card has no libpng), for 8-bit grayscale
files that are not interlaced, what KITTI and EuRoC store: there it must
equal PIL and the JAX loader byte for byte. Every other format raises with
a message that names it (the JAX loader converts such files through
libpng's simplified API instead, which is not what PIL gives either).
"""
import re
import struct
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
from PIL import Image  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from lldslam_tpu import native as jnative  # noqa: E402
from lldslam_tpu_torch import native  # noqa: E402
from lldslam_tpu_torch.config import load_config  # noqa: E402
from lldslam_tpu_torch.io import datasets  # noqa: E402
from lldslam_tpu_torch.io.png import encode_png, write_png  # noqa: E402
from lldslam_tpu_torch.io.synthetic import make_sequence  # noqa: E402
from lldslam_tpu_torch.io.synthetic import write_kitti_sequence  # noqa: E402

MINI = ROOT / "tests" / "data" / "mini_kitti"


@pytest.fixture(scope="module")
def gray_pngs(tmp_path_factory):
    """Six random 8-bit gray images of two sizes, written by PIL."""
    d = tmp_path_factory.mktemp("pngs")
    rng = np.random.default_rng(0)
    imgs = []
    for i in range(6):
        img = rng.integers(0, 256, (48, 64), dtype=np.uint8)
        img[:, :20] = np.arange(20, dtype=np.uint8)[None] * 9   # smooth part
        Image.fromarray(img).save(d / f"{i:06d}.png", optimize=bool(i % 2))
        imgs.append(img)
    return d, imgs


def _jax_loader(paths, **kw):
    assert jnative.get_lib() is not None, "the JAX loader did not build"
    return jnative.NativeImageLoader(paths, **kw)


def test_loader_matches_pil_and_jax(gray_pngs):
    """Out-of-order access (window 3, two threads): every frame equals PIL's
    decode and the JAX package's native loader; frames asked for again
    after they were read come back the same (the port decodes them again;
    the JAX loader has released their pixels and cannot return a frame
    twice); `load_gray` is the float32 copy."""
    d, imgs = gray_pngs
    paths = [d / f"{i:06d}.png" for i in range(6)]
    jl = _jax_loader(paths, window=3, n_threads=2)
    with native.NativeImageLoader(paths, window=3, n_threads=2) as ld:
        assert len(ld) == 6 and (ld.h, ld.w) == (48, 64)
        for k, i in enumerate([0, 2, 1, 5, 3, 4, 0, 5, 1]):
            got = ld.frame(i)
            assert got.dtype == np.uint8
            np.testing.assert_array_equal(got, imgs[i])
            np.testing.assert_array_equal(got,
                                          np.asarray(Image.open(paths[i])))
            if k < 6:
                np.testing.assert_array_equal(got, jl.frame(i))
    jl.close()
    for i in range(6):
        g = datasets.load_gray(paths[i])
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, imgs[i].astype(np.float32))


def test_loader_on_mini_kitti():
    """The checked-in mini KITTI sequence (20 PNGs): the prefetched
    sequence, PIL and the JAX loader agree byte for byte, with the
    timestamps of times.txt."""
    seq = datasets.load_kitti(MINI)
    pre = datasets.prefetch(seq, window=4, n_threads=2)
    jl = _jax_loader(seq.left + seq.right)
    for i in range(len(seq)):
        left, right, ts = pre.frame(i)
        assert ts == float(seq.timestamps[i])
        for got, path, j in ((left, seq.left[i], i),
                             (right, seq.right[i], len(seq) + i)):
            np.testing.assert_array_equal(got, np.asarray(Image.open(path)))
            np.testing.assert_array_equal(got, jl.frame(j))
    pre.close()
    jl.close()


def _pil_file(tmp_path, kind):
    rng = np.random.default_rng(1)
    path = tmp_path / f"{kind}.png"
    if kind == "gray16":
        Image.fromarray(rng.integers(0, 65535, (20, 30), dtype=np.uint16)
                        ).save(path)
    elif kind == "rgb":
        Image.fromarray(rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)
                        ).save(path)
    elif kind == "gray_alpha":
        Image.fromarray(rng.integers(0, 256, (20, 30), dtype=np.uint8)
                        ).convert("LA").save(path)
    elif kind == "palette":
        Image.fromarray(rng.integers(0, 256, (20, 30), dtype=np.uint8)
                        ).convert("P").save(path)
    return path


@pytest.mark.parametrize("kind,named", [
    ("gray16", "16-bit grayscale"), ("rgb", "8-bit RGB"),
    ("gray_alpha", "8-bit grayscale+alpha"), ("palette", "8-bit palette")])
def test_other_formats_raise(tmp_path, kind, named):
    """A PNG that is not 8-bit grayscale raises, naming its format, from
    `load_gray`, the loader and the prefetched sequence; nothing converts
    it (the JAX loader does, through libpng)."""
    path = _pil_file(tmp_path, kind)
    with pytest.raises(RuntimeError,
                       match=re.escape(named) + ".*8-bit grayscale"):
        datasets.load_gray(path)
    with native.NativeImageLoader([path], window=1, n_threads=1) as ld:
        with pytest.raises(RuntimeError, match=re.escape(named)):
            ld.frame(0)
    assert jnative.NativeImageLoader([path]).frame(0).shape == (20, 30)


def test_broken_files_raise(tmp_path):
    """A file that is not a PNG, one with a damaged chunk (CRC) and a
    missing one raise with what is wrong."""
    img = np.arange(600, dtype=np.uint8).reshape(20, 30)
    data = bytearray(encode_png(img))
    (tmp_path / "text.png").write_bytes(b"not a png at all")
    data[40] ^= 0xFF                    # inside the IDAT payload
    (tmp_path / "crc.png").write_bytes(bytes(data))
    for name, what in (("text.png", "not a PNG"), ("crc.png", "corrupt"),
                       ("absent.png", "cannot be opened")):
        with pytest.raises(RuntimeError, match=what):
            datasets.load_gray(tmp_path / name)


def _png_with_filters(img, filters):
    """An 8-bit gray PNG whose row y uses scanline filter filters[y]
    (0 none, 1 sub, 2 up, 3 average, 4 Paeth), written by hand."""
    h, w = img.shape
    x = img.astype(np.int32)
    raw = bytearray()
    for y in range(h):
        a = np.concatenate([[0], x[y, :-1]])
        b = x[y - 1] if y else np.zeros(w, np.int32)
        c = np.concatenate([[0], b[:-1]])
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = [np.zeros(w, np.int32), a, b, (a + b) // 2, paeth][filters[y]]
        raw += bytes([filters[y]]) + ((x[y] - pred) % 256).astype(
            np.uint8).tobytes()
    chunk = lambda k, d: (struct.pack(">I", len(d)) + k + d + struct.pack(
        ">I", zlib.crc32(k + d) & 0xFFFFFFFF))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"tEXt", b"Comment\x00an ancillary chunk")
            + chunk(b"IEND", b""))


def test_every_scanline_filter(tmp_path):
    """Rows written with each of the five filters decode to the image, as
    PIL decodes them."""
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (25, 33), dtype=np.uint8)
    img[5:15] = np.clip(np.arange(33) * 7, 0, 255).astype(np.uint8)[None]
    path = tmp_path / "filters.png"
    path.write_bytes(_png_with_filters(img, [y % 5 for y in range(25)]))
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    np.testing.assert_array_equal(native.read_png(path), img)


def test_prefetch_returns_frames_and_timestamps(gray_pngs):
    """`prefetch` wraps a StereoSequence: frames in order and out of order
    with their timestamps; a sequence it cannot read raises instead of
    coming back unwrapped."""
    d, imgs = gray_pngs
    seq = datasets.StereoSequence(
        left=[d / f"{i:06d}.png" for i in range(3)],
        right=[d / f"{i:06d}.png" for i in range(3, 6)],
        timestamps=np.array([0.0, 0.1, 0.2]))
    pre = datasets.prefetch(seq, window=2, n_threads=1)
    assert isinstance(pre, datasets.PrefetchedStereoSequence)
    assert len(pre) == 3
    for i in (1, 0, 2, 1):
        left, right, ts = pre.frame(i)
        np.testing.assert_array_equal(left, imgs[i])
        np.testing.assert_array_equal(right, imgs[3 + i])
        assert ts == seq.timestamps[i]
    pre.close()
    bad = datasets.StereoSequence(left=[d / "absent.png"], right=[d / "x.png"],
                                  timestamps=np.zeros(1))
    with pytest.raises(RuntimeError, match="cannot be opened"):
        datasets.prefetch(bad)


def test_build_without_compiler_raises(tmp_path, monkeypatch):
    """A build that cannot find its compiler raises; it is not skipped and
    nothing falls back to another decoder."""
    monkeypatch.setattr(native, "COMPILER", "no-such-compiler-g++")
    with pytest.raises(RuntimeError, match="no-such-compiler-g.. not found"):
        native.build(tmp_path / "build")
    assert not (tmp_path / "build").exists()
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="not found"):
        native.read_png(MINI / "image_0" / "000000.png")


def test_png_writer_round_trips(tmp_path):
    """io/png.py's gray and RGB files read back through PIL and (gray)
    through the loader; write_kitti_sequence writes a sequence that
    load_kitti, the prefetcher and load_config read back as written."""
    from lldslam_tpu_torch.config import (CameraConfig, LineConfig,
                                          SlamConfig, TrackingConfig)
    from lldslam_tpu_torch.ops.orb import OrbConfig

    rng = np.random.default_rng(3)
    gray = rng.integers(0, 256, (37, 53), dtype=np.uint8)
    rgb = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    write_png(tmp_path / "g.png", gray)
    write_png(tmp_path / "c.png", rgb)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "g.png")),
                                  gray)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "c.png")),
                                  rgb)
    np.testing.assert_array_equal(native.read_png(tmp_path / "g.png"), gray)
    with pytest.raises(ValueError):
        encode_png(gray.astype(np.float32))

    cfg = SlamConfig(
        camera=CameraConfig(fx=450.0, fy=450.0, cx=80.0, cy=30.0, bf=200.0,
                            fps=10.0, width=160, height=60),
        orb=OrbConfig(n_features=300), tracking=TrackingConfig(
            min_init_points=40), line=LineConfig(ld_type="LBDFloat",
                                                 md_thr=0.6))
    frames, poses, _ = make_sequence(cfg.camera.stereo_camera(), 3, seed=1,
                                     return_poses=True)
    seq_dir = tmp_path / "seq"
    write_kitti_sequence(seq_dir, frames, cfg, poses)
    assert load_config(seq_dir / "settings.yaml") == cfg
    pre = datasets.prefetch(datasets.load_kitti(seq_dir))
    for i, (left, right) in enumerate(frames):
        got_l, got_r, ts = pre.frame(i)
        np.testing.assert_array_equal(got_l, left)
        np.testing.assert_array_equal(got_r, right)
        np.testing.assert_array_equal(
            np.asarray(Image.open(seq_dir / "image_1" / f"{i:06d}.png")),
            right)
        assert ts == pytest.approx(0.1 * i)
    pre.close()
    gt = np.loadtxt(seq_dir / "gt.txt").reshape(-1, 3, 4)
    np.testing.assert_allclose(gt, np.stack([np.linalg.inv(p)[:3]
                                             for p in poses]), atol=1e-6)
