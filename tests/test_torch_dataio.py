"""The port's data entry point against the JAX package: the native PNG
decoder (the port's own ``csrc/mvo_io.cpp``, built with g++ at first use),
the prefetching reader, the three dataset loaders and the synthetic frame
cache and realism stress.

Test PNGs come from a writer here that sets each row's filter (None, Sub,
Up, Average, Paeth in turn), so every reconstruction path is decoded.
Tolerances: none.  Both decoders are the same C++ and must agree bit for
bit; the loaders' fields, frames and the numpy synthetic functions are
equal.
"""
import dataclasses
import os
import struct
import threading
import time
import zlib

import numpy as np
import pytest

from monocular_visual_odometry_va4mr_torch.dataio import datasets as tds
from monocular_visual_odometry_va4mr_torch.dataio import native_io as tio
from monocular_visual_odometry_va4mr_torch.dataio import synthetic as tsyn

CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Adam7 passes: (x0, y0, dx, dy).
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
# A palette of 256 distinct colours, so gray reduction is exercised.
PALETTE = np.random.default_rng(99).integers(0, 256, (256, 3), dtype=np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def filter_rows(raw: np.ndarray, bpp: int, filters) -> bytes:
    """PNG filtering of (H, stride) uint8 rows: row y takes filter
    ``filters[y % len(filters)]``."""
    H, stride = raw.shape
    x = raw.astype(np.int32)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    pred = {0: 0, 1: a, 2: b, 3: (a + b) // 2, 4: paeth}
    ftype = np.array([filters[y % len(filters)] for y in range(H)])
    out = np.empty((H, stride + 1), np.uint8)
    out[:, 0] = ftype
    for f in set(ftype.tolist()):
        rows = ftype == f
        out[rows, 1:] = ((x - pred[f]) & 0xFF)[rows]
    return out.tobytes()


def png_bytes(img: np.ndarray, color_type: int, *, bit_depth: int = 8,
              filters=(0, 1, 2, 3, 4), interlace: int = 0) -> bytes:
    """A PNG of ``img`` ((H, W) or (H, W, C), uint8 or uint16)."""
    H, W = img.shape[:2]
    ch = CHANNELS[color_type]
    samples = img.reshape(H, W * ch)
    if bit_depth == 16:
        raw = samples.astype(">u2").view(np.uint8).reshape(H, W * ch * 2)
    else:
        raw = samples.astype(np.uint8)
    bpp = max(1, ch * bit_depth // 8)
    body = (_chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, bit_depth,
                                        color_type, 0, 0, interlace)))
    if color_type == 3:
        body += _chunk(b"PLTE", PALETTE.tobytes())
    if interlace:  # Adam7: seven reduced images, each filtered on its own
        raw = raw.reshape(H, W, -1)
        data = b"".join(
            filter_rows(np.ascontiguousarray(sub.reshape(sub.shape[0], -1)),
                        bpp, filters)
            for sub in (raw[y0::dy, x0::dx] for x0, y0, dx, dy in ADAM7)
            if sub.size)
    else:
        data = filter_rows(raw, bpp, filters)
    body += _chunk(b"IDAT", zlib.compress(data))
    return b"\x89PNG\r\n\x1a\n" + body + _chunk(b"IEND", b"")


def write_png(path, img, color_type=0, **kw):
    os.makedirs(os.path.dirname(str(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(png_bytes(img, color_type, **kw))


def gray(rng, H=48, W=64):
    return rng.integers(0, 256, (H, W), dtype=np.uint8)


def jax_io():
    from monocular_visual_odometry_va4mr_tpu.dataio import native_io

    assert native_io.available()
    return native_io


# --- decoder -----------------------------------------------------------------

CASES = {
    "gray8": (0, 8, None), "gray16": (0, 16, None), "gray_alpha": (4, 8, 2),
    "rgb": (2, 8, 3), "rgba": (6, 8, 4),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     (0, 1, 2, 3, 4)],
                         ids=["none", "sub", "up", "average", "paeth",
                              "mixed"])
def test_decode_equals_the_jax_decoder(tmp_path, case, filters):
    color_type, depth, ch = CASES[case]
    rng = np.random.default_rng(len(case) * 10 + filters[0])
    H, W = 37, 53  # odd sizes: no row lines up with a word
    hi = 65536 if depth == 16 else 256
    shape = (H, W) if ch is None else (H, W, ch)
    img = rng.integers(0, hi, shape).astype(np.uint16 if depth == 16
                                            else np.uint8)
    path = str(tmp_path / "f.png")
    write_png(path, img, color_type, bit_depth=depth, filters=filters)
    ours = tio.decode_png(path)
    ref = jax_io().decode_png(path)
    assert ours is not None and ours.dtype == np.float32
    assert ours.shape == (H, W)
    np.testing.assert_array_equal(ours, ref)
    if case == "gray8":
        np.testing.assert_array_equal(ours, img.astype(np.float32))
    if case == "gray_alpha":
        np.testing.assert_array_equal(ours, img[..., 0].astype(np.float32))


@pytest.mark.parametrize("kind", ["palette", "interlaced", "rgb16",
                                  "truncated", "not_png", "missing"])
def test_unsupported_pngs_give_none(tmp_path, kind):
    rng = np.random.default_rng(1)
    path = str(tmp_path / "f.png")
    if kind == "palette":
        write_png(path, gray(rng), 3)
    elif kind == "interlaced":
        write_png(path, gray(rng), 0, interlace=1)
    elif kind == "rgb16":
        write_png(path, rng.integers(0, 65536, (8, 8, 3)).astype(np.uint16),
                  2, bit_depth=16)
    elif kind == "truncated":
        data = png_bytes(gray(rng), 0)
        with open(path, "wb") as f:
            f.write(data[:len(data) // 2])
    elif kind == "not_png":
        with open(path, "wb") as f:
            f.write(b"GIF89a" + bytes(64))
    assert tio.decode_png(path) is None
    assert jax_io().decode_png(path) is None


def test_decoder_builds_from_the_port_source():
    from monocular_visual_odometry_va4mr_torch import _build

    lib, _, _ = _build.build_host("mvo_io")
    assert lib.parent == _build.BUILD_DIR
    assert lib.name.startswith("mvo_io-") and lib.exists()
    # One build: zlib's header and -lz, so a machine without them fails
    # the build instead of getting another decoder.
    assert _build.HOST_LINK == ("-lz", "-lpthread")
    assert b"#include <zlib.h>" in (_build.CSRC / "mvo_io.cpp").read_bytes()


# --- prefetching reader ------------------------------------------------------

def write_stream(root, n, rng, H=40, W=56):
    imgs = [gray(rng, H, W) for _ in range(n)]
    paths = [str(root / f"{i:06d}.png") for i in range(n)]
    for p, img in zip(paths, imgs):
        write_png(p, img)
    return imgs, paths


@pytest.mark.parametrize("threads,prefetch", [(1, 1), (4, 3), (8, 16)])
def test_reader_order_equals_one_shot_decodes(tmp_path, threads, prefetch):
    imgs, paths = write_stream(tmp_path, 23, np.random.default_rng(threads))
    with tio.PrefetchingReader(paths, num_threads=threads,
                               prefetch=prefetch) as reader:
        got = list(reader)
    assert [i for i, _ in got] == list(range(len(paths)))
    for (_, frame), img, p in zip(got, imgs, paths):
        np.testing.assert_array_equal(frame, img.astype(np.float32))
        np.testing.assert_array_equal(frame, tio.decode_png(p))


def test_reader_early_close_returns_promptly(tmp_path):
    _, paths = write_stream(tmp_path, 60, np.random.default_rng(3))
    reader = tio.PrefetchingReader(paths, num_threads=4, prefetch=2)
    it = iter(reader)
    for _ in range(3):
        next(it)
    time.sleep(0.2)  # the workers are now waiting on cv_space
    closer = threading.Thread(target=reader.close, daemon=True)
    t0 = time.perf_counter()
    closer.start()
    closer.join(timeout=10.0)
    assert not closer.is_alive(), "close() hung on the waiting workers"
    assert time.perf_counter() - t0 < 5.0
    with pytest.raises(IOError):
        next(it)


@pytest.mark.parametrize("threads,prefetch", [(0, 8), (4, 0)])
def test_reader_rejects_an_empty_pool(tmp_path, threads, prefetch):
    _, paths = write_stream(tmp_path, 2, np.random.default_rng(6))
    with pytest.raises(ValueError, match="must be >= 1"):
        tio.PrefetchingReader(paths, num_threads=threads, prefetch=prefetch)


def test_reader_raises_on_a_bad_frame(tmp_path):
    _, paths = write_stream(tmp_path, 5, np.random.default_rng(4))
    write_png(paths[3], gray(np.random.default_rng(5)), 3)  # palette
    with tio.PrefetchingReader(paths) as reader:
        it = iter(reader)
        for _ in range(3):
            next(it)
        with pytest.raises(IOError, match="frame 3"):
            next(it)


# --- loaders -----------------------------------------------------------------

def kitti_root(tmp_path, n=5):
    root = tmp_path / "kitti"
    for i in range(n):
        write_png(root / "05" / "image_0" / f"{i:06d}.png",
                  gray(np.random.default_rng(i)))
    poses = np.tile(np.eye(3, 4).reshape(-1), (n, 1))
    poses[:, 3] = np.arange(n)
    poses[:, 11] = 0.5 * np.arange(n)
    os.makedirs(root / "poses", exist_ok=True)
    np.savetxt(root / "poses" / "05.txt", poses)
    return str(root)


def malaga_root(tmp_path, n=8):
    root = tmp_path / "malaga"
    d = root / "malaga-urban-dataset-extract-07_rectified_800x600_Images"
    for i in range(n):
        side = "left" if i % 2 == 0 else "right"
        write_png(d / f"img_{i:03d}_{side}.png", gray(np.random.default_rng(i)))
    return str(root)


def parking_root(tmp_path, n=4):
    root = tmp_path / "parking"
    for i in range(n):
        write_png(root / "images" / f"img_{i:05d}.png",
                  gray(np.random.default_rng(i)))
    np.savetxt(root / "poses.txt", np.tile(np.eye(3, 4).reshape(-1), (n, 1)))
    return str(root)


def colour(rng, H=48, W=64, C=3):
    """A colour image whose chroma varies slowly, as in a photo (8x8 blocks
    plus noise), so subsampled JPEG chroma and the luma plane part
    visibly."""
    img = rng.integers(0, 256, (H // 8 + 2, W // 8 + 2, C)).astype(np.float64)
    img = np.kron(img, np.ones((8, 8, 1)))[:H, :W]
    img += rng.normal(0, 24, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def malaga_jpeg_root(tmp_path, n=8):
    """Colour JPEGs, as the real Malaga extract ships them."""
    from PIL import Image

    root = tmp_path / "malaga"
    d = root / "malaga-urban-dataset-extract-07_rectified_800x600_Images"
    os.makedirs(d)
    for i in range(n):
        side = "left" if i % 2 == 0 else "right"
        Image.fromarray(colour(np.random.default_rng(i), 120, 160)).save(
            d / f"img_{i:03d}_{side}.jpg", quality=95)
    return str(root)


# Frame kinds of the colour PNG layouts: (colour type, bit depth,
# channels, interlace).  Each colour layout stores one frame of each kind.
PNG_KINDS = {
    "native": [(2, 8, 3, 0), (6, 8, 4, 0), (4, 8, 2, 0), (0, 8, 1, 0)],
    "pil": [(3, 8, 1, 0), (0, 8, 1, 1), (2, 8, 3, 1), (0, 16, 1, 0)],
}


def parking_png_root(tmp_path, kinds):
    root = tmp_path / "parking"
    for i, (ct, depth, ch, interlace) in enumerate(PNG_KINDS[kinds]):
        rng = np.random.default_rng(i)
        if depth == 16:
            img = rng.integers(0, 65536, (48, 64), dtype=np.uint16)
        elif ct == 3:
            img = rng.integers(0, 256, (48, 64), dtype=np.uint8)
        else:
            img = colour(rng, C=ch)
            img = img[..., 0] if ch == 1 else img
        write_png(root / "images" / f"img_{i:05d}.png", img, ct,
                  bit_depth=depth, interlace=interlace)
    n = len(PNG_KINDS[kinds])
    np.savetxt(root / "poses.txt", np.tile(np.eye(3, 4).reshape(-1), (n, 1)))
    return str(root)


LAYOUTS = {
    "kitti": (kitti_root, {}), "kitti_cap": (kitti_root, dict(last_frame=4)),
    "malaga": (malaga_root, {}), "parking": (parking_root,
                                             dict(last_frame=4)),
    # Colour JPEG (the real Malaga extract): luma straight from libjpeg.
    "malaga_jpeg": (malaga_jpeg_root, {}),
    # Colour, gray + alpha: load_frame rounds as cv2, frames() stays on the
    # native decoder's unrounded BT.601 (both as the reference).
    "parking_colour": (lambda p: parking_png_root(p, "native"),
                       dict(last_frame=4)),
    # Palette, interlaced, 16-bit: load_frame reads them as cv2 does; the
    # native reader of either package refuses them.
    "parking_palette_interlaced": (lambda p: parking_png_root(p, "pil"),
                                   dict(last_frame=4)),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_loaders_equal_the_jax_loaders(tmp_path, layout):
    from monocular_visual_odometry_va4mr_tpu.dataio import datasets as jds

    make, kw = LAYOUTS[layout]
    root = make(tmp_path)
    name = layout.split("_")[0]
    ours = tds.LOADERS[name](root, **kw)
    ref = jds.LOADERS[name](root, **kw)
    assert ours.name == ref.name
    assert ours.num_frames == ref.num_frames
    assert ours.frame_paths == ref.frame_paths
    assert ours.bootstrap_frames == ref.bootstrap_frames
    np.testing.assert_array_equal(ours.K, ref.K)
    assert dataclasses.asdict(ours.config) == dataclasses.asdict(ref.config)
    if ref.gt_poses is None:
        assert ours.gt_poses is None and ours.gt_xz is None
    else:
        np.testing.assert_array_equal(ours.gt_poses, ref.gt_poses)
        np.testing.assert_array_equal(ours.gt_xz, ref.gt_xz)
        np.testing.assert_array_equal(ours.gt_positions, ref.gt_positions)
    streams = []
    for prefetch in (True, False):
        try:
            ref_frames = list(ref.frames(prefetch=prefetch))
        except OSError:  # the reference's native reader refuses the file
            with pytest.raises(OSError):
                list(ours.frames(prefetch=prefetch))
            continue
        streams.append(prefetch)
        got = list(ours.frames(prefetch=prefetch))
        assert [i for i, _ in got] == [i for i, _ in ref_frames]
        for (_, a), (_, b) in zip(got, ref_frames):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    # cv2 and the port agree bit for bit on every frame kind: the largest
    # difference is 0 gray levels on 0% of the pixels.
    for i in range(ours.num_frames):
        np.testing.assert_array_equal(ours.load_frame(i), ref.load_frame(i))
    assert [i for i, _ in ours.frames(start=2, prefetch=streams[0])] == list(
        range(2, ours.num_frames))


def test_an_unsupported_png_frame_raises(tmp_path):
    """A frame no decoder reads raises (the reference's cv2 returns None
    and its loader raises too); palette and interlaced PNGs now load."""
    root = parking_root(tmp_path)
    data = png_bytes(gray(np.random.default_rng(0)), 0)
    spec = tds.load_parking(root, last_frame=4)
    for bad in (data[:40], b"GIF89a" + data[6:]):  # truncated, not a PNG
        with open(spec.frame_paths[1], "wb") as f:
            f.write(bad)
        with pytest.raises(ValueError, match="not a readable PNG"):
            spec.load_frame(1)


def test_non_png_frames_go_through_pil(tmp_path):
    pil = pytest.importorskip("PIL.Image")
    root = tmp_path / "malaga"
    d = root / "malaga-urban-dataset-extract-07_rectified_800x600_Images"
    os.makedirs(d)
    rng = np.random.default_rng(0)
    imgs = []
    for i in range(6):
        img = gray(rng)
        pil.fromarray(img).save(d / f"img_{i:03d}.bmp")
        imgs.append(img)
    spec = tds.load_malaga(str(root))
    assert spec.num_frames == 2
    got = list(spec.frames())
    np.testing.assert_array_equal(got[0][1], imgs[2].astype(np.float32))
    np.testing.assert_array_equal(got[1][1], imgs[4].astype(np.float32))


def test_non_png_frames_without_pil_name_the_decoder(tmp_path, monkeypatch):
    import sys

    path = tmp_path / "f.jpg"
    path.write_bytes(b"\xff\xd8\xff")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PIL"):
        tds._imread_gray(str(path))


# --- synthetic frame cache and realism stress ------------------------------

def stress_frames():
    rng = np.random.default_rng(11)
    base = rng.uniform(0, 255, (6, 40, 56)).astype(np.float32)
    return [f for f in base]


AUGMENTS = {
    "noise": dict(noise_std=2.0), "exposure": dict(exposure_drift=0.10),
    "vignette": dict(vignette=0.2), "occluder": dict(occluder_frac=0.10),
    "blur": dict(motion_blur_px=3), "gamma": dict(gamma=0.7),
    "photometric": dict(noise_std=2.0, exposure_drift=0.10, vignette=0.2,
                        occluder_frac=0.02),
    "hard": dict(noise_std=2.0, exposure_drift=0.10, occluder_frac=0.10,
                 motion_blur_px=3, gamma=0.7),
}


@pytest.mark.parametrize("name", sorted(AUGMENTS))
def test_augment_frames_bit_equal(name):
    from monocular_visual_odometry_va4mr_tpu.dataio import synthetic as jsyn

    frames = stress_frames()
    ours = tsyn.augment_frames(frames, seed=3, **AUGMENTS[name])
    ref = jsyn.augment_frames(frames, seed=3, **AUGMENTS[name])
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_render_all_cached_round_trip(tmp_path):
    from monocular_visual_odometry_va4mr_tpu.dataio import synthetic as jsyn

    kw = dict(seed=7, num_frames=3, image_shape=(48, 64), step=1.0)
    scene = tsyn.make_textured_scene(**kw)
    assert tsyn.SCENE_VERSION == jsyn.SCENE_VERSION
    calls = []

    def render(sc):
        calls.append(sc.num_frames)
        return [tsyn.render_frame(sc, i) for i in range(sc.num_frames)]

    first = tsyn.render_all_cached(scene, "t", str(tmp_path / "a"),
                                   render=render)
    again = tsyn.render_all_cached(scene, "t", str(tmp_path / "a"),
                                   render=render)
    assert calls == [3]  # the second call reads the cache
    assert (tmp_path / "a" / f"v{tsyn.SCENE_VERSION}-t.npz").exists()
    ref = jsyn.render_all_cached(jsyn.make_textured_scene(**kw), "t",
                                 str(tmp_path / "b"))
    serial = tsyn.render_all_cached(scene, "t", str(tmp_path / "c"))
    for a, b, c, d in zip(first, again, ref, serial):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(a, d)


def test_render_cache_defaults_to_the_checkout_build_dir():
    import inspect

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert str(tsyn.SCENE_CACHE) == os.path.join(root, "build", "scene_cache")
    default = inspect.signature(tsyn.render_all_cached).parameters[
        "cache_dir"].default
    assert default is None
