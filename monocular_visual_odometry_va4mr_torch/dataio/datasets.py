"""Dataset loaders: KITTI odometry, Malaga urban, Parking (port of
``dataio/datasets.py``, the same layouts, frame caps, ground truth and
presets).

  * KITTI   — grayscale PNGs ``05/image_0/{i:06d}.png``, GT poses from
    ``poses/05.txt`` (3x4 row-major per line) (reference utils.py:16-25,
    :54-57); hard-coded K (utils.py:22-24).
  * Malaga  — every 2nd file starting from index 2 of the rectified
    800x600 image dir = left camera (utils.py:29-31); no GT (utils.py:33).
  * Parking — ``images/img_{i:05d}.png``, GT ``poses.txt`` (utils.py:39-48).

Ground truth is returned as full (N, 3, 4) pose matrices plus the (x, z)
pair the reference plots; a ``SequenceSpec`` carries the dataset's
``PipelineConfig`` preset.

Decoding follows the reference's ``cv2.imread(path, IMREAD_GRAYSCALE)``
bit for bit:

  * ``frames()`` streams ``.png`` frames through the native prefetching
    reader (``dataio/native_io.py``), as the reference's ``frames()`` does;
    a PNG it does not support raises there.
  * ``load_frame`` reads an 8-bit gray (or gray + alpha) PNG with the native
    decoder.  Any other PNG (colour, palette, 16-bit, interlaced) goes
    through PIL, and its samples are reduced to gray the way cv2's libpng
    does: the high byte of a 16-bit sample, palette entries expanded, alpha
    dropped, and ``(9797 R + 19234 G + 3737 B) >> 15`` (libpng's fixed-point
    ``png_set_rgb_to_gray(1, 0.299, 0.587)``, truncated).  The native
    decoder's colour conversion is the unrounded BT.601 float instead.
  * Other formats (the real Malaga extract is JPEG) go through PIL; a JPEG
    is decoded straight to its luma plane (``draft("L")``), as libjpeg does
    for cv2.  Without PIL they raise an ``ImportError`` that names the
    missing decoder.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..core.config import (PipelineConfig, kitti_config, malaga_config,
                           parking_config)

# Hard-coded intrinsics, verbatim from reference utils.py.
KITTI_K = np.array(
    [[7.188560000000e02, 0, 6.071928000000e02],
     [0, 7.188560000000e02, 1.852157000000e02],
     [0, 0, 1]]
)  # utils.py:22-24
MALAGA_K = np.array(
    [[621.18428, 0, 404.0076], [0, 621.18428, 309.05989], [0, 0, 1]]
)  # utils.py:34-36
PARKING_K = np.array([[331.37, 0, 320], [0, 369.568, 240], [0, 0, 1]])
# utils.py:43-45


def _is_png(path: str) -> bool:
    return path.lower().endswith(".png")


# libpng's rgb-to-gray weights in 1/32768 (png_set_rgb_to_gray(1, 0.299,
# 0.587) as cv2 sets it; the blue weight takes the remainder).
_RGB_TO_GRAY = (9797, 19234, 3737)


def _png_header(path: str):
    """(bit depth, colour type, interlace) of a PNG's IHDR, or None when the
    file does not start like a PNG."""
    with open(path, "rb") as f:
        head = f.read(29)
    if len(head) < 29 or head[:8] != b"\x89PNG\r\n\x1a\n" \
            or head[12:16] != b"IHDR":
        return None
    return head[24], head[25], head[28]


def _pil(path: str):
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{path}: decoding this frame needs PIL (Pillow), "
                          "which is not installed") from e
    return Image


def _png_gray_like_cv2(path: str) -> np.ndarray:
    """A PNG the native decoder does not reduce as cv2 does, decoded by PIL
    and reduced to gray as cv2's libpng does."""
    with _pil(path).open(path) as im:
        if im.mode in ("I;16", "I;16B", "I"):
            return (np.asarray(im, dtype=np.int64) >> 8).astype(np.float32)
        if im.mode in ("L", "LA", "1"):
            return np.asarray(im.convert("L"), dtype=np.float32)
        rgb = np.asarray(im.convert("RGB"), dtype=np.int64)
    r, g, b = _RGB_TO_GRAY
    y = (r * rgb[..., 0] + g * rgb[..., 1] + b * rgb[..., 2]) >> 15
    return y.astype(np.float32)


def _imread_gray(path: str) -> np.ndarray:
    """One frame as an (H, W) float32 gray image, as cv2 reads it."""
    if _is_png(path):
        header = _png_header(path)
        if header is None:
            raise ValueError(f"{path}: not a readable PNG")
        depth, colour, interlace = header
        if depth == 8 and colour in (0, 4) and not interlace:
            from . import native_io

            img = native_io.decode_png(path)
            if img is None:
                raise ValueError(f"{path}: not a readable PNG")
            return img
        return _png_gray_like_cv2(path)
    with _pil(path).open(path) as im:
        if im.format == "JPEG":
            im.draft("L", im.size)  # libjpeg's own luma plane, as cv2 reads
        return np.asarray(im.convert("L"), dtype=np.float32)


@dataclasses.dataclass
class SequenceSpec:
    name: str
    K: np.ndarray
    num_frames: int
    frame_paths: List[str]
    gt_poses: Optional[np.ndarray]  # (N, 3, 4) or None (Malaga)
    config: PipelineConfig
    bootstrap_frames: Tuple[int, int]

    @property
    def gt_positions(self) -> Optional[np.ndarray]:
        if self.gt_poses is None:
            return None
        return self.gt_poses[:, :3, 3]

    @property
    def gt_xz(self) -> Optional[np.ndarray]:
        """The reference's plotting GT: columns [-9, -1] of the flat rows
        (utils.py:20,:47) == (x, z) translation components."""
        if self.gt_poses is None:
            return None
        return self.gt_poses[:, [0, 2], 3]

    def load_frame(self, i: int) -> np.ndarray:
        return _imread_gray(self.frame_paths[i])

    def frames(self, start: int = 0,
               prefetch: bool = True) -> Iterator[Tuple[int, np.ndarray]]:
        """Ordered frame stream; PNGs go through the native prefetching
        reader (decoding ahead of the consumer) unless ``prefetch`` is
        False."""
        paths = self.frame_paths[start:self.num_frames]
        if prefetch and paths and all(_is_png(p) for p in paths):
            from . import native_io

            with native_io.PrefetchingReader(paths) as reader:
                for i, img in reader:
                    yield start + i, img
            return
        for i in range(start, self.num_frames):
            yield i, self.load_frame(i)


def _load_poses(path: str) -> np.ndarray:
    rows = np.loadtxt(path)
    return rows.reshape(-1, 3, 4)


def load_kitti(root: str, sequence: str = "05",
               last_frame: Optional[int] = None) -> SequenceSpec:
    img_dir = os.path.join(root, sequence, "image_0")
    gt = _load_poses(os.path.join(root, "poses", f"{sequence}.txt"))
    names = sorted(f for f in os.listdir(img_dir) if f.endswith(".png"))
    # Reference caps KITTI at 2761 frames (main.py:17, Quirk Q1).
    n = min(len(names), last_frame or len(names))
    paths = [os.path.join(img_dir, f"{i:06d}.png") for i in range(n)]
    return SequenceSpec(
        name=f"kitti-{sequence}", K=KITTI_K, num_frames=n, frame_paths=paths,
        gt_poses=gt[:n], config=kitti_config(), bootstrap_frames=(0, 2),
    )


def load_malaga(root: str) -> SequenceSpec:
    img_dir = os.path.join(
        root, "malaga-urban-dataset-extract-07_rectified_800x600_Images"
    )
    names = sorted(os.listdir(img_dir))
    left = names[2::2]  # every 2nd file from index 2 (utils.py:31)
    paths = [os.path.join(img_dir, f) for f in left]
    return SequenceSpec(
        name="malaga-07", K=MALAGA_K, num_frames=len(paths),
        frame_paths=paths, gt_poses=None, config=malaga_config(),
        bootstrap_frames=(0, 6),
    )


def load_parking(root: str, last_frame: int = 598) -> SequenceSpec:
    paths = [os.path.join(root, "images", f"img_{i:05d}.png")
             for i in range(last_frame)]
    gt = _load_poses(os.path.join(root, "poses.txt"))
    return SequenceSpec(
        name="parking", K=PARKING_K, num_frames=last_frame, frame_paths=paths,
        gt_poses=gt[:last_frame], config=parking_config(),
        bootstrap_frames=(0, 6),
    )


LOADERS = {"kitti": load_kitti, "malaga": load_malaga, "parking": load_parking}
