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

Decoding: ``.png`` frames always go through the native decoder
(``dataio/native_io.py``), one at a time in ``load_frame`` and through the
prefetching reader in ``frames()``; a PNG it does not support raises.  Other
formats (the real Malaga extract is JPEG) go through PIL; without PIL they
raise an ``ImportError`` that names the missing decoder.
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


def _imread_gray(path: str) -> np.ndarray:
    """One frame as an (H, W) float32 gray image."""
    if _is_png(path):
        from . import native_io

        img = native_io.decode_png(path)
        if img is None:
            raise ValueError(f"{path}: a PNG the native decoder does not "
                             "support (palette, interlaced or unreadable)")
        return img
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{path}: decoding a non-PNG frame needs PIL "
                          "(Pillow), which is not installed") from e
    with Image.open(path) as im:
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
