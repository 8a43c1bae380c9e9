"""Render a reference-scale synthetic sequence to disk in the KITTI layout,
counterpart of ``tools/make_kitti_seq.py``.

The reference's workload is 2761 KITTI frames streamed from PNG files
(reference ``main.py:17``).  This renders the loop-room world
(``dataio.synthetic.make_loop_scene``: ~2.8 km of travel over 3 laps, with
viewpoint revisits for loop closure) or the weaving corridor, and writes
``<out>/05/image_0/{i:06d}.png``, ``<out>/poses/05.txt`` and
``<out>/scene.json``: what ``dataio.datasets.load_kitti`` and the native
decoder read.

Frames go to uint8 by the JAX script's recipe, ``np.clip(render, 0, 255)
.astype(np.uint8)`` (it truncates), and to PNG through
``dataio.native_io.write_png`` (numpy and zlib, no cv2), each written to a
temporary file and renamed.  A frame whose file exists is skipped, so a
render can be resumed, or split: ``--count N`` writes the scene's first N
frames only.  The frames render in a spawn pool of ``--workers`` processes
(one per core by default; the JAX script's default is 2).

The frames render on the host whatever ``--device`` says; like every tool
of the port it defaults to ``cuda`` and raises without it, so ``--device
cpu`` is needed where there is no card.  One JSON line: the root, the
frames rendered and skipped, and the render time.

    python -m monocular_visual_odometry_va4mr_torch.tools.make_kitti_seq \\
        [--out build/kitti_loop_2761] [--frames 2761] [--scene loop|corridor]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from . import harness

DEFAULT_OUT = harness.BUILD / "kitti_loop_2761"

_JOB = None  # (scene, image directory) in a render worker


def build_scene(scene, frames, shape, seed, laps, step):
    """The JAX script's scene for its arguments."""
    from ..dataio import synthetic

    if scene == "loop":
        return synthetic.make_loop_scene(seed=seed, num_frames=frames,
                                         image_shape=shape, laps=laps,
                                         step=step)
    return synthetic.make_textured_scene(seed=seed, num_frames=frames,
                                         image_shape=shape, step=step)


def to_uint8(frame) -> np.ndarray:
    """The JAX script's uint8 recipe (``make_kitti_seq.py:61``)."""
    return np.clip(frame, 0, 255).astype(np.uint8)


def _init_worker(scene, img_dir):
    global _JOB
    _JOB = (scene, img_dir)


def _render_one(i):
    """Render and write frame ``i`` unless its file exists; seconds spent
    (0.0 for a skipped frame)."""
    from ..dataio import native_io

    scene, img_dir = _JOB
    path = os.path.join(img_dir, f"{i:06d}.png")
    if os.path.exists(path):
        return 0.0
    t0 = time.perf_counter()
    native_io.write_png(path, to_uint8(scene.render(i)))
    return time.perf_counter() - t0


def make_sequence(out, *, frames=2761, scene="loop", shape=(376, 1241),
                  seed=11, laps=3.0, step=1.0, workers=None, count=None):
    """Write the sequence under ``out`` (its first ``count`` frames when
    given; the poses and ``scene.json`` always cover all ``frames``);
    returns the summary line."""
    from ..dataio import native_io

    sc = build_scene(scene, frames, tuple(shape), seed, laps, step)
    img_dir, pose_file = native_io.kitti_paths(str(out))
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(os.path.dirname(pose_file), exist_ok=True)
    native_io.write_poses(pose_file, sc.poses_WC)
    with open(os.path.join(out, "scene.json"), "w") as f:
        json.dump({"scene": scene, "frames": frames,
                   "shape": list(sc.image_shape), "seed": seed,
                   "laps": laps, "step": step, "K": sc.K.tolist()}, f)
    n = frames if count is None else min(count, frames)
    t0 = time.perf_counter()
    secs = harness.spawn_map(_render_one, range(n), workers,
                             _init_worker, (sc, img_dir))
    wall = time.perf_counter() - t0
    rendered = sum(1 for s in secs if s > 0)
    return dict(root=str(out), scene=scene, frames=frames,
                shape=list(sc.image_shape), written=n, rendered=rendered,
                skipped=n - rendered, render_s=wall,
                s_per_frame_per_worker=(sum(secs) / rendered
                                        if rendered else None),
                workers=min(n, workers or os.cpu_count() or 1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--frames", type=int, default=2761)
    ap.add_argument("--scene", choices=("loop", "corridor"), default="loop")
    ap.add_argument("--shape", default="376,1241")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--laps", type=float, default=3.0)
    ap.add_argument("--step", type=float, default=1.0)
    ap.add_argument("--workers", type=int, default=None,
                    help="render processes (default: one per core)")
    ap.add_argument("--count", type=int, default=None,
                    help="write only the first COUNT frames of the scene "
                         "(a later run without it writes the rest)")
    harness.add_device_arg(ap)
    args = ap.parse_args(argv)
    device = harness.resolve_device(args.device)
    shape = tuple(int(x) for x in args.shape.split(","))
    res = make_sequence(args.out, frames=args.frames, scene=args.scene,
                        shape=shape, seed=args.seed, laps=args.laps,
                        step=args.step, workers=args.workers,
                        count=args.count)
    harness.emit({**res, **harness.device_fields(device)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
