"""The native PNG decode path at full KITTI scale, counterpart of
``tools/bench_native_decode.py``.

1. Renders ``tools/bench.py``'s scene (100 frames at 376x1241), takes it to
   uint8 by the JAX tool's recipe (``np.clip(f, 0, 255).astype(np.uint8)``)
   and writes it in the KITTI layout (``dataio.native_io.write_kitti``)
   under ``build/``.
2. Times the decode alone through ``load_kitti(...).frames()`` (the native
   prefetching reader), every frame, and checks frame 0 against its
   source.
3. Runs the pipeline (``kitti_config()``, the KLT bootstrap over frames
   0..4, quality 0.03, in-step BA every 4 frames; one ``step`` a frame)
   on the frames decoded from disk and on the same uint8 frames from
   memory: the trajectories must be identical (PNG is lossless on uint8).
4. Times the port's block driver (``scan_driver.run_streaming``, one block,
   after a warm pass) on the same frames: the rate the decoder has to keep
   up with.  The JAX tool's ``device_rate_target_fps`` was a fixed TPU
   number (300); here it is this measured rate, and ``decode_keeps_up``
   compares the decode rate with it.

One JSON line with the JAX tool's keys, plus the stream's ``klt_lk``
launches and the card's ``nvidia-smi`` name and power limit.  Exit code 2
when the trajectories differ or the decoder is slower than the block
driver.

    python -m monocular_visual_odometry_va4mr_torch.tools.bench_native_decode \\
        [--frames 100] [--keep]
"""
from __future__ import annotations

import argparse
import dataclasses
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from . import bench, harness


def make_vo(scene, device):
    """The JAX tool's configuration."""
    from ..core.camera import Camera
    from ..core.config import kitti_config
    from ..pipeline.vo import VisualOdometry

    cfg = kitti_config().replace(image_shape=scene.image_shape,
                                 bootstrap_method="klt")
    cfg = cfg.replace(
        detector=dataclasses.replace(cfg.detector, quality_level=0.03),
        ba=dataclasses.replace(cfg.ba, every=4))
    return VisualOdometry(Camera.from_matrix(scene.K), cfg, device, seed=0)


def run_pipeline(vo, frames, n):
    """Bootstrap and steps over an (idx, frame) iterator up to frame ``n``;
    the (F, 4, 4) poses."""
    from ..pipeline import runner

    dev = vo.device
    b = bench.BOOTSTRAP_STRIDE
    got = {}
    it = iter(frames)
    while len(got) <= b:
        i, f = next(it)
        got[i] = torch.as_tensor(np.asarray(f, np.float32)).to(dev)
    state = vo.bootstrap(got[0], got[b],
                         intermediate=[got[j] for j in range(1, b)],
                         generator=runner.frame_generator(0, 0, dev))
    poses = [state.T_CW.cpu().numpy()]
    for i, f in it:
        if i >= n:
            break
        state = vo.step(state, torch.as_tensor(np.asarray(f, np.float32))
                        .to(dev), generator=runner.frame_generator(0, i, dev))
        poses.append(state.T_CW.cpu().numpy())
    return np.stack(poses)


def block_rate(vo, frames_u8):
    """Frames/s of the block driver over frames 5.. in one block (after a
    warm pass), and ``klt_lk``'s launches against 3 per step and hop."""
    from ..ops import klt_pallas2 as k2
    from ..pipeline import runner, scan_driver

    dev = vo.device
    b = bench.BOOTSTRAP_STRIDE
    ids = list(range(b + 1, len(frames_u8)))
    with harness.CallCounts(vo) as counts:
        k2.klt_lk.launches = 0
        state = vo.bootstrap(frames_u8[0], frames_u8[b],
                             intermediate=frames_u8[1:b],
                             generator=runner.frame_generator(0, 0, dev))

        def stream():
            out = scan_driver.run_streaming(
                vo, state, ((i, frames_u8[i]) for i in ids), 0,
                block=len(ids))
            harness.sync(dev)
            return out

        stream()
        t0 = time.perf_counter()
        stream()
        dt = time.perf_counter() - t0
    launches, expected = k2.klt_lk.launches, counts.expected_lk()
    if launches != expected:
        raise RuntimeError(f"klt_lk launched {launches} times, expected "
                           f"{expected}")
    return len(ids) / dt, launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--keep", action="store_true",
                    help="keep the written sequence")
    ap.add_argument("--frames", type=int, default=bench.NUM_FRAMES)
    harness.add_device_arg(ap)
    args = ap.parse_args(argv)
    device = harness.resolve_device(args.device)
    harness.build_kernels(device)
    fields = harness.device_fields(device)

    from .. import _build
    from ..dataio import datasets, native_io

    _build.build_host("mvo_io")  # the decoder builds before it is timed
    scene, frames = bench.render_scene()
    n = min(args.frames, len(frames))
    frames_u8 = [np.clip(f, 0, 255).astype(np.uint8) for f in frames[:n]]
    harness.BUILD.mkdir(parents=True, exist_ok=True)
    root = tempfile.mkdtemp(prefix="kitti_synth_", dir=harness.BUILD)
    try:
        native_io.write_kitti(root, frames_u8, scene.poses_WC[:n])
        spec = datasets.load_kitti(root, "05")
        if spec.num_frames != n:
            raise RuntimeError(f"load_kitti found {spec.num_frames} frames")

        t0 = time.perf_counter()
        count, ref0 = 0, None
        for i, img in spec.frames(prefetch=True):
            count += 1
            if i == 0:
                ref0 = img
        decode_fps = count / (time.perf_counter() - t0)
        if count != n or not np.array_equal(ref0, frames_u8[0]):
            raise RuntimeError("decoded frames differ from the source")

        vo = make_vo(scene, device)
        poses_disk = run_pipeline(vo, spec.frames(prefetch=True), n)
        poses_mem = run_pipeline(vo, enumerate(frames_u8), n)
        identical = bool(np.array_equal(poses_disk, poses_mem))
        max_diff = float(np.max(np.abs(poses_disk - poses_mem)))
        rate, launches = block_rate(vo, frames_u8)
        keeps_up = decode_fps >= rate
        harness.emit({
            "decode_fps": decode_fps, "frames": n,
            "resolution": list(scene.image_shape),
            "device_rate_target_fps": rate, "decode_keeps_up": keeps_up,
            "trajectory_identical": identical, "max_pose_diff": max_diff,
            "tracker": vo.klt_backend, "stream_klt_lk_launches": launches,
            **fields})
        if args.keep:
            print(f"kept: {root}", file=sys.stderr)
    finally:
        if not args.keep:
            shutil.rmtree(root, ignore_errors=True)
    return 0 if identical and keeps_up else 2


if __name__ == "__main__":
    sys.exit(main())
