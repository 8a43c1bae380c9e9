"""Loop closure twice in one process: where two runs of one code on one
stream first differ.

The loop stream of ``chip_smoke.py``'s phase B: ``make_loop_scene`` (seed
11, 640 frames, 1.25 laps of an 81 m circle, KITTI-05 K) at 376x1241,
``kitti_tuned_config()`` with the KLT bootstrap (stride 8) and in-step BA
off (``loop_vo``), streamed once as uint8 by ``scan_driver.run_streaming``
(blocks of 64, landmark snapshots, recovery), every 8th frame kept.  Its
loop closure (``loop_closure``: the keyframe bank of 512 SIFT features a
keyframe, the verifier over the retrieved candidates, the loop edges and
the Sim(3) refinement) then runs three times: A and B each from a bank of
their own, C on A's bank.  ``first_difference`` names the first of
``STAGES`` where two runs differ: the keyframes' features (positions and
validity), their descriptors, the matches, the verification (inliers,
pose, depths), the loop edges, the refined trajectory.  A against B
finds where the loop closure stops repeating; A against C, with the bank
held fixed, whether what follows the bank repeats by itself.  One more
line holds SIFT of one keyframe image twice.

    python -m monocular_visual_odometry_va4mr_torch.tools.diag_loop_repeat

One JSON line per comparison, with the card's name and power limit.  The
card only (``--device cpu`` runs it at full size, which takes long).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from . import harness

SEED = 11
FRAMES = 640
LAPS = 1.25
IMAGE_SHAPE = (376, 1241)
STRIDE = 8
BLOCK = 64
EVERY = 8  # keyframe period
FEATURES = 512  # SIFT features per keyframe
STAGES = ("features", "descriptors", "matches", "verification", "edges",
          "refined")


def loop_vo(scene, device):
    """Phase B's VO: ``kitti_tuned_config()`` with the KLT bootstrap and
    in-step BA off (``tools/bench_stream_2761.py``'s stream at this
    length)."""
    from ..core.camera import Camera
    from ..core.config import kitti_tuned_config
    from ..pipeline.vo import VisualOdometry

    cfg = kitti_tuned_config().replace(image_shape=scene.image_shape,
                                       bootstrap_method="klt")
    cfg = cfg.replace(
        detector=dataclasses.replace(cfg.detector, quality_level=0.03),
        ba=dataclasses.replace(cfg.ba, every=0))
    return VisualOdometry(Camera.from_matrix(scene.K), cfg, device, seed=0)


def loop_stream(device, frames=FRAMES):
    """The loop scene streamed once: (VO, outputs, frame ids, the kept
    keyframe images)."""
    from ..dataio import synthetic
    from ..pipeline import posegraph_runner as pr, runner, scan_driver

    scene = synthetic.make_loop_scene(seed=SEED, num_frames=frames,
                                      laps=LAPS, image_shape=IMAGE_SHAPE)
    u8 = [np.clip(np.rint(f), 0, 255).astype(np.uint8)
          for f in harness.render_frames(scene, frames)]
    vo = loop_vo(scene, device)
    s0 = vo.bootstrap(u8[0], u8[STRIDE], intermediate=u8[1:STRIDE],
                      generator=runner.frame_generator(0, 0, vo.device))
    images = {}
    src = pr.keep_every(((i, u8[i]) for i in range(STRIDE + 1, frames)),
                        EVERY, images)
    _, outs, fids, _ = scan_driver.run_streaming(
        vo, s0, src, 0, block=BLOCK, emit_landmarks=True, recover=True,
        bootstrap_stride=STRIDE)
    return vo, outs, fids, images


def loop_closure(vo, outs, fids, images, bank=None):
    """One run of the loop closure on a streamed run: its bank (made here
    unless given), the verifier's outputs, the loop edges and the refined
    positions (``refine_stream_trajectory``, Sim(3)), as a record of
    ``STAGES`` with the refinement's seconds by stage under ``"split"``
    (``refine_trajectory``'s trace: retrieval, verification, graph,
    solves, recomposition, the graphs captured and replayed), and its
    seconds."""
    from ..pipeline import posegraph_runner as pr

    t0 = time.perf_counter()
    if bank is None:
        bank = pr.bank_from_stream(vo, outs, fids, images, every=EVERY,
                                   max_features=FEATURES)
    seen = {}
    refined = pr.refine_stream_trajectory(outs, fids, bank, method="sim3",
                                          trace=seen)
    harness.sync(vo.device)
    kfs = bank.keyframes
    verified = seen.get("verified", [])
    return bank, dict(
        features=[(k.uv, k.valid) for k in kfs],
        descriptors=[k.desc for k in kfs],
        matches=[(v[0], v[8]) for v in verified],
        verification=[v[1:8] + v[9:] for v in verified],
        edges=seen.get("loops", []),
        refined=refined,
        split={k: v for k, v in seen.items()
               if k not in ("verified", "loops")}), time.perf_counter() - t0


def same(a, b) -> bool:
    """Equal, bit for bit (NaN equal to NaN), through tuples and lists."""
    if isinstance(a, (tuple, list)) or isinstance(b, (tuple, list)):
        return (isinstance(a, (tuple, list)) and isinstance(b, (tuple, list))
                and len(a) == len(b) and all(map(same, a, b)))
    if a is None or b is None:
        return a is b
    a, b = np.asarray(a), np.asarray(b)
    return (a.shape == b.shape and a.dtype == b.dtype
            and np.array_equal(a, b, equal_nan=a.dtype.kind == "f"))


def first_difference(a, b, stages=STAGES):
    """The first stage where records ``a`` and ``b`` differ, with how many
    of its entries differ, or None."""
    for stage in stages:
        x, y = a[stage], b[stage]
        if not same(x, y):
            if isinstance(x, list) and isinstance(y, list):
                n = sum(not same(p, q) for p, q in zip(x, y))
                n += abs(len(x) - len(y))
            else:
                n = None
            return dict(stage=stage, entries=n,
                        lengths=[len(x) if isinstance(x, list) else None,
                                 len(y) if isinstance(y, list) else None])
    return None


def summary(record) -> dict:
    refined = record["refined"]
    return dict(keyframes=len(record["features"]),
                candidates=len(record["matches"]),
                edges=len(record["edges"]),
                refined_finite=(refined is not None
                                and bool(np.all(np.isfinite(refined)))))


def sift_repeat(vo, image):
    """SIFT of one image twice, op by op with the VO's knobs
    (``sift.detect_and_compute``): bit-equal or not, and the rows whose
    descriptor or orientation differ."""
    from ..ops import sift

    sc = vo.config.sift
    img = torch.as_tensor(image).to(vo.device, torch.float32)
    a, b = (sift.detect_and_compute(
        img, max_features=FEATURES, num_octaves=sc.num_octaves,
        scales_per_octave=sc.scales_per_octave,
        contrast_threshold=sc.contrast_threshold,
        edge_threshold=sc.edge_threshold, sigma=sc.sigma,
        first_octave=sc.first_octave) for _ in range(2))
    rows = (~torch.all(a.desc == b.desc, 1)
            | (a.orientation != b.orientation))
    return dict(equal=all(same(x.cpu().numpy(), y.cpu().numpy())
                          for x, y in zip(a, b)),
                rows_differing=int(rows.sum()),
                valid=int(a.valid.sum()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=FRAMES)
    harness.add_device_arg(ap)
    a = ap.parse_args(argv)
    device = harness.resolve_device(a.device)
    harness.build_kernels(device)
    fields = harness.device_fields(device)
    t0 = time.perf_counter()
    vo, outs, fids, images = loop_stream(device, a.frames)
    harness.emit(dict(stream_s=time.perf_counter() - t0, frames=a.frames,
                      **fields))
    bank_a, run_a, s_a = loop_closure(vo, outs, fids, images)
    _, run_b, s_b = loop_closure(vo, outs, fids, images)
    _, run_c, s_c = loop_closure(vo, outs, fids, images, bank=bank_a)
    harness.emit(dict(compare="A_B", first_difference=first_difference(
        run_a, run_b), a=summary(run_a), b=summary(run_b), seconds=[s_a, s_b],
        **fields))
    harness.emit(dict(compare="A_C_same_bank",
                      first_difference=first_difference(run_a, run_c),
                      c=summary(run_c), seconds=s_c, **fields))
    harness.emit(dict(compare="sift_twice",
                      **sift_repeat(vo, images[min(images)]), **fields))
    return 0


if __name__ == "__main__":
    sys.exit(main())
