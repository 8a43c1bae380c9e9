"""The step at an in-step BA trigger frame against a skip frame, and the
block driver with BA on and off, counterpart of ``tools/profile_trigger.py``.

Set-up (``build``): ``kitti_config()`` at 376x1241 with the KLT bootstrap
and ``quality_level=0.03``, in-step BA every 4 frames (its window is 10);
the textured scene (seed 11, 40 frames); a bootstrap over frames 0..4 and
steps 5..13.  Then, on frame 14's image:

* ``step_trigger``: the state relabelled as frame 15, so the step makes
  frame 16 (16 % 4 == 0 and >= the window: BA runs);
* ``step_skip``: relabelled as frame 16 (17: no BA);
* ``scan_ba_on``: ``scan_driver.make_scan_step`` over frames 14..39, ms a
  frame (after a warm pass);
* ``scan_ba_off`` and ``step_ba_off``: the same with in-step BA off.

Each row: host ms (median of 20 synced calls; the scans one timed pass),
device ms, launches (device events) and host dispatches per call or frame
from ``torch.profiler`` (``null`` on the CPU), and for the steps the BA branches run per call, which must
be 1 at the trigger and 0 elsewhere.  One JSON line per row.

    python -m monocular_visual_odometry_va4mr_torch.tools.profile_trigger
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch

from . import harness

SEED = 11
NUM_FRAMES = 40
BA_EVERY = 4


def ba_on(cfg):
    return cfg.replace(ba=dataclasses.replace(cfg.ba, every=BA_EVERY))


def build(cfg_mut, device):
    """(VO, state after frame 13, frames on the device)."""
    from ..core.camera import Camera
    from ..core.config import kitti_config
    from ..dataio import synthetic
    from ..pipeline import runner
    from ..pipeline.vo import VisualOdometry

    cfg = kitti_config().replace(bootstrap_method="klt")
    cfg = cfg_mut(cfg.replace(
        detector=dataclasses.replace(cfg.detector, quality_level=0.03)))
    H, W = cfg.image_shape
    scene = synthetic.make_textured_scene(
        seed=SEED, num_frames=NUM_FRAMES, image_shape=(H, W), step=1.0)
    frames = synthetic.render_all_cached(
        scene, f"textured-s{SEED}-f{NUM_FRAMES}-{H}x{W}",
        render=lambda sc: harness.render_frames(sc, sc.num_frames))
    vo = VisualOdometry(Camera.from_matrix(scene.K), cfg, device, seed=0)
    dev = vo.device
    up = [torch.as_tensor(f).to(dev) for f in frames]
    state = vo.bootstrap(up[0], up[4], intermediate=up[1:4],
                         generator=runner.frame_generator(0, 0, dev))
    for i in range(5, 14):
        state = vo.step(state, up[i],
                        generator=runner.frame_generator(0, i, dev))
    harness.sync(dev)
    return vo, state, up


def at_frame(state, frame):
    """``state`` with its frame counter set to ``frame``, on the device and
    on the host."""
    out = state.replace(frame_idx=torch.full(
        (), frame, dtype=torch.int32, device=state.frame_idx.device))
    out.host_frame = frame
    return out


def step_row(name, vo, state, img):
    """The step on ``state`` and ``img``: host ms, device ms, launches and
    BA branches per call."""
    dev = vo.device
    gen = torch.Generator(device=dev)

    def fn():
        return vo.step(state, img, generator=gen.manual_seed(0))

    runs0 = vo.ba_runs
    fn()
    ba_runs = vo.ba_runs - runs0
    ms = harness.host_ms(fn, dev)
    dev_ms = launches = dispatches = None
    if dev.type == "cuda":
        dev_ms, launches, dispatches = harness.profile_calls(fn)
    return dict(case=name, frame=state.host_frame_idx() + 1, ms=ms,
                device_ms=dev_ms, launches=launches, dispatches=dispatches,
                ba_runs_per_call=ba_runs)


def scan_row(name, vo, state, imgs):
    """``make_scan_step`` over ``imgs``: ms and fps per frame after a warm
    pass; device ms and launches per frame."""
    from ..pipeline import scan_driver

    dev = vo.device
    run = scan_driver.make_scan_step(vo)
    n = imgs.shape[0]

    def fn():
        gens = [torch.Generator(device=dev).manual_seed(99 + i)
                for i in range(n)]
        out = run(state, imgs, gens)
        harness.sync(dev)
        return out

    fn()
    t0 = time.perf_counter()
    fn()
    dt = time.perf_counter() - t0
    prof = harness.profile_steps(fn, n, dev)
    return dict(case=name, frames=n, ms_per_frame=1e3 * dt / n,
                fps=n / dt, device_ms_per_frame=prof["device_ms_per_step"],
                launches_per_frame=prof["launches_per_step"],
                dispatches_per_frame=prof["dispatches_per_step"])


def profile(device):
    vo, state, up = build(ba_on, device)
    img = up[14]
    rows = [step_row("step_trigger", vo, at_frame(state, 15), img),
            step_row("step_skip", vo, at_frame(state, 16), img)]
    imgs = torch.stack(up[14:])
    rows.append(scan_row("scan_ba_on", vo, state, imgs))
    vo0, state0, _ = build(lambda c: c, device)
    rows.append(scan_row("scan_ba_off", vo0, state0, imgs))
    rows.append(step_row("step_ba_off", vo0, state0, img))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    harness.add_device_arg(ap)
    args = ap.parse_args(argv)
    device = harness.resolve_device(args.device)
    harness.build_kernels(device)
    fields = harness.device_fields(device)
    for r in profile(device):
        harness.emit({**r, **fields})
    return 0


if __name__ == "__main__":
    sys.exit(main())
