"""Per-stage profile of one VO step of the port, counterpart of
``tools/profile_step.py``.

Each stage of ``VisualOdometry.step`` runs as a separate call on the same
state (after a bootstrap over frames 0..4 and steps 5..9 of a textured
scene, seed 11, at the preset's geometry; the stepped frame is frame 10):
``pyramid``, ``klt/coarse_volume``, ``klt/prior_sample``, ``klt/total``
(forward chain), ``klt/total+fb`` (with the backward check), ``pnp_ransac``
(the RANSAC bank draw and the solve, as the JAX stage draws inside its
solve), ``triangulate`` (candidates), ``lm_retriangulate``,
``detect_corners``, ``dedup_matrix`` and ``FULL STEP`` (``step``: on the
card a replay of the captured step).  Per stage: ``ms``, the median host
time of 20 calls with a device sync around each, and from
``torch.profiler`` over 3 calls ``launches`` (device events: kernels,
copies, fills), ``dispatches`` (the host's runtime calls that queue work,
one ``cudaGraphLaunch`` for a replay) and ``device_ms`` per call (``null``
on the CPU).  The ``FULL STEP`` row also carries the same four numbers of
the step's body run op by op (``_step_impl``) under ``eager_*``.
``--scan`` also times ``scan_driver.run_streaming`` over frames 10.. in one
block.

The preset (``--dataset``, ``core.config.PRESETS``; the JAX default
``parking`` with 24 frames) runs as defined, with the KLT bootstrap.

    python -m monocular_visual_odometry_va4mr_torch.tools.profile_step \\
        [--dataset parking] [--frames 24] [--scan] [--json]
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from . import harness

SEED = 11
REPS, WARMUP = 20, 3
PROFILE_REPS = 3


def setup(dataset, frames_n, device):
    """(VO, frames, state after frame 9) on the preset's scene."""
    from ..core.camera import Camera
    from ..core.config import PRESETS
    from ..dataio import synthetic
    from ..pipeline import runner
    from ..pipeline.vo import VisualOdometry

    cfg = PRESETS[dataset]().replace(bootstrap_method="klt")
    H, W = cfg.image_shape
    n = max(frames_n, 12)
    scene = synthetic.make_textured_scene(seed=SEED, num_frames=n,
                                          image_shape=(H, W), step=1.0)
    frames = synthetic.render_all_cached(
        scene, f"textured-s{SEED}-f{n}-{H}x{W}",
        render=lambda sc: harness.render_frames(sc, sc.num_frames))
    vo = VisualOdometry(Camera.from_matrix(scene.K), cfg, device, seed=0)
    up = [torch.as_tensor(f).to(vo.device) for f in frames]
    state = vo.bootstrap(up[0], up[4], intermediate=up[1:4],
                         generator=runner.frame_generator(0, 0, vo.device))
    for i in range(5, 10):
        state = vo.step(state, up[i],
                        generator=runner.frame_generator(0, i, vo.device))
    harness.sync(vo.device)
    return vo, frames, up, state


def stages(vo, state, img):
    """(name, call) of each stage on ``state`` and the next image."""
    from ..ops import klt_pallas, pnp, triangulate

    cfg = vo.config
    dev = vo.device
    gen = torch.Generator(device=dev).manual_seed(0)
    pyr = vo.make_pyramid(img)
    ci0, ci1 = state.prev_pyramid[-1], pyr[-1]
    flow_c = klt_pallas.coarse_flow_volume(ci0, ci1)
    all_pts = torch.cat([state.lm_uv, state.cand_uv], 0)
    all_valid = torch.cat([state.lm_valid, state.cand_valid], 0)
    scale = float(round(cfg.image_shape[0] / ci0.shape[0]))
    new_pts, tracked, _ = vo._track(state.prev_pyramid, pyr, all_pts,
                                    all_valid)
    K = cfg.capacity.max_landmarks
    lm_uv, lm_valid = new_pts[:K], tracked[:K]
    cand_uv, cand_valid = new_pts[K:], tracked[K:]

    def pnp_ransac():
        idx, ok = vo.sampler(gen, lm_valid, cfg.pnp.iterations, 3)
        return pnp.solve_pnp_ransac(
            vo.cam, state.lm_xyz, lm_uv, lm_valid, idx, ok,
            reproj_threshold_px=cfg.pnp.reproj_err_px,
            refine_iters=cfg.pnp.refine_iters, min_points=cfg.pnp.min_points)

    T_CW = pnp_ransac()[0]
    lmc = cfg.landmarks
    gates = dict(min_baseline_frames=lmc.min_baseline_frames,
                 min_baseline_angle_deg=lmc.min_baseline_angle_deg,
                 min_dist=lmc.min_dist, max_dist=lmc.max_dist)
    age = state.frame_idx + 1 - state.cand_first_frame
    det_uv, _, det_valid = vo._detect(img)
    md2 = cfg.detector.min_dist ** 2

    def dedup():
        d2c = torch.sum((det_uv[:, None, :] - cand_uv[None]) ** 2, -1)
        d2l = torch.sum((det_uv[:, None, :] - lm_uv[None]) ** 2, -1)
        inf = torch.tensor(float("inf"), device=dev)
        fc = torch.all(torch.where(cand_valid[None, :], d2c, inf) > md2, 1)
        fl = torch.all(torch.where(lm_valid[None, :], d2l, inf) > md2, 1)
        return det_valid & fc & fl

    step_gen = torch.Generator(device=dev).manual_seed(0)
    return [
        ("pyramid", lambda: vo.make_pyramid(img)),
        ("klt/coarse_volume", lambda: klt_pallas.coarse_flow_volume(ci0, ci1)),
        ("klt/prior_sample",
         lambda: klt_pallas.sample_map_onehot(flow_c, all_pts / scale)),
        ("klt/total", lambda: vo._track(state.prev_pyramid, pyr, all_pts,
                                        all_valid)),
        ("klt/total+fb", lambda: vo._track_fb(state.prev_pyramid, pyr,
                                              all_pts, all_valid)),
        ("pnp_ransac", pnp_ransac),
        ("triangulate", lambda: triangulate.triangulate_candidates(
            vo.cam, state.cand_first_uv, cand_uv, state.cand_T_CW_first,
            T_CW, cand_valid, age, **gates)),
        ("lm_retriangulate", lambda: triangulate.triangulate_candidates(
            vo.cam, state.lm_first_uv, lm_uv, state.lm_T_CW_first, T_CW,
            lm_valid, torch.zeros(K, dtype=torch.int32, device=dev),
            enforce_age=False, **gates)),
        ("detect_corners", lambda: vo._detect(img)),
        ("dedup_matrix", dedup),
        ("FULL STEP", lambda: vo.step(state, img, generator=step_gen)),
    ]


def measure(fn, device):
    """Host ms, launches, dispatches and device ms per call of ``fn``."""
    ms = harness.host_ms(fn, device, reps=REPS, warmup=WARMUP)
    dev_ms = launches = dispatches = None
    if device.type == "cuda":
        dev_ms, launches, dispatches = harness.profile_calls(fn, PROFILE_REPS)
    return dict(ms=ms, launches=launches, dispatches=dispatches,
                device_ms=dev_ms)


def profile(vo, state, img):
    """One row per stage: name, host ms, launches, dispatches and device ms
    per call; the ``FULL STEP`` row also the eager body's."""
    rows = [dict(stage=name, **measure(fn, vo.device))
            for name, fn in stages(vo, state, img)]
    gen = torch.Generator(device=vo.device)
    run_ba = vo.ba_due(state)
    eager = measure(lambda: vo._step_impl(
        state, img, vo.step_draws(gen.manual_seed(0)), run_ba), vo.device)
    rows[-1].update({f"eager_{k}": v for k, v in eager.items()})
    step_ms = rows[-1]["ms"]
    for r in rows:
        r["pct_of_step"] = 100.0 * r["ms"] / step_ms
    return rows


def scan(vo, frames, state):
    """``run_streaming`` over frames 10.. in one block, after a warm pass."""
    from ..pipeline import scan_driver

    ids = list(range(10, len(frames)))

    def run():
        out = scan_driver.run_streaming(vo, state,
                                        ((i, frames[i]) for i in ids), 99,
                                        block=len(ids))
        harness.sync(vo.device)
        return out

    run()
    t0 = time.perf_counter()
    run()
    dt = time.perf_counter() - t0
    return dict(stage="scan", frames=len(ids), ms=1e3 * dt,
                ms_per_frame=1e3 * dt / len(ids), fps=len(ids) / dt)


def main(argv=None) -> int:
    from ..core.config import PRESETS

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="parking", choices=sorted(PRESETS))
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--scan", action="store_true",
                    help="also time the block driver")
    ap.add_argument("--json", action="store_true",
                    help="one JSON line per stage instead of a table")
    harness.add_device_arg(ap)
    args = ap.parse_args(argv)
    device = harness.resolve_device(args.device)
    harness.build_kernels(device)
    label = harness.device_label(device)
    vo, frames, up, state = setup(args.dataset, args.frames, device)
    rows = profile(vo, state, up[10])
    extra = [scan(vo, frames, state)] if args.scan else []
    head = dict(dataset=args.dataset, resolution=list(vo.config.image_shape),
                tracker=vo.klt_backend, device=label)
    if args.json:
        for r in rows + extra:
            harness.emit({**head, **r})
    else:
        print_table(head, rows, extra)
    return 0


def print_table(head, rows, extra=()):
    """The JAX tool's table, with the launches and device ms columns."""
    print(f"{head['dataset']} {head['resolution']} {head['tracker']} on "
          f"{head['device']}")
    print(f"\n{'stage':24s} {'ms':>8s}  {'% of step':>9s} {'launches':>9s} "
          f"{'dispatches':>10s} {'device ms':>9s}")
    for r in rows:
        launches = "-" if r["launches"] is None else f"{r['launches']:.0f}"
        disp = "-" if r["dispatches"] is None else f"{r['dispatches']:.0f}"
        dev_ms = "-" if r["device_ms"] is None else f"{r['device_ms']:.3f}"
        print(f"{r['stage']:24s} {r['ms']:8.3f}  {r['pct_of_step']:8.1f}% "
              f"{launches:>9s} {disp:>10s} {dev_ms:>9s}")
    total = sum(r["ms"] for r in rows[:-1])
    print(f"{'sum of stages':24s} {total:8.3f}")
    last = rows[-1]
    if "eager_ms" in last:
        fmt = lambda v, f: "-" if v is None else format(v, f)  # noqa: E731
        print(f"{'eager body (_step_impl)':24s} {last['eager_ms']:8.3f}  "
              f"{'':9s} {fmt(last['eager_launches'], '.0f'):>9s} "
              f"{fmt(last['eager_dispatches'], '.0f'):>10s} "
              f"{fmt(last['eager_device_ms'], '.3f'):>9s}")
    for r in extra:
        print(f"\nscan driver: {r['frames']} frames in {r['ms']:.1f} ms -> "
              f"{r['ms_per_frame']:.3f} ms/frame ({r['fps']:.1f} fps)")

if __name__ == "__main__":
    sys.exit(main())
