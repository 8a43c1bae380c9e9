"""Per-preset benchmarks of the port, counterpart of
``tools/bench_datasets.py``: the Malaga (600x800) and Parking (480x640)
presets beside the tuned KITTI one (376x1241).

For each preset: a 95-frame textured scene at the preset's geometry (seed
11, ~1 m a frame), the preset at the benched operating point
(``tune_for_tpu``; ``kitti_tuned_config`` for KITTI, which pins
``mid_iters=0``) with the KLT bootstrap, ``quality_level=0.03`` and stride
4, warmed to frame 12, then ``scan_driver.run_streaming`` over frames
12..94, best of 3 (``harness.bench_run``).  Malaga is the only preset with
``mid_iters=4``: its 150x200 mid plane runs 4 LK iterations.

Gate: 0 LOST, a finite trajectory and an ATE within 2% of the path, over
the timed frames as the JAX tool reads them.  The JAX tool's reference
term runs the original CPU pipeline through cv2
(``tools/run_reference.py``), which the port does not carry: every
``ref_*`` field is ``null``.  Beside the gate stand the JAX record's
``ate_rmse`` and ``ref_ate`` from ``BENCH_datasets.json`` (``jax_ate_rmse``,
``jax_ref_ate``), read only: TPU history on the same frames (the port's
renderer is bit-equal to the JAX one), never the port's result.

Prints one JSON line per preset and writes the list to ``--out``
(``build/bench_datasets.json``; the JAX tool's ``BENCH_datasets.json`` is
never written).  Exit code 2 when a preset is unhealthy.

    python -m monocular_visual_odometry_va4mr_torch.tools.bench_datasets \\
        [--frames 95] [--datasets kitti,malaga,parking]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from . import harness

# name: (image shape, preset function of core.config, bootstrap stride)
PRESETS = {
    "kitti": ((376, 1241), "kitti_tuned_config", 4),
    "malaga": ((600, 800), "malaga_config", 4),
    "parking": ((480, 640), "parking_config", 4),
}
SEED = 11
TIMED_START = 12
REPS = 3
JAX_RECORD = harness.REPO / "BENCH_datasets.json"


def make_case(name, frames_n, device):
    """(scene, frames, VO) of preset ``name``."""
    from ..core import config as cfgmod
    from ..core.camera import Camera
    from ..dataio import synthetic
    from ..pipeline.vo import VisualOdometry

    shape, preset, _ = PRESETS[name]
    scene = synthetic.make_textured_scene(
        seed=SEED, num_frames=frames_n, image_shape=shape, step=1.0)
    frames = synthetic.render_all_cached(
        scene, f"bench-{name}-s{SEED}-f{frames_n}-{shape[0]}x{shape[1]}",
        render=lambda sc: harness.render_frames(sc, sc.num_frames))
    cfg = cfgmod.tune_for_tpu(getattr(cfgmod, preset)()).replace(
        image_shape=shape, bootstrap_method="klt")
    cfg = cfg.replace(
        detector=dataclasses.replace(cfg.detector, quality_level=0.03))
    vo = VisualOdometry(Camera.from_matrix(scene.K), cfg, device, seed=0)
    return scene, frames, vo


def jax_record(name):
    """The JAX tool's ``ate_rmse`` and ``ref_ate`` for ``name`` (TPU
    history), or Nones when the record is absent."""
    try:
        with open(JAX_RECORD) as f:
            rows = {r["dataset"]: r for r in json.load(f)}
    except FileNotFoundError:
        rows = {}
    r = rows.get(name, {})
    return r.get("ate_rmse"), r.get("ref_ate")


def run_case(name, scene, frames, vo, device_name, seed=0):
    """One preset through ``bench.py``'s procedure: the JAX tool's line."""
    _, _, stride = PRESETS[name]
    r = harness.bench_run(vo, frames, seed=seed, stride=stride,
                          start=TIMED_START, reps=REPS)
    n = r["n_warm"]
    h = harness.trajectory_health(scene, r["ids"][n:], r["positions"][n:],
                                  r["statuses"][n:])
    jax_ate, jax_ref = jax_record(name)
    cfg = vo.config
    return {
        "dataset": name, "resolution": list(cfg.image_shape),
        "klt_window": cfg.klt.window, "klt_max_level": cfg.klt.max_level,
        "fps": r["fps"], "lost": h["lost"], "ate_rmse": h["ate"],
        "ate_bound": h["ate_bound"], "ref_fps": None, "ref_ate": None,
        "ref_completed": None, "vs_ref": None, "healthy": harness.healthy(h),
        "jax_ate_rmse": jax_ate, "jax_ref_ate": jax_ref,
        "device": device_name, "tracker": vo.klt_backend,
        "mid_iters": cfg.klt.mid_iters, "frames": len(frames),
        "lost_warmup": sum(1 for s in r["statuses"][:n] if s != 0),
        "step_ms": r["step_ms"], "bootstrap_ms": r["bootstrap_ms"],
        "device_ms_per_step": r["device_ms_per_step"],
        "launches_per_step": r["launches_per_step"],
        "dispatches_per_step": r["dispatches_per_step"],
        "klt_lk_per_step": r["klt_lk_per_step"],
        "klt_lk_launches": r["klt_lk_launches"],
        "klt_lk_launches_expected": r["klt_lk_launches_expected"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=95)
    ap.add_argument("--datasets", default="kitti,malaga,parking")
    ap.add_argument("--out", default=str(harness.BUILD / "bench_datasets.json"))
    harness.add_device_arg(ap)
    args = ap.parse_args(argv)
    device = harness.resolve_device(args.device)
    harness.build_kernels(device)
    label = harness.device_label(device)
    out = []
    for name in args.datasets.split(","):
        name = name.strip()
        out.append(run_case(name, *make_case(name, args.frames, device),
                            label))
        harness.emit(out[-1])
    harness.write_json(args.out, out)
    return 0 if all(r["healthy"] for r in out) else 2


if __name__ == "__main__":
    sys.exit(main())
