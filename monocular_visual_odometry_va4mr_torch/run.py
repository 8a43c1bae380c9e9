"""CLI driver of the port (port of ``run.py``).

Examples:
  python -m monocular_visual_odometry_va4mr_torch.run --dataset synthetic
  python -m monocular_visual_odometry_va4mr_torch.run --dataset kitti \
      --data-root ./data/kitti --plot out/interface_plot.png
  python -m monocular_visual_odometry_va4mr_torch.run --dataset parking \
      --data-root ./data/parking --max-frames 200 --bootstrap klt
  python -m monocular_visual_odometry_va4mr_torch.run --dataset synthetic \
      --max-frames 40 --ba-every 8 --checkpoint-dir ckpt/ --checkpoint-every 20
  python -m monocular_visual_odometry_va4mr_torch.run --dataset synthetic \
      --max-frames 40 --ba-every 8 --resume ckpt/
  python -m monocular_visual_odometry_va4mr_torch.run --dataset synthetic \
      --bootstrap sift --posegraph --posegraph-method sim3

The pipeline runs on ``--device`` (``cuda`` by default; ``cpu`` only when
asked).  PNG frames are decoded by the native decoder (``dataio/native_io``,
built at first use); other formats need PIL.  ``--plot`` / ``--plot-live``
need matplotlib, imported only when asked for.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description="Monocular VO on PyTorch / CUDA")
    p.add_argument("--dataset", required=True,
                   choices=["kitti", "malaga", "parking", "synthetic"])
    p.add_argument("--data-root", default=None,
                   help="dataset root (default ./data/<dataset>)")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--bootstrap", choices=["sift", "klt"], default=None,
                   help="override the preset bootstrap method")
    p.add_argument("--device", default="cuda",
                   help="torch device of the pipeline (default cuda)")
    p.add_argument("--plot", default=None,
                   help="write the 2x2 dashboard PNG here at the end")
    p.add_argument("--plot-live", action="store_true",
                   help="update the dashboard every frame (interactive "
                        "backend if available, else a periodic PNG to "
                        "--plot)")
    p.add_argument("--plot-every", type=int, default=1,
                   help="with --plot-live on agg: save the PNG every N frames")
    p.add_argument("--metrics-json", default=None,
                   help="write per-frame metrics as JSON lines")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint-dir", default=None,
                   help="write a resumable state checkpoint every "
                        "--checkpoint-every frames")
    p.add_argument("--checkpoint-every", type=int, default=100)
    p.add_argument("--resume", default=None,
                   help="checkpoint directory to resume from")
    p.add_argument("--ba-every", type=int, default=0,
                   help="run sliding-window bundle adjustment every N frames "
                        "(0 = off)")
    p.add_argument("--ba-window", type=int, default=8,
                   help="number of recent frames in the BA window")
    p.add_argument("--posegraph", action="store_true",
                   help="collect keyframes + SIFT loop closures and refine "
                        "the trajectory with pose-graph optimization")
    p.add_argument("--posegraph-method", choices=["sim3", "se3"],
                   default="sim3",
                   help="loop-closure graph: Sim(3) corrects monocular "
                        "scale drift (default); SE(3) is rigid-only")
    p.add_argument("--posegraph-every", type=int, default=8,
                   help="keyframe selection period (frames)")
    p.add_argument("--tuned", action="store_true",
                   help="apply core/config.py tune_for_tpu: in-step BA every "
                        "8, 512-slot tables, 6/4 LK iterations")
    p.add_argument("--quiet", action="store_true")
    return p


class SyntheticSpec:
    """The beacon corridor with exact ground truth, the parking preset at
    480x640, bootstrap over frames 0..6."""

    name = "synthetic"
    bootstrap_frames = (0, 6)

    def __init__(self, seed: int, num_frames: int):
        from .core.config import parking_config
        from .dataio import synthetic

        self._synthetic = synthetic
        self.scene = synthetic.make_corridor_scene(
            seed=seed, num_frames=num_frames,
            num_points=int((num_frames + 60) * 60), image_shape=(480, 640))
        self.K = self.scene.K
        self.num_frames = self.scene.num_frames
        self.config = parking_config().replace(
            image_shape=self.scene.image_shape, bootstrap_method="klt")

    @property
    def gt_positions(self):
        return self.scene.poses_WC[:, :3, 3]

    @property
    def gt_xz(self):
        return self.scene.poses_WC[:, [0, 2], 3]

    def load_frame(self, i):
        return self._synthetic.render_frame(self.scene, i)

    def frames(self, start=0):
        for i in range(start, self.scene.num_frames):
            yield i, self._synthetic.render_frame(self.scene, i)


def make_sequence(args):
    if args.dataset == "synthetic":
        return SyntheticSpec(args.seed, args.max_frames or 100)
    from .dataio import datasets

    if args.data_root is None:
        args.data_root = f"./data/{args.dataset}"
    spec = datasets.LOADERS[args.dataset](args.data_root)
    if args.max_frames:
        spec.num_frames = min(spec.num_frames, args.max_frames)
        spec.frame_paths = spec.frame_paths[: spec.num_frames]
    return spec


def live_dashboard(args, spec, cfg):
    """The per-frame ``on_frame`` callback of ``--plot-live``, and its
    dashboard."""
    from .viz.dashboard import LiveDashboard

    live = LiveDashboard(
        out_path=args.plot or "out/interface_plot.png",
        gt_xz=spec.gt_xz if spec.gt_positions is not None else None,
        max_dist=cfg.landmarks.max_dist, save_every=args.plot_every)

    def on_frame(records, snap):
        live.update(
            image=snap["image"], inlier_uv=snap["inlier_uv"],
            outlier_uv=snap["outlier_uv"],
            trajectory=np.stack([r.T_WC[:3, 3] for r in records]),
            landmark_xyz=snap["landmark_xyz"],
            num_tracked=np.array([r.n_tracked for r in records]),
            frame_index=records[-1].frame)

    return live, on_frame


def main(argv=None):
    args = build_parser().parse_args(argv)
    t_start = time.time()

    from .core.camera import Camera
    from .evalx import ate_rmse
    from .pipeline import VisualOdometry, run_sequence

    spec = make_sequence(args)
    cfg = spec.config
    if args.tuned:
        from .core.config import tune_for_tpu

        cfg = tune_for_tpu(cfg)
    if args.bootstrap:
        cfg = cfg.replace(bootstrap_method=args.bootstrap)

    vo = VisualOdometry(Camera.from_matrix(spec.K), cfg, args.device,
                        seed=args.seed)
    print(f"{spec.name}: {spec.num_frames} frames, "
          f"bootstrap {spec.bootstrap_frames}, klt={vo.klt_backend} "
          f"bootstrap={cfg.bootstrap_method} device={vo.device}")

    live, on_frame = (live_dashboard(args, spec, cfg) if args.plot_live
                      else (None, None))
    stride = spec.bootstrap_frames[1] - spec.bootstrap_frames[0]
    result = run_sequence(
        vo, spec.frames(), seed=args.seed, bootstrap_stride=stride,
        verbose=not args.quiet, on_frame=on_frame,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every, resume_from=args.resume,
        ba_every=args.ba_every, ba_window=args.ba_window,
        posegraph=args.posegraph, posegraph_every=args.posegraph_every,
        posegraph_method=args.posegraph_method)

    est = result.positions
    print(f"\nVO pipeline executed over {spec.num_frames} frames")
    print(f"throughput: {result.frames_per_sec:.2f} frames/s "
          f"(steady state, device-synchronized)")
    print(f"LOST frames: {result.num_lost()}")
    gt = spec.gt_positions
    refined = result.refined_positions
    if gt is not None:
        gt_matched = np.stack([gt[r.frame] for r in result.records])
        print(f"ATE RMSE (Sim3-aligned): {ate_rmse(est, gt_matched):.3f} m")
        if refined is not None:
            print(f"ATE RMSE after pose-graph refinement: "
                  f"{ate_rmse(refined, gt_matched):.3f} m")
    if refined is None and args.posegraph:
        print("pose-graph refinement: none (too few keyframes or verified "
              "loop edges)")

    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            for k, r in enumerate(result.records):
                f.write(json.dumps({
                    "frame": r.frame,
                    "position": r.T_WC[:3, 3].tolist(),
                    "refined_position": (None if refined is None
                                         else refined[k].tolist()),
                    "n_inliers": r.n_inliers,
                    "n_tracked": r.n_tracked,
                    "status": r.status,
                    "wall_ms": r.wall_ms,
                }) + "\n")
        print(f"metrics written to {args.metrics_json}")

    if live is not None:
        live.close()
    if args.plot:
        from .viz.dashboard import render_dashboard

        os.makedirs(os.path.dirname(args.plot) or ".", exist_ok=True)
        final = result.final_snapshot
        render_dashboard(
            image=final["image"], inlier_uv=final["inlier_uv"],
            outlier_uv=final["outlier_uv"], trajectory=est,
            landmark_xyz=final["landmark_xyz"],
            # Pane (1,0): tracked-landmark counts, windowed to the last 20
            # inside the renderer.
            num_tracked=np.array([r.n_tracked for r in result.records]),
            frame_index=result.records[-1].frame, out_path=args.plot,
            gt_xz=spec.gt_xz if gt is not None else None,
            max_dist=cfg.landmarks.max_dist)
        print(f"dashboard written to {args.plot}")

    print(f"Time elapsed: {(time.time() - t_start) / 60:.2f} min")
    return result


if __name__ == "__main__":
    main()
