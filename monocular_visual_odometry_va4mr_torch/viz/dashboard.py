"""Dashboard renderer (port of ``viz/dashboard.py``, the same figure): the
reference's 2x2 live interface (reference main.py:107-202) as a post-hoc
renderer, so the device loop never blocks on matplotlib.  ``run.py``
imports this module only under ``--plot`` / ``--plot-live``.

Panes (matching main.py):
  (0,0) current image with PnP-RANSAC inliers (green x) / outliers (red x)
        (main.py:127-131)
  (0,1) full trajectory (x vs z) with ground truth dashed (main.py:133-139)
  (1,0) # tracked landmarks over the last 20 frames (main.py:141-144)
  (1,1) last-20-frame trajectory + current landmarks (main.py:146-153)
"""
from __future__ import annotations

from typing import Optional

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402


def render_dashboard(
    image: np.ndarray,
    inlier_uv: np.ndarray,
    outlier_uv: np.ndarray,
    trajectory: np.ndarray,  # (N, 3) camera positions
    landmark_xyz: np.ndarray,  # (L, 3) current landmarks
    num_tracked: np.ndarray,  # (N,) inlier counts per frame
    frame_index: int,
    out_path: str,
    gt_xz: Optional[np.ndarray] = None,  # (M, 2) ground-truth (x, z)
    max_dist: float = 50.0,
):
    fig, axs = plt.subplots(2, 2, figsize=(10, 8))

    axs[0, 0].imshow(image, cmap="gray")
    if len(outlier_uv):
        axs[0, 0].plot(outlier_uv[:, 0], outlier_uv[:, 1], "rx", markersize=6,
                       label="Outliers")
    if len(inlier_uv):
        axs[0, 0].plot(inlier_uv[:, 0], inlier_uv[:, 1], "gx", markersize=6,
                       label="Inliers")
    axs[0, 0].set_title("Current image with RANSAC inliers and outliers")
    axs[0, 0].legend(loc=4, borderaxespad=0.0)

    axs[0, 1].plot(trajectory[:, 0], trajectory[:, 2], "bo-", linewidth=1,
                   markersize=3, label="Trajectory")
    if gt_xz is not None and len(gt_xz):
        axs[0, 1].plot(gt_xz[:, 0], gt_xz[:, 1], "k--", label="Ground Truth")
    axs[0, 1].set_title("Full Trajectory")
    axs[0, 1].set_xlabel("X")
    axs[0, 1].set_ylabel("Y")
    axs[0, 1].legend(loc=4, borderaxespad=0.0)

    last20 = num_tracked[-20:]
    xs = np.arange(frame_index - len(last20) + 1, frame_index + 1)
    axs[1, 0].plot(xs, last20, "-", color="black", linewidth=1)
    axs[1, 0].set_title("# of tracked landmarks over the last 20 frames")
    axs[1, 0].set_xlabel("Frames")
    axs[1, 0].set_ylabel("# of Tracked Landmarks")

    t20 = trajectory[-20:]
    axs[1, 1].plot(t20[:, 0], t20[:, 2], "bo-", linewidth=1, markersize=3,
                   label="Trajectory")
    if len(landmark_xyz):
        axs[1, 1].plot(landmark_xyz[:, 0], landmark_xyz[:, 2], "ro",
                       markersize=4, label="Landmarks")
    cx, cz = trajectory[-1, 0], trajectory[-1, 2]
    axs[1, 1].set_xlim([cx - max_dist, cx + max_dist])
    axs[1, 1].set_ylim([cz - max_dist, cz + max_dist])
    axs[1, 1].set_title("Landmarks over the last 20 frames")
    axs[1, 1].set_xlabel("X")
    axs[1, 1].set_ylabel("Y")
    axs[1, 1].legend(loc=4, borderaxespad=0.0)

    plt.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


class LiveDashboard:
    """Per-frame dashboard (reference main.py:177-202 live mode).

    With an interactive matplotlib backend the figure updates in place via
    ``plt.pause`` (reference main.py:203-204); on the Agg backend it saves
    the PNG every ``save_every`` frames (the reference's agg fallback,
    main.py:199-202).  Artists are updated in place — no per-frame figure
    rebuild, so even agg mode costs one draw, not a full re-layout.
    """

    def __init__(self, out_path: str = "out/interface_plot.png",
                 gt_xz: Optional[np.ndarray] = None, max_dist: float = 50.0,
                 save_every: int = 1, window: int = 20):
        self.out_path = out_path
        self.gt_xz = gt_xz
        self.max_dist = max_dist
        self.save_every = save_every
        self.window = window
        self.interactive = matplotlib.get_backend().lower() not in (
            "agg", "pdf", "svg", "ps")
        self.fig, self.axs = plt.subplots(2, 2, figsize=(10, 8))
        self._image = None
        self._n = 0

    def update(self, *, image, inlier_uv, outlier_uv, trajectory,
               landmark_xyz, num_tracked, frame_index):
        for ax in self.axs.ravel():
            ax.clear()
        axs = self.axs
        axs[0, 0].imshow(image, cmap="gray")
        if len(outlier_uv):
            axs[0, 0].plot(outlier_uv[:, 0], outlier_uv[:, 1], "rx",
                           markersize=6, label="Outliers")
        if len(inlier_uv):
            axs[0, 0].plot(inlier_uv[:, 0], inlier_uv[:, 1], "gx",
                           markersize=6, label="Inliers")
        axs[0, 0].set_title("Current image with RANSAC inliers and outliers")

        axs[0, 1].plot(trajectory[:, 0], trajectory[:, 2], "bo-",
                       linewidth=1, markersize=3)
        if self.gt_xz is not None and len(self.gt_xz):
            axs[0, 1].plot(self.gt_xz[:, 0], self.gt_xz[:, 1], "k--")
        axs[0, 1].set_title("Full Trajectory")

        lastw = np.asarray(num_tracked)[-self.window:]
        xs = np.arange(frame_index - len(lastw) + 1, frame_index + 1)
        axs[1, 0].plot(xs, lastw, "-", color="black", linewidth=1)
        axs[1, 0].set_title(
            f"# of tracked landmarks over the last {self.window} frames")

        tw = trajectory[-self.window:]
        axs[1, 1].plot(tw[:, 0], tw[:, 2], "bo-", linewidth=1, markersize=3)
        if len(landmark_xyz):
            axs[1, 1].plot(landmark_xyz[:, 0], landmark_xyz[:, 2], "ro",
                           markersize=4)
        cx, cz = trajectory[-1, 0], trajectory[-1, 2]
        axs[1, 1].set_xlim([cx - self.max_dist, cx + self.max_dist])
        axs[1, 1].set_ylim([cz - self.max_dist, cz + self.max_dist])
        axs[1, 1].set_title(f"Landmarks over the last {self.window} frames")

        self._n += 1
        if self.interactive:
            plt.pause(0.001)
        elif self._n % self.save_every == 0:
            import os

            os.makedirs(os.path.dirname(self.out_path) or ".", exist_ok=True)
            self.fig.savefig(self.out_path)

    def close(self):
        plt.close(self.fig)
