"""Host-side sequence driver (port of ``pipeline/runner.py``).

Feeds frames to ``VisualOdometry.step`` one call per frame (on the card a
replay of the captured step), collects poses and metrics on the host, re-bootstraps after tracking loss, and optionally
refines with host-side windowed BA (``--ba-every``), collects pose-graph
keyframes (``posegraph=True``) and checkpoints every K frames.

Random draws: each call draws its RANSAC bank from a ``torch.Generator``
seeded from (seed, stream) by :func:`frame_generator`: the bootstrap from
stream 0, the step of frame ``idx`` from ``idx`` and a re-bootstrap at frame
``idx`` from ``10_000_000 + idx``, the pattern of ``jax.random.fold_in`` in
the reference, and the loop verification of the pose graph from
``20_000_000``.  So a resumed run repeats the uninterrupted one.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..core import spans
from ..core.state import STATUS_TRACKING, FrameState
from .vo import VisualOdometry

REBOOT_STREAM = 10_000_000  # generator stream offset of re-bootstraps
POSEGRAPH_STREAM = 20_000_000  # generator stream of the loop verification


def frame_seed(seed: int, stream: int) -> int:
    """The 63-bit generator seed of one call: distinct for every (seed,
    stream) pair with 0 <= stream < 2**32.  The seed is mixed into the low
    32 bits too, the only ones the CPU generator (a Mersenne twister) keeps;
    seed 0 gives ``stream`` itself."""
    s = seed & 0x7FFFFFFF
    return (s << 32) | ((stream + s * 0x9E3779B1) & 0xFFFFFFFF)


def frame_generator(seed: int, stream: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(frame_seed(seed, stream))
    return gen


@dataclasses.dataclass
class FrameRecord:
    frame: int
    T_WC: np.ndarray  # (4,4) camera pose in world (translation = position)
    n_inliers: int
    n_tracked: int
    status: int
    wall_ms: float


@dataclasses.dataclass
class RunResult:
    records: List[FrameRecord]
    final_snapshot: Optional[Dict] = None
    # (len(records), 3) positions after pose-graph refinement, or None.
    refined_positions: Optional[np.ndarray] = None

    @property
    def positions(self) -> np.ndarray:
        return np.stack([r.T_WC[:3, 3] for r in self.records])

    @property
    def frames_per_sec(self) -> float:
        ms = [r.wall_ms for r in self.records[1:]]  # skip bootstrap
        return 1000.0 / (np.mean(ms) + 1e-9) if ms else 0.0

    def num_lost(self) -> int:
        return sum(1 for r in self.records if r.status != STATUS_TRACKING)


def _T_WC(T_CW: np.ndarray) -> np.ndarray:
    T_WC = np.eye(4)
    T_WC[:3, :3] = T_CW[:3, :3].T
    T_WC[:3, 3] = -T_CW[:3, :3].T @ T_CW[:3, 3]
    return T_WC


def _reads(*tensors) -> None:
    """Count the blocking reads of ``tensors``, all on one device, that the
    host makes (on the card)."""
    if tensors[0].is_cuda:
        spans.d2h(sum(t.nbytes for t in tensors), len(tensors))


def _record(frame: int, state: FrameState, wall_ms: float) -> FrameRecord:
    _reads(state.T_CW, state.n_inliers, state.n_tracked, state.status)
    return FrameRecord(frame=frame,
                       T_WC=_T_WC(state.T_CW.cpu().numpy()),
                       n_inliers=int(state.n_inliers),
                       n_tracked=int(state.n_tracked),
                       status=int(state.status), wall_ms=wall_ms)


def median_step_len(track, n: int = 6) -> Optional[float]:
    """Median per-frame translation over the last tracked frames of
    ``track``, (status, camera position) pairs: the velocity prior that
    restores a metric-consistent scale on re-bootstrap."""
    good = [p for s, p in track if s == STATUS_TRACKING]
    if len(good) < 3:
        return None
    ps = np.stack(good[-(n + 1):])
    d = np.linalg.norm(np.diff(ps, axis=0), axis=1)
    d = d[d > 1e-9]
    return float(np.median(d)) if len(d) else None


def map_scale_from_points(X_w_old: np.ndarray, fresh: FrameState, cam,
                          anchor_T_CW: np.ndarray, *, gate_px: float = 10.0,
                          min_pairs: int = 12,
                          max_spread: float = 0.3) -> Optional[float]:
    """Map-based metric scale for a re-bootstrap.

    Projects the surviving old world-frame landmarks ``X_w_old`` into the
    re-bootstrap's first camera (extrinsics ~ ``anchor_T_CW``, the pose held
    through the LOST frames), associates each fresh landmark with the
    nearest old one in that image, and returns the median of the depth
    ratios z_old / z_fresh.  None (the caller falls back to the velocity
    prior) when fewer than ``min_pairs`` associate within ``gate_px`` or the
    inter-quartile spread of the ratios exceeds ``max_spread`` of the
    median."""
    X = np.asarray(X_w_old, np.float64)
    if X.ndim != 2 or X.shape[0] == 0:
        return None
    A = np.asarray(anchor_T_CW, np.float64)
    xc = X @ A[:3, :3].T + A[:3, 3]
    z_old = xc[:, 2]
    ok = np.isfinite(z_old) & (z_old > 0.5)
    if not np.any(ok):
        return None
    fx, fy = float(cam.fx), float(cam.fy)
    cx, cy = float(cam.cx), float(cam.cy)
    xc = xc[ok]
    z_old = z_old[ok]
    uv_old = np.stack([fx * xc[:, 0] / z_old + cx,
                       fy * xc[:, 1] / z_old + cy], axis=1)

    _reads(fresh.lm_xyz, fresh.lm_valid)
    Xl = fresh.lm_xyz.cpu().numpy().astype(np.float64)
    vl = fresh.lm_valid.cpu().numpy()
    z_f = Xl[:, 2]
    okf = vl & np.isfinite(z_f) & (z_f > 1e-3)
    if not np.any(okf):
        return None
    Xl = Xl[okf]
    z_f = z_f[okf]
    uv_f = np.stack([fx * Xl[:, 0] / z_f + cx,
                     fy * Xl[:, 1] / z_f + cy], axis=1)

    d2 = ((uv_f[:, None, :] - uv_old[None, :, :]) ** 2).sum(-1)
    nn = np.argmin(d2, axis=1)
    hit = d2[np.arange(len(uv_f)), nn] <= gate_px ** 2
    if np.count_nonzero(hit) < min_pairs:
        return None
    ratios = z_old[nn[hit]] / z_f[hit]
    med = float(np.median(ratios))
    q25, q75 = np.percentile(ratios, [25.0, 75.0])
    if med <= 0 or (q75 - q25) > max_spread * med:
        return None
    return med


def reanchor_state(fresh: FrameState, anchor_T_CW: np.ndarray,
                   scale: float) -> FrameState:
    """Express a fresh (re-)bootstrap state in the ORIGINAL world frame.

    A re-bootstrap's world frame is its own first camera with a unit-norm
    baseline.  Every world-frame quantity is scaled by ``scale`` and
    transported through the anchor pose A (extrinsics of the re-bootstrap's
    first frame in the original world):

      X_world = A^-1 * (s * X_local)          (landmarks)
      T_CW_world = T_CW_local(s*t) @ A        (current + per-track anchors)
    """
    A = np.asarray(anchor_T_CW, np.float64)
    R_A = A[:3, :3]
    t_A = A[:3, 3]
    dev = fresh.T_CW.device
    moved = (fresh.T_CW, fresh.lm_xyz, fresh.lm_T_CW_first,
             fresh.cand_T_CW_first)
    _reads(*moved)
    if dev.type == "cuda":
        spans.h2d(sum(t.nbytes for t in moved))

    def compose(T_local: torch.Tensor) -> torch.Tensor:
        T = T_local.cpu().numpy().astype(np.float64)
        T[..., :3, 3] *= scale
        return torch.from_numpy((T @ A).astype(np.float32)).to(dev)

    X = fresh.lm_xyz.cpu().numpy().astype(np.float64) * scale
    X_world = (X - t_A) @ R_A  # R_A^T (X - t_A), row-vector form
    return fresh.replace(
        T_CW=compose(fresh.T_CW),
        lm_xyz=torch.from_numpy(X_world.astype(np.float32)).to(dev),
        lm_T_CW_first=compose(fresh.lm_T_CW_first),
        cand_T_CW_first=compose(fresh.cand_T_CW_first))


def _snapshot(state: FrameState, image) -> Dict:
    """Host-side pull of the state a viewer draws."""
    _reads(state.lm_valid, state.lm_inlier, state.lm_uv, state.lm_xyz)
    lm_valid = state.lm_valid.cpu().numpy()
    lm_inlier = state.lm_inlier.cpu().numpy()
    lm_uv = state.lm_uv.cpu().numpy()
    return {
        "image": np.asarray(image.cpu() if torch.is_tensor(image) else image),
        "inlier_uv": lm_uv[lm_valid & lm_inlier],
        "outlier_uv": lm_uv[lm_valid & ~lm_inlier],
        "landmark_xyz": state.lm_xyz.cpu().numpy()[lm_valid],
    }


def run_sequence(
    vo: VisualOdometry,
    frames: Iterable[Tuple[int, np.ndarray]],
    *,
    seed: int = 0,
    bootstrap_stride: int = 2,
    verbose: bool = False,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 100,
    resume_from: Optional[str] = None,
    ba_every: int = 0,
    ba_window: int = 8,
    ba_mesh=None,
    recover: bool = True,
    recover_after: int = 2,
    posegraph: bool = False,
    posegraph_every: int = 8,
    posegraph_method: str = "sim3",
    on_frame: Optional[Callable] = None,
) -> RunResult:
    """Run the full pipeline over an (index, image) iterable on ``vo``'s
    device.

    The first frame and the frame ``bootstrap_stride`` later form the
    bootstrap pair, the frames between them its KLT chain.  ``posegraph``:
    keep a keyframe every ``posegraph_every`` frames and refine the
    trajectory with the ``posegraph_method`` ("sim3" or "se3") pose graph
    at the end (``RunResult.refined_positions``)."""
    dev = vo.device
    it: Iterator = iter(frames)
    records: List[FrameRecord] = []

    idx0, img0 = next(it)
    img1 = None
    idx1 = idx0
    intermediate = []
    for _ in range(bootstrap_stride):
        idx1, img1 = next(it)
        intermediate.append(img1)
    intermediate = intermediate[:-1]  # the last one IS the bootstrap frame

    t0 = time.perf_counter()
    state = vo.bootstrap(img0, img1, intermediate=intermediate,
                         generator=frame_generator(seed, 0, dev))
    records.append(_record(idx1, state, (time.perf_counter() - t0) * 1000))

    ring = None
    if ba_every:
        from .ba_refine import BARing

        ring = BARing(window=ba_window)

    bank = None
    if posegraph:
        from .posegraph_runner import KeyframeBank

        bank = KeyframeBank(vo, every=posegraph_every)
        bank.maybe_add(len(records) - 1, idx1, state, img1)

    resume_at = None
    if resume_from is not None:
        from . import checkpoint

        state, resume_at = checkpoint.restore(resume_from, state)
        # Host-side refinement state (records, BA ring, keyframe bank)
        # resumes too.
        rec_r, ring_r, bank_r = checkpoint.restore_aux(resume_from, vo)
        if rec_r is not None:
            records = rec_r
        if ring_r is not None:
            ring = ring_r
        if bank_r is not None:
            bank = bank_r
        if verbose:
            print(f"resumed from {resume_from} at frame {resume_at}")

    last_img = img1
    recent = [img1]  # short frame history for re-bootstrap
    # Last TRACKING state: its landmark map survives the blackout intact and
    # feeds the map-based recovery scale.
    last_good_state = state if int(state.status) == STATUS_TRACKING else None
    lost_streak = 0
    for idx, img in it:
        if resume_at is not None and idx <= resume_at:
            continue
        with spans.span("runner.frame", frame=idx):
            t0 = time.perf_counter()
            state = vo.step(state, img,
                            generator=frame_generator(seed, idx, dev))

            if recover:
                with spans.span("runner.recover"):
                    _reads(state.status)
                    lost = int(state.status) != STATUS_TRACKING
                    lost_streak = lost_streak + 1 if lost else 0
                    if (lost_streak >= recover_after
                            and len(recent) >= bootstrap_stride):
                        # Re-bootstrap over the recent span, then transport
                        # the fresh state (pose AND map) into the original
                        # world frame.
                        _reads(state.T_CW)
                        anchor = state.T_CW.cpu().numpy()
                        span = recent[-bootstrap_stride:]
                        spans.COUNTS["recover.attempts"] += 1
                        fresh = vo.bootstrap(
                            span[0], img, intermediate=span[1:],
                            generator=frame_generator(
                                seed, REBOOT_STREAM + idx, dev))
                        _reads(fresh.status)
                        if int(fresh.status) == STATUS_TRACKING:
                            # Map-based scale first (robust to braking or
                            # accelerating through the blackout), the
                            # velocity prior as fallback.
                            scale = None
                            src = "map"
                            if last_good_state is not None:
                                _reads(last_good_state.lm_valid,
                                       last_good_state.lm_xyz)
                                lv = last_good_state.lm_valid.cpu().numpy()
                                scale = map_scale_from_points(
                                    last_good_state.lm_xyz.cpu().numpy()[lv],
                                    fresh, vo.cam, anchor)
                            if scale is None:
                                src = "velocity-prior"
                                step_len = median_step_len(
                                    [(r.status, r.T_WC[:3, 3])
                                     for r in records])
                                # The re-bootstrap pair spans
                                # bootstrap_stride frames.
                                scale = (step_len * bootstrap_stride
                                         if step_len else 1.0)
                            # The fresh state keeps its own frame counter:
                            # candidate ages are relative to it.
                            state = reanchor_state(fresh, anchor, scale)
                            lost_streak = 0
                            spans.COUNTS["recover.done"] += 1
                            if verbose:
                                print(f"frame {idx}: re-bootstrapped after "
                                      f"loss (scale {scale:.3f}, {src})")

            refined_ring = False
            if ring is not None:
                ring.push(state)
                if idx % ba_every == 0:
                    from .ba_refine import refine

                    state = refine(state, ring, vo.cam, mesh=ba_mesh)
                    refined_ring = True
            if dev.type == "cuda":
                with spans.span("runner.sync"):
                    spans.COUNTS["host.syncs"] += 1
                    torch.cuda.synchronize(dev)
            wall = (time.perf_counter() - t0) * 1000
            with spans.span("runner.record"):
                records.append(_record(idx, state, wall))
                if refined_ring:
                    # refine() rewrote ring.poses with the refined window,
                    # whose last pose is this frame's: ring pose k goes to
                    # the record of ring frame k.  (The reference writes
                    # back before appending this frame's record, so each of
                    # its refined poses lands one record early,
                    # runner.py:346-352.)
                    for k in range(len(ring)):
                        records[-len(ring) + k].T_WC = _T_WC(ring.poses[k])
                _reads(state.status)
                if int(state.status) == STATUS_TRACKING:
                    last_good_state = state
            if bank is not None:
                bank.maybe_add(len(records) - 1, idx, state, img)
            if on_frame is not None:
                with spans.span("runner.snapshot"):
                    snap = _snapshot(state, img)
                with spans.span("runner.on_frame"):
                    on_frame(records, snap)
            last_img = img
            recent.append(img)
            if len(recent) > bootstrap_stride + 1:
                recent.pop(0)
            if verbose:
                r = records[-1]
                print(f"frame {idx}: inliers={r.n_inliers} "
                      f"tracked={r.n_tracked} status={r.status} "
                      f"{wall:.1f}ms")
            if checkpoint_dir and idx % checkpoint_every == 0:
                from . import checkpoint

                checkpoint.save(checkpoint_dir, state, idx, records=records,
                                ring=ring, bank=bank)

    refined = None
    if bank is not None:
        from .posegraph_runner import refine_trajectory

        refined = refine_trajectory(
            records, bank, method=posegraph_method, verbose=verbose,
            generator=frame_generator(seed, POSEGRAPH_STREAM, dev))
    return RunResult(records, final_snapshot=_snapshot(state, last_img),
                     refined_positions=refined)
