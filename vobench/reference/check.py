"""The comparison that decides ``correct``: what the timed path produced,
held against the drive's exact geometry.

The drive is synthetic, so its truth is exact: the camera's pose at every
frame, and through the renderer's ray cast (``scene.ray_depth``,
``scene.true_flow``) the depth and the motion of every pixel.  From the
outputs of the program's timed passes (each a ``Pass`` of plain NumPy
arrays) this file works out:

* per pass, the ATE: its TRACKING frames' camera centres aligned onto the
  true ones by Sim(3) (Umeyama), the RMSE of the position errors as a
  share of the pass's true path (``trajectory``);
* ``ate_pct_median`` and ``ate_pct_mean``: the median and the mean of the
  passes' ATE shares, a pass without a trajectory counting as ``inf``;
* ``gate_fail_pct``: the share of passes whose ATE exceeds ``GATE_PCT``,
  the health gate of the project's headline benchmark, or that have no
  trajectory;
* ``lost_pct``: the share of the timed frames the program reported LOST
  (each a failed operation, which the ATE above leaves out);
* the tracker's reading ``track_err_px``: each landmark pixel of frame
  t-1 carried to frame t by the true flow, its distance to the nearest
  landmark pixel the program reports in frame t, the median over a frame,
  then over the frames of a sample of passes (nearest-pixel matching needs
  no slot identity, so it reads the runner's snapshot too);
* the map's reading ``lm_depth_err_pct``: each landmark's camera-frame
  depth against the true depth at its pixel, as a ratio; a frame's ratios
  over their median (monocular depth has no scale), the median distance
  from 1, then the median over the frames of the sampled passes.

``limits/<cell>.json`` holds a cell to a limit on each of the first
numbers that it names (``judge``): those the configuration's guarantees
bound, and those the control moves by 3x or more, with the limit set
between the readings.  The tracker's and the map's readings are reported
beside them, held to none, since no control moves them (``PERF.md``).

NumPy only: nothing here imports torch, the program or the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from . import ate, scene as scenemod

STATUS_TRACKING = 0
# bench.py's health gate: a pass's ATE RMSE within 2% of its path.
GATE_PCT = 2.0
# Fewest observations a frame needs to count for the tracker or the map.
MIN_POINTS = 8


@dataclasses.dataclass
class Pass:
    """What one timed pass (its ``index``) produced, on the host.

    ``ids``: (F,) frame of the drive; ``T_CW``: (F, 4, 4) world-to-camera
    poses; ``status``: (F,) 0 for TRACKING; ``uv``: per frame, (n, 2) the
    landmarks' pixels; ``lm``: per frame, ((n, 2) pixel, (n,) camera-frame
    depth) of the landmarks, or ``lm_world`` per frame (n, 3) world points,
    which ``lm_of`` projects with the frame's own pose."""

    ids: np.ndarray
    T_CW: np.ndarray
    status: np.ndarray
    uv: Optional[List[np.ndarray]] = None
    lm: Optional[list] = None
    lm_world: Optional[List[np.ndarray]] = None
    index: int = 0


def positions(T_CW: np.ndarray) -> np.ndarray:
    T = np.asarray(T_CW, np.float64)
    return -np.einsum("fji,fj->fi", T[:, :3, :3], T[:, :3, 3])


def trajectory(scene, p: Pass):
    """The ATE RMSE of one pass over its TRACKING frames, % of its true
    path, or None with fewer than 3 of them or poses that align to
    nothing."""
    ids = np.asarray(p.ids)
    track = np.asarray(p.status) == STATUS_TRACKING
    gt_all = scene.poses_WC[ids, :3, 3]
    path = ate.path_length(gt_all)
    if track.sum() < 3 or path <= 0:
        return None
    est = positions(np.asarray(p.T_CW)[track])
    if not np.all(np.isfinite(est)):
        return None
    with np.errstate(divide="ignore", invalid="ignore"):
        err, _ = ate.aligned_errors(est, gt_all[track])
    if not np.all(np.isfinite(err)):
        return None  # a pose that never moved aligns to nothing
    return 100.0 * float(np.sqrt(np.mean(err ** 2))) / path


def _inside(scene, uv):
    H, W = scene.image_shape
    return ((uv[:, 0] >= 0) & (uv[:, 0] <= W - 1) & (uv[:, 1] >= 0)
            & (uv[:, 1] <= H - 1) & np.all(np.isfinite(uv), axis=1))


def track_errors(scene, p: Pass) -> List[float]:
    """Per consecutive pair of TRACKING frames, the median distance from
    each landmark pixel carried by the true flow to the nearest reported
    pixel of the next frame."""
    out = []
    for k in range(1, len(p.ids)):
        if (p.ids[k] != p.ids[k - 1] + 1 or p.status[k] != STATUS_TRACKING
                or p.status[k - 1] != STATUS_TRACKING):
            continue
        a = np.asarray(p.uv[k - 1], np.float64).reshape(-1, 2)
        b = np.asarray(p.uv[k], np.float64).reshape(-1, 2)
        a, b = a[_inside(scene, a)], b[_inside(scene, b)]
        if len(a) < MIN_POINTS or len(b) < MIN_POINTS:
            continue
        pred, ok = scenemod.true_flow(scene, int(p.ids[k - 1]),
                                      int(p.ids[k]), a)
        pred = pred[ok & _inside(scene, pred)]
        if len(pred) < MIN_POINTS:
            continue
        d2 = ((pred[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        out.append(float(np.median(np.sqrt(d2.min(1)))))
    return out


def lm_of(p: Pass, k: int, K: np.ndarray):
    """Frame ``k``'s landmarks as (pixel, camera-frame depth)."""
    if p.lm is not None:
        uv, z = p.lm[k]
        return (np.asarray(uv, np.float64).reshape(-1, 2),
                np.asarray(z, np.float64).reshape(-1))
    X = np.asarray(p.lm_world[k], np.float64).reshape(-1, 3)
    T = np.asarray(p.T_CW[k], np.float64)
    xc = X @ T[:3, :3].T + T[:3, 3]
    z = xc[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        uv = np.stack([K[0, 0] * xc[:, 0] / z + K[0, 2],
                       K[1, 1] * xc[:, 1] / z + K[1, 2]], 1)
    return uv, z


def depth_errors(scene, p: Pass) -> List[float]:
    """Per TRACKING frame, the median of |ratio / median ratio - 1| over
    its landmarks, the ratio being the true depth at the landmark's pixel
    over the landmark's depth."""
    out = []
    for k in range(len(p.ids)):
        if p.status[k] != STATUS_TRACKING:
            continue
        uv, z = lm_of(p, k, scene.K)
        ok = _inside(scene, uv) & np.isfinite(z) & (z > 0)
        uv, z = uv[ok], z[ok]
        if len(z) < MIN_POINTS:
            continue
        zt, hit = scenemod.ray_depth(scene, int(p.ids[k]), uv)
        r = zt[hit] / z[hit]
        if len(r) < MIN_POINTS:
            continue
        out.append(float(np.median(np.abs(r / np.median(r) - 1.0))))
    return out


def sample(n: int, k: int, seed: int) -> List[int]:
    """``k`` of ``n`` passes drawn from ``seed`` (all of them when n <= k)."""
    if n <= k:
        return list(range(n))
    rng = np.random.default_rng(seed & 0xFFFFFFFFFFFF)
    return sorted(rng.choice(n, size=k, replace=False).tolist())


def numbers(scene, passes: List[Pass], check_passes: int, seed: int):
    """(numbers, readings): ``numbers`` maps each name a limit can hold to
    its value (``inf`` where the outputs give none); ``readings`` holds the
    tracker's and the map's numbers."""
    traj = [trajectory(scene, p) for p in passes]
    fails = sum(1 for t in traj if t is None or t > GATE_PCT)
    chosen = set(sample(max(p.index for p in passes) + 1 if passes else 0,
                        check_passes, seed))
    tr, lm = [], []
    for p in passes:
        if p.index in chosen:
            tr += track_errors(scene, p)
            lm += depth_errors(scene, p)
    # A pass without a trajectory counts as the worst of all.
    per_pass = [np.inf if t is None else t for t in traj]
    frames = sum(len(p.ids) for p in passes)
    lost = sum(int(np.sum(np.asarray(p.status) != STATUS_TRACKING))
               for p in passes)
    values = dict(
        lost_pct=100.0 * lost / frames if frames else float("inf"),
        ate_pct_mean=float(np.mean(per_pass)) if passes else float("inf"),
        ate_pct_median=(float(np.median(per_pass)) if passes
                        else float("inf")),
        gate_fail_pct=100.0 * fails / len(passes) if passes else float("inf"))
    readings = dict(
        track_err_px=float(np.median(tr)) if tr else None,
        lm_depth_err_pct=100.0 * float(np.median(lm)) if lm else None)
    return values, readings


def judge(values: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): every number finite and at
    most its limit."""
    out, ok = {}, True
    for name, lim in limits.items():
        v = values.get(name, float("inf"))
        good = bool(np.isfinite(v)) and v <= lim
        ok = ok and good
        out[name] = dict(value=v if np.isfinite(v) else None, limit=lim)
    return ok, out
