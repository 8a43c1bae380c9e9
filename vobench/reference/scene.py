"""The drive: a frozen copy of the textured KITTI-geometry corridor and its
renderer, with the exact ray cast that the comparison reads.

``_value_noise``, ``TexturedScene``, ``make_textured_scene`` and
``_render_textured`` are copied verbatim from the port's
``dataio/synthetic.py`` (itself a copy of the JAX package's), so that the
benchmark's traffic and ground truth stay what they are whatever a later
change does to the program.  ``ray_depth`` and ``true_flow`` are the ray
cast of the port's ``tools/diag_tracker.py::gt_flow``, split in two: the
camera-frame depth of the first surface each pixel's ray hits, and that
point reprojected into another frame.

NumPy only: nothing here imports torch or the program.
"""
from __future__ import annotations

import dataclasses

import numpy as np


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



def camera_frame(frame: np.ndarray) -> np.ndarray:
    """A rendered frame as the camera delivers it: 8-bit grey levels, the
    form of KITTI's and Malaga's PNG frames."""
    return np.clip(np.rint(frame), 0.0, 255.0).astype(np.uint8)


def ray_depth(scene: TexturedScene, frame: int, uv: np.ndarray):
    """The camera-frame depth at pixels ``uv`` (N, 2) of ``frame``: the
    first surface each pixel's ray hits (ground, walls, pillars), as the
    renderer casts it.  Returns ((N,) depth, (N,) hit mask)."""
    uv = np.asarray(uv, np.float64).reshape(-1, 2)
    K = scene.K
    T = scene.poses_WC[frame]
    d_cam = np.stack([(uv[:, 0] - K[0, 2]) / K[0, 0],
                      (uv[:, 1] - K[1, 2]) / K[1, 1],
                      np.ones(len(uv))], axis=-1)
    d = d_cam @ T[:3, :3].T
    cam = T[:3, 3]
    INF = 1e18
    best_t = np.full(len(uv), INF)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (scene.ground_y - cam[1]) / d[:, 1]
        ok = (d[:, 1] > 1e-9) & (t > 0.2)
        best_t = np.where(ok & (t < best_t), t, best_t)
        for sgn in (-1.0, 1.0):
            t = (sgn * scene.half_width - cam[0]) / d[:, 0]
            p = cam + t[:, None] * d
            ok = ((np.abs(d[:, 0]) > 1e-9) & (t > 0.2)
                  & (p[:, 1] < scene.ground_y))
            best_t = np.where(ok & (t < best_t), t, best_t)
        for pz, x0, x1, y0, y1 in scene.pillars:
            t = (pz - cam[2]) / d[:, 2]
            p = cam + t[:, None] * d
            ok = ((np.abs(d[:, 2]) > 1e-9) & (t > 0.2)
                  & (p[:, 0] >= x0) & (p[:, 0] <= x1)
                  & (p[:, 1] >= y0) & (p[:, 1] <= y1))
            best_t = np.where(ok & (t < best_t), t, best_t)
        px_quads = scene.pillars_x if scene.pillars_x is not None else ()
        for px, z0, z1, y0, y1 in px_quads:
            t = (px - cam[0]) / d[:, 0]
            p = cam + t[:, None] * d
            ok = ((np.abs(d[:, 0]) > 1e-9) & (t > 0.2)
                  & (p[:, 2] >= z0) & (p[:, 2] <= z1)
                  & (p[:, 1] >= y0) & (p[:, 1] <= y1))
            best_t = np.where(ok & (t < best_t), t, best_t)
    # The ray's camera-frame z component is 1, so its length parameter is
    # the depth.
    return best_t, best_t < INF


def true_flow(scene: TexturedScene, frame0: int, frame1: int,
              uv: np.ndarray):
    """Exact correspondence of pixels ``uv`` of ``frame0`` in ``frame1``:
    the surface point each pixel sees, reprojected.  Returns ((N, 2)
    positions, (N,) mask of pixels that hit a surface in front of both
    cameras)."""
    uv = np.asarray(uv, np.float64).reshape(-1, 2)
    z, hit = ray_depth(scene, frame0, uv)
    K = scene.K
    z = np.where(hit, z, 1.0)
    x_cam = np.stack([(uv[:, 0] - K[0, 2]) / K[0, 0] * z,
                      (uv[:, 1] - K[1, 2]) / K[1, 1] * z, z], axis=-1)
    T0 = scene.poses_WC[frame0]
    X = x_cam @ T0[:3, :3].T + T0[:3, 3]
    T1_CW = scene.pose_CW(frame1)
    Xc = X @ T1_CW[:3, :3].T + T1_CW[:3, 3]
    zc = Xc[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        u1 = K[0, 0] * Xc[:, 0] / zc + K[0, 2]
        v1 = K[1, 1] * Xc[:, 1] / zc + K[1, 2]
    return np.stack([u1, v1], -1), hit & (zc > 0.2)
