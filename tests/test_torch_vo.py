"""The slice as a whole: the port's KLT bootstrap and per-frame step (with
in-step BA) against the JAX pipeline on the CPU.

Scene: ``make_textured_scene`` at 96x160.  Config: ``kitti_tuned_config()``
shrunk in width only (128-slot tables, 128 corners) with ``ba.window=3``,
``ba.every=2`` and ``ba.max_landmarks=64``, so that the BA trigger AND the
top-k compaction branch run within 3 steps (the trigger fires at frame 4).

The JAX side runs the main-path tracker (``klt.backend="pallas2"``) in
interpret mode: ``klt_pallas2.track_features_pallas2`` and
``klt_pallas2.track_multilevel`` are patched with ``interpret=True`` (both,
since ``track_multilevel`` passes ``interpret`` explicitly).  Both packages
draw their RANSAC banks from ``jax.random`` with the keys the reference uses
(bootstrap: the key itself; step: ``jax.random.split(key)[0]``).

Tolerances (the two packages differ only in float32 summation order and in
eigh/SVD bases, so the pipelines agree closely but not bit for bit):
  * the number of tracked landmarks differs by at most one feature;
  * where it is equal: rotation within 0.01 deg, translation within 1e-3
    (the bootstrap fixes |t| = 1, so this is 0.1% of the baseline) and,
    after the BA step, landmarks valid in both within 1e-3;
  * where one feature differs: 0.5 deg, 5e-2 and 0.5 (one landmark of ~16
    more or less moves the PnP and BA solution);
  * landmark / candidate validity: at least 97% of slots agree;
  * status equal; PnP inlier count within 3% (+1).

The scene seed matters for the bootstrap: its essential-matrix RANSAC is
sensitive to float32 rounding wherever hypotheses score nearly alike.  On
seeds 5 and 11 at this size the two packages track the same valid
correspondences (within 1e-5 px) yet bootstrap to poses 0.25 and 1.9 deg
apart (ROADMAP.md Queue 3); seed 7 is well conditioned (8e-6 deg).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_visual_odometry_va4mr_tpu.core.camera import Camera as JCamera
from monocular_visual_odometry_va4mr_tpu.core.config import kitti_tuned_config
from monocular_visual_odometry_va4mr_tpu.dataio import synthetic
from monocular_visual_odometry_va4mr_tpu.ops import klt_pallas as jv1
from monocular_visual_odometry_va4mr_tpu.ops import klt_pallas2 as jk2
from monocular_visual_odometry_va4mr_tpu.ops import ransac as jransac
from monocular_visual_odometry_va4mr_tpu.pipeline.vo import (
    VisualOdometry as JVO)
from monocular_visual_odometry_va4mr_torch.core.camera import Camera
from monocular_visual_odometry_va4mr_torch.core.config import (
    kitti_tuned_config as t_kitti_tuned_config)
from monocular_visual_odometry_va4mr_torch.core.state import FrameState
from monocular_visual_odometry_va4mr_torch.pipeline.vo import VisualOdometry

torch.set_num_threads(1)

STRIDE = 3  # bootstrap frames 0 -> 3 through frames 1, 2
N_STEPS = 3
# Same tracks on both sides: the rest of the step is float32 arithmetic in
# another order.
ROT_TOL_DEG = 0.01
T_TOL = 1e-3
LM_TOL = 1e-3
# The tracker is allowed to differ on one feature per step (the reference
# kernel's slab row wrap, ROADMAP.md Queue 3); with ~16 landmarks one
# landmark more or less moves the PnP/BA pose by a few tenths of a degree.
ROT_TOL_TRACK_DIFF_DEG = 0.5
T_TOL_TRACK_DIFF = 5e-2
LM_TOL_TRACK_DIFF = 0.5
MASK_AGREE = 0.97


def small_config(base, backend="pallas2"):
    cfg = base().replace(image_shape=(96, 160), bootstrap_method="klt")
    return cfg.replace(
        detector=dataclasses.replace(cfg.detector, max_corners=128,
                                     quality_level=0.03),
        klt=dataclasses.replace(cfg.klt, backend=backend),
        ba=dataclasses.replace(cfg.ba, window=3, every=2, max_landmarks=64),
        capacity=dataclasses.replace(cfg.capacity, max_landmarks=128,
                                     max_candidates=128),
    )


class JaxBank:
    """The reference's own RANSAC draws, for the key set before each call."""

    key = None

    def __call__(self, generator, valid, n, k):
        idx, ok = jransac.sample_minimal_sets(
            self.key, jnp.asarray(valid.numpy()), n, k)
        return (torch.from_numpy(np.asarray(idx)).long(),
                torch.from_numpy(np.asarray(ok)))


def jax_state_dict(s):
    out = {}
    for f in dataclasses.fields(s):
        v = getattr(s, f.name)
        out[f.name] = (tuple(np.asarray(p) for p in v)
                       if f.name == "prev_pyramid" else np.asarray(v))
    return out


def slice_runs(backend):
    """Bootstrap + N_STEPS steps in both packages with ``klt.backend =
    backend``, the port fed the reference's RANSAC draws and started from
    the reference's bootstrap state."""
    scene = synthetic.make_textured_scene(
        seed=7, num_frames=STRIDE + N_STEPS + 1, image_shape=(96, 160),
        step=1.0)
    frames = [scene.render(i) for i in range(STRIDE + N_STEPS + 1)]
    key = jax.random.PRNGKey(0)
    keys = [jax.random.fold_in(key, i) for i in range(len(frames))]

    jvo = JVO(JCamera.from_matrix(scene.K),
              small_config(kitti_tuned_config, backend))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jk2, "track_features_pallas2", functools.partial(
            jk2.track_features_pallas2, interpret=True))
        mp.setattr(jv1, "track_features_pallas", functools.partial(
            jv1.track_features_pallas, interpret=True))
        mp.setattr(jk2, "track_multilevel", functools.partial(
            jk2.track_multilevel, interpret=True))
        j_boot = jvo.bootstrap(frames[0], frames[STRIDE], keys[0],
                               intermediate=frames[1:STRIDE])
        j_steps = []
        s = j_boot
        for i in range(STRIDE + 1, STRIDE + 1 + N_STEPS):
            s = jvo.step(s, frames[i], keys[i])
            j_steps.append(jax_state_dict(s))

    bank = JaxBank()
    tvo = VisualOdometry(Camera.from_matrix(scene.K),
                         small_config(t_kitti_tuned_config, backend), "cpu",
                         sampler=bank)
    ba_calls = []
    run_ba_branch = tvo._run_ba_branch

    def spy(*args):
        ba_calls.append(int(args[6].sum()))  # live landmarks at the trigger
        return run_ba_branch(*args)

    tvo._run_ba_branch = spy
    bank.key = keys[0]
    t_boot = tvo.bootstrap(frames[0], frames[STRIDE],
                           intermediate=frames[1:STRIDE]).to_numpy()
    t_steps = []
    s = FrameState.from_numpy(jax_state_dict(j_boot))
    for i in range(STRIDE + 1, STRIDE + 1 + N_STEPS):
        bank.key = jax.random.split(keys[i])[0]
        s = tvo.step(s, frames[i])
        t_steps.append((s.to_numpy(), list(ba_calls)))
    return dict(j_boot=jax_state_dict(j_boot), t_boot=t_boot,
                j_steps=j_steps, t_steps=[a for a, _ in t_steps],
                ba_calls=[b for _, b in t_steps])


@pytest.fixture(scope="module")
def runs():
    return slice_runs("pallas2")


def rot_deg(Ta, Tb):
    """Angle between two rotations, well conditioned near 0."""
    d = np.linalg.norm(Ta[:3, :3].astype(np.float64) - Tb[:3, :3])
    return np.degrees(2 * np.arcsin(min(1.0, d / (2 * np.sqrt(2)))))


def same_tracks(j, t):
    n_j, n_t = int(j["n_tracked"]), int(t["n_tracked"])
    assert abs(n_j - n_t) <= 1
    return n_j == n_t


def assert_states_agree(j, t):
    assert int(j["status"]) == int(t["status"])
    same = same_tracks(j, t)
    rot_tol = ROT_TOL_DEG if same else ROT_TOL_TRACK_DIFF_DEG
    t_tol = T_TOL if same else T_TOL_TRACK_DIFF
    assert rot_deg(j["T_CW"], t["T_CW"]) < rot_tol
    np.testing.assert_allclose(t["T_CW"][:3, 3], j["T_CW"][:3, 3], atol=t_tol)
    for name in ("lm_valid", "cand_valid"):
        assert np.mean(j[name] == t[name]) >= MASK_AGREE, name
    assert abs(int(j["n_inliers"]) - int(t["n_inliers"])) <= (
        0.03 * int(j["n_inliers"]) + 1)


def test_bootstrap_matches_reference(runs):
    j, t = runs["j_boot"], runs["t_boot"]
    assert int(j["status"]) == 0, "reference bootstrap failed on the scene"
    assert int(t["frame_idx"]) == int(j["frame_idx"]) == 1
    assert_states_agree(j, t)
    assert j["lm_valid"].sum() >= 8


@pytest.mark.parametrize("k", range(N_STEPS))
def test_step_matches_reference(runs, k):
    j, t = runs["j_steps"][k], runs["t_steps"][k]
    assert int(t["frame_idx"]) == int(j["frame_idx"]) == 2 + k
    assert_states_agree(j, t)


def test_in_step_ba_ran_with_compaction(runs):
    """The bootstrap leaves frame_idx at 1, so the steps make frames 2, 3, 4
    and frame 4 is the only trigger (window 3, every 2).  It ran once, on a
    tracking frame, through the top-k compaction (max_landmarks 64 < 128
    slots), and the BA ring and map agree with the reference's after it."""
    assert runs["ba_calls"] == [[], [], [runs["ba_calls"][-1][0]]]
    j, t = runs["j_steps"][-1], runs["t_steps"][-1]
    assert int(j["frame_idx"]) == 4 and int(j["status"]) == 0
    assert runs["ba_calls"][-1][0] >= 8
    same = same_tracks(j, t)
    for a, b in zip(j["ba_T"], t["ba_T"]):
        assert rot_deg(a, b) < (ROT_TOL_DEG if same else ROT_TOL_TRACK_DIFF_DEG)
        np.testing.assert_allclose(b[:3, 3], a[:3, 3],
                                   atol=T_TOL if same else T_TOL_TRACK_DIFF)
    both = j["lm_valid"] & t["lm_valid"]
    np.testing.assert_allclose(t["lm_xyz"][both], j["lm_xyz"][both], rtol=0,
                               atol=LM_TOL if same else LM_TOL_TRACK_DIFF)
