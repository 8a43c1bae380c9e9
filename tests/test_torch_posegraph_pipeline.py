"""The port's pose-graph pipeline on the CPU: ``run_sequence(posegraph=True)``
with its keyframe bank checkpointed, then that bank carried to both packages
(``posegraph_runner.bank_to_arrays``; the JAX side reads the same arrays
through its own ``checkpoint.restore_aux``) and held against the JAX
``detect_loops`` and ``refine_trajectory``.

Scene: ``make_orbit_scene(seed=4)``, 130 frames at 320x416, 1.2 revolutions
(``tests/test_posegraph_pipeline.py``'s), the parking preset with that
test's detector and landmark settings, cut for CPU time: 256-slot tables,
400 corners, LK window 11 over 4 levels with 10 iterations, 200 PnP
hypotheses.  Keyframes every 8 frames with 384 SIFT features.

The port verifies loop pairs with the reference's RANSAC draws
(``fold_in(PRNGKey(0), k)`` for the k-th candidate pair, the key the JAX
verifier gives chunk slot k).  Tolerances of ``detect_loops``: the same
verified pairs, inlier counts within 2 (float32 sums in another order move
Sampson distances at the threshold), and each pair's (R, t) within 1e-3 of
the reference's, or, where the reference's jitted verifier and its own
eager one disagree (a near-degenerate pair whose 5-point hypotheses score
alike, as in ROADMAP.md Queue 3 item 6: on this bank pair (1, 15), 75
inliers either way, t 0.26 apart), within 1e-3 of the eager one.  So
``refine_trajectory`` is held against the reference on the same loop edges
(both packages' ``detect_loops`` return the port's): refined positions
within 1e-3 of the path length, Sim(3) and SE(3).

``verify_pairs`` takes each chunk of 8 candidates in one batched call (the
matching over the chunk, ``verify_geometry`` under ``torch.func.vmap``);
on this bank every pair's arrays equal, bit for bit, those of the same
functions called pair by pair with the same banks, and no op of the batched
call falls back to a loop over the pairs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_visual_odometry_va4mr_tpu.core.camera import Camera as JCamera
from monocular_visual_odometry_va4mr_tpu.core import config as jconfig
from monocular_visual_odometry_va4mr_tpu.dataio import synthetic as jsyn
from monocular_visual_odometry_va4mr_tpu.ops import essential as jess
from monocular_visual_odometry_va4mr_tpu.ops import match as jmatch
from monocular_visual_odometry_va4mr_tpu.ops import ransac as jransac
from monocular_visual_odometry_va4mr_tpu.pipeline import (
    checkpoint as jcheckpoint)
from monocular_visual_odometry_va4mr_tpu.pipeline import (
    posegraph_runner as jpr)
from monocular_visual_odometry_va4mr_tpu.pipeline.vo import (
    VisualOdometry as JVO)
from monocular_visual_odometry_va4mr_torch.core import config as tconfig
from monocular_visual_odometry_va4mr_torch.core.camera import Camera
from monocular_visual_odometry_va4mr_torch.dataio import synthetic
from monocular_visual_odometry_va4mr_torch.pipeline import (
    checkpoint, posegraph_runner, runner)
from monocular_visual_odometry_va4mr_torch.ops import match
from monocular_visual_odometry_va4mr_torch.pipeline.vo import VisualOdometry
from test_torch_batched import no_vmap_fallback

torch.set_num_threads(1)

NUM_FRAMES = 130
IMAGE_SHAPE = (320, 416)
PATH_TOL = 1e-3
INLIER_TOL = 2
POSE_TOL = 1e-3
LOOP_GATES = dict(min_gap_frames=30, min_matches=30, min_inliers=20)


def orbit_config(cfg_mod):
    cfg = cfg_mod.parking_config().replace(image_shape=IMAGE_SHAPE,
                                           bootstrap_method="klt")
    return cfg.replace(
        detector=dataclasses.replace(cfg.detector, quality_level=0.02,
                                     max_corners=400),
        landmarks=dataclasses.replace(cfg.landmarks, max_dist=200.0),
        klt=dataclasses.replace(cfg.klt, window=11, max_level=3,
                                num_iters=10),
        pnp=dataclasses.replace(cfg.pnp, iterations=200),
        capacity=dataclasses.replace(cfg.capacity, max_landmarks=256,
                                     max_candidates=256))


class LoopDraws:
    """The JAX verifier's RANSAC draws: the k-th call gets those of
    ``fold_in(PRNGKey(seed), k)``."""

    def __init__(self, seed=0):
        self.key = jax.random.PRNGKey(seed)
        self.calls = 0

    def __call__(self, generator, valid, n, k):
        key = jax.random.fold_in(self.key, self.calls)
        self.calls += 1
        idx, ok = jransac.sample_minimal_sets(
            key, jnp.asarray(valid.cpu().numpy()), n, k)
        return (torch.from_numpy(np.asarray(idx)).long(),
                torch.from_numpy(np.asarray(ok)))


@pytest.fixture(scope="module")
def orbit(tmp_path_factory):
    """The port's runner over the orbit scene with the pose graph on, a
    checkpoint at the last frame; its bank restored from that checkpoint
    and carried to the JAX package."""
    scene = synthetic.make_orbit_scene(seed=4, num_frames=NUM_FRAMES,
                                       image_shape=IMAGE_SHAPE,
                                       revolutions=1.2)
    frames = [scene.render(i) for i in range(NUM_FRAMES)]
    tvo = VisualOdometry(Camera.from_matrix(scene.K), orbit_config(tconfig),
                         "cpu")
    ckpt = tmp_path_factory.mktemp("ckpt")
    result = runner.run_sequence(tvo, enumerate(frames), bootstrap_stride=2,
                                 posegraph=True, checkpoint_dir=str(ckpt),
                                 checkpoint_every=NUM_FRAMES - 1)
    records, _, bank = checkpoint.restore_aux(str(ckpt), tvo)
    arrays = posegraph_runner.bank_to_arrays(bank)
    jdir = tmp_path_factory.mktemp("jax_aux")
    np.savez(jdir / "aux.npz", **arrays)
    jvo = JVO(JCamera.from_matrix(scene.K), orbit_config(jconfig))
    _, _, jbank = jcheckpoint.restore_aux(str(jdir), jvo)
    return dict(scene=scene, frames=frames, result=result, tvo=tvo,
                bank=bank, records=records, arrays=arrays, jvo=jvo,
                jbank=jbank)


def test_orbit_scene_renders_what_the_reference_renders(orbit):
    jscene = jsyn.make_orbit_scene(seed=4, num_frames=NUM_FRAMES,
                                   image_shape=IMAGE_SHAPE, revolutions=1.2)
    np.testing.assert_array_equal(orbit["scene"].poses_WC, jscene.poses_WC)
    for i in (0, 77):
        np.testing.assert_array_equal(orbit["frames"][i],
                                      jsyn.render_frame(jscene, i))


def test_loop_scene_renders_what_the_reference_renders():
    kw = dict(seed=11, num_frames=200, laps=1.25, image_shape=(96, 160))
    a, b = synthetic.make_loop_scene(**kw), jsyn.make_loop_scene(**kw)
    np.testing.assert_array_equal(a.poses_WC, b.poses_WC)
    np.testing.assert_array_equal(a.pillars, b.pillars)
    np.testing.assert_array_equal(a.pillars_x, b.pillars_x)
    np.testing.assert_array_equal(a.render(40), jsyn.render_frame(b, 40))


def test_run_sequence_with_posegraph_on_cpu(orbit):
    """The runner kept a keyframe every 8 frames on tracking frames, wrote
    the bank into its checkpoint and refined the trajectory."""
    res, bank = orbit["result"], orbit["bank"]
    assert len(bank.keyframes) >= 8
    assert all(k.frame % 8 == 0 for k in bank.keyframes)
    assert [r.frame for r in orbit["records"]] == [r.frame
                                                   for r in res.records]
    ref = res.refined_positions
    assert ref is not None and ref.shape == (len(res.records), 3)
    assert np.all(np.isfinite(ref))


def test_checkpoint_bank_round_trip(orbit, tmp_path):
    """The bank through a checkpoint and back, and the JAX bank read from
    the same arrays: every array equal."""
    state = orbit["tvo"].bootstrap(orbit["frames"][0], orbit["frames"][2])
    checkpoint.save(str(tmp_path), state, 5, bank=orbit["bank"])
    again = checkpoint.restore_aux(str(tmp_path), orbit["tvo"])[2]
    a, b = orbit["arrays"], posegraph_runner.bank_to_arrays(again)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for tk, jk in zip(orbit["bank"].keyframes, orbit["jbank"].keyframes):
        for f in dataclasses.fields(tk):
            np.testing.assert_array_equal(getattr(tk, f.name),
                                          getattr(jk, f.name),
                                          err_msg=f.name)


def eager_reference_pose(orbit, k, a, b):
    """(R, t) of the reference's verifier for candidate k = (a, b), its
    functions called one by one outside ``jit``."""
    jcam = orbit["jvo"].cam
    ka, kb = orbit["jbank"].keyframes[a], orbit["jbank"].keyframes[b]
    idx1, mok = jmatch.match_ratio(
        jnp.asarray(ka.desc), jnp.asarray(ka.valid), jnp.asarray(kb.desc),
        jnp.asarray(kb.valid), ratio=orbit["jvo"].config.sift.ratio)
    u0, u1 = jnp.asarray(ka.uv), jnp.asarray(kb.uv)[idx1]
    key = jax.random.fold_in(jax.random.PRNGKey(0), k)
    E, inl, _ = jess.find_essential_ransac(key, jcam, u0, u1, mok,
                                           iterations=300, threshold_px=1.5,
                                           solver="5point")
    R, t, _ = jess.recover_pose(E, jcam, u0, u1, inl)
    return np.asarray(R), np.asarray(t)


@pytest.fixture(scope="module")
def port_loops(orbit):
    return posegraph_runner.detect_loops(orbit["bank"], sampler=LoopDraws(),
                                         **LOOP_GATES)


def test_detect_loops_matches_reference(orbit, port_loops):
    jloops = jpr.detect_loops(orbit["jbank"], orbit["jvo"].cam, **LOOP_GATES)
    assert len(jloops) >= 2
    assert [(a, b) for a, b, *_ in port_loops] == [
        (a, b) for a, b, *_ in jloops]
    cands = jpr.retrieve_candidates(orbit["jbank"],
                                    min_gap_frames=LOOP_GATES[
                                        "min_gap_frames"])
    for j, t in zip(jloops, port_loops):
        assert abs(j[4] - t[4]) <= INLIER_TOL
        assert (j[5] is None) == (t[5] is None)
        assert (j[6] is None) == (t[6] is None)
        R, tt = np.asarray(j[2]), np.asarray(j[3])
        if max(np.abs(R - t[2]).max(), np.abs(tt - t[3]).max()) > POSE_TOL:
            R, tt = eager_reference_pose(orbit, cands.index(j[:2]), *j[:2])
        np.testing.assert_allclose(t[2], R, rtol=0, atol=POSE_TOL)
        np.testing.assert_allclose(t[3], tt, rtol=0, atol=POSE_TOL)


def test_batched_verifier_equals_the_per_pair_functions(orbit):
    vo, kfs = orbit["tvo"], orbit["bank"].keyframes
    pairs = posegraph_runner.retrieve_candidates(
        orbit["bank"], min_gap_frames=LOOP_GATES["min_gap_frames"])
    # More than one chunk, the last one padded.
    assert len(pairs) > posegraph_runner.VERIFY_CHUNK
    assert len(pairs) % posegraph_runner.VERIFY_CHUNK
    kw = dict(ransac_iters=300, threshold_px=1.5, sampler=vo.sampler)
    with no_vmap_fallback():
        batched = posegraph_runner.verify_pairs(
            vo, vo.cam, pairs, kfs, generator=torch.Generator().manual_seed(0),
            **kw)
    gen = torch.Generator().manual_seed(0)
    assert len(batched) == len(pairs)
    for (a, b), got in zip(pairs, batched):
        ka, kb = kfs[a], kfs[b]
        idx1, mok = match.match_ratio(
            torch.from_numpy(ka.desc), torch.from_numpy(ka.valid),
            torch.from_numpy(kb.desc), torch.from_numpy(kb.valid),
            ratio=vo.config.sift.ratio)
        u0, u1m = torch.from_numpy(ka.uv), torch.from_numpy(kb.uv)[idx1]
        idx, ok = vo.sampler(gen, mok, kw["ransac_iters"], 5)
        want = (idx1, *posegraph_runner.verify_geometry(
            vo.cam, u0, u1m, mok, idx, ok, threshold_px=kw["threshold_px"]))
        assert len(got) == len(want) == 10
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y.numpy())


@pytest.mark.parametrize("method", ["sim3", "se3"])
def test_refine_trajectory_matches_reference(orbit, port_loops, method):
    """Both packages refine the same records over the same bank with the
    same verified loop edges (the port's)."""
    records = orbit["records"]
    gates = dict(min_gap_frames=30, min_matches=60, min_inliers=60)
    loops = [lp for lp in port_loops if lp[4] >= gates["min_inliers"]]

    def same_loops(*args, **kw):
        return loops

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpr, "detect_loops", same_loops)
        mp.setattr(posegraph_runner, "detect_loops", same_loops)
        jref = jpr.refine_trajectory(records, orbit["jbank"],
                                     orbit["jvo"].cam, method=method,
                                     **gates)
        tref = posegraph_runner.refine_trajectory(
            records, orbit["bank"], method=method, **gates)
    assert jref is not None and tref is not None
    pos = np.stack([r.T_WC[:3, 3] for r in records])
    path = np.sum(np.linalg.norm(np.diff(pos, axis=0), axis=1))
    assert np.abs(tref - pos).max() > 10 * PATH_TOL * path  # it moved
    np.testing.assert_allclose(tref, jref, rtol=0, atol=PATH_TOL * path)
