"""The step's execution model on the CPU: what lets ``VisualOdometry.step``
replay one captured CUDA graph on the card.

* The step's body (``_step_impl``) reads no device value on the host and
  makes no tensor from host data: run under a dispatch mode that raises on
  ``aten._local_scalar_dense`` (``.item()``, ``int(t)``, a 0-d index),
  ``aten.nonzero``, ``aten.masked_select``, ``aten.unique*`` and
  ``aten.lift_fresh`` (``torch.tensor(...)``, on the card a copy from the
  host), with the default device set to ``meta`` so that a tensor made
  without the state's device fails where it meets one, on a skip frame and
  on a BA-trigger frame, on each tracker.
* ``frame_idx`` is a device int32 scalar equal to the JAX state's after the
  bootstrap and after each step, and survives ``to_numpy`` /
  ``from_numpy`` and a checkpoint.
* The RANSAC draw split in two (``draw_uniforms``, ``select_minimal_sets``)
  equals the generator path bit for bit.
* The ring slot written on the device equals the JAX step's over more
  frames than the ring holds, through two BA triggers.
* A state made without its host frame index raises instead of reading it
  from the device; the default sampler's draw reaches every slot's VO.

Scene and config as ``tests/test_torch_vo.py`` (96x160, 128-slot tables,
``ba.window=3``, ``ba.every=2``), over 5 steps: frames 2..6, the ring
wraps at frame 3 and again at 6, BA triggers at frames 4 and 6.  The port
starts from the reference's bootstrap state and draws the reference's
RANSAC banks; tolerances are those of ``tests/test_torch_vo.py``.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from monocular_visual_odometry_va4mr_tpu.core.camera import Camera as JCamera
from monocular_visual_odometry_va4mr_tpu.core.config import kitti_tuned_config
from monocular_visual_odometry_va4mr_tpu.dataio import synthetic
from monocular_visual_odometry_va4mr_tpu.ops import klt_pallas as jv1
from monocular_visual_odometry_va4mr_tpu.ops import klt_pallas2 as jk2
from monocular_visual_odometry_va4mr_tpu.pipeline.vo import (
    VisualOdometry as JVO)
from monocular_visual_odometry_va4mr_torch.core.camera import Camera
from monocular_visual_odometry_va4mr_torch.core.config import (
    kitti_tuned_config as t_kitti_tuned_config)
from monocular_visual_odometry_va4mr_torch.core.state import (FrameState,
                                                              Packing)
from monocular_visual_odometry_va4mr_torch.ops import ransac
from monocular_visual_odometry_va4mr_torch.parallel import seq_dp
from monocular_visual_odometry_va4mr_torch.pipeline import checkpoint
from monocular_visual_odometry_va4mr_torch.pipeline.vo import (
    VisualOdometry, frame_outputs)
from test_torch_vo import (JaxBank, jax_state_dict, rot_deg, same_tracks,
                           small_config)

torch.set_num_threads(1)

STRIDE = 3
N_STEPS = 5  # frames 2..6: more than the ring's 3, triggers at 4 and 6
WINDOW = 3
HOST_SYNC_OPS = ("aten._local_scalar_dense", "aten.nonzero",
                 "aten.masked_select", "aten.unique", "aten._unique",
                 "aten.lift_fresh")


class NoHostReads(TorchDispatchMode):
    """Raises on every op that reads the device on the host or makes a
    tensor from host data."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func).startswith(HOST_SYNC_OPS):
            raise AssertionError(f"{func} inside the step")
        return func(*args, **(kwargs or {}))


def scene_frames(n):
    scene = synthetic.make_textured_scene(
        seed=7, num_frames=n, image_shape=(96, 160), step=1.0)
    return scene, [scene.render(i) for i in range(n)]


@pytest.fixture(scope="module")
def runs():
    """Bootstrap + N_STEPS steps in both packages on ``pallas2`` (the JAX
    kernel in interpret mode), the port from the reference's bootstrap
    state with the reference's draws; every port state kept."""
    scene, frames = scene_frames(STRIDE + N_STEPS + 1)
    key = jax.random.PRNGKey(0)
    keys = [jax.random.fold_in(key, i) for i in range(len(frames))]
    jvo = JVO(JCamera.from_matrix(scene.K), small_config(kitti_tuned_config))
    with pytest.MonkeyPatch.context() as mp:
        for mod, name in ((jk2, "track_features_pallas2"),
                          (jv1, "track_features_pallas"),
                          (jk2, "track_multilevel")):
            mp.setattr(mod, name, functools.partial(getattr(mod, name),
                                                    interpret=True))
        s = jvo.bootstrap(frames[0], frames[STRIDE], keys[0],
                          intermediate=frames[1:STRIDE])
        j_states = [jax_state_dict(s)]
        for i in range(STRIDE + 1, STRIDE + 1 + N_STEPS):
            s = jvo.step(s, frames[i], keys[i])
            j_states.append(jax_state_dict(s))

    bank = JaxBank()
    tvo = VisualOdometry(Camera.from_matrix(scene.K),
                         small_config(t_kitti_tuned_config), "cpu",
                         sampler=bank)
    t = FrameState.from_numpy(j_states[0])
    t_states = [t]
    for i in range(STRIDE + 1, STRIDE + 1 + N_STEPS):
        bank.key = jax.random.split(keys[i])[0]
        t = tvo.step(t, frames[i])
        t_states.append(t)
    return dict(j=j_states, t=t_states, vo=tvo, ba_runs=tvo.ba_runs)


@pytest.fixture(scope="module")
def port_run():
    """The port alone (its own draws): a VO per tracker and its bootstrap
    state on the scene, with the image of the next frame."""
    scene, frames = scene_frames(STRIDE + 2)
    out = {}
    for backend in ("pallas2", "pallas", "xla"):
        vo = VisualOdometry(Camera.from_matrix(scene.K),
                            small_config(t_kitti_tuned_config, backend),
                            "cpu", seed=0)
        state = vo.bootstrap(frames[0], frames[STRIDE],
                             intermediate=frames[1:STRIDE])
        out[backend] = (vo, state, torch.as_tensor(frames[STRIDE + 1]))
    return out


def at_frame(state, frame):
    out = state.replace(frame_idx=torch.tensor(frame, dtype=torch.int32))
    out.host_frame = frame
    return out


@pytest.mark.parametrize("run_ba", [False, True], ids=["skip", "trigger"])
@pytest.mark.parametrize("backend", ["pallas2", "pallas", "xla"])
def test_step_body_reads_nothing_on_the_host(port_run, backend, run_ba):
    vo, state, img = port_run[backend]
    # The ring full and frame 4 next (window 3, every 2): the BA runs.
    state = at_frame(state, 3 if run_ba else 2)
    assert vo.ba_due(state) == run_ba
    draws = vo.step_draws()
    eager = vo._step_impl(state, img, draws, run_ba)
    torch.set_default_device("meta")
    try:
        with NoHostReads():
            out = vo._step_impl(state, img, draws, run_ba)
    finally:
        torch.set_default_device(None)
    for a, b in zip(out.tensors(), eager.tensors()):
        assert a.device.type == "cpu" and torch.equal(a, b)
    assert int(out.frame_idx) == state.host_frame + 1


def test_step_on_the_cpu_is_the_body(port_run):
    """On the CPU ``step`` runs ``_step_impl`` with the same draws, advances
    the host's frame count and counts the BA it ran."""
    vo, state, img = port_run["pallas2"]
    state = at_frame(state, 3)
    runs0 = vo.ba_runs
    out = vo.step(state, img, generator=torch.Generator().manual_seed(5))
    ref = vo._step_impl(state, img,
                        vo.step_draws(torch.Generator().manual_seed(5)), True)
    assert vo.ba_runs == runs0 + 1 and out.host_frame == 4
    for a, b in zip(out.tensors(), ref.tensors()):
        assert torch.equal(a, b)


def test_frame_idx_is_a_device_int32_scalar_like_the_reference(runs):
    for k, (j, t) in enumerate(zip(runs["j"], runs["t"])):
        assert t.frame_idx.dtype == torch.int32 and t.frame_idx.dim() == 0
        assert j["frame_idx"].dtype == np.int32
        assert int(t.frame_idx) == int(j["frame_idx"]) == 1 + k
        assert t.host_frame == 1 + k
    assert runs["ba_runs"] == 2


def test_frame_idx_survives_numpy_and_checkpoint_round_trips(runs, tmp_path):
    t = runs["t"][-1]
    back = FrameState.from_numpy(t.to_numpy())
    assert back.frame_idx.dtype == torch.int32 and back.host_frame == 6
    assert torch.equal(back.frame_idx, t.frame_idx)
    checkpoint.save(str(tmp_path), t, 9)
    restored, at = checkpoint.restore(str(tmp_path), runs["t"][0])
    assert at == 9 and restored.host_frame == 6
    for a, b in zip(restored.tensors(), t.tensors()):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # A state made without its host index: the step raises rather than
    # read the index back from the device.
    blind = t.replace(frame_idx=t.frame_idx.clone())
    assert blind.host_frame is None
    with pytest.raises(ValueError, match="host_frame"):
        runs["vo"].step(blind, torch.zeros(96, 160))


@pytest.mark.parametrize("n,k", [(500, 3), (64, 5), (2000, 8)])
def test_split_draw_equals_the_generator_path(n, k):
    rng = np.random.default_rng(n + k)
    for frac in (0.0, 0.01, 0.5, 1.0):
        valid = torch.from_numpy(rng.random(300) < frac)
        g1 = torch.Generator().manual_seed(n * 7 + k)
        g2 = torch.Generator().manual_seed(n * 7 + k)
        idx, ok = ransac.sample_minimal_sets(g1, valid, n, k)
        u = ransac.draw_uniforms(g2, n, k)
        assert u.shape == (n, k) and u.dtype == torch.float32
        idx2, ok2 = ransac.select_minimal_sets(u, valid)
        assert torch.equal(idx, idx2) and torch.equal(ok, ok2)


def test_ring_slot_across_a_wrap_matches_the_reference(runs):
    for k, (j, t) in enumerate(zip(runs["j"][1:], runs["t"][1:])):
        frame = 2 + k
        slot = frame % WINDOW
        T = t.T_CW.numpy()
        # The newest pose sits in the frame's slot, on both sides.
        np.testing.assert_array_equal(t.ba_T[slot].numpy(), T)
        np.testing.assert_array_equal(j["ba_T"][slot], j["T_CW"])
        same = same_tracks(j, t.to_numpy())
        for a, b in zip(j["ba_T"], t.ba_T.numpy()):
            assert rot_deg(a, b) < (0.01 if same else 0.5)
            np.testing.assert_allclose(b[:3, 3], a[:3, 3],
                                       atol=1e-3 if same else 5e-2)
        np.testing.assert_array_equal(t.ba_gen.numpy(), j["ba_gen"])
        assert np.mean(t.ba_mask.numpy() == j["ba_mask"]) >= 0.97


def test_packing_views_and_copies():
    like = [torch.zeros((4, 4)), torch.zeros((), dtype=torch.int32),
            torch.zeros((5,), dtype=torch.bool), torch.zeros((3, 2))]
    p = Packing(like)
    assert p.nbytes % Packing.ALIGN == 0
    assert all(o % Packing.ALIGN == 0 for o in p.offsets)
    src = [torch.arange(16.0).reshape(4, 4), torch.tensor(7, dtype=torch.int32),
           torch.tensor([True, False, True, True, False]),
           torch.arange(6.0).reshape(3, 2).T.contiguous().T]
    rows = torch.zeros((3, p.nbytes), dtype=torch.uint8)
    p.pack(rows[1], src)
    for v, t in zip(p.views(rows[1]), src):
        assert v.dtype == t.dtype and torch.equal(v, t)
    lead = p.views(rows)
    assert [tuple(v.shape) for v in lead] == [(3, 4, 4), (3,), (3, 5), (3, 3, 2)]
    assert torch.equal(lead[0][1], src[0]) and not lead[0][0].any()
    with pytest.raises(ValueError):
        p.pack(rows[0], src[:2] + [torch.zeros(5)] + src[3:])


@pytest.mark.parametrize("landmarks", [False, True],
                         ids=["pose", "landmarks"])
def test_frame_outputs_pack_into_the_block_row(runs, landmarks):
    vo = runs["vo"]
    t = runs["t"][-1]
    packing = vo.outputs[landmarks]
    row = torch.zeros(packing.nbytes, dtype=torch.uint8)
    vo.outputs[landmarks].pack(row, frame_outputs(t, landmarks))
    views = packing.views(row)
    assert len(views) == (7 if landmarks else 4)
    T, n_inl, n_trk, status = views[:4]
    assert torch.equal(T, t.T_CW)
    assert int(n_inl) == int(t.n_inliers) and int(status) == int(t.status)
    assert int(n_trk) == int(t.n_tracked)
    if landmarks:
        lm_uv, lm_z, lm_valid = views[4:]
        z = t.lm_xyz @ t.T_CW[2, :3] + t.T_CW[2, 3]
        assert torch.equal(lm_uv, t.lm_uv) and torch.equal(lm_z, z)
        assert torch.equal(lm_valid,
                           t.lm_valid & torch.isfinite(z) & (z > 0))


def test_every_slot_vo_draws_its_bank_before_the_step(port_run):
    """The default sampler carries its draw, so a VO made with it, as
    ``seq_dp.slot_vos`` makes one for each further device, feeds the
    captured step uniforms, and its step equals the original's."""
    vo, state, img = port_run["pallas2"]
    assert vo._draw is ransac.draw_uniforms
    named = VisualOdometry(vo.cam, vo.config, "cpu",
                           sampler=ransac.sample_minimal_sets)
    assert named._draw is ransac.draw_uniforms
    mesh = seq_dp.SlotMesh((torch.device("cpu"), torch.device("cpu", 0)))
    own, other = seq_dp.slot_vos(vo, mesh)
    assert own is vo and other is not vo
    assert other._draw is ransac.draw_uniforms
    draws = other.step_draws(torch.Generator().manual_seed(3))
    assert torch.is_tensor(draws) and draws.shape == (
        vo.config.pnp.iterations, 3)
    a = other.step(state, img, generator=torch.Generator().manual_seed(3))
    b = vo.step(state, img, generator=torch.Generator().manual_seed(3))
    for x, y in zip(a.tensors(), b.tensors()):
        assert torch.equal(x, y)

