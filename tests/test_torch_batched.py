"""The batched step and its LK kernels on the CPU: the port's counterpart of
the JAX package's ``jax.vmap`` of the per-frame step
(``parallel/seq_dp.py``).

* Both LK kernels' plain versions take a leading batch axis and give each
  problem of a batch of 3 its solo result bit for bit; ``torch.func.vmap``
  of either kernel's custom op reaches ONE call of the batched plain version
  through the op's vmap rule (on the card that call is one launch; on the
  CPU no launch is counted) and equals the loop of solo calls.
* The ``pallas2`` tracker under ``torch.func.vmap`` against the JAX tracker
  under ``jax.vmap`` (its Pallas kernel in interpret mode, batched by
  Pallas's own vmap rule) over 2 slots, with ``tests/test_torch_klt.py``'s
  exemption of the features the reference's slab wrap reaches.
* ``VisualOdometry.step_batch`` against ``step``: 3 sequences (the
  textured scene of ``tests/test_torch_vo.py`` from frames 0, 1 and 2) over
  3 steps through a BA trigger (``ba.window=3``, ``ba.every=2``: frame 4),
  on each tracker: every state and every packed output row bit for bit the
  solo one's.
* The batched body (``_step_batch_impl``) at B = 2 under
  ``tests/test_torch_step_graph.py``'s dispatch mode that raises on host
  reads, default device ``meta``, on skip and BA frames of each tracker.
* Every batched call here runs with the vmap fallback disabled, so an op
  without a batching rule (which the fallback would run slice by slice)
  raises.
* The batched step against ``jax.jit(jax.vmap(_step_impl))`` over 2
  sequences at 96x160 (the JAX trackers in interpret mode), from the
  reference's bootstrap states at frame index 2, 2 steps: frame 3 skips the
  BA, frame 4 runs it.  The port draws the reference's PnP banks
  (``JaxTableBank``), so only float32 rounding parts them; tolerances are
  ``tests/test_torch_vo.py``'s.
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_visual_odometry_va4mr_tpu.core.camera import Camera as JCamera
from monocular_visual_odometry_va4mr_tpu.core.config import kitti_tuned_config
from monocular_visual_odometry_va4mr_tpu.dataio import synthetic
from monocular_visual_odometry_va4mr_tpu.ops import image as jimops
from monocular_visual_odometry_va4mr_tpu.ops import klt_pallas as jv1
from monocular_visual_odometry_va4mr_tpu.ops import klt_pallas2 as jk2
from monocular_visual_odometry_va4mr_tpu.pipeline.vo import (
    VisualOdometry as JVO)
from monocular_visual_odometry_va4mr_torch.core.camera import Camera
from monocular_visual_odometry_va4mr_torch.core.config import (
    kitti_tuned_config as t_kitti_tuned_config)
from monocular_visual_odometry_va4mr_torch.core.state import (
    FrameState, stack_states, unstack_states)
from monocular_visual_odometry_va4mr_torch.ops import klt_pallas as tv1
from monocular_visual_odometry_va4mr_torch.ops import klt_pallas2 as tk2
from monocular_visual_odometry_va4mr_torch.pipeline.vo import (
    VisualOdometry, frame_outputs)
from test_torch_klt import (assert_parity, search_positions, shifted, texture,
                            tt, wrap_exposed)
from test_torch_step_graph import NoHostReads, at_frame
from test_torch_vo import (LM_TOL, LM_TOL_TRACK_DIFF, assert_states_agree,
                           jax_state_dict, same_tracks, small_config)

torch.set_num_threads(1)

SHAPE = (96, 160)
STRIDE = 3  # bootstrap frames s -> s + 3
N_STEPS = 3  # frames 2, 3, 4: the BA triggers at 4
SLOTS = 3
N_LK = 64  # features per LK problem (a multiple of 8, as v1 needs)
LK_KW = dict(num_iters=6, eps=0.01, min_eig_threshold=1e-4,
             max_residual=20.0)


@contextlib.contextmanager
def no_vmap_fallback():
    """Every op under ``torch.func.vmap`` must have a batching rule: the
    fallback that would run it slice by slice raises instead."""
    was = torch._C._functorch._is_vmap_fallback_enabled()
    torch._C._functorch._set_vmap_fallback_enabled(False)
    try:
        yield
    finally:
        torch._C._functorch._set_vmap_fallback_enabled(was)


def same_bits(a, b):
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().reshape(-1).view(torch.uint8),
                            b.contiguous().reshape(-1).view(torch.uint8)))


# ---------------------------------------------------------------------------
# The LK kernels over a batch axis
# ---------------------------------------------------------------------------

def lk_problem(rng, shift):
    """One tracking problem for both kernels: planes, klt_lk's feat rows and
    valid flags, klt_v1's meta rows."""
    img0 = texture(rng, *SHAPE)
    img1 = shifted(img0, *shift)
    pts = np.stack([rng.uniform(10, SHAPE[1] - 10, N_LK),
                    rng.uniform(10, SHAPE[0] - 10, N_LK)], 1).astype(
                        np.float32)
    q = pts + np.float32(shift) + rng.normal(0, 1.0, (N_LK, 2)).astype(
        np.float32)
    po, pp = tk2._origin_and_phase(tt(pts), 15)
    qo, qp = tk2._origin_and_phase(tt(q), 15)
    valid = tt(rng.uniform(size=N_LK) < 0.9)
    meta = torch.stack([tt(pts[:, 1]), tt(pts[:, 0]), tt(q[:, 1]),
                        tt(q[:, 0]), valid.to(torch.float32)], 1)
    return tt(img0), tt(img1), torch.cat([po, pp, qo, qp], 1), valid, meta


@pytest.fixture(scope="module")
def lk_batch():
    """Three problems, each tensor stacked on a leading axis."""
    rng = np.random.default_rng(3)
    probs = [lk_problem(rng, s) for s in ((2.5, -1.3), (-3.1, 0.7),
                                          (0.4, 4.2))]
    return [torch.stack(ts) for ts in zip(*probs)]


def kernel_calls(name, batch):
    """(wrapper, plain version's module attribute, batched args, kwargs)."""
    tmpl, srch, feat, valid, meta = batch
    if name == "klt_lk":
        return (tk2.klt_lk, (tk2, "klt_lk_plain"), (tmpl, srch, feat, valid),
                dict(win=15, **LK_KW))
    return tv1.klt_v1, (tv1, "klt_v1_plain"), (tmpl, srch, meta), LK_KW


@pytest.mark.parametrize("name", ["klt_lk", "klt_v1"])
def test_plain_versions_take_a_batch_axis(lk_batch, name):
    _, (mod, attr), args, kw = kernel_calls(name, lk_batch)
    plain = getattr(mod, attr)
    out = plain(*args, **kw)
    assert out.shape == (SLOTS, N_LK, 5)
    for b in range(SLOTS):
        assert same_bits(out[b], plain(*(a[b] for a in args), **kw))
    ok = out[..., 2] > 0.5
    assert ok.sum() > 0.5 * ok.numel()


@pytest.mark.parametrize("name", ["klt_lk", "klt_v1"])
def test_vmap_of_the_kernel_op_is_one_batched_call(lk_batch, name,
                                                   monkeypatch):
    wrapper, (mod, attr), args, kw = kernel_calls(name, lk_batch)
    plain = getattr(mod, attr)
    calls = []

    def spy(tmpl, *a, **k):
        calls.append(tuple(tmpl.shape))
        return plain(tmpl, *a, **k)

    monkeypatch.setattr(mod, attr, spy)
    before = wrapper.launches
    with no_vmap_fallback():
        out = torch.func.vmap(functools.partial(wrapper, **kw))(*args)
    # The op's vmap rule folds the vmap's axis into the op's batch axis: one
    # call of the batched plain version (one launch on the card).
    assert calls == [(SLOTS,) + SHAPE]
    assert wrapper.launches == before  # the CPU launches no kernel
    loop = torch.stack([plain(*(a[b] for a in args), **kw)
                        for b in range(SLOTS)])
    assert same_bits(out, loop)
    # A batch given directly is the same single call.
    calls.clear()
    assert same_bits(wrapper(*args, **kw), loop) and len(calls) == 1


def test_tracker_under_vmap_matches_the_reference_under_jax_vmap():
    rng = np.random.default_rng(11)
    shifts = ((3.7, -2.3), (-2.2, 1.6))
    pyr0, pyr1, pts = [], [], []
    for s in shifts:
        img0 = texture(rng, *SHAPE)
        pyr0.append(tuple(np.asarray(p) for p in
                          jimops.build_pyramid(jnp.asarray(img0), 5)))
        pyr1.append(tuple(np.asarray(p) for p in jimops.build_pyramid(
            jnp.asarray(shifted(img0, *s)), 5)))
        pts.append(np.stack([rng.uniform(12, SHAPE[1] - 12, 96),
                             rng.uniform(12, SHAPE[0] - 12, 96)],
                            1).astype(np.float32))
    valid = rng.uniform(size=(2, 96)) < 0.9
    P0 = tuple(np.stack(ls) for ls in zip(*pyr0))
    P1 = tuple(np.stack(ls) for ls in zip(*pyr1))
    kw = dict(num_iters=8, win=15)
    jout = jax.vmap(functools.partial(jk2.track_features_pallas2,
                                      interpret=True, **kw))(
        tuple(map(jnp.asarray, P0)), tuple(map(jnp.asarray, P1)),
        jnp.asarray(np.stack(pts)), jnp.asarray(valid))
    with no_vmap_fallback():
        tout = torch.func.vmap(functools.partial(
            tk2.track_features_pallas2, **kw))(
            tuple(map(tt, P0)), tuple(map(tt, P1)), tt(np.stack(pts)),
            tt(valid))
    for s in range(2):
        j = tuple(np.asarray(a)[s] for a in jout)
        t = tuple(a[s] for a in tout)
        q = search_positions(pyr0[s], pyr1[s], pts[s], None, False)
        assert_parity(j, t, wrap_exposed(q, [j[0], t[0].numpy()], 15))
        assert t[1].numpy().sum() > 30  # of 96, some near the border


# ---------------------------------------------------------------------------
# The batched step against the solo step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scene_frames():
    scene = synthetic.make_textured_scene(
        seed=7, num_frames=SLOTS - 1 + STRIDE + N_STEPS + 1, image_shape=SHAPE,
        step=1.0)
    return scene, [scene.render(i) for i in range(SLOTS - 1 + STRIDE
                                                  + N_STEPS + 1)]


def slot_frame(frames, s, k):
    """Frame k of sequence s: the scene from frame s on."""
    return frames[s + k]


@pytest.fixture(scope="module")
def booted(scene_frames):
    """Per tracker: a port VO and the bootstrap states of the 3 sequences
    (each bootstrap drawn from its own generator)."""
    scene, frames = scene_frames
    out = {}
    for backend in ("pallas2", "pallas", "xla"):
        vo = VisualOdometry(Camera.from_matrix(scene.K),
                            small_config(t_kitti_tuned_config, backend),
                            "cpu")
        states = [vo.bootstrap(slot_frame(frames, s, 0),
                               slot_frame(frames, s, STRIDE),
                               intermediate=[slot_frame(frames, s, k)
                                             for k in range(1, STRIDE)],
                               generator=torch.Generator().manual_seed(s))
                  for s in range(SLOTS)]
        out[backend] = (vo, states)
    return out


@pytest.mark.parametrize("backend", ["pallas2", "pallas", "xla"])
def test_batched_step_equals_solo_steps(scene_frames, booted, backend):
    _, frames = scene_frames
    vo, states = booted[backend]
    runs0 = vo.ba_runs
    solo = []
    for s, st in enumerate(states):
        g = torch.Generator().manual_seed(100 + s)
        run = []
        for k in range(N_STEPS):
            st = vo.step(st, slot_frame(frames, s, STRIDE + 1 + k),
                         generator=g)
            run.append(st)
        solo.append(run)
    assert vo.ba_runs - runs0 == SLOTS  # frame 4 of every sequence
    # At frame 4 sequences 0 and 1 track (the BA's result is kept) and
    # sequence 2 is LOST (the BA's result is dropped): a batch holds both.
    assert [int(r[-1].status) for r in solo] == [0, 0, 1]

    gens = [torch.Generator().manual_seed(100 + s) for s in range(SLOTS)]
    batch = stack_states(states)
    packing = vo.outputs[True]
    rows = torch.zeros((SLOTS, packing.nbytes), dtype=torch.uint8)
    with no_vmap_fallback():
        for k in range(N_STEPS):
            batch = vo.step_batch(
                batch, [slot_frame(frames, s, STRIDE + 1 + k)
                        for s in range(SLOTS)], gens,
                outputs=rows, landmarks=True)
            assert batch.host_frame == 2 + k
            for s, one in enumerate(unstack_states(batch)):
                for a, b in zip(one.tensors(), solo[s][k].tensors()):
                    assert same_bits(a, b)
                for a, b in zip(packing.views(rows[s]),
                                frame_outputs(solo[s][k], True)):
                    assert same_bits(a, b)
    assert vo.ba_runs - runs0 == SLOTS + 1  # one BA branch for the batch


def test_lockstep_needs_one_host_frame(booted):
    vo, states = booted["xla"]
    late = states[1].replace()
    late.host_frame = 2
    with pytest.raises(ValueError, match="host frame"):
        stack_states([states[0], late])
    with pytest.raises(ValueError, match="generators"):
        vo.step_batch(stack_states(states[:2]), torch.zeros((2,) + SHAPE),
                      [torch.Generator()])


@pytest.mark.parametrize("run_ba", [False, True], ids=["skip", "trigger"])
@pytest.mark.parametrize("backend", ["pallas2", "pallas", "xla"])
def test_batched_body_reads_nothing_on_the_host(scene_frames, booted, backend,
                                                run_ba):
    _, frames = scene_frames
    vo, states = booted[backend]
    frame = 3 if run_ba else 2
    batch = stack_states([at_frame(st, frame) for st in states[:2]])
    assert vo.ba_due(batch) == run_ba
    images = torch.stack([tt(slot_frame(frames, s, STRIDE + 1))
                          for s in range(2)])
    draws = torch.stack([vo.step_draws(torch.Generator().manual_seed(s))
                         for s in range(2)])
    eager = vo._step_batch_impl(batch, images, draws, run_ba)
    torch.set_default_device("meta")
    try:
        with NoHostReads(), no_vmap_fallback():
            out = vo._step_batch_impl(batch, images, draws, run_ba)
    finally:
        torch.set_default_device(None)
    for a, b in zip(out.tensors(), eager.tensors()):
        assert a.device.type == "cpu" and same_bits(a, b)
    assert out.frame_idx.tolist() == [frame + 1] * 2


# ---------------------------------------------------------------------------
# The batched step against jax.vmap(_step_impl)
# ---------------------------------------------------------------------------

class JaxTableBank:
    """The reference's PnP draws for a step's key, as a sampler with a draw
    and a select: ``draw(key, n, k)`` gives the reference's index draws
    ``randint(key, (n, k), 0, max(m, 1))`` for every count m = 0..K of
    valid rows, and ``select`` maps the row of the actual count onto the
    valid rows as the reference's ``sample_minimal_sets`` does, on the
    device, so the batched step takes the reference's banks."""

    def __init__(self, K):
        self.K = K

    def __call__(self, generator, valid, n, k):
        raise AssertionError("the port starts from the reference's states")

    def draw(self, key, n, k):
        table = jax.vmap(lambda m: jax.random.randint(key, (n, k), 0, m))(
            jnp.maximum(jnp.arange(self.K + 1), 1))
        return torch.from_numpy(np.asarray(table)).to(torch.int64)

    @staticmethod
    def select(table, valid):
        k = table.shape[-1]
        order = torch.argsort((~valid).to(torch.int32), stable=True)
        n_valid = valid.sum()
        r = table.index_select(0, n_valid.view(1))[0]
        eq = (r[:, :, None] == r[:, None, :]) & ~torch.eye(k, dtype=torch.bool)
        return order[r], ~eq.flatten(1).any(1) & (n_valid >= k)


def test_table_bank_is_the_reference_draw():
    from monocular_visual_odometry_va4mr_tpu.ops import ransac as jransac

    key = jax.random.PRNGKey(3)
    valid = np.random.default_rng(0).uniform(size=40) < 0.4
    idx, ok = jransac.sample_minimal_sets(key, jnp.asarray(valid), 50, 3)
    bank = JaxTableBank(40)
    tidx, tok = bank.select(bank.draw(key, 50, 3), tt(valid))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ok))


def test_batched_step_matches_the_reference_jax_vmap(scene_frames):
    scene, frames = scene_frames
    key = jax.random.PRNGKey(0)
    jvo = JVO(JCamera.from_matrix(scene.K), small_config(kitti_tuned_config))
    S = 2
    with pytest.MonkeyPatch.context() as mp:
        for mod, name in ((jk2, "track_features_pallas2"),
                          (jv1, "track_features_pallas"),
                          (jk2, "track_multilevel")):
            mp.setattr(mod, name, functools.partial(getattr(mod, name),
                                                    interpret=True))
        boots = [jvo.bootstrap(slot_frame(frames, s, 0),
                               slot_frame(frames, s, STRIDE),
                               jax.random.fold_in(key, s),
                               intermediate=[slot_frame(frames, s, k)
                                             for k in range(1, STRIDE)])
                 for s in range(S)]
        # From frame index 2: the steps make frames 3 (skip) and 4 (BA).
        boots = [b.replace(frame_idx=jnp.int32(2)) for b in boots]
        jstep = jax.jit(jax.vmap(jvo._step_impl))
        jstate = jax.tree.map(lambda *xs: jnp.stack(xs), *boots)
        keys = [[jax.random.fold_in(key, 100 * (k + 1) + s) for s in range(S)]
                for k in range(2)]
        j_steps = []
        for k in range(2):
            imgs = jnp.stack([jnp.asarray(slot_frame(frames, s, STRIDE + 1 + k),
                                          jnp.float32) for s in range(S)])
            jstate = jstep(jstate, imgs, jnp.stack(keys[k]))
            j_steps.append(jax_state_dict(jstate))

    bank = JaxTableBank(128)
    tvo = VisualOdometry(Camera.from_matrix(scene.K),
                         small_config(t_kitti_tuned_config), "cpu",
                         sampler=bank)
    batch = stack_states([FrameState.from_numpy(jax_state_dict(b))
                          for b in boots])
    assert batch.host_frame == 2
    with no_vmap_fallback():
        for k in range(2):
            batch = tvo.step_batch(
                batch, [slot_frame(frames, s, STRIDE + 1 + k)
                        for s in range(S)],
                [jax.random.split(kk)[0] for kk in keys[k]])
            t = batch.to_numpy()
            for s in range(S):
                j = {n: (tuple(p[s] for p in v) if n == "prev_pyramid"
                         else v[s]) for n, v in j_steps[k].items()}
                ts = {n: (tuple(p[s] for p in v) if n == "prev_pyramid"
                          else v[s]) for n, v in t.items()}
                assert int(ts["frame_idx"]) == int(j["frame_idx"]) == 3 + k
                assert int(j["status"]) == 0
                assert_states_agree(j, ts)
                both = j["lm_valid"] & ts["lm_valid"]
                np.testing.assert_allclose(
                    ts["lm_xyz"][both], j["lm_xyz"][both], rtol=0,
                    atol=LM_TOL if same_tracks(j, ts) else LM_TOL_TRACK_DIFF)
    assert tvo.ba_runs == 1
