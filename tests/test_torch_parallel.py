"""The port's ``parallel/`` over ``torch.distributed`` against the port's
single-device functions and the JAX package.

Multi-rank runs spawn gloo worlds of 2 and 4 processes on the CPU (once per
world for the whole file, module-level workers that import no jax), joined
through a ``file://`` store under ``tmp_path`` so concurrent test processes
never share a port.  Each rank writes its results; the tests read them.

Tolerances:
  * ``run_ba_sharded`` vs ``run_ba``: the same float32 sums split over
    ranks, poses within 1e-5 and landmarks within 1e-4; vs the JAX
    ``run_ba_sharded`` on 8 CPU devices, ``tests/test_ba.py``'s (costs 1e-2
    relative, poses 5e-4, landmarks 0.1);
  * ``run_traj_ba``: one iteration equals per-segment ``run_ba`` within
    2e-4 (``tests/test_parallel.py``), ``build_synthetic_traj`` equals the
    JAX arrays within 1e-6 (float32 rounding of one matmul);
  * ``refine(mesh=)`` vs ``refine()``: 1e-4;
  * lockstep ``multi_seq`` vs solo runs: exact.
"""
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from monocular_visual_odometry_va4mr_torch.backend import ba as tba
from monocular_visual_odometry_va4mr_torch.core.camera import Camera
from monocular_visual_odometry_va4mr_torch.parallel import (ba_sharded,
                                                            multihost,
                                                            traj_ba)

# One thread, as the workers: the single-device references round as they
# do whichever other test files share the process.
torch.set_num_threads(1)

K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1]], np.float32)
BA_W = 8
BA_ITERS = 4
PAYLOAD_LMS = (128, 256)
TRAJ_1 = dict(S=4, L=64, seed=5)  # one iteration, damping 1e-4
TRAJ_12 = dict(S=6, L=96, seed=3)  # 12 iterations, D = 4


def make_ba_problem(rng, W=BA_W, L=256, noise_px=0.3, pose_err=0.02,
                    lm_err=0.15, depth=(10, 40), width=8.0):
    """A forward-moving window with ground truth, then perturbed: numpy
    (T_init (W,4,4), X_init (L,3), obs (W,L,2), mask (W,L))."""
    from scipy.spatial.transform import Rotation

    X = np.stack([rng.uniform(-width, width, L), rng.uniform(-3, 3, L),
                  rng.uniform(*depth, L)], axis=1)
    T_gt = np.zeros((W, 4, 4))
    for i in range(W):
        T = np.eye(4)
        T[:3, :3] = Rotation.from_rotvec([0.0, np.radians(0.8 * i),
                                          0.0]).as_matrix()
        T[:3, 3] = -T[:3, :3] @ np.array([0.12 * i, 0.0, 0.4 * i])
        T_gt[i] = T
    obs = np.zeros((W, L, 2), np.float32)
    mask = np.zeros((W, L), bool)
    for i in range(W):
        Xc = X @ T_gt[i][:3, :3].T + T_gt[i][:3, 3]
        z = Xc[:, 2]
        u = K[0, 0] * Xc[:, 0] / z + K[0, 2]
        v = K[1, 1] * Xc[:, 1] / z + K[1, 2]
        mask[i] = (z > 1) & (u > 0) & (u < 640) & (v > 0) & (v < 480)
        obs[i, :, 0] = u + rng.normal(0, noise_px, L)
        obs[i, :, 1] = v + rng.normal(0, noise_px, L)
    T_init = T_gt.copy()
    for i in range(2, W):
        d = rng.normal(0, pose_err, 6)
        dT = np.eye(4)
        dT[:3, :3] = Rotation.from_rotvec(d[3:]).as_matrix()
        dT[:3, 3] = d[:3]
        T_init[i] = dT @ T_gt[i]
    X_init = X + rng.normal(0, lm_err, X.shape)
    return (T_init.astype(np.float32), X_init.astype(np.float32), obs, mask)


def torch_window(problem):
    return tba.BAWindow(*(torch.from_numpy(a) for a in problem))


# Landmarks 6-16 m ahead within the view of every frame: a window whose
# landmarks are all well determined, so the 1e-4 landmark comparison reads
# the split of the sums over ranks, not the conditioning of far points.
WELL_POSED = dict(depth=(6, 16), width=3.0)


def ba_problem(L=256):
    return make_ba_problem(np.random.default_rng(0), L=L, **WELL_POSED)


def refine_inputs():
    """A FrameState and a BA ring over the BA problem's window; the ring
    has one stale slot generation and landmarks seen too rarely."""
    from monocular_visual_odometry_va4mr_torch.core.config import (
        CapacityConfig, PipelineConfig)
    from monocular_visual_odometry_va4mr_torch.core.state import init_state
    from monocular_visual_odometry_va4mr_torch.pipeline.ba_refine import (
        BARing)

    T, X, obs, mask = make_ba_problem(np.random.default_rng(1), W=6, L=100,
                                      **WELL_POSED)
    L = X.shape[0]
    cfg = PipelineConfig(capacity=CapacityConfig(L, 8), image_shape=(32, 32))
    state = init_state(cfg, (torch.zeros(32, 32),))
    gen = np.zeros((6, L), np.int32)
    gen[:2, :5] = 7  # slots 0..4 were re-allocated after frame 1
    mask[:, 90:] &= np.arange(6)[:, None] < 2  # seen twice only
    state = state.replace(T_CW=torch.from_numpy(T[-1]),
                          lm_xyz=torch.from_numpy(X),
                          lm_valid=torch.from_numpy(np.arange(L) != 50),
                          lm_gen=torch.zeros(L, dtype=torch.int32))
    ring = BARing(window=6, poses=list(T), obs_uv=list(obs),
                  obs_mask=list(mask), obs_gen=list(gen))
    return state, ring


def _worker(rank, world, store, out_dir):
    """One rank of a gloo world: every sharded function the tests read."""
    import copy

    from monocular_visual_odometry_va4mr_torch.pipeline import ba_refine
    from test_torch_sharded_graph import loop_ba_sharded, loop_traj_ba

    torch.set_num_threads(1)
    multihost.initialize(f"file://{store}", world, rank)
    cam = Camera.from_matrix(K)
    res = {}

    def comm_of(fn):
        multihost.COMM.clear()
        out = fn()
        return out, dict(multihost.COMM)

    (w, costs), comm = comm_of(lambda: ba_sharded.run_ba_sharded(
        ba_sharded.shard_window(torch_window(ba_problem()), rank, world),
        cam, iters=BA_ITERS))
    res["ba"] = dict(T_CW=w.T_CW, lm_xyz=w.lm_xyz, costs=costs, comm=comm)
    # The loops as they stood before their scans, on the same inputs.
    (w, costs), comm = comm_of(lambda: loop_ba_sharded(
        ba_sharded.shard_window(torch_window(ba_problem()), rank, world),
        cam, iters=BA_ITERS))
    res["ba_loop"] = dict(T_CW=w.T_CW, lm_xyz=w.lm_xyz, costs=costs,
                          comm=comm)
    for L in PAYLOAD_LMS:
        _, comm = comm_of(lambda: ba_sharded.run_ba_sharded(
            ba_sharded.shard_window(torch_window(ba_problem(L)), rank, world),
            cam, iters=3))
        res[f"payload_{L}"] = comm

    for name, kw, iters, damping in (("traj_1", TRAJ_1, 1, 1e-4),
                                     ("traj_12", TRAJ_12, 12, 1e-2)):
        noisy, _, tcam = traj_ba.build_synthetic_traj(world, **kw)
        (seg, costs), comm = comm_of(lambda: traj_ba.run_traj_ba(
            traj_ba.shard_segments(noisy, rank, world), tcam, iters=iters,
            damping=damping))
        res[name] = dict(T_CW=seg.T_CW, lm_xyz=seg.lm_xyz, costs=costs,
                         comm=comm)
        (seg, costs), comm = comm_of(lambda: loop_traj_ba(
            traj_ba.shard_segments(noisy, rank, world), tcam, iters=iters,
            damping=damping))
        res[name + "_loop"] = dict(T_CW=seg.T_CW, lm_xyz=seg.lm_xyz,
                                   costs=costs, comm=comm)

    state, ring = refine_inputs()
    mesh = multihost.global_mesh("lm")
    ring_m = copy.deepcopy(ring)
    (st, comm) = comm_of(lambda: ba_refine.refine(state, ring_m, cam,
                                                  mesh=mesh))
    res["refine"] = dict(T_CW=st.T_CW, lm_xyz=st.lm_xyz,
                         ring=np.stack(ring_m.poses), comm=comm)

    res["mesh"] = dict(global_=(mesh.shape, mesh.mesh_dim_names))
    if world == 4:
        grid = multihost.grid_mesh(2, 2)
        res["mesh"]["grid"] = (grid.shape, grid.mesh_dim_names,
                               grid["lm"].size())
    res["backend"] = dist.get_backend()
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{world: [rank results]} for gloo worlds of 2 and 4."""
    out = {}
    for world in (2, 4):
        d = tmp_path_factory.mktemp(f"world{world}")
        mp.spawn(_worker, args=(world, str(d / "pg"), str(d)), nprocs=world)
        out[world] = [torch.load(d / f"rank{r}.pt", weights_only=False)
                      for r in range(world)]
    return out


@pytest.fixture(scope="module")
def ba_reference():
    out, costs = tba.run_ba(torch_window(ba_problem()), Camera.from_matrix(K),
                            iters=BA_ITERS)
    return out, costs


def gathered_lms(ranks, key, L):
    return torch.cat([r[key]["lm_xyz"] for r in ranks])[:L]


@pytest.mark.parametrize("world", [2, 4])
def test_ba_sharded_equals_run_ba(worlds, ba_reference, world):
    ref, ref_costs = ba_reference
    ranks = worlds[world]
    for r in ranks:  # every rank holds the same poses and costs
        torch.testing.assert_close(r["ba"]["T_CW"], ranks[0]["ba"]["T_CW"],
                                   rtol=0, atol=0)
        torch.testing.assert_close(r["ba"]["costs"], ranks[0]["ba"]["costs"],
                                   rtol=0, atol=0)
    np.testing.assert_allclose(ranks[0]["ba"]["T_CW"].numpy(),
                               ref.T_CW.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(gathered_lms(ranks, "ba", 256).numpy(),
                               ref.lm_xyz.numpy(), rtol=0, atol=1e-4)
    # The cost after a step reads every residual of the new poses: 1e-3.
    np.testing.assert_allclose(ranks[0]["ba"]["costs"].numpy(),
                               ref_costs.numpy(), rtol=1e-3)


def test_ba_sharded_equals_the_jax_sharded_ba(worlds):
    import jax.numpy as jnp

    from monocular_visual_odometry_va4mr_tpu.backend import ba as jba
    from monocular_visual_odometry_va4mr_tpu.core.camera import Camera as JCam
    from monocular_visual_odometry_va4mr_tpu.parallel import ba_sharded as jbs
    from monocular_visual_odometry_va4mr_tpu.parallel.seq_dp import make_mesh

    window = jba.BAWindow(*(jnp.asarray(a) for a in ba_problem()))
    mesh = make_mesh(8, "lm")
    out, costs = jbs.run_ba_sharded(jbs.shard_window(window, mesh, "lm"),
                                    JCam.from_matrix(K), mesh=mesh, axis="lm",
                                    iters=BA_ITERS)
    for world in (2, 4):
        ranks = worlds[world]
        np.testing.assert_allclose(ranks[0]["ba"]["costs"].numpy(),
                                   np.asarray(costs), rtol=1e-2)
        np.testing.assert_allclose(ranks[0]["ba"]["T_CW"].numpy(),
                                   np.asarray(out.T_CW), atol=5e-4)
        np.testing.assert_allclose(gathered_lms(ranks, "ba", 256).numpy(),
                                   np.asarray(out.lm_xyz), atol=0.1)


@pytest.mark.parametrize("world", [2, 4])
def test_ba_sharded_payload_is_the_camera_system(worlds, world):
    """One all-reduce a Gauss-Newton iteration of 4 (36 W^2 + 6 W + 1)
    bytes (9412 at W = 8) whatever the landmark count, and nothing else."""
    payload = 4 * (36 * BA_W ** 2 + 6 * BA_W + 1)
    assert payload == 9412
    for r in worlds[world]:
        for L in PAYLOAD_LMS:
            assert r[f"payload_{L}"] == {("all_reduce", payload): 3}
        assert r["ba"]["comm"] == {("all_reduce", payload): BA_ITERS}


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_scans_are_the_loops_they_replace(worlds, world):
    """``run_ba_sharded`` and ``run_traj_ba`` as ``core.graphs.scan`` of
    their iteration (op by op on gloo) are bit for bit the loops as they
    stood (``tests/test_torch_sharded_graph.py``) on every rank, with the
    same collectives."""
    for r in worlds[world]:
        for name in ("ba", "traj_1", "traj_12"):
            new, old = r[name], r[name + "_loop"]
            for key in ("T_CW", "lm_xyz", "costs"):
                assert torch.equal(new[key], old[key]), (name, key)
            assert new["comm"] == old["comm"]


def test_shard_window_pads_the_last_block():
    window = torch_window(make_ba_problem(np.random.default_rng(2), L=10))
    blocks = [ba_sharded.shard_window(window, r, 4) for r in range(4)]
    assert [b.lm_xyz.shape[0] for b in blocks] == [3, 3, 3, 3]
    torch.testing.assert_close(torch.cat([b.lm_xyz for b in blocks])[:10],
                               window.lm_xyz)
    assert not blocks[3].obs_mask[:, 1:].any()
    assert torch.equal(blocks[3].lm_xyz[1:], torch.zeros(2, 3))


def test_build_synthetic_traj_equals_jax():
    from monocular_visual_odometry_va4mr_tpu.parallel import traj_ba as jtraj

    for D, kw in ((2, TRAJ_1), (4, TRAJ_12)):
        ours = traj_ba.build_synthetic_traj(D, **kw)
        ref = jtraj.build_synthetic_traj(D, **kw)
        for a, b in zip(ours[:2], ref[:2]):
            for x, y in zip(a, b):
                np.testing.assert_allclose(x.numpy(), np.asarray(y),
                                           rtol=0, atol=1e-6)
        assert tuple(ours[2]) == tuple(ref[2])


def test_traj_ba_one_iteration_equals_segment_ba(worlds):
    D, S, L = 2, TRAJ_1["S"], TRAJ_1["L"]
    noisy, _, cam = traj_ba.build_synthetic_traj(D, **TRAJ_1)
    got = torch.cat([r["traj_1"]["T_CW"] for r in worlds[D]])
    ref = []
    for d in range(D):
        halo = noisy.anchor_T_CW if d == 0 else noisy.T_CW[d * S - 2:d * S]
        win = tba.BAWindow(torch.cat([halo, noisy.T_CW[d * S:(d + 1) * S]]),
                           noisy.lm_xyz[d * L:(d + 1) * L], noisy.obs_uv[d],
                           noisy.obs_mask[d])
        out, _ = tba.run_ba(win, cam, iters=1, n_fixed=2)
        ref.append(out.T_CW[2:])
    np.testing.assert_allclose(got.numpy(), torch.cat(ref).numpy(),
                               rtol=0, atol=2e-4)


def test_traj_ba_converges_to_ground_truth(worlds):
    ranks = worlds[4]
    noisy, gt, _ = traj_ba.build_synthetic_traj(4, **TRAJ_12)
    costs = ranks[0]["traj_12"]["costs"].numpy()
    for r in ranks:
        np.testing.assert_array_equal(r["traj_12"]["costs"].numpy(), costs)
    assert costs[-1] < 0.05 * costs[0], costs
    T = torch.cat([r["traj_12"]["T_CW"] for r in ranks]).numpy()
    t_err = np.linalg.norm(T[:, :3, 3] - gt.T_CW[:, :3, 3].numpy(), axis=1)
    t0_err = np.linalg.norm((noisy.T_CW - gt.T_CW)[:, :3, 3].numpy(), axis=1)
    assert np.median(t_err) < 0.25 * np.median(t0_err)


@pytest.mark.parametrize("world", [2, 4])
def test_traj_ba_halo_is_one_send_recv_and_a_cost(worlds, world):
    for rank, r in enumerate(worlds[world]):
        per_iter = [("all_reduce", 4)]
        if rank + 1 < world:
            per_iter.append(("send", 128))
        if rank > 0:
            per_iter.append(("recv", 128))
        assert r["traj_12"]["comm"] == {k: 12 for k in per_iter}
        assert r["traj_1"]["comm"] == {k: 1 for k in per_iter}


@pytest.mark.parametrize("world", [2, 4])
def test_refine_on_a_mesh_equals_refine(worlds, world):
    from monocular_visual_odometry_va4mr_torch.pipeline import ba_refine

    state, ring = refine_inputs()
    ref = ba_refine.refine(state, ring, Camera.from_matrix(K))
    for r in worlds[world]:
        np.testing.assert_allclose(r["refine"]["T_CW"].numpy(),
                                   ref.T_CW.numpy(), rtol=0, atol=1e-4)
        np.testing.assert_allclose(r["refine"]["lm_xyz"].numpy(),
                                   ref.lm_xyz.numpy(), rtol=0, atol=1e-4)
        np.testing.assert_allclose(r["refine"]["ring"], np.stack(ring.poses),
                                   rtol=0, atol=1e-4)
        kinds = {k: n for (k, _), n in r["refine"]["comm"].items()}
        assert kinds == {"all_reduce": 4, "all_gather": 1}
    # Landmarks that did not take part pass through unchanged.
    assert torch.equal(ref.lm_xyz[90:], state.lm_xyz[90:])


def test_multihost_initialize_is_a_noop_alone():
    multihost.initialize()
    multihost.initialize(num_processes=1)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialize"):
        multihost.global_mesh()


@pytest.mark.parametrize("world", [2, 4])
def test_multihost_meshes(worlds, world):
    for r in worlds[world]:
        assert r["backend"] == "gloo"
        assert r["mesh"]["global_"] == ((world,), ("lm",))
        if world == 4:
            assert r["mesh"]["grid"] == ((2, 2), ("data", "lm"), 2)


# --- sequence data parallelism -----------------------------------------------

def small_config(shape):
    from monocular_visual_odometry_va4mr_torch.core.config import (
        CapacityConfig, DetectorConfig, EssentialConfig, KLTConfig,
        LandmarkConfig, PipelineConfig, PnPConfig)

    return PipelineConfig(
        landmarks=LandmarkConfig(min_dist=0.5, max_dist=120.0,
                                 min_baseline_angle_deg=1.0,
                                 min_baseline_frames=2),
        detector=DetectorConfig(max_corners=512, quality_level=0.05,
                                min_dist=8.0),
        klt=KLTConfig(window=11, max_level=3, num_iters=15, eps=0.01),
        pnp=PnPConfig(iterations=200, reproj_err_px=4.0),
        essential=EssentialConfig(iterations=300, threshold_px=1.0),
        capacity=CapacityConfig(max_landmarks=512, max_candidates=512),
        image_shape=shape, bootstrap_method="klt")


def test_multi_seq_lockstep_equals_solo_runs():
    from monocular_visual_odometry_va4mr_torch.dataio import synthetic
    from monocular_visual_odometry_va4mr_torch.parallel import multi_seq
    from monocular_visual_odometry_va4mr_torch.pipeline import runner
    from monocular_visual_odometry_va4mr_torch.pipeline.vo import (
        VisualOdometry)

    scenes = [synthetic.make_corridor_scene(seed=s, num_frames=10,
                                            num_points=2000,
                                            image_shape=(160, 224), step=0.5)
              for s in (1, 2)]
    vo = VisualOdometry(Camera.from_matrix(scenes[0].K),
                        small_config((160, 224)), "cpu")
    seqs = [[synthetic.render_frame(sc, i) for i in range(10)]
            for sc in scenes]
    seqs[1] = seqs[1][:9]  # padded by repeating its last frame
    res = multi_seq.run_sequences_dp(vo, seqs, n_devices=3,
                                     bootstrap_stride=2, seed=5)
    assert res.positions.shape == (2, 7, 3)
    assert (res.status == 0).all()
    for s, seq in enumerate(seqs):
        seq = seq + [seq[-1]] * (10 - len(seq))
        solo = runner.run_sequence(
            vo, enumerate(seq), seed=multi_seq.sequence_seed(5, s),
            bootstrap_stride=2, recover=False)
        # solo.records[0] is the bootstrap (frame 2); lockstep starts at 3.
        np.testing.assert_array_equal(res.positions[s], solo.positions[1:])
        assert res.status[s].tolist() == [r.status for r in solo.records[1:]]
        assert res.n_inliers[s].tolist() == [r.n_inliers
                                             for r in solo.records[1:]]


def test_sequence_seeds_never_shared_between_runs():
    from monocular_visual_odometry_va4mr_torch.parallel import multi_seq

    seeds = [multi_seq.sequence_seed(seed, s)
             for seed in range(2000) for s in range(16)]
    assert len(set(seeds)) == len(seeds)
    assert all(0 <= sd < 2 ** 31 for sd in seeds)
    assert [multi_seq.sequence_seed(0, s) for s in range(4)] == [0, 1, 2, 3]
    assert multi_seq.sequence_seed(0, 1) != multi_seq.sequence_seed(1, 0)


def test_seq_dp_mesh_and_dryrun():
    from monocular_visual_odometry_va4mr_torch.parallel import seq_dp
    from monocular_visual_odometry_va4mr_torch.pipeline.vo import (
        VisualOdometry)

    mesh = seq_dp.make_mesh(3, devices=["cpu", "meta"])
    assert [d.type for d in mesh.devices] == ["cpu", "meta", "cpu"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            seq_dp.make_mesh(2)
    vo = VisualOdometry(Camera.from_matrix(K), small_config((64, 96)), "cpu")
    seq_dp.dryrun(vo, 2)
