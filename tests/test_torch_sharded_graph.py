"""What lets the sharded BAs replay a CUDA graph an iteration on the card:
``parallel/ba_sharded.py::run_ba_sharded`` and
``parallel/traj_ba.py::run_traj_ba`` as ``core.graphs.scan`` of their
Gauss-Newton iteration (``gn_iteration``, the counterpart of the
reference's ``lax.scan`` body inside its ``shard_map``), the collectives
inside.

* Each iteration reads nothing on the host and makes no tensor from host
  data (``tests/test_torch_step_graph.py``'s ``NoHostReads``, the default
  device ``meta``), its collectives included, in a one-rank gloo world.
* On that world the scan form is bit for bit the loop as it stood before
  it (``loop_ba_sharded`` and ``loop_traj_ba``, copies kept here) and sends
  the same collectives; ``tests/test_torch_parallel.py`` holds the same on
  gloo worlds of 2 and 4 (its workers run these copies beside the scan
  form).
* The graph's key separates what changes the graph: the camera, Huber
  threshold, damping, ``n_fixed``, rank 0 or not, the process group.

Shapes: ``tests/test_torch_parallel.py``'s well-posed window (W = 8,
L = 256) and its 12-iteration trajectory problem cut to one rank.
Tolerance: bit-equal everywhere (the same float32 operations in the same
order).
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from monocular_visual_odometry_va4mr_torch.backend import ba
from monocular_visual_odometry_va4mr_torch.core import graphs
from monocular_visual_odometry_va4mr_torch.core.camera import Camera
from monocular_visual_odometry_va4mr_torch.parallel import (ba_sharded,
                                                            multihost,
                                                            traj_ba)

K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1]], np.float32)


def loop_ba_sharded(window_local, cam, *, group=None, iters=5, huber_px=3.0,
                    damping=1e-4, n_fixed=2):
    """``run_ba_sharded`` as it stood before its scan: a Python loop."""
    rank = dist.get_rank(group)
    W = window_local.T_CW.shape[0]
    window = window_local
    costs = []
    for _ in range(iters):
        S, rhs, Hpp_inv, Hcp, b_p, cost = ba.build_normal_blocks(
            window, cam, huber_px=huber_px, damping=damping,
            camera_damping=damping if rank == 0 else 0.0)
        packed = multihost.all_reduce(
            torch.cat([S.reshape(-1), rhs.reshape(-1), cost.reshape(1)]),
            group)
        S = packed[:36 * W * W].reshape(W, W, 6, 6)
        rhs = packed[36 * W * W:-1].reshape(W, 6)
        delta_c = ba.solve_camera_system(S, rhs, n_fixed=n_fixed)
        window = ba.apply_updates(window, delta_c, Hpp_inv, Hcp, b_p)
        costs.append(packed[-1])
    return window, torch.stack(costs)


def loop_traj_ba(seg_local, cam, *, group=None, iters=8, huber_px=3.0,
                 damping=1e-2):
    """``run_traj_ba`` as it stood before its scan: a Python loop."""
    T_local, lm_local = seg_local.T_CW, seg_local.lm_xyz
    obs_uv, obs_mask = seg_local.obs_uv[0], seg_local.obs_mask[0]
    halo = torch.empty_like(seg_local.anchor_T_CW)
    costs = []
    for _ in range(iters):
        got = multihost.shift_right(T_local[-2:], halo, group)
        window = ba.BAWindow(
            T_CW=torch.cat([halo if got else seg_local.anchor_T_CW, T_local]),
            lm_xyz=lm_local, obs_uv=obs_uv, obs_mask=obs_mask)
        S_blk, rhs, Hpp_inv, Hcp, b_p, cost = ba.build_normal_blocks(
            window, cam, huber_px=huber_px, damping=damping)
        delta_c = ba.solve_camera_system(S_blk, rhs, n_fixed=2)
        new_window = ba.apply_updates(window, delta_c, Hpp_inv, Hcp, b_p)
        T_local, lm_local = new_window.T_CW[2:], new_window.lm_xyz
        costs.append(multihost.all_reduce(cost.reshape(1), group)[0])
    return (seg_local._replace(T_CW=T_local, lm_xyz=lm_local),
            torch.stack(costs))


def ba_window():
    from test_torch_parallel import ba_problem, torch_window

    return torch_window(ba_problem())


def traj_segment():
    from test_torch_parallel import TRAJ_12

    noisy, _, cam = traj_ba.build_synthetic_traj(1, **TRAJ_12)
    return traj_ba.shard_segments(noisy, 0, 1), cam


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A one-rank gloo world in this process."""
    store = tmp_path_factory.mktemp("gloo") / "store"
    multihost.initialize(f"file://{store}", 1, 0)
    assert dist.get_backend() == "gloo"
    yield
    dist.destroy_process_group()


def on_meta(fn, *args):
    from test_torch_step_graph import NoHostReads

    torch.set_default_device("meta")
    try:
        with NoHostReads():
            return fn(*args)
    finally:
        torch.set_default_device(None)


def iteration_inputs(name):
    """(the iteration, its arguments) of one GN iteration of each
    function on this rank."""
    if name == "ba_sharded":
        w = ba_window()
        body = ba_sharded.gn_iteration
        return body, (Camera.from_matrix(K), 3.0, 1e-4, 2, True, None, *w)
    seg, cam = traj_segment()
    return traj_ba.gn_iteration, (cam, 3.0, 1e-2, None, seg.T_CW, seg.lm_xyz,
                                  seg.anchor_T_CW, seg.obs_uv[0],
                                  seg.obs_mask[0])


def flat(out):
    (a, b), (c,) = out
    return a, b, c


@pytest.mark.parametrize("name", ["ba_sharded", "traj_ba"])
def test_iteration_reads_nothing_on_the_host(one_rank, name):
    body, args = iteration_inputs(name)
    multihost.COMM.clear()
    meta = on_meta(body, *args)
    comm = dict(multihost.COMM)
    multihost.COMM.clear()
    eager = body(*args)
    assert comm == dict(multihost.COMM) and len(comm) == 1
    for a, b in zip(flat(meta), flat(eager)):
        assert a.device.type == "cpu" and torch.equal(a, b)


def test_ba_sharded_scan_is_the_loop_on_one_rank(one_rank):
    cam = Camera.from_matrix(K)
    for kw in (dict(iters=4), dict(iters=3, huber_px=2.0, damping=1e-3,
                                   n_fixed=1)):
        multihost.COMM.clear()
        out, costs = ba_sharded.run_ba_sharded(ba_window(), cam, **kw)
        comm = dict(multihost.COMM)
        multihost.COMM.clear()
        ref, ref_costs = loop_ba_sharded(ba_window(), cam, **kw)
        assert comm == dict(multihost.COMM) == {
            ("all_reduce", 4 * (36 * 64 + 48 + 1)): kw["iters"]}
        for a, b in zip((out.T_CW, out.lm_xyz, costs),
                        (ref.T_CW, ref.lm_xyz, ref_costs)):
            assert torch.equal(a, b)
        assert torch.equal(out.obs_uv, ref.obs_uv)


def test_traj_ba_scan_is_the_loop_on_one_rank(one_rank):
    seg, cam = traj_segment()
    multihost.COMM.clear()
    out, costs = traj_ba.run_traj_ba(seg, cam, iters=5)
    comm = dict(multihost.COMM)
    multihost.COMM.clear()
    ref, ref_costs = loop_traj_ba(seg, cam, iters=5)
    assert comm == dict(multihost.COMM) == {("all_reduce", 4): 5}
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert torch.equal(costs, ref_costs)


def test_keys_separate_what_changes_the_graph(one_rank, monkeypatch):
    keys = []

    def recorded(key, *args):
        keys.append(key)
        return scan(key, *args)

    scan = graphs.scan
    monkeypatch.setattr(graphs, "scan", recorded)
    cam = Camera.from_matrix(K)
    w = ba_window()
    for kw in (dict(), dict(huber_px=2.0), dict(damping=1e-3),
               dict(n_fixed=1), dict(iters=2)):
        ba_sharded.run_ba_sharded(w, cam, **kw)
    ba_sharded.run_ba_sharded(w, cam._replace(fx=cam.fx + 1))
    seg, tcam = traj_segment()
    for kw in (dict(), dict(damping=1e-3), dict(huber_px=2.0),
               dict(iters=2)):
        traj_ba.run_traj_ba(seg, tcam, **kw)
    assert len(set(keys[:6])) == 5 and keys[0] == keys[4]  # iters: no
    assert len(set(keys[6:])) == 3 and keys[6] == keys[9]
    # Rank 0 of the default group: the damping on S, no halo received.
    assert keys[0][5] is True and keys[0][6] is dist.group.WORLD
    assert keys[6][4] == 0 and keys[6][5] is dist.group.WORLD
