"""What lets the back end's compiled functions replay as CUDA graphs on the
card (``core/graphs.py``), on the CPU: the pose graphs' Gauss-Newton
iteration (``backend/posegraph.py::gn_iteration``, looped by
``core.graphs.scan`` as the reference's ``lax.scan`` loops its body) and
the runner's windowed BA (``pipeline/ba_refine.py::refine_window``, the
reference's ``jax.jit(run_ba)``).

* One GN iteration of each group (``optimize(iters=1)``, with and without
  the Huber factor) and ``refine_window`` at ``ba_refine``'s shapes read
  nothing on the host and make no tensor from host data: run under
  ``tests/test_torch_step_graph.py``'s ``NoHostReads`` with
  ``aten._linalg_check_errors`` added (``torch.linalg.solve``'s check of
  the factorisation, read on the host) and the default device ``meta``,
  bit for bit their own run without the mode.
* The loop equals the loop as it stood before the iteration became a
  body (``loop_as_before``: ``torch.linalg.solve``, the gauge written
  with host scalars) bit for bit, on both groups, with and without the
  Huber factor, and the JAX package's ``optimize`` within
  ``tests/test_torch_posegraph.py``'s tolerances; ``sim3_log``'s
  ``solve_ex`` equals ``torch.linalg.solve`` bit for bit.
* ``optimize_consistent`` drops the same edges as the JAX function and
  reports its stages; ``ba_refine.refine`` through ``refine_window``
  equals the BA called as before bit for bit.

Sizes: chains of at most 40 nodes; the BA window of the runner's default
ring (8 frames) over 128 landmark slots.
"""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_visual_odometry_va4mr_tpu.backend import posegraph as jpg
from monocular_visual_odometry_va4mr_tpu.backend import posegraph_sim3 as jpg3
from monocular_visual_odometry_va4mr_tpu.core import lie as jlie
from monocular_visual_odometry_va4mr_torch.backend import ba as tba
from monocular_visual_odometry_va4mr_torch.backend import posegraph as tpg
from monocular_visual_odometry_va4mr_torch.backend import (
    posegraph_sim3 as tpg3)
from monocular_visual_odometry_va4mr_torch.core import graphs, lie, linalg
from monocular_visual_odometry_va4mr_torch.core.camera import Camera
from monocular_visual_odometry_va4mr_torch.core.config import (
    CapacityConfig, PipelineConfig)
from monocular_visual_odometry_va4mr_torch.core.state import init_state
from monocular_visual_odometry_va4mr_torch.pipeline import ba_refine
from test_torch_parallel import K, WELL_POSED, make_ba_problem
from test_torch_posegraph import POSE_TOL, chain_with_loops, close
from test_torch_step_graph import HOST_SYNC_OPS, NoHostReads

torch.set_num_threads(1)

BA_W, BA_L = 8, 128  # the runner's default ring over 128 landmark slots


class NoHostChecks(NoHostReads):
    """``NoHostReads`` that also raises on ``torch.linalg``'s check of a
    factorisation's ``info``, which reads it on the host."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func).startswith(HOST_SYNC_OPS
                                + ("aten._linalg_check_errors",)):
            raise AssertionError(f"{func} inside the graphed function")
        return func(*args, **(kwargs or {}))


def on_meta(fn, *args, **kw):
    """``fn(*args, **kw)`` under ``NoHostChecks`` with the default device
    ``meta``."""
    torch.set_default_device("meta")
    try:
        with NoHostChecks():
            return fn(*args, **kw)
    finally:
        torch.set_default_device(None)


def same_bits(a, b):
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def loop_chain(group, n=40, seed=5, loops=((39, 0), (30, 4), (24, 9),
                                           (35, 17))):
    """A drifted circle of ``n`` nodes with loop edges measured from the
    truth, as ``group``'s graph (Sim(3): the odometry drifts in scale
    too)."""
    gen = torch.Generator().manual_seed(seed)
    ang = torch.arange(n) * (2 * np.pi / n)
    xi = torch.zeros(n, 6)
    xi[:, 4] = ang
    T_WC = lie.se3_exp(xi)
    T_WC[:, 0, 3] = 5 * torch.sin(ang)
    T_WC[:, 2, 3] = 5 * (1 - torch.cos(ang))
    gt = lie.invert_se3(T_WC)
    noise = torch.cat([0.03 * torch.randn(n, 3, generator=gen),
                       0.01 * torch.randn(n, 3, generator=gen)], 1)
    drifted = [gt[0]]
    for k in range(1, n):
        rel = gt[k] @ lie.invert_se3(gt[k - 1])
        if group == "sim3":
            rel[:3, 3] *= 1.01 ** k
        drifted.append(lie.se3_exp(noise[k]) @ rel @ drifted[-1])
    nodes = torch.stack(drifted)
    if group == "se3":
        g = tpg.odometry_edges(nodes)
        for i, j in loops:
            g = tpg.add_edge(g, i, j, gt[j] @ lie.invert_se3(gt[i]),
                             weight=3.0)
        return g
    g = tpg3.from_se3_chain(nodes)
    for i, j in loops:
        rel = gt[j] @ lie.invert_se3(gt[i])
        g = tpg3.add_loop_edge(g, i, j, rel[:3, :3], rel[:3, 3], 1.0,
                               weight=3.0)
    return g


GROUPS = {"se3": (tpg._edge_residual, lie.se3_exp, 6, tpg.optimize),
          "sim3": (tpg3._edge_residual, lie.sim3_exp, 7, tpg3.optimize)}


def loop_as_before(graph, residual, exp, dof, *, iters, damping,
                   robust_delta):
    """The Gauss-Newton loop as it stood before its iteration became a
    body: a Python loop, ``torch.linalg.solve``, the gauge written with
    host scalars."""
    nodes, ii, jj, meas, weight = graph
    N = nodes.shape[0]
    dev, dt = nodes.device, nodes.dtype
    delta_rb = 1e30 if robust_delta is None else float(robust_delta)
    z = torch.zeros((ii.shape[0], dof), dtype=dt, device=dev)
    eye = torch.eye(dof, dtype=dt, device=dev)
    costs = []
    for _ in range(iters):
        Ti, Tj = nodes[ii], nodes[jj]
        r = residual(z, z, Ti, Tj, meas)
        Ji, Jj = tpg.edge_jacobians(residual, dof, Ti, Tj, meas)
        w_r = torch.clamp(delta_rb / torch.clamp(
            torch.linalg.vector_norm(r, dim=-1), min=1e-12), max=1.0)
        sw = torch.sqrt(weight * w_r)
        r = r * sw[:, None]
        Ji = Ji * sw[:, None, None]
        Jj = Jj * sw[:, None, None]
        Hb = torch.zeros((N, N, dof, dof), dtype=dt, device=dev)
        HtH_ij = torch.einsum("eai,eaj->eij", Ji, Jj)
        Hb.index_put_((ii, ii), torch.einsum("eai,eaj->eij", Ji, Ji),
                      accumulate=True)
        Hb.index_put_((jj, jj), torch.einsum("eai,eaj->eij", Jj, Jj),
                      accumulate=True)
        Hb.index_put_((ii, jj), HtH_ij, accumulate=True)
        Hb.index_put_((jj, ii), HtH_ij.transpose(-1, -2), accumulate=True)
        g = torch.zeros((N, dof), dtype=dt, device=dev)
        g.index_put_((ii,), torch.einsum("eai,ea->ei", Ji, r),
                     accumulate=True)
        g.index_put_((jj,), torch.einsum("eai,ea->ei", Jj, r),
                     accumulate=True)
        Hb[0] = 0.0
        Hb[:, 0] = 0.0
        Hb[0, 0] = eye
        g[0] = 0.0
        Hm = Hb.permute(0, 2, 1, 3).reshape(N * dof, N * dof)
        Hm = Hm + damping * torch.eye(N * dof, dtype=dt, device=dev)
        delta = torch.linalg.solve(Hm, -g.reshape(-1)).reshape(N, dof)
        nodes = exp(delta) @ nodes
        costs.append(0.5 * torch.sum(r * r))
    return nodes, torch.stack(costs)


@pytest.mark.parametrize("robust_delta", [None, 0.5], ids=["plain", "huber"])
@pytest.mark.parametrize("group", ["se3", "sim3"])
def test_gn_iteration_reads_nothing_on_the_host(group, robust_delta):
    graph = loop_chain(group)
    optimize = GROUPS[group][3]
    eager = optimize(graph, iters=1, damping=1e-4, robust_delta=robust_delta)
    meta = on_meta(optimize, graph, iters=1, damping=1e-4,
                   robust_delta=robust_delta)
    for a, b in ((meta[0][0], eager[0][0]), (meta[1], eager[1])):
        assert a.device.type == "cpu" and same_bits(a, b)


def refine_inputs(seed=1):
    """A state and a full BA ring at ``ba_refine``'s shapes: the runner's
    default window over ``BA_L`` slots, one stale slot generation, a few
    landmarks seen too rarely and one invalid slot."""
    T, X, obs, mask = make_ba_problem(np.random.default_rng(seed), W=BA_W,
                                      L=BA_L, **WELL_POSED)
    cfg = PipelineConfig(capacity=CapacityConfig(BA_L, 8),
                         image_shape=(32, 32))
    state = init_state(cfg, (torch.zeros(32, 32),))
    gen = np.zeros((BA_W, BA_L), np.int32)
    gen[:2, :5] = 7  # slots 0..4 were re-allocated after frame 1
    mask[:, 120:] &= np.arange(BA_W)[:, None] < 2  # seen twice only
    state = state.replace(T_CW=torch.from_numpy(T[-1]),
                          lm_xyz=torch.from_numpy(X),
                          lm_valid=torch.from_numpy(np.arange(BA_L) != 50),
                          lm_gen=torch.zeros(BA_L, dtype=torch.int32))
    ring = ba_refine.BARing(window=BA_W, poses=list(T), obs_uv=list(obs),
                            obs_mask=list(mask), obs_gen=list(gen))
    return state, ring


def test_refine_window_reads_nothing_on_the_host():
    state, ring = refine_inputs()
    window = tba.BAWindow(
        torch.from_numpy(np.stack(ring.poses)), state.lm_xyz,
        torch.from_numpy(np.stack(ring.obs_uv)),
        torch.from_numpy(np.stack(ring.obs_mask)))
    cam = Camera.from_matrix(K)
    eager = ba_refine.refine_window(window, cam, iters=4, huber_px=3.0)
    meta = on_meta(ba_refine.refine_window, window, cam, iters=4,
                   huber_px=3.0)
    assert torch.isfinite(eager[0]).all()
    for a, b in zip(meta, eager):
        assert a.device.type == "cpu" and same_bits(a, b)


@pytest.mark.parametrize("robust_delta", [None, 0.5], ids=["plain", "huber"])
@pytest.mark.parametrize("group", ["se3", "sim3"])
def test_the_loop_equals_the_loop_as_before(group, robust_delta):
    """``optimize`` (the iteration looped by ``core.graphs.scan``) and the
    iteration called ``iters`` times by hand both equal the loop as it
    stood, bit for bit, nodes and every cost."""
    residual, exp, dof, optimize = GROUPS[group]
    graph = loop_chain(group)
    kw = dict(iters=8, damping=1e-4, robust_delta=robust_delta)
    want = loop_as_before(graph, residual, exp, dof, **kw)
    out, costs = optimize(graph, **kw)
    assert same_bits(out[0], want[0]) and same_bits(costs, want[1])
    assert costs[-1] < 0.5 * costs[0]
    nodes, ii, jj, meas, weight = graph
    by_hand = []
    for _ in range(kw["iters"]):
        (nodes,), (cost,) = tpg.gn_iteration(
            residual, exp, dof, 1e-4,
            1e30 if robust_delta is None else robust_delta,
            nodes, ii, jj, meas, weight)
        by_hand.append(cost)
    assert same_bits(nodes, want[0])
    assert same_bits(torch.stack(by_hand), want[1])


def test_scan_on_the_cpu_is_the_body_looped():
    """``core.graphs.scan`` off a CUDA device: the carry threaded through
    ``iters`` calls of the body, each y stacked, nothing captured."""
    def body(x, step):
        return (x * 2 + step,), (x.sum(), x[0])

    (x,), (sums, firsts) = graphs.scan("test", body, (torch.ones(3),),
                                       (torch.tensor(1.0),), 4)
    assert torch.equal(x, torch.full((3,), 31.0))
    assert torch.equal(sums, torch.tensor([3.0, 9.0, 21.0, 45.0]))
    assert torch.equal(firsts, torch.tensor([1.0, 3.0, 7.0, 15.0]))
    assert graphs.replays("cpu") == 0 and graphs.captures("cpu") == (0, 0.0)


def test_sim3_log_solves_as_torch_linalg_solve():
    """``sim3_log`` solves with ``solve_ex`` (``linalg.solve``): the bits of
    ``torch.linalg.solve`` without its check on the host."""
    gen = torch.Generator().manual_seed(2)
    xi = 0.5 * torch.randn(64, 7, generator=gen)
    W = lie._sim3_W(xi[:, 3:6], xi[:, 6])
    b = torch.randn(64, 3, generator=gen)
    assert same_bits(linalg.solve(W, b), torch.linalg.solve(W, b))
    S = lie.sim3_exp(xi)
    assert torch.allclose(lie.sim3_log(S), xi, atol=1e-4)


@pytest.mark.parametrize("group", ["se3", "sim3"])
def test_optimize_matches_reference(group):
    """``tests/test_torch_posegraph.py``'s parity case through the loop:
    the JAX package's ``optimize`` on the same 20-node chain, poses within
    ``POSE_TOL``, costs within 1e-4 of the first."""
    rng = np.random.default_rng(3)
    nodes, loops = chain_with_loops(rng, group)
    if group == "se3":
        gj = jpg.odometry_edges(jnp.asarray(nodes))
        gt_ = tpg.odometry_edges(torch.from_numpy(nodes))
        for i, j, R, t, _ in loops:
            T = np.eye(4, dtype=np.float32)
            T[:3, :3], T[:3, 3] = R, t
            gj = jpg.add_edge(gj, i, j, jnp.asarray(T), weight=3.0)
            gt_ = tpg.add_edge(gt_, i, j, torch.from_numpy(T), weight=3.0)
        oj, cj = jpg.optimize(gj, iters=15, damping=1e-5, robust_delta=0.5)
        ot, ct = tpg.optimize(gt_, iters=15, damping=1e-5, robust_delta=0.5)
        Tj, Tt = oj.T_CW, ot.T_CW
    else:
        gj = jpg3.from_se3_chain(jnp.asarray(nodes))
        gt_ = tpg3.from_se3_chain(torch.from_numpy(nodes))
        for i, j, R, t, s in loops:
            gj = jpg3.add_loop_edge(gj, i, j, R, t, s, weight=3.0)
            gt_ = tpg3.add_loop_edge(gt_, i, j, R, t, s, weight=3.0)
        oj, cj = jpg3.optimize(gj, iters=15, damping=1e-4, robust_delta=0.5)
        ot, ct = tpg3.optimize(gt_, iters=15, damping=1e-4, robust_delta=0.5)
        Tj, Tt = oj.S_CW, ot.S_CW
    close(cj, ct, 1e-4 * float(cj[0]))
    close(Tj, Tt, POSE_TOL)


def test_optimize_consistent_drops_the_same_edges_and_reports_stages():
    """``tests/test_posegraph_sim3.py``'s adversarial graph (a true loop
    edge and a confidently wrong one): both packages drop the wrong one
    only; the trace holds the suspects and the seconds of the first, the
    leave-one-out and the final solves."""
    from test_posegraph_sim3 import make_scale_drift_loop

    gt, drifted, total_scale = make_scale_drift_loop()
    n = gt.shape[0]
    rel = np.asarray(gt[0] @ jlie.invert_se3(gt[n - 1]))
    bogus = (3, n // 2, np.eye(3, dtype=np.float32),
             np.array([0.1, 0.0, 0.1], np.float32), 2.5)
    edges = [(n - 1, 0, rel[:3, :3], rel[:3, 3] * total_scale,
              1.0 / total_scale), bogus]
    gj = jpg3.from_se3_chain(drifted)
    gt_ = tpg3.from_se3_chain(torch.from_numpy(np.asarray(drifted)))
    for i, j, R, t, s in edges:
        gj = jpg3.add_loop_edge(gj, i, j, R, t, s, weight=3.0)
        gt_ = tpg3.add_loop_edge(gt_, i, j, R, t, s, weight=3.0)
    oj, cj, dj = jpg3.optimize_consistent(gj, n_odo=n - 1, iters=30)
    trace = {}
    ot, ct, dt = tpg3.optimize_consistent(gt_, n_odo=n - 1, iters=30,
                                          trace=trace)
    assert list(dj) == list(dt) == [False, True]
    assert trace["suspects"] >= 1
    assert {"solve_first_s", "solve_loo_s", "solve_final_s"} <= set(trace)
    assert all(trace[k] > 0 for k in ("solve_first_s", "solve_loo_s",
                                      "solve_final_s"))
    close(jpg3.corrected_poses(oj), tpg3.corrected_poses(ot), POSE_TOL)
    # Without a trace: the same solves, the same bits.
    ou, cu, du = tpg3.optimize_consistent(gt_, n_odo=n - 1, iters=30)
    assert same_bits(ou.S_CW, ot.S_CW) and same_bits(cu, ct)


def refine_as_before(state, ring, cam, *, iters=4, huber_px=3.0, min_obs=3):
    """``ba_refine.refine`` as it stood: ``run_ba`` called directly."""
    W = len(ring)
    obs_mask = np.stack(ring.obs_mask)
    obs_mask &= np.stack(ring.obs_gen) == state.lm_gen.numpy()[None, :]
    participate = (obs_mask.sum(0) >= min_obs) & state.lm_valid.numpy()
    window = tba.BAWindow(
        T_CW=torch.from_numpy(np.stack(ring.poses)).to(torch.float32),
        lm_xyz=state.lm_xyz, obs_uv=torch.from_numpy(np.stack(ring.obs_uv)),
        obs_mask=torch.from_numpy(obs_mask & participate[None, :]))
    out, _ = tba.run_ba(window, cam, iters=iters, huber_px=huber_px)
    part = torch.from_numpy(participate)
    lm_xyz = torch.where(part[:, None], out.lm_xyz, state.lm_xyz)
    refined = out.T_CW.numpy()
    for k in range(W):
        ring.poses[k] = refined[k]
    return state.replace(T_CW=out.T_CW[-1], lm_xyz=lm_xyz)


def test_ba_refine_equals_the_ba_called_as_before():
    state, ring = refine_inputs()
    ring_before = copy.deepcopy(ring)
    cam = Camera.from_matrix(K)
    out = ba_refine.refine(state, ring, cam)
    want = refine_as_before(state, ring_before, cam)
    assert same_bits(out.T_CW, want.T_CW)
    assert same_bits(out.lm_xyz, want.lm_xyz)
    assert not torch.equal(out.lm_xyz, state.lm_xyz)
    for a, b in zip(ring.poses, ring_before.poses):
        assert np.array_equal(a, b)
