"""The port's Lie group functions and both pose graphs against the JAX
package's, on the CPU, with the same float32 inputs made from a seed.

Tolerances:
  * Lie functions: values within 1e-5 (float32 arithmetic in another
    order); the edge-residual Jacobians at xi = 0 (``posegraph
    .edge_jacobians``, forward-mode ``torch.func.jvp``) against
    ``jax.jacobian``, within 1e-5;
  * ``posegraph.optimize`` and ``posegraph_sim3.optimize`` on a 20-node
    chain with 3 loop edges: the refined poses within 1e-4 (dense float32
    solves in another summation order);
  * ``optimize_consistent``: the same dropped edges, corrected camera
    positions within 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_visual_odometry_va4mr_tpu.backend import posegraph as jpg
from monocular_visual_odometry_va4mr_tpu.backend import posegraph_sim3 as jpg3
from monocular_visual_odometry_va4mr_tpu.core import lie as jlie
from monocular_visual_odometry_va4mr_torch.backend import posegraph as tpg
from monocular_visual_odometry_va4mr_torch.backend import (
    posegraph_sim3 as tpg3)
from monocular_visual_odometry_va4mr_torch.core import lie as tlie

torch.set_num_threads(1)

VAL_TOL = 1e-5
JAC_TOL = 1e-5
POSE_TOL = 1e-4
N_NODES = 20


def jv(f):
    return jax.jit(jax.vmap(f))


def close(j, t, tol=VAL_TOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=0,
                               atol=tol)


def rand_rotations(rng, n, scale=1.0):
    w = rng.normal(0, scale, (n, 3)).astype(np.float32)
    return np.asarray(jv(jlie.so3_exp)(jnp.asarray(w)))


def test_so3_and_se3_functions_match_reference():
    rng = np.random.default_rng(0)
    w = rng.normal(0, 0.8, (16, 3)).astype(np.float32)
    w[0] = 0.0
    w[1] = [1e-6, -2e-6, 3e-7]
    # Near pi: the argmax branch of so3_log.
    w[2] = np.float32([np.pi - 2e-4, 0, 0])
    w[3] = (np.pi - 5e-4) * np.float32([0.48, -0.6, 0.64])
    xi = np.concatenate([rng.normal(0, 2, (16, 3)), w], 1).astype(np.float32)
    close(jv(jlie.so3_exp)(jnp.asarray(w)),
          tlie.so3_exp(torch.from_numpy(w)))
    R = np.asarray(jv(jlie.so3_exp)(jnp.asarray(w)))
    close(jv(jlie.so3_log)(jnp.asarray(R)),
          tlie.so3_log(torch.from_numpy(R)), 1e-4 * np.pi)
    T = np.asarray(jv(jlie.se3_exp)(jnp.asarray(xi)))
    tT = torch.from_numpy(T)
    close(jv(jlie.se3_log)(jnp.asarray(T)), tlie.se3_log(tT), 1e-3)
    close(jv(jlie.se3_log)(jnp.asarray(T[4:])), tlie.se3_log(tT[4:]))
    close(jv(jlie.invert_se3)(jnp.asarray(T)), tlie.invert_se3(tT))
    Rj, tj = jlie.matrix_to_rt(jnp.asarray(T[5]))
    Rt, tt = tlie.matrix_to_rt(tT[5])
    close(Rj, Rt)
    close(tj, tt)
    for a, b in zip(jlie.invert_rt(Rj, tj), tlie.invert_rt(Rt, tt)):
        close(a, b)


def test_sim3_functions_match_reference():
    rng = np.random.default_rng(1)
    xi = rng.normal(0, 0.7, (24, 7)).astype(np.float32)
    xi[0] = 0.0
    xi[1] = [1e-6, -2e-6, 1e-6, 2e-7, -1e-7, 1e-7, 5e-7]
    xi[2, 3:6] = 0.0  # sigma != 0, theta -> 0
    xi[3, 6] = 0.0  # sigma -> 0
    S = np.asarray(jv(jlie.sim3_exp)(jnp.asarray(xi)))
    tS = torch.from_numpy(S)
    close(S, tlie.sim3_exp(torch.from_numpy(xi)))
    close(jv(jlie.sim3_log)(jnp.asarray(S)), tlie.sim3_log(tS))
    close(jv(jlie.invert_sim3)(jnp.asarray(S)), tlie.invert_sim3(tS))
    close(jv(jlie.sim3_to_se3)(jnp.asarray(S)), tlie.sim3_to_se3(tS))
    R = rand_rotations(rng, 1)[0]
    t = rng.normal(size=3).astype(np.float32)
    close(jlie.sim3_from_rt_s(jnp.asarray(R), jnp.asarray(t), 1.7),
          tlie.sim3_from_rt_s(torch.from_numpy(R), torch.from_numpy(t), 1.7))


def rand_similarities(rng, n, scale):
    xi = rng.normal(0, 0.5, (n, 7)).astype(np.float32)
    xi[:, :3] *= 3.0
    xi[:, 6] = rng.normal(0, scale, n)
    return np.asarray(jv(jlie.sim3_exp)(jnp.asarray(xi)))


@pytest.mark.parametrize("group", ["se3", "sim3"])
def test_edge_jacobians_at_zero_match_jax_jacobian(group):
    """Both Jacobians of the edge residual at xi = 0 (the linearization
    point, where every Taylor guard is taken) on random and on consistent
    edges (the residual itself near 0, where so3_log's guards act)."""
    rng = np.random.default_rng(2)
    d = 6 if group == "se3" else 7
    j_res = (jpg._edge_residual if group == "se3"
             else jpg3._edge_residual)
    t_res = (tpg._edge_residual if group == "se3"
             else tpg3._edge_residual)
    sigma = 0.0 if group == "se3" else 0.3
    nodes = rand_similarities(rng, 15, sigma)
    if group == "se3":
        nodes = np.asarray(jv(jlie.sim3_to_se3)(jnp.asarray(nodes)))
    Si, Sj = nodes[:6], nodes[6:12]
    inv = jlie.invert_se3 if group == "se3" else jlie.invert_sim3
    consistent = np.asarray(jv(lambda a, b: b @ inv(a))(
        jnp.asarray(Si), jnp.asarray(Sj)))
    meas = np.concatenate([nodes[12:], consistent[3:]])
    z = jnp.zeros(d)
    jac = jax.jit(jax.vmap(jax.jacobian(j_res, argnums=(0, 1)),
                           in_axes=(None, None, 0, 0, 0)))
    Ji_j, Jj_j = jac(z, z, jnp.asarray(Si), jnp.asarray(Sj),
                     jnp.asarray(meas))
    Ji_t, Jj_t = tpg.edge_jacobians(t_res, d, torch.from_numpy(Si),
                                    torch.from_numpy(Sj),
                                    torch.from_numpy(meas))
    assert np.all(np.isfinite(Ji_t.numpy())) and np.all(
        np.isfinite(Jj_t.numpy()))
    close(Ji_j, Ji_t, JAC_TOL)
    close(Jj_j, Jj_t, JAC_TOL)


def chain_with_loops(rng, group):
    """A drifted 20-node circle with 3 loop edges measured from the truth:
    (drifted nodes, [(i, j, R, t, s)])."""
    n = N_NODES
    gt = np.zeros((n, 4, 4), np.float64)
    for k in range(n):
        ang = 2 * np.pi * k / n
        c, s = np.cos(ang), np.sin(ang)
        R_WC = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        C = np.array([5 * s, 0.0, 5 * (1 - c)])
        gt[k] = np.eye(4)
        gt[k, :3, :3] = R_WC.T
        gt[k, :3, 3] = -R_WC.T @ C
    drifted = [gt[0]]
    scale = 1.0
    for k in range(1, n):
        rel = gt[k] @ np.linalg.inv(gt[k - 1])
        xi = np.concatenate([rng.normal(0, 0.03, 3),
                             rng.normal(0, 0.01, 3)]).astype(np.float32)
        d = np.asarray(jlie.se3_exp(jnp.asarray(xi)), np.float64)
        rel = d @ rel
        if group == "sim3":
            scale *= 1.02
            rel[:3, 3] *= scale
        drifted.append(rel @ drifted[-1])
    loops = []
    for i, j in ((19, 0), (15, 2), (12, 5)):
        rel = gt[j] @ np.linalg.inv(gt[i])
        loops.append((i, j, rel[:3, :3], rel[:3, 3], 1.0))
    return np.stack(drifted).astype(np.float32), loops


@pytest.mark.parametrize("group", ["se3", "sim3"])
def test_optimize_matches_reference(group):
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
        close(jpg.graph_cost(gj), tpg.graph_cost(gt_), 1e-4)
    else:
        gj = jpg3.from_se3_chain(jnp.asarray(nodes))
        gt_ = tpg3.from_se3_chain(torch.from_numpy(nodes))
        for i, j, R, t, s in loops:
            gj = jpg3.add_loop_edge(gj, i, j, R, t, s, weight=3.0)
            gt_ = tpg3.add_loop_edge(gt_, i, j, R, t, s, weight=3.0)
        oj, cj = jpg3.optimize(gj, iters=15, damping=1e-4)
        ot, ct = tpg3.optimize(gt_, iters=15, damping=1e-4)
        Tj, Tt = oj.S_CW, ot.S_CW
        close(jpg3.graph_cost(gj), tpg3.graph_cost(gt_), 1e-4)
    assert float(ct[-1]) < 0.5 * float(ct[0])
    close(cj, ct, 1e-4 * float(cj[0]))
    close(Tj, Tt, POSE_TOL)


def test_optimize_consistent_drops_the_same_edges():
    """tests/test_posegraph_sim3.py's adversarial graph: a true loop edge
    and a confidently wrong one; both packages drop the wrong one only."""
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
    oj, _, dj = jpg3.optimize_consistent(gj, n_odo=n - 1, iters=30)
    ot, _, dt = tpg3.optimize_consistent(gt_, n_odo=n - 1, iters=30)
    assert list(dj) == list(dt) == [False, True]
    close(jpg3.edge_residual_norms(oj), tpg3.edge_residual_norms(ot), 1e-3)
    close(jpg3.corrected_poses(oj), tpg3.corrected_poses(ot), POSE_TOL)
