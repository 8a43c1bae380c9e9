"""Pose-graph optimization over Sim(3): monocular scale-drift correction
(port of ``backend/posegraph_sim3.py``).

Nodes live on Sim(3) (pose + scale, Strasdat et al., RSS 2010): odometry
edges measure S_j S_i^-1 of the VO chain (relative scale 1); loop edges
carry a measured relative pose AND relative scale; the residual is
log_sim3(S_meas^-1 S_j S_i^-1) (7,), solved by the SE(3) graph's
Gauss-Newton (``posegraph.gauss_newton``) with 7-dof blocks and the gauge on
node 0 (global pose and scale).  Each optimized node's camera pose is
[[R, t/s]] (``lie.sim3_to_se3``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import lie
from .posegraph import (Laps, append_edge, chain_edges, edge_residuals,
                        gauss_newton)


class Sim3Graph(NamedTuple):
    S_CW: torch.Tensor  # (N, 4, 4) node similarities [[s*R, t], [0, 1]]
    edge_i: torch.Tensor  # (E,) int64 source node
    edge_j: torch.Tensor  # (E,) int64 target node
    S_meas: torch.Tensor  # (E, 4, 4) measured S_j * S_i^-1
    weight: torch.Tensor  # (E,) float32 (0 = invalid edge)


def from_se3_chain(T_CW: torch.Tensor) -> Sim3Graph:
    """Lift an SE(3) trajectory to a Sim(3) chain graph (all scales 1)."""
    return Sim3Graph(T_CW, *chain_edges(T_CW, lie.invert_sim3))


def add_loop_edge(graph: Sim3Graph, i: int, j: int, R, t, s_rel: float,
                  weight: float = 1.0) -> Sim3Graph:
    """Append a loop-closure edge S_ji = [[s_rel * R, t], [0, 1]].

    (R, t): measured rigid transform camera_i -> camera_j, |t| already in
    node i's local metric scale; ``s_rel``: measured scale of node j's
    odometry relative to node i's."""
    S = lie.sim3_from_rt_s(torch.as_tensor(R, dtype=torch.float32),
                           torch.as_tensor(t, dtype=torch.float32),
                           float(s_rel))
    return append_edge(graph, i, j, S, weight)


def _edge_residual(xi_i, xi_j, S_i, S_j, S_meas):
    """Residual under left-mult updates exp(xi) S.  (..., 7)"""
    Si = lie.sim3_exp(xi_i) @ S_i
    Sj = lie.sim3_exp(xi_j) @ S_j
    return lie.sim3_log(lie.invert_sim3(S_meas) @ (Sj @ lie.invert_sim3(Si)))


def graph_cost(graph: Sim3Graph) -> torch.Tensor:
    r = edge_residuals(_edge_residual, 7, graph)
    return 0.5 * torch.sum(graph.weight * torch.sum(r * r, -1))


def optimize(graph: Sim3Graph, *, iters: int = 10, damping: float = 1e-6,
             robust_delta: float = None):
    """Gauss-Newton Sim(3) pose-graph optimization; node 0 is the gauge
    anchor (pose + scale).  Returns (graph with refined S_CW, costs).

    ``robust_delta``: optional Huber threshold on the per-edge residual
    norm (IRLS), so one confidently-wrong loop edge cannot drag the whole
    graph."""
    S_out, costs = gauss_newton(graph, _edge_residual, lie.sim3_exp, 7,
                                iters=iters, damping=damping,
                                robust_delta=robust_delta)
    return graph._replace(S_CW=S_out), costs


def corrected_poses(graph: Sim3Graph) -> torch.Tensor:
    """(N, 4, 4) SE(3) camera extrinsics from the optimized Sim(3) nodes."""
    return lie.sim3_to_se3(graph.S_CW)


def edge_residual_norms(graph: Sim3Graph) -> torch.Tensor:
    """(E,) unweighted residual norms at the graph's current nodes."""
    return torch.linalg.vector_norm(edge_residuals(_edge_residual, 7, graph),
                                    dim=-1)


def optimize_consistent(graph: Sim3Graph, *, n_odo: int, iters: int = 15,
                        damping: float = 1e-4, robust_delta: float = 0.5,
                        suspect_factor: float = 1.5,
                        suspect_floor: float = 0.15, gain: float = 0.5,
                        verbose: bool = False, trace: dict = None):
    """Huber-robust optimize + leave-one-out consistency pruning of the loop
    edges (edges with index >= ``n_odo``), on the host.

    Re-optimizing WITHOUT a genuinely wrong edge collapses the total cost
    (everything else agrees), while removing a correct edge barely changes
    it.  Only suspects (loop residual > max(floor, factor * median)) pay the
    extra solve.  Every solve has the graph's shapes and differs only in
    its weights, so on a CUDA device one graph of the GN iteration serves
    them all (``posegraph.gauss_newton``).  The residual norms and the
    costs are read on the host where the reference reads them.  ``trace``:
    a dict that receives the seconds of the first solve (the residual
    norms read back included), of the leave-one-out solves and of the
    final solve (``solve_first_s``, ``solve_loo_s``, ``solve_final_s``,
    each ended by a device sync) and the suspects' count
    (``suspects``).  Returns (optimized graph, costs, dropped (n_loops,)
    bool)."""
    kw = dict(iters=iters, damping=damping, robust_delta=robust_delta)
    lap = Laps(graph.S_CW.device, trace)
    out, costs = optimize(graph, **kw)
    loop_rn = edge_residual_norms(out).cpu().numpy()[n_odo:]
    lap("solve_first_s")
    dropped = np.zeros(len(loop_rn), bool)
    if len(loop_rn) == 0:
        return out, costs, dropped
    thresh = max(suspect_floor, suspect_factor * float(np.median(loop_rn)))
    suspects = [e for e in range(len(loop_rn)) if loop_rn[e] > thresh]
    if trace is not None:
        trace["suspects"] = len(suspects)
    base_cost = float(costs[-1])
    for e in suspects:
        w2 = graph.weight.clone()
        w2[n_odo + e] = 0.0  # weight 0 removes the edge
        _, c2 = optimize(graph._replace(weight=w2), **kw)
        if float(c2[-1]) < gain * base_cost:
            dropped[e] = True
            if verbose:
                print(f"posegraph: dropped inconsistent loop edge {e} "
                      f"(residual {loop_rn[e]:.3f}, cost "
                      f"{base_cost:.3f} -> {float(c2[-1]):.3f})")
    lap("solve_loo_s")
    if dropped.any():
        w = graph.weight.clone()
        w[n_odo + torch.from_numpy(np.flatnonzero(dropped))] = 0.0
        out, costs = optimize(graph._replace(weight=w), **kw)
        lap("solve_final_s")
    return out, costs, dropped
