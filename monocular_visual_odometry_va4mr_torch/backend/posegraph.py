"""Pose-graph optimization over SE(3) relative-pose constraints (port of
``backend/posegraph.py``).

Fixed edge tables (i, j, measured T_j T_i^-1, weight; weight 0 disables an
edge); residual r_e = log(T_meas^-1 T_j T_i^-1) under left-multiplicative
updates exp(xi) T; exact edge Jacobians at xi = 0 by forward-mode autodiff
(:func:`edge_jacobians`); the normal equations and the gradient assembled
block by block into a dense (N*d, N*d) system and an (N, d) one by
``index_put_(accumulate=True)``: on the CPU it adds in index order, on a
CUDA device its kernel sums each node's terms in a fixed order (a stable
sort of the indices, then each run of equal ones in turn), where
``index_add_`` would add in atomic order and two solves of one graph could
differ; gauge on node 0, LM damping, an optional Huber IRLS factor;
``solve_ex`` in float32.  The Gauss-Newton loop (:func:`gauss_newton`)
returns the cost of every iteration; its body is one iteration
(:func:`gn_iteration`), which a CUDA device replays as one graph an
iteration, as the reference's ``lax.scan`` runs its body.

:func:`gauss_newton` is shared with the Sim(3) graph
(``backend/posegraph_sim3.py``), which differs only in the group.
"""
from __future__ import annotations

import functools
import time
from typing import Callable, NamedTuple

import torch

from ..core import graphs, lie
from ..core.linalg import solve


class PoseGraph(NamedTuple):
    T_CW: torch.Tensor  # (N, 4, 4) node poses (extrinsics convention)
    edge_i: torch.Tensor  # (E,) int64 source node
    edge_j: torch.Tensor  # (E,) int64 target node
    T_meas: torch.Tensor  # (E, 4, 4) measured T_j * T_i^-1
    weight: torch.Tensor  # (E,) float32 (0 = invalid edge)


def chain_edges(nodes: torch.Tensor, invert: Callable):
    """(edge_i, edge_j, measurements, weights) of the chain graph whose
    edges reproduce ``nodes``: node k+1 times the inverse of node k."""
    n = nodes.shape[0]
    i = torch.arange(n - 1, device=nodes.device)
    meas = nodes[1:] @ invert(nodes[:-1])
    return i, i + 1, meas, torch.ones(n - 1, device=nodes.device)


def odometry_edges(T_CW: torch.Tensor) -> PoseGraph:
    """Build a chain graph whose edges reproduce the given trajectory."""
    return PoseGraph(T_CW, *chain_edges(T_CW, lie.invert_se3))


def append_edge(graph: NamedTuple, i: int, j: int, meas: torch.Tensor,
                weight: float) -> NamedTuple:
    """The graph with one more edge (the edge tables are fields 1..4)."""
    nodes, edge_i, edge_j, all_meas, weights = graph
    dev = nodes.device
    return type(graph)(
        nodes,
        torch.cat([edge_i, torch.tensor([i], device=dev)]),
        torch.cat([edge_j, torch.tensor([j], device=dev)]),
        torch.cat([all_meas, meas.to(dev, all_meas.dtype)[None]]),
        torch.cat([weights, torch.tensor([weight], dtype=weights.dtype,
                                         device=dev)]))


def add_edge(graph: PoseGraph, i: int, j: int, T_meas,
             weight: float = 1.0) -> PoseGraph:
    """Append one (loop-closure) edge."""
    return append_edge(graph, i, j, torch.as_tensor(T_meas), weight)


def _edge_residual(xi_i, xi_j, T_i, T_j, T_meas):
    """Residual under left-mult updates exp(xi) T.  (..., 6)"""
    Ti = lie.se3_exp(xi_i) @ T_i
    Tj = lie.se3_exp(xi_j) @ T_j
    return lie.se3_log(lie.invert_se3(T_meas) @ (Tj @ lie.invert_se3(Ti)))


def edge_residuals(residual: Callable, dof: int, graph) -> torch.Tensor:
    """(E, dof) residuals at the graph's current nodes."""
    nodes, edge_i, edge_j, meas, _ = graph
    z = torch.zeros((edge_i.shape[0], dof), dtype=nodes.dtype,
                    device=nodes.device)
    return residual(z, z, nodes[edge_i], nodes[edge_j], meas)


def edge_jacobians(residual: Callable, dof: int, nodes_i, nodes_j, meas):
    """(E, dof, dof) Jacobians of ``residual`` with respect to xi_i and
    xi_j at xi = 0: ``jacfwd`` over the edges, written as one
    ``torch.func.jvp`` per argument on a (dof, E) batch whose tangents are
    the basis vectors.  (``vmap(jacfwd(...))`` over the edges makes every
    per-edge scalar 0-dim, and torch gives a 0-dim tensor combined with a
    Python float a float64 tangent under ``vmap``, which breaks the
    matmuls after it.)"""
    E = meas.shape[0]
    eye = torch.eye(dof, dtype=meas.dtype, device=meas.device)
    basis = eye[:, None, :].expand(dof, E, dof)
    z = torch.zeros_like(basis)
    _, Ji = torch.func.jvp(
        lambda x: residual(x, z, nodes_i, nodes_j, meas), (z,), (basis,))
    _, Jj = torch.func.jvp(
        lambda x: residual(z, x, nodes_i, nodes_j, meas), (z,), (basis,))
    return Ji.permute(1, 2, 0), Jj.permute(1, 2, 0)


def graph_cost(graph: PoseGraph) -> torch.Tensor:
    r = edge_residuals(_edge_residual, 6, graph)
    return 0.5 * torch.sum(graph.weight * torch.sum(r * r, -1))


def gn_iteration(residual: Callable, exp: Callable, dof: int,
                 damping: float, robust_delta: float, nodes, ii, jj, meas,
                 weight):
    """One Gauss-Newton iteration, the body of :func:`gauss_newton`'s loop
    (the reference's ``lax.scan`` body): (nodes, edge tables, weight) ->
    ((new nodes,), (cost,)).  Node 0 is the gauge anchor.  It reads
    nothing on the host and makes no tensor from host data, so a CUDA
    graph holds it whole: the solve is ``solve_ex`` (``linalg.solve``) and
    the gauge is set with ``fill_`` / ``copy_``."""
    N = nodes.shape[0]
    dev, dt = nodes.device, nodes.dtype
    z = torch.zeros((ii.shape[0], dof), dtype=dt, device=dev)
    eye = torch.eye(dof, dtype=dt, device=dev)
    Ti, Tj = nodes[ii], nodes[jj]
    r = residual(z, z, Ti, Tj, meas)
    Ji, Jj = edge_jacobians(residual, dof, Ti, Tj, meas)
    # sqrt(w) on the residual AND the Jacobians: the normal equations
    # weight each edge by w, as graph_cost does; the Huber IRLS factor
    # composes the same way.
    w_r = torch.clamp(robust_delta / torch.clamp(
        torch.linalg.vector_norm(r, dim=-1), min=1e-12), max=1.0)
    sw = torch.sqrt(weight * w_r)
    r = r * sw[:, None]
    Ji = Ji * sw[:, None, None]
    Jj = Jj * sw[:, None, None]

    # Dense normal equations, one (dof, dof) block per node pair.
    Hb = torch.zeros((N, N, dof, dof), dtype=dt, device=dev)
    HtH_ij = torch.einsum("eai,eaj->eij", Ji, Jj)
    Hb.index_put_((ii, ii), torch.einsum("eai,eaj->eij", Ji, Ji),
                  accumulate=True)
    Hb.index_put_((jj, jj), torch.einsum("eai,eaj->eij", Jj, Jj),
                  accumulate=True)
    Hb.index_put_((ii, jj), HtH_ij, accumulate=True)
    Hb.index_put_((jj, ii), HtH_ij.transpose(-1, -2), accumulate=True)
    g = torch.zeros((N, dof), dtype=dt, device=dev)
    g.index_put_((ii,), torch.einsum("eai,ea->ei", Ji, r), accumulate=True)
    g.index_put_((jj,), torch.einsum("eai,ea->ei", Jj, r), accumulate=True)

    # Gauge: freeze node 0.
    Hb[0].fill_(0.0)
    Hb[:, 0].fill_(0.0)
    Hb[0, 0].copy_(eye)
    g[0].fill_(0.0)

    Hm = Hb.permute(0, 2, 1, 3).reshape(N * dof, N * dof)
    Hm = Hm + damping * torch.eye(N * dof, dtype=dt, device=dev)
    delta = solve(Hm, -g.reshape(-1)).reshape(N, dof)
    return (exp(delta) @ nodes,), (0.5 * torch.sum(r * r),)


def gauss_newton(graph, residual: Callable, exp: Callable, dof: int, *,
                 iters: int, damping: float, robust_delta):
    """Gauss-Newton over the nodes (field 0) of ``graph``; node 0 is the
    gauge anchor.  Returns (refined nodes, costs (iters,)).

    The loop is ``core.graphs.scan`` of :func:`gn_iteration`: on a CUDA
    device one graph of the iteration per (group, N, E, damping,
    robust_delta), captured at the first solve of those shapes and replayed
    once an iteration by every later one (the nodes pass from one replay
    to the next in the graph's own buffer, each cost lands in a device
    (iters,) tensor); on the CPU the iteration op by op.  Either way the
    bits are those of the iteration run ``iters`` times eagerly."""
    nodes, ii, jj, meas, weight = graph
    delta_rb = 1e30 if robust_delta is None else float(robust_delta)
    body = functools.partial(gn_iteration, residual, exp, dof,
                             float(damping), delta_rb)
    (nodes,), (costs,) = graphs.scan(
        ("gauss_newton", residual, exp, dof, float(damping), delta_rb),
        body, (nodes,), (ii, jj, meas, weight), iters)
    return nodes, costs


def optimize(graph: PoseGraph, *, iters: int = 10, damping: float = 1e-6,
             robust_delta: float = None):
    """Gauss-Newton pose-graph optimization; node 0 is the gauge anchor.

    Returns (graph with refined T_CW, costs (iters,)).  ``robust_delta``:
    optional Huber threshold on the per-edge residual norm (IRLS) bounding
    the influence of outlier (wrong-loop) edges."""
    T_out, costs = gauss_newton(graph, _edge_residual, lie.se3_exp, 6,
                                iters=iters, damping=damping,
                                robust_delta=robust_delta)
    return graph._replace(T_CW=T_out), costs


class Laps:
    """Seconds between calls, each ended by a device sync, added to
    ``trace[name]`` (nothing without a trace)."""

    def __init__(self, device, trace):
        self.device, self.trace = device, trace
        self.t = time.perf_counter()

    def __call__(self, name):
        if self.trace is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.trace[name] = self.trace.get(name, 0.0) + now - self.t
        self.t = now
