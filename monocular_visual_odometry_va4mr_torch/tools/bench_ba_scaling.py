"""The sharded bundle adjustments over process groups, counterpart of
``tools/bench_ba_scaling.py``: the time of one Gauss-Newton iteration of
the landmark-sharded window BA (``parallel/ba_sharded.py``) and of the
keyframe-sharded trajectory BA (``parallel/traj_ba.py``) at each world
size, beside the same problem solved unsharded on rank 0, and the bytes
each iteration sends: the JAX tool's analytic model beside what
``parallel.multihost.COMM`` counted.

Worlds: one process a rank (``harness.run_world``).  On the card the world
is 1 (NCCL; one card has one rank); on the CPU, gloo worlds of 1, 2, 4 and
8 processes of one thread each.  Problems, as the JAX tool's: a window of
``--window`` poses and ``--landmarks`` landmarks (in all, or per rank with
``--weak``), and trajectories of 8 keyframes a segment (``--weak``; else
max(2, 8 / world)) with 512 landmarks a segment.

Per row: ``ms_per_iter`` sharded (rank 0's, after a barrier; on the card
one replay of the iteration's CUDA graph, its collectives inside,
``replayed`` true), ``ms_per_iter_eager`` the same calls op by op
(``core.graphs.eager()``; on the CPU both are op by op), unsharded (rank 0
alone), the ratio ``unsharded_over_sharded`` (1.0: splitting and the
collectives cost nothing; below 1.0 they cost), the model's bytes an
iteration (``model_bytes_per_iter``: 4 (36 W^2 + 6 W + 1) for the window
BA's one all-reduce; 2 x 16 x 4 + 4 for the trajectory BA's halo and cost),
and the counted bytes: the most any rank sent an iteration (an all-reduce's
payload, a send's payload; receives not counted), with every rank's
``(kind, bytes) -> count`` of one call.

No multi-card efficiency is claimed: one card runs one rank, and the CPU's
ranks share one host.  The JAX tool's modelled efficiency rested on a TPU
link's rate; this tool prints ``multi_card_efficiency: null`` and says why.

    python -m monocular_visual_odometry_va4mr_torch.tools.bench_ba_scaling \\
        [--weak] [--iters 10] [--worlds 1,2,4,8]
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from . import harness
from .traj_ba_convergence import global_window

K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1]])
SEGMENT_KF = 8
SEGMENT_LMS = 512
REPS, WARMUP = 10, 2
NOTE = ("no multi-card efficiency is claimed: one card runs a world of one "
        "rank, and the CPU's gloo ranks share one host; the times are one "
        "host's, the bytes are what each iteration sends")


def lm_model_bytes(W):
    """The JAX tool's model: one all-reduce of S (W,W,6,6), rhs (W,6) and
    the cost, float32 (``bench_ba_scaling.py:87``)."""
    return (W * W * 36 + W * 6 + 1) * 4


def kf_model_bytes():
    """The JAX tool's model: the (2,4,4) halo poses and the cost
    (``bench_ba_scaling.py:132``)."""
    return 2 * 16 * 4 + 4


def lm_problem(W, L, seed=0):
    """The JAX tool's window: (BAWindow on the CPU, Camera)."""
    from ..backend import ba
    from ..core.camera import Camera

    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-8, 8, L), rng.uniform(-2, 2, L),
                  rng.uniform(5, 40, L)], 1)
    T = np.tile(np.eye(4, dtype=np.float32), (W, 1, 1))
    for i in range(W):
        T[i, :3, 3] = [0.1 * i, 0.0, -0.4 * i]
    obs = np.zeros((W, L, 2), np.float32)
    for i in range(W):
        Xc = X @ T[i, :3, :3].T + T[i, :3, 3]
        obs[i, :, 0] = K[0, 0] * Xc[:, 0] / Xc[:, 2] + K[0, 2]
        obs[i, :, 1] = K[1, 1] * Xc[:, 1] / Xc[:, 2] + K[1, 2]
    window = ba.BAWindow(
        T_CW=torch.from_numpy(T),
        lm_xyz=torch.from_numpy(
            (X + rng.normal(0, 0.05, X.shape)).astype(np.float32)),
        obs_uv=torch.from_numpy(obs),
        obs_mask=torch.ones((W, L), dtype=torch.bool))
    return window, Camera.from_matrix(K)


def _to(window, dev):
    return type(window)(*(t.to(dev) for t in window))


def _time(fn, dev, reps, warmup):
    for _ in range(warmup):
        fn()
    harness.sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    harness.sync(dev)
    return (time.perf_counter() - t0) / reps


def _comm_of(fn):
    from ..parallel import multihost

    multihost.COMM.clear()
    fn()
    return {f"{kind}:{nbytes}": n
            for (kind, nbytes), n in multihost.COMM.items()}


def _sent_per_iter(comm, iters):
    """Bytes this rank sent an iteration: all-reduce and send payloads."""
    total = 0
    for key, n in comm.items():
        kind, nbytes = key.split(":")
        if kind in ("all_reduce", "send"):
            total += int(nbytes) * n
    return total / iters


def _eager(fn):
    """``fn`` op by op, its graphs not replayed."""
    from ..core import graphs

    def run():
        with graphs.eager():
            return fn()
    return run


def _unsharded(rank, fn, dev, iters, reps, warmup):
    import torch.distributed as dist

    t = _time(fn, dev, reps, warmup) / iters if rank == 0 else None
    dist.barrier()
    return t


def lm_worker(rank, world, W, L_total, weak, iters, reps, warmup, device):
    """One rank of the landmark-sharded window BA."""
    import torch.distributed as dist

    from ..backend import ba
    from ..core import graphs
    from ..parallel import ba_sharded

    dev = torch.device(device)
    L = L_total * world if weak else L_total
    window, cam = lm_problem(W, L)
    window = _to(window, dev)
    local = ba_sharded.shard_window(window, rank, world)

    def sharded():
        return ba_sharded.run_ba_sharded(local, cam, iters=iters)

    comm = _comm_of(sharded)
    dist.barrier()
    t = _time(sharded, dev, reps, warmup) / iters
    t_eager = _time(_eager(sharded), dev, reps, warmup) / iters
    t_un = _unsharded(rank, lambda: ba.run_ba(window, cam, iters=iters), dev,
                      iters, reps, warmup)
    return dict(L=L, t=t, t_eager=t_eager, t_un=t_un, comm=comm,
                sent=_sent_per_iter(comm, iters), backend=dist.get_backend(),
                replayed=graphs.replaying(dev))


def kf_worker(rank, world, S, L_seg, weak, iters, reps, warmup, device):
    """One rank of the keyframe-sharded trajectory BA."""
    import torch.distributed as dist

    from ..backend import ba
    from ..core import graphs
    from ..parallel import traj_ba

    dev = torch.device(device)
    S_eff = S if weak else max(2, S // world)
    noisy, _, cam = traj_ba.build_synthetic_traj(world, S_eff, L_seg, seed=1)
    local = traj_ba.shard_segments(noisy, rank, world)
    local = type(local)(*(t.to(dev) for t in local))

    def sharded():
        return traj_ba.run_traj_ba(local, cam, iters=iters)

    comm = _comm_of(sharded)
    dist.barrier()
    t = _time(sharded, dev, reps, warmup) / iters
    t_eager = _time(_eager(sharded), dev, reps, warmup) / iters
    window = _to(global_window(noisy, world, S_eff, L_seg), dev)
    t_un = _unsharded(rank, lambda: ba.run_ba(window, cam, iters=iters), dev,
                      iters, reps, warmup)
    return dict(kframes=world * S_eff, t=t, t_eager=t_eager, t_un=t_un,
                comm=comm, sent=_sent_per_iter(comm, iters),
                backend=dist.get_backend(), replayed=graphs.replaying(dev))


def row(sharding, world, ranks, model, iters):
    r0 = ranks[0]
    out = dict(sharding=sharding, shards=world, iters=iters,
               ms_per_iter=1e3 * r0["t"], replayed=r0["replayed"],
               ms_per_iter_eager=1e3 * r0["t_eager"],
               ms_per_iter_unsharded=1e3 * r0["t_un"],
               unsharded_over_sharded=r0["t_un"] / r0["t"],
               model_bytes_per_iter=model,
               counted_bytes_per_iter=max(r["sent"] for r in ranks),
               comm_by_rank=[r["comm"] for r in ranks],
               backend=r0["backend"], multi_card_efficiency=None)
    out.update({k: r0[k] for k in ("L", "kframes") if k in r0})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--weak", action="store_true",
                    help="hold the work per rank constant")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--landmarks", type=int, default=2048,
                    help="landmarks in all (strong) or per rank (weak)")
    ap.add_argument("--worlds", default=None,
                    help="world sizes (default 1 on the card, 1,2,4,8 on "
                         "the CPU)")
    harness.add_device_arg(ap)
    args = ap.parse_args(argv)
    device = harness.resolve_device(args.device)
    harness.build_kernels(device)
    fields = harness.device_fields(device)
    worlds = harness.parse_worlds(args.worlds, device)
    if device.type == "cuda" and max(worlds) > torch.cuda.device_count():
        raise RuntimeError(f"worlds {worlds} need more cards than the "
                           f"{torch.cuda.device_count()} present")
    mode = "weak" if args.weak else "strong"
    common = (args.weak, args.iters, REPS, WARMUP, device.type)
    for n in worlds:
        ranks = harness.run_world(lm_worker, n, args.window, args.landmarks,
                                  *common)
        harness.emit({**row("landmark", n, ranks,
                            lm_model_bytes(args.window), args.iters),
                      "window": args.window, "scaling": mode, **fields})
    for n in worlds:
        ranks = harness.run_world(kf_worker, n, SEGMENT_KF, SEGMENT_LMS,
                                  *common)
        harness.emit({**row("keyframe", n, ranks, kf_model_bytes(),
                            args.iters), "scaling": mode, **fields})
    harness.emit(dict(summary="bench_ba_scaling", worlds=worlds,
                      scaling=mode, multi_card_efficiency=None, note=NOTE,
                      **fields))
    return 0


if __name__ == "__main__":
    sys.exit(main())
