"""CUDA graphs of the port's compiled functions: the capture and replay
that the step (``pipeline/vo.py::StepGraphs``), the VO's other graphs
(``VisualOdometry.graphed``) and the back end's solves share.

``GraphCache`` holds graphs keyed by their caller in one memory pool:
``capture`` records a function (in segments around the library calls that
wait on the device inside them, ``_HOST_WAITS``), ``replay`` runs it and
adds the launches of the counted kernels it holds to their wrappers'
counts, ``call`` is the graph of a function of tensors over static copies
of its inputs, and ``scan`` is the counterpart of ``lax.scan``: one graph
of the loop's body, replayed once an iteration, that writes its new carry
over its own inputs.

``shared(device)`` is the cache of the functions that belong to no VO, the
counterpart of ``jax.jit``'s own cache: the pose graphs' Gauss-Newton
iterations (``backend/posegraph.py``), the runner's windowed BA
(``pipeline/ba_refine.py``) and the sharded BAs' iterations with their
collectives (``parallel/ba_sharded.py``, ``parallel/traj_ba.py``).
``scan(key, body, carry, consts, iters)`` runs a loop on any device: on a
CUDA device it replays the body's graph in ``shared``, on the CPU it runs
the body op by op, and so does every device inside ``eager()``, which
callers enter to compare a replay with the same work op by op.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import threading
import time
from typing import Callable, Dict, List, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..ops import klt_pallas, klt_pallas2
from ..parallel import multihost
from . import spans
from .state import Packing

# The kernel wrappers whose launch counts a replay adds to.
_COUNTED = (klt_pallas2.klt_lk, klt_pallas.klt_v1)


def _launch_counts() -> Tuple[int, ...]:
    return tuple(fn.launches for fn in _COUNTED)


def _set_launch_counts(counts: Tuple[int, ...]) -> None:
    for fn, n in zip(_COUNTED, counts):
        fn.launches = n


# The library calls that wait on the device inside them: torch reads their
# error codes (``eigh``'s; ``svd``'s convergence) on the host, which no
# capture allows.  A graph whose function makes one is captured in segments
# around it (``GraphCache``).
_HOST_WAITS = (torch.ops.aten._linalg_eigh.default,
               torch.ops.aten._linalg_svd.default)


class _Segments(TorchDispatchMode):
    """What one capture records: graphs, and between them the calls of
    ``_HOST_WAITS`` that no graph can hold.  Active while a function is
    captured, it ends the capture before each such call, replays the graph
    it just ended (a captured graph has run nothing: without the replay the
    call would read whatever earlier replays left in the pool, and could
    fail on it), runs the call, keeps its arguments and its result, and
    begins a new capture after it.  ``replay`` replays the graphs in turn,
    and runs each call between them again on the same arguments (the
    tensors the graphs write), its result copied into the tensors the
    later graphs read."""

    def __init__(self, pool):
        super().__init__()
        self.pool = pool
        self.steps = []  # CUDAGraph, (func, args, kwargs, result), ...
        self.graph = None

    def begin(self):
        self.graph = torch.cuda.CUDAGraph()
        self.graph.capture_begin(pool=self.pool,
                                 capture_error_mode="thread_local")

    def end(self):
        if self.graph is not None:
            self.graph.capture_end()
            self.steps.append(self.graph)
            self.graph = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in _HOST_WAITS:
            return func(*args, **kwargs)
        self.end()
        self.steps[-1].replay()
        out = func(*args, **kwargs)
        self.steps.append((func, args, kwargs, out))
        self.begin()
        return out

    @staticmethod
    def replay(steps) -> None:
        for step in steps:
            if isinstance(step, torch.cuda.CUDAGraph):
                step.replay()
            else:
                func, args, kwargs, out = step
                with spans.span("graph.host_wait"):
                    for kept, new in zip(out, func(*args, **kwargs)):
                        kept.copy_(new)


class GraphCache:
    """CUDA graphs keyed by their caller, in one memory pool: the capture and
    replay that ``StepGraphs``, ``VisualOdometry``'s other graphs
    (``graphed``: the bootstrap's pieces, SIFT, the loop verifier's chunk)
    and the back end's (``shared``: the pose graphs' iterations, the
    runner's windowed BA) share.

    ``capture(key, record, warm_up)`` runs ``warm_up()`` on a side stream
    (it builds and loads the kernels and the library handles, and makes
    the constant tensors, ``core.linalg.constant`` / ``kept``; its result
    is dropped), then captures ``record()`` on it with Python's garbage
    collector collected and off (a graph it frees, one of a VO that is
    gone, would end the capture: no graph may be destroyed while a stream
    captures) and ``capture_error_mode="thread_local"``.  A call that
    waits on the device inside it (``_HOST_WAITS``) ends one capture and
    begins the next (``_Segments``), so a key may hold several graphs with
    such calls between them.  Capturing records how many launches of each
    counted kernel the graphs hold, and which collectives of
    ``parallel.multihost`` (``COMM``: the wrappers count when they run, at
    the warm-up and the capture, never at a replay); ``replay(key)`` adds
    both to the counts, and the warm-up and the capture add nothing.  A
    graph's collectives run on the communicators that exist when it is
    captured: the warm-up's collectives make them, and every rank of a
    group warms up and captures the same collectives in the same order.

    ``call(key, fn, inputs)`` is the graph of a function of tensors that
    returns a tuple of tensors, one graph per key and the inputs' shapes
    and dtypes: it reads static copies of the inputs and packs the outputs
    into one buffer (``core.state.Packing``).  Each call copies the inputs
    in, replays, and returns the outputs as views of one copy of that
    buffer (on the host if ``host``), so a later replay leaves them as they
    are.  ``scan(key, body, carry, consts, iters)`` replays one graph of a
    loop's body once an iteration.  Every failure raises: nothing falls
    back to running eagerly."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: Dict[tuple, tuple] = {}  # key -> (steps, launches held)
        self.comm: Dict[tuple, collections.Counter] = {}  # collectives held
        self.capture_s: Dict[tuple, float] = {}  # warm-up included
        self.replays = 0
        self._io: Dict[tuple, tuple] = {}  # key -> static buffers

    def capture(self, key, record: Callable[[], None],
                warm_up: Callable[[], object]) -> None:
        t0 = time.perf_counter()
        counts = _launch_counts()
        comm = collections.Counter(multihost.COMM)
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(device=self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            warm_up()
        warmed = _launch_counts()
        comm_warmed = collections.Counter(multihost.COMM)
        segments = _Segments(self.pool)
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            torch.cuda.synchronize(self.device)
            with torch.cuda.stream(side):
                segments.begin()
                try:
                    with segments:
                        record()
                finally:
                    segments.end()
        finally:
            if collecting:
                gc.enable()
        main.wait_stream(side)
        held = tuple(a - b for a, b in zip(_launch_counts(), warmed))
        comm_held = multihost.COMM - comm_warmed
        _set_launch_counts(counts)
        multihost.COMM.clear()
        multihost.COMM.update(comm)
        torch.cuda.synchronize(self.device)
        self.graphs[key] = (segments.steps, held)
        self.comm[key] = comm_held
        self.capture_s[key] = time.perf_counter() - t0

    def replay(self, key) -> None:
        steps, held = self.graphs[key]
        # The graphs alternate with the host waits between them.
        with spans.span("graph.replay", key=key,
                        segments=(len(steps) + 1) // 2):
            _Segments.replay(steps)
        _set_launch_counts(tuple(c + h for c, h
                                 in zip(_launch_counts(), held)))
        multihost.COMM.update(self.comm[key])
        self.replays += 1

    def call(self, key, fn: Callable, inputs: Sequence[torch.Tensor],
             host: bool = False) -> List[torch.Tensor]:
        key = (key,) + tuple((tuple(t.shape), t.dtype) for t in inputs)
        spans.h2d(sum(t.nbytes for t in inputs if t.device.type == "cpu"))
        if key in self._io:
            for buf, t in zip(self._io[key][0], inputs):
                buf.copy_(t)
        else:
            static = [t.to(self.device, copy=True) for t in inputs]
            out = {}

            def warm_up():
                out["packing"] = Packing(fn(*static))

            def record():
                packing = out["packing"]
                out["buf"] = torch.empty(packing.nbytes, dtype=torch.uint8,
                                         device=self.device)
                packing.pack(out["buf"], fn(*static))

            self.capture(key, record, warm_up)
            self._io[key] = (static, out["packing"], out["buf"])
        _, packing, buf = self._io[key]
        self.replay(key)
        if host:
            spans.d2h(buf.nbytes)
            return packing.views(buf.cpu())
        return packing.views(buf.clone())

    def scan(self, key, body: Callable, carry: Sequence[torch.Tensor],
             consts: Sequence[torch.Tensor], iters: int):
        """``iters`` iterations of ``body(*carry, *consts) -> (new carry,
        ys)``, the counterpart of ``lax.scan``: one graph of the body per
        key and the inputs' shapes and dtypes, over static copies of the
        carry and the constants.  The graph writes the new carry over its
        own carry buffers and each of ``ys`` into a buffer of its own; a
        call copies the caller's carry and constants in (so a loop never
        starts from what the last one left), replays ``iters`` times and
        copies each iteration's ``ys`` into row k of a device tensor.
        Returns (the final carry, one (iters, ...) tensor per y); nothing is
        read on the host."""
        inputs = (*carry, *consts)
        key = (key,) + tuple((tuple(t.shape), t.dtype) for t in inputs)
        n = len(carry)
        if key not in self._io:
            static = [t.to(self.device, copy=True) for t in inputs]
            out = {}

            def warm_up():
                body(*static)

            def record():
                new, ys = body(*static)
                # ys kept before the carry is overwritten (a y may view it).
                out["ys"] = [y.clone() for y in ys]
                for buf, t in zip(static[:n], new):
                    buf.copy_(t)

            self.capture(key, record, warm_up)
            self._io[key] = (static, out["ys"])
        static, ys = self._io[key]
        for buf, t in zip(static, inputs):
            buf.copy_(t)
        stacked = [torch.empty((iters,) + tuple(y.shape), dtype=y.dtype,
                               device=self.device) for y in ys]
        for k in range(iters):
            self.replay(key)
            for row, y in zip(stacked, ys):
                row[k].copy_(y)
        return [t.clone() for t in static[:n]], stacked


_SHARED: Dict[torch.device, GraphCache] = {}
_EAGER = threading.local()


@contextlib.contextmanager
def eager(on: bool = True):
    """Within it (when ``on``), ``scan`` and ``replaying`` run the back
    end's functions op by op on every device: what a replay is compared
    with.  Nothing enters it by itself: a capture or replay that fails
    raises."""
    was = getattr(_EAGER, "on", False)
    _EAGER.on = on
    try:
        yield
    finally:
        _EAGER.on = was


def replaying(device) -> bool:
    """Whether the back end's functions on ``device`` replay their graphs
    (a CUDA device, outside ``eager()``)."""
    return (torch.device(device).type == "cuda"
            and not getattr(_EAGER, "on", False))


def shared(device) -> GraphCache:
    """The graph cache of ``device`` for the functions that belong to no
    VO (the pose graphs' iterations, the runner's windowed BA), made at
    the first call and the same cache at every later one."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _SHARED:
        _SHARED[device] = GraphCache(device)
    return _SHARED[device]


def scan(key, body: Callable, carry: Sequence[torch.Tensor],
         consts: Sequence[torch.Tensor], iters: int):
    """``GraphCache.scan`` in ``shared(device)`` where the device replays
    (``replaying``); elsewhere the same loop op by op, each y stacked by
    ``torch.stack``, with the same bits."""
    device = carry[0].device
    if replaying(device):
        return shared(device).scan(key, body, carry, consts, iters)
    carry, rows = list(carry), []
    for _ in range(iters):
        carry, ys = body(*carry, *consts)
        carry = list(carry)
        rows.append(ys)
    return carry, [torch.stack(col) for col in zip(*rows)]


def replays(device) -> int:
    """Replays so far in ``shared(device)`` (0 off a CUDA device)."""
    device = torch.device(device)
    return shared(device).replays if device.type == "cuda" else 0


def captures(device) -> Tuple[int, float]:
    """(graphs captured, their capture seconds) so far in
    ``shared(device)`` ((0, 0.0) off a CUDA device)."""
    device = torch.device(device)
    if device.type != "cuda":
        return 0, 0.0
    cache = shared(device)
    return len(cache.capture_s), sum(cache.capture_s.values())
