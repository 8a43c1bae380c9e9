"""The port's spans and counters (``core/spans.py``) on the CPU.

* Off, ``span`` hands out one shared no-op and nothing is recorded.
* On, the block driver's blackout stream in blocks of 8 (the in-step BA
  every 3 frames over a ring of 3, so chunks of 3, recovery and landmark
  snapshots on) leaves a consistent tree: each child within its parent,
  every stage span inside a ``vo.step`` or ``vo.chunk``, every
  ``stream.block`` holding its ``stream.stack`` and ``stream.readback``,
  each re-bootstrap's ``vo.bootstrap`` inside ``stream.recover``.
* ``COUNTS`` against hand counts: ``steps`` the step bodies that ran,
  ``chunks`` the ``vo.chunk`` spans, ``bootstrap.hops`` the stride a
  bootstrap, ``recover.done`` ``StreamInfo.recoveries``, at most
  ``recover.attempts``; ``tools/harness.CallCounts`` reads the same.
* ``runner.run_sequence`` through the blackout: its recovery moves
  ``recover.done``; each ``runner.frame`` holds its step, and the
  caller's callback runs in ``runner.on_frame``.
* ``StepGraphs`` with stand-in graphs: replays equal the eager bodies, and
  ``stage_map`` runs each captured body on copies of its buffers;
  ``trace_events``' links and ``device_stages`` on fake profiler events.

Scene and config: ``tests/test_torch_streaming.py``'s 240x320 corridor
and ``tests/test_torch_block_graph.py``'s VO.
"""
import collections

import numpy as np
import pytest
import torch

from monocular_visual_odometry_va4mr_torch.core import spans
from monocular_visual_odometry_va4mr_torch.pipeline import (runner,
                                                            scan_driver)
from monocular_visual_odometry_va4mr_torch.pipeline.vo import (
    VisualOdometry)
from monocular_visual_odometry_va4mr_torch.tools import harness
from test_torch_block_graph import IDS, gen, make_vo
from test_torch_drivers import BLACKOUT, SEED, STRIDE
from test_torch_streaming import blackout_frames, frames, scene  # noqa: F401

torch.set_num_threads(1)

STAGES = ("stage.klt", "stage.pnp", "stage.retri", "stage.triangulate",
          "stage.detect", "stage.ring", "stage.ba", "stage.pack")


@pytest.fixture
def recorded():
    """Spans on for the test, off after it whatever happens."""
    spans.start()
    yield
    spans.stop()


def by_id(records):
    return {r[0]: r for r in records}


def ancestors(rec, ids):
    while rec[1] >= 0:
        rec = ids[rec[1]]
        yield rec


def children(rec, records):
    return [r for r in records if r[1] == rec[0]]


def assert_tree(records):
    ids = by_id(records)
    assert [r[0] for r in records] == list(range(len(records)))
    for r in records:
        assert 0 < r[3] <= r[4], r
        if r[1] >= 0:
            p = ids[r[1]]
            assert p[3] <= r[3] and r[4] <= p[4], (r, p)


def test_off_records_nothing():
    a, b = spans.span("vo.step"), spans.span("stage.pnp", K=3)
    assert a is b
    with a as inner:
        assert inner is a
    spans.start()
    assert spans.stop() == []


def test_streaming_blackout_tree_and_counts(scene, blackout_frames,  # noqa
                                            monkeypatch):
    vo = make_vo(scene)
    bodies = [0]
    body = VisualOdometry._step_impl

    def counted(self, *args):
        bodies[0] += 1
        return body(self, *args)

    monkeypatch.setattr(VisualOdometry, "_step_impl", counted)
    ba_frames = [0]
    branch = VisualOdometry._run_ba_branch

    def counted_ba(self, *args):
        ba_frames[0] += 1
        return branch(self, *args)

    monkeypatch.setattr(VisualOdometry, "_run_ba_branch", counted_ba)
    before = collections.Counter(spans.COUNTS)
    with harness.CallCounts(vo) as calls:
        spans.start()
        try:
            s0 = vo.bootstrap(blackout_frames[0], blackout_frames[STRIDE],
                              intermediate=blackout_frames[1:STRIDE],
                              generator=gen(0))
            _, _, ids, info = scan_driver.run_streaming(
                vo, s0, ((i, blackout_frames[i]) for i in IDS), SEED,
                block=8, recover=True, bootstrap_stride=STRIDE,
                emit_landmarks=True)
        finally:
            records = spans.stop()
    d = spans.COUNTS - before
    assert_tree(records)
    ids_ = by_id(records)
    names = collections.Counter(r[2] for r in records)
    for r in records:
        up = {a[2] for a in ancestors(r, ids_)}
        if r[2] in STAGES:
            assert up & {"vo.step", "vo.chunk"}, r
        if r[2] in ("vo.step", "vo.chunk"):
            assert "stream.block" in up, r
    blocks = [r for r in records if r[2] == "stream.block"]
    assert len(blocks) == info.blocks
    assert [r[5]["block"] for r in blocks] == list(range(info.blocks))
    for r in blocks:
        kids = {c[2] for c in children(r, records)}
        assert {"stream.stack", "stream.readback"} <= kids, kids
        assert "stream.recover" in kids  # recovery on: a check a block
    recovers = [r for r in records if r[2] == "stream.recover"]
    boots = [r for r in records if r[2] == "vo.bootstrap"]
    assert boots[0][1] == -1 and len(boots) == 1 + d["recover.attempts"]
    assert all(ids_[r[1]][2] == "stream.recover" for r in boots[1:])
    assert len(recovers) == info.blocks
    for stage in STAGES:
        # The BA's stage on a BA frame only.
        want = ba_frames[0] if stage == "stage.ba" else bodies[0]
        assert names[stage] == want, stage
    assert ba_frames[0] >= 1

    # The counters against the hand counts.
    assert info.recoveries >= 1 and min(BLACKOUT) in ids
    assert d["steps"] == bodies[0] == calls.steps
    assert d["chunks"] == names["vo.chunk"] == calls.chunks >= 2
    assert names["vo.step"] + 3 * names["vo.chunk"] == d["steps"]
    assert d["bootstraps"] == len(boots) == calls.bootstraps
    assert d["bootstrap.hops"] == STRIDE * len(boots) == calls.hops
    assert d["recover.done"] == info.recoveries <= d["recover.attempts"]
    # Off the card nothing crosses to a device.
    assert d["h2d.bytes"] == d["d2h.bytes"] == d["host.syncs"] == 0


def test_runner_recovery_moves_the_counter(scene, blackout_frames,  # noqa
                                           recorded):
    vo = make_vo(scene)
    before = collections.Counter(spans.COUNTS)
    seen = []
    res = runner.run_sequence(
        vo, enumerate(blackout_frames[:14]), seed=SEED,
        bootstrap_stride=STRIDE, recover=True,
        on_frame=lambda records, snap: seen.append(records[-1].frame))
    records = spans.stop()
    spans.start()  # for the fixture to stop
    d = spans.COUNTS - before
    assert 1 <= d["recover.done"] <= d["recover.attempts"]
    assert d["steps"] == len(res.records) - 1 == len(seen)
    assert_tree(records)
    ids = by_id(records)
    frames_ = [r for r in records if r[2] == "runner.frame"]
    assert [r[5]["frame"] for r in frames_] == seen
    for r in frames_:
        kids = [c[2] for c in children(r, records)]
        assert kids[0] == "vo.step" and "runner.on_frame" in kids, kids
        assert "runner.recover" in kids and "runner.record" in kids
    recovered = [r for r in records if r[2] == "vo.bootstrap" and r[1] >= 0]
    assert len(recovered) == d["recover.attempts"]
    assert all(ids[r[1]][2] == "runner.recover" for r in recovered)


def test_stage_map_runs_each_body_on_copies(scene, frames,  # noqa: F811
                                            monkeypatch):
    """``StepGraphs`` on the CPU with stand-in graphs (a capture keeps the
    recorded function, a replay calls it): a step and a chunk replay give
    the eager bodies' states bit for bit, each captured key keeps its body
    and buffers, and ``stage_map`` runs every key's body without touching
    the buffers a replay left (on the CPU no device event is mapped)."""
    from torch import profiler

    from monocular_visual_odometry_va4mr_torch.core import graphs
    from monocular_visual_odometry_va4mr_torch.pipeline import vo as vomod

    def capture(self, key, record, warm_up):
        warm_up()
        self.graphs[key] = ([record], (0, 0))
        self.comm[key] = collections.Counter()
        self.capture_s[key] = 0.0

    cpu_profile = profiler.profile
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(graphs.GraphCache, "capture", capture)
    monkeypatch.setattr(graphs._Segments, "replay",
                        staticmethod(lambda steps: [s() for s in steps]))
    monkeypatch.setattr(profiler, "profile", lambda activities: cpu_profile(
        activities=[profiler.ProfilerActivity.CPU]))
    vo = make_vo(scene)
    s0 = vo.bootstrap(frames[0], frames[STRIDE],
                      intermediate=frames[1:STRIDE], generator=gen(0))
    g = vomod.StepGraphs(vo)
    imgs = torch.from_numpy(np.stack(frames[3:7]))
    draws = [vo.step_draws(gen(i)) for i in range(3, 7)]
    rows = torch.empty((4, vo.outputs[True].nbytes), dtype=torch.uint8)
    s = g.step(s0, imgs[0], draws[0], vo.ba_due(s0), rows[0], True)
    s.host_frame = s0.host_frame + 1
    flags = vo.ba_flags(s, 3)
    s = g.chunk(s, imgs[1:4], draws[1:4], flags, rows[1:4], True)
    e = vo._step_impl(s0, imgs[0], draws[0], vo.ba_due(s0))
    e = vo._chunk_impl(e, imgs[1:4], draws[1:4], flags)
    assert all(torch.equal(a, b) for a, b in zip(s.tensors(), e.tensors()))
    assert set(g.bodies) == set(g.graphs) and len(g.bodies) == 2
    kept = g.bufs[None].state.clone()
    maps = g.stage_map()
    assert set(maps) == set(g.graphs) and all(m == [] for m in maps.values())
    assert torch.equal(kept, g.bufs[None].state)
    spans.start()  # stage_map turned its recording off
    assert spans.stop() == []


class FakeEvent:
    """A ``kineto_results.events()`` entry, as much of it as
    ``trace_events`` reads."""

    def __init__(self, name, device, start, end, corr, ua=False, stream=7):
        self._v = (name, device, start, end, corr, ua, stream)

    def name(self):
        return self._v[0]

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._v[1]
                else torch.autograd.DeviceType.CPU)

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]

    def device_resource_id(self):
        return self._v[6]


E = FakeEvent
# Two op-by-op runs of a body with the spans mirrored: each range, an
# operator and the runtime calls and device events they queued.
FAKE = [
    E("stage.klt", False, 0, 50_000, 1, ua=True),  # the first run
    E("aten::mean", False, 10_000, 20_000, 2),
    E("cudaLaunchKernel", False, 12_000, 14_000, 900),
    E("reduce", True, 15_000, 16_000, 900),
    E("stage.klt", False, 100_000, 150_000, 3, ua=True),  # the second run
    E("stage.klt", True, 110_000, 120_000, 3, ua=True),  # its shadow
    E("aten::mean", False, 105_000, 120_000, 4),
    E("cudaLaunchKernel", False, 110_000, 112_000, 901),
    E("reduce", True, 113_000, 114_000, 901),
    E("stage.pnp", False, 150_000, 200_000, 5, ua=True),
    E("cudaMemcpyAsync", False, 160_000, 161_000, 902),
    E("Memcpy DtoD (Device -> Device)", True, 162_000, 163_000, 902,
      stream=9),
    E("cudaLaunchKernel", False, 210_000, 211_000, 903),  # no stage
    E("orphan", True, 212_000, 213_000, 903),
    E("lost", True, 214_000, 215_000, 904),  # no runtime call
]


def test_trace_events_links_each_device_event_to_its_call():
    """Each device event to the runtime call with its correlation id, on
    the trace's axis in us; ranges kept on the host, their device shadows
    left out, and an event with no call unlinked."""
    events, links, streams = spans.trace_events(FAKE, t0_ns=100_000)
    assert len(events) == len(FAKE) - 1
    assert events[0] == ("range", "stage.klt", -100.0, -50.0)
    assert events[1][0] == "host" and events[3][0] == "device"
    named = {events[d][1]: events[h][1] for d, h in links.items()}
    assert named == {"reduce": "cudaLaunchKernel",
                     "Memcpy DtoD (Device -> Device)": "cudaMemcpyAsync",
                     "orphan": "cudaLaunchKernel"}
    assert sum(e[0] == "device" for e in events) == len(links) + 1
    lost = next(d for d, e in enumerate(events) if e[1] == "lost")
    assert lost not in links and streams[lost] == 7
    copy = next(d for d, e in enumerate(events) if e[1].startswith("Memcpy"))
    assert streams[copy] == 9


def test_device_stages_reads_each_op_of_the_second_run():
    """A device event takes the stage range around the runtime call that
    queued it; events queued before ``after_us`` are left out, one with no
    call stays in with no stage, and copies and fills go by their kind (a
    graph runs a copy as a kernel)."""
    from monocular_visual_odometry_va4mr_torch.pipeline.vo import (
        device_stages, op_kind)

    events, links, _ = spans.trace_events(FAKE)
    assert device_stages(events, links, 100.0) == [
        ("reduce", "stage.klt"), ("memcpy", "stage.pnp"),
        ("orphan", None), ("lost", None)]
    assert device_stages(events, links)[0] == ("reduce", "stage.klt")
    assert op_kind("memcpy32_post") == op_kind(
        "Memcpy DtoD (Device -> Device)") == "memcpy"
    assert op_kind("Memset (Device)") == "memset"
    assert op_kind("void klt_lk_kernel<15, false>") == (
        "void klt_lk_kernel<15, false>")
