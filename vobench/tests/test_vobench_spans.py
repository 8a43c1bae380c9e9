"""The span arithmetic (``reference/spans.py``) on a fake traced pass, as
``test_vobench_harness.py`` holds ``reference/trace.py`` on a fake
profiler: a block with a chunk replay and a step replay, the host's own
work between them, a bootstrap, and the profiler's buffer flush."""
import pytest

from vobench.reference import spans as sp

CHUNK = ("chunk", "uint8", (False, True), "pallas2", False)
STEP = ("uint8", False, "pallas2", False, None)

# (id, parent, name, start_us, end_us, attrs), as spantrace.on_axis gives.
SPANS = [
    (0, -1, "stream.block", 0.0, 100.0, {"block": 0, "frames": 3}),
    (1, 0, "vo.chunk", 2.0, 20.0, {"K": 2, "ba": (False, True)}),
    (2, 1, "graph.replay", 5.0, 10.0, {"key": CHUNK, "segments": 1}),
    (3, 0, "vo.step", 40.0, 55.0, {"ba": False}),
    (4, 3, "graph.replay", 42.0, 46.0, {"key": STEP, "segments": 1}),
    (5, 0, "stream.readback", 60.0, 70.0, {}),
    (6, -1, "vo.bootstrap", 110.0, 130.0, {}),
    (7, 6, "graph.replay", 112.0, 115.0, {"key": ("hop",)}),
]

EVENTS = [
    ("host", "cudaGraphLaunch", 6.0, 8.0),  # 0: the chunk
    ("device", "klt", 8.0, 12.0),  # 1
    ("device", "pnp", 12.0, 18.0),  # 2
    ("device", "ba", 18.0, 21.0),  # 3
    ("host", "cudaGraphLaunch", 43.0, 44.0),  # 4: the step
    ("device", "klt", 44.0, 46.0),  # 5
    ("device", "pnp", 46.0, 50.0),  # 6
    ("host", "cudaMemcpyAsync", 61.0, 62.0),  # 7: the read-back
    ("device", "Memcpy DtoH", 62.0, 64.0),  # 8
    ("host", "Buffer Flush", 80.0, 95.0),  # 9: the profiler's
    ("host", "cudaGraphLaunch", 113.0, 114.0),  # 10: the hop
    ("device", "hop", 114.0, 120.0),  # 11
    ("host", "cudaGraphLaunch", 200.0, 201.0),  # 12: outside every replay
    ("device", "orphan", 201.0, 202.0),  # 13
]
LINKS = {1: 0, 2: 0, 3: 0, 5: 4, 6: 4, 8: 7, 11: 10, 13: 12}
MAPS = {CHUNK: [("klt", "stage.klt"), ("pnp", "stage.pnp"),
                ("ba", "stage.ba")],
        STEP: [("klt", "stage.klt"), ("pnp", "stage.pnp")]}
WINDOW = (0.0, 210.0)


TOL = 20.0  # us: how far a host stamp may sit from the profiler's


def test_innermost_span_of_each_time():
    got = sp.innermost_names(SPANS, [1.0, 7.0, 30.0, 43.0, 105.0, 113.0])
    assert got == ["stream.block", "graph.replay", "stream.block",
                   "graph.replay", None, "graph.replay"]


def test_idle_gaps_by_program_span():
    idle = sp.idle_by_span(EVENTS, WINDOW, SPANS)
    # 0-8 under the chunk's vo.chunk span, 21-44 and 50-62 in the block,
    # 64-114: its middle 89 under the profiler's flush, 120-201: middle
    # 160.5 under no span, 202-210 the same.
    assert idle == pytest.approx({"vo.chunk": 8.0,
                                  "stream.block": 23.0 + 12.0,
                                  "profiler": 50.0, "no span": 81.0 + 8.0})


def test_device_time_by_span_and_launches_outside():
    dev = sp.device_by_span(EVENTS, LINKS, SPANS)
    assert dev == pytest.approx({"graph.replay": 13.0 + 6.0 + 6.0,
                                 "stream.readback": 2.0, "no span": 1.0})
    assert sp.launches_outside(EVENTS, SPANS, TOL) == 1
    assert sp.device_inside(EVENTS, LINKS, SPANS, "vo.bootstrap") == (
        pytest.approx(6.0), 1)


def test_stage_split_and_an_unstaged_replay():
    split = sp.stage_split(EVENTS, LINKS, SPANS, MAPS, tol=TOL)
    assert split["stage_us"] == pytest.approx(
        {"stage.klt": 6.0, "stage.pnp": 10.0, "stage.ba": 3.0})
    assert split["replay_us"] == split["extent_us"] == pytest.approx(19.0)
    assert (split["staged"], split["unstaged"], split["frames"]) == (2, 0, 3)
    assert split["ba_frames"] == 1 and split["unlinked_us"] == 0.0
    # The step's map one name short: that replay is unstaged, and says
    # where it parts.
    maps = {**MAPS, STEP: MAPS[STEP][:1]}
    split = sp.stage_split(EVENTS, LINKS, SPANS, maps, tol=TOL)
    assert (split["staged"], split["unstaged"]) == (1, 1)
    assert split["differ"] == [[str(STEP), 2, 1, 1, ["pnp"], [],
                                [("pnp", 1)], []]]
    assert split["replay_us"] == pytest.approx(19.0)


def test_the_stages_against_the_replays_extent():
    """A device event the links miss inside a replay's extent shows as the
    extent's surplus over the stages, and in ``unlinked_us``; one on
    another stream does not; names compare through ``kind``."""
    events = EVENTS + [("device", "lost", 15.0, 16.0),
                       ("device", "other", 9.0, 11.0)]
    streams = {d: 0 for d, e in enumerate(EVENTS) if e[0] == "device"}
    streams.update({len(EVENTS): 0, len(EVENTS) + 1: 1})
    split = sp.stage_split(events, LINKS, SPANS, MAPS, tol=TOL,
                           streams=streams)
    assert split["staged"] == 2
    assert sum(split["stage_us"].values()) == pytest.approx(19.0)
    assert split["extent_us"] == pytest.approx(20.0)
    assert split["unlinked_us"] == pytest.approx(1.0 + 2.0)
    upper = {k: [(n.upper(), st) for n, st in v] for k, v in MAPS.items()}
    split = sp.stage_split(EVENTS, LINKS, SPANS, upper, tol=TOL,
                           kind=str.upper)
    assert (split["staged"], split["unstaged"]) == (2, 0)


def test_the_five_numbers():
    m = sp.metrics(EVENTS, WINDOW, LINKS, SPANS, MAPS, frames=3, tol=TOL)
    assert m == pytest.approx(dict(
        pnp_device_ms_per_frame=10.0 / 1e3 / 3,
        ba_branch_device_ms=3.0 / 1e3,
        driver_idle_ms_per_frame=35.0 / 1e3 / 3,
        runner_idle_ms_per_frame=None,
        bootstrap_device_ms=6.0 / 1e3))
