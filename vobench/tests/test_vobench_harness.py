"""The benchmark's harness on the CPU: every cell through the one command
at a tiny size, cells found by name from their files, a cell with a new
driver added by files and entries alone, the trace arithmetic on a fake
profiler, the frozen roofline against ``chip_smoke.py``'s, and what the
runs and the sources may not touch."""
import argparse
import ast
import json
import shutil
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from vobench import cell as cellmod, drivers, run
from vobench.reference import roofline, trace as tr

ROOT = Path(__file__).resolve().parents[2]
VB = ROOT / "vobench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
E2E = {m["name"]: m for m in BENCH["end_to_end"]}


def _tiny_run(name, trace=0, seed=2 ** 31 + 7):
    out = subprocess.run(
        [sys.executable, "-m", "vobench.tests.tiny", name, str(seed),
         str(trace)], cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    return out


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_runs_the_one_command_on_the_cpu(name):
    out = _tiny_run(name)
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "forbidden []", lines[-1]  # no jax, no JAX package
    res = json.loads(lines[-2])
    assert list(res)[:4] == ["correct", "attempted", "failed", "metrics"]
    assert list(res)[-1] == "check"
    assert isinstance(res["correct"], bool) and res["attempted"] > 0
    assert res["device"]["count"] == 1
    cell = cellmod.load(name)
    want = {m["name"] for m in cell.end_to_end}
    got = set(res["metrics"])
    assert got == want, (want, got)
    for m in cell.end_to_end:
        if m["name"] in got:
            v = res["metrics"][m["name"]]
            assert v["unit"] == m["unit"] and np.isfinite(v["value"])
    assert set(res["check"]) == set(cell.limits)
    for c in res["check"].values():
        assert set(c) == {"value", "limit"}
    err = out.stderr.strip().splitlines()
    assert [ln.split()[1] for ln in err[-len(cell.limits):]] == list(
        cell.limits)


def test_a_traced_run_reports_the_per_layer_metrics_it_finds():
    """On the CPU nothing runs on a device: the trace readers find nothing
    and leave their metrics out; the host-clock one reads."""
    out = _tiny_run("kitti05.live", trace=1)
    res = json.loads(out.stdout.strip().splitlines()[-2])
    names = {m["name"] for m in cellmod.load("kitti05.live").per_layer}
    assert set(res["metrics"]) <= names
    assert "device_idle_pct.live" not in res["metrics"]
    assert res["device"]["busy_s"] == 0.0


def test_no_card_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(ROOT)
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_cells_are_found_by_name_from_their_files():
    for name in CELLS:
        c = cellmod.load(name, ROOT)
        w = next(w for w in BENCH["workloads"] if w["name"] == name)
        assert c.config["name"] == w["config"]
        assert (VB / "drivers" / f"{c.traffic['driver']}.py").is_file()
        assert callable(cellmod.driver(c.traffic["driver"]))
        assert cellmod.pipeline_config(c.config["pipeline"]) is not None
        for m in c.end_to_end + c.per_layer:
            assert callable(cellmod.reader(m["name"]))
    for conf in BENCH["configs"]:
        assert (ROOT / conf["file"]).is_file()
        assert json.loads((ROOT / conf["file"]).read_text())["name"] == \
            conf["name"]


NEW_DRIVER = '''"""The stream driver, each pass's index written to the mix's log."""
from vobench import cell

Stream = cell.driver("stream")


class Driver(Stream):
    def run_pass(self, index):
        with open(self.t["log"], "a") as f:
            f.write(f"{index}\\n")
        return super().run_pass(index)
'''


def test_a_config_a_mix_a_driver_and_a_metric_are_added_by_files_alone(
        tmp_path):
    """A new configuration, a mix with a new driver, a metric and a cell,
    each a file and an entry, and the cell run through the harness at the
    tiny size on the CPU: the new driver and the new metric are found by
    name."""
    from vobench.tests import tiny

    files = tmp_path / "vb"
    for d in ("configs", "traffic", "limits", "metrics", "drivers"):
        shutil.copytree(VB / d, files / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    conf = json.loads((VB / "configs" / "kitti05.json").read_text())
    conf["name"] = "kitti05_wide"
    (files / "configs" / "kitti05_wide.json").write_text(json.dumps(conf))
    (files / "drivers" / "logged.py").write_text(NEW_DRIVER)
    mix = json.loads((VB / "traffic" / "offline.json").read_text())
    mix.update(driver="logged", block=32, log=str(tmp_path / "passes.log"))
    (files / "traffic" / "logged32.json").write_text(json.dumps(mix))
    (files / "limits" / "kitti05_wide.logged32.json").write_text(
        (VB / "limits" / "kitti05.offline.json").read_text())
    (files / "metrics" / "passes_run.py").write_text(
        "def read(ctx):\n    return float(ctx.passes)\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append(dict(
        name="kitti05_wide.logged32", config="kitti05_wide",
        traffic="logged32", chips=1, why="a test cell"))
    bench["per_layer"].append(dict(
        name="passes_run", unit="passes", better="higher",
        source="host_clock", layer="driver loop", moves="frames_per_s",
        workloads=["kitti05_wide.logged32"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    c = cellmod.load("kitti05_wide.logged32", tmp_path, files)
    assert c.traffic["block"] == 32 and c.config["name"] == "kitti05_wide"
    assert [m["name"] for m in c.per_layer][-1] == "passes_run"
    with pytest.raises(KeyError):
        cellmod.load("no_such.cell", tmp_path, files)
    res, info = run.run(tiny.tiny(c), 2 ** 31 + 9, 0.0, 1, "cpu", workers=2)
    logged = (tmp_path / "passes.log").read_text().split()
    assert logged == [str(drivers.SETUP)] + [str(k) for k in range(
        info["window"]["passes"])]
    assert res["metrics"]["passes_run"]["value"] == info["window"]["passes"]


def test_lost_frames_are_counted_apart_from_the_ate():
    from vobench.reference import check

    sc = types.SimpleNamespace(poses_WC=np.tile(np.eye(4), (6, 1, 1)))
    sc.poses_WC[:, 2, 3] = np.arange(6.0)  # 1 m a frame along z
    T = np.linalg.inv(sc.poses_WC)
    good = check.Pass(ids=np.arange(6), T_CW=T, status=np.zeros(6, int))
    lost = check.Pass(ids=np.arange(6), T_CW=T,
                      status=np.array([0, 0, 0, 1, 1, 0]), index=1)
    vals, _ = check.numbers(sc, [good, lost], 0, 1)
    assert vals["lost_pct"] == pytest.approx(100 * 2 / 12)
    assert vals["ate_pct_median"] == pytest.approx(0.0, abs=1e-9)
    assert vals["gate_fail_pct"] == 0.0


def test_pipeline_config_refuses_unknown_or_missing_keys():
    spec = json.loads((VB / "configs" / "kitti05.json").read_text())
    pipe = spec["pipeline"]
    cfg = cellmod.pipeline_config(pipe)
    assert cfg.ba.every == 8 and cfg.image_shape == (376, 1241)
    bad = json.loads(json.dumps(pipe))
    bad["klt"]["num_itres"] = 3
    with pytest.raises(ValueError):
        cellmod.pipeline_config(bad)
    del bad["klt"]["num_itres"], bad["ba"]["every"]
    with pytest.raises(ValueError):
        cellmod.pipeline_config(bad)


def test_pass_seeds_are_31_bit_and_part_by_seed_and_pass():
    big = 2 ** 31 + 12345
    seeds = {drivers.pass_seed(s, p) for s in (0, 1, big, 2 ** 40)
             for p in range(50)}
    assert len(seeds) == 200 and all(0 <= s < 2 ** 31 for s in seeds)
    assert drivers.pass_seed(big, 3) == drivers.pass_seed(big, 3)


# --- the trace arithmetic on a fake profiler ---------------------------------

FAKE = [
    ("host", "cudaGraphLaunch", 0.0, 5.0),
    ("host", "cudaMemcpyAsync", 40.0, 42.0),
    ("host", "cudaLaunchKernel", 50.0, 51.0),
    ("host", "aten::copy_", 39.0, 60.0),
    ("host", "cudaStreamSynchronize", 61.0, 90.0),
    ("host", "aten::empty", 10.0, 11.0),
    ("device", "kernel_a", 5.0, 25.0),
    ("device", "kernel_b", 20.0, 30.0),  # overlaps a: counted once in busy
    ("device", "Memcpy HtoD", 42.0, 45.0),
    ("device", "kernel_a", 52.0, 60.0),
]


def test_union_idle_share_dispatches_and_device_time_on_a_fake_trace():
    win = (0.0, 100.0)
    assert tr.dispatches(FAKE) == 3
    assert tr.device_us(FAKE) == 20 + 10 + 3 + 8
    assert tr.busy_intervals(FAKE) == [(5.0, 30.0), (42.0, 45.0),
                                       (52.0, 60.0)]
    assert tr.busy_us(FAKE, win) == 25 + 3 + 8
    assert tr.idle_share(FAKE, win) == pytest.approx(1 - 36 / 100)
    assert tr.busy_us(FAKE, (10.0, 50.0)) == 20 + 3
    assert tr.top_device_ops(FAKE) == [["kernel_a", 28e-6],
                                       ["kernel_b", 10e-6],
                                       ["Memcpy HtoD", 3e-6]]
    gaps = dict(tr.idle_gaps(FAKE, win))
    # 0-5 under the graph launch, 30-42 under nothing but aten::copy_ at
    # its end, 45-52 under aten::copy_, 60-100 under the sync.
    assert gaps == pytest.approx({"cudaGraphLaunch": 5e-6,
                                  "no host call": 12e-6,
                                  "aten::copy_": 7e-6,
                                  "cudaStreamSynchronize": 40e-6})


def test_the_trace_readers_on_a_fake_trace():
    ctx = types.SimpleNamespace(
        trace=types.SimpleNamespace(events=FAKE, window=(0.0, 100.0),
                                    frames=4),
        config=json.loads((VB / "configs" / "kitti05.json").read_text()),
        traffic=json.loads((VB / "traffic" / "offline.json").read_text()))
    assert cellmod.reader("dispatches_per_frame")(ctx) == 0.75
    assert cellmod.reader("device_ms_per_frame")(ctx) == pytest.approx(
        41e-3 / 4)
    assert cellmod.reader("device_idle_pct")(ctx) == pytest.approx(64.0)
    assert cellmod.reader("klt_lk.roofline_pct")(ctx) is None  # no call
    ev = FAKE + [("device", "void klt_lk_kernel<15, false>(...)", 70.0,
                  78.5)]
    ctx.trace.events = ev
    want = 100 * roofline.call_bound_ms(1024) / (8.5e-3)
    assert cellmod.reader("klt_lk.roofline_pct")(ctx) == pytest.approx(want)
    ctx.trace = None
    for m in ("dispatches_per_frame", "device_ms_per_frame",
              "device_idle_pct", "klt_lk.roofline_pct"):
        assert cellmod.reader(m)(ctx) is None


def test_ba_frame_extra_and_latency_readers():
    ctx = types.SimpleNamespace(latency_ms=[5.0, 5.0, 9.0, 5.0, 7.0, 5.0],
                                ba_flags=[False, False, True, False, True,
                                          False])
    assert cellmod.reader("ba_frame_extra_ms.live")(ctx) == 3.0
    assert cellmod.reader("frame_latency_p95_ms")(ctx) == pytest.approx(
        float(np.percentile(ctx.latency_ms, 95)))
    ctx.ba_flags = [False] * 6
    assert cellmod.reader("ba_frame_extra_ms.live")(ctx) is None


def test_the_frozen_bound_equals_chip_smokes_on_its_cases():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    rng = np.random.default_rng(0)
    for n, in_row in ((1024, 33), (4096, 33), (1024, 20), (512, 33)):
        iters = rng.integers(0, 9, n)
        assert roofline.bound_ms(n, iters, in_row, 20) == \
            chip_smoke.bound_ms(n, iters, in_row, 20)
    assert roofline.PEAK_BYTES_S == chip_smoke.PEAK_BYTES_S
    assert roofline.PEAK_F32_FLOPS == chip_smoke.PEAK_F32_FLOPS
    # The bound from shapes counts no iteration: a lower bound.
    assert roofline.call_bound_ms(1024) <= chip_smoke.bound_ms(
        1024, np.full(1024, 6), 33, 20)[0]


# --- what the runs and the sources may not touch -----------------------------

def _sources():
    """The harness's files (the tests, which name what they look for, and
    the cache left out)."""
    return sorted(p for p in VB.rglob("*.py")
                  if "cache" not in p.parts and "tests" not in p.parts)


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _strings(tree):
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)):
                docs.add(id(body[0].value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


def test_no_source_imports_jax_or_reads_the_jax_sides_records():
    for path in _sources():
        tree = ast.parse(path.read_text())
        for mod in _imports(tree):
            top = mod.partition(".")[0]
            assert top not in run.FORBIDDEN, (path, mod)
            assert not mod.startswith(
                "monocular_visual_odometry_va4mr_torch.tools"), (path, mod)
        for s in _strings(tree):
            for bad in ("bench.py", "tools/", "BENCH_", "MULTICHIP_"):
                assert bad not in s, (path, s)


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((VB / "reference").glob("*.py")):
        for mod in _imports(ast.parse(path.read_text())):
            assert mod.partition(".")[0] in {
                "numpy", "dataclasses", "typing", "collections",
                "__future__"}, (path, mod)


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_like", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules,
                        "monocular_visual_odometry_va4mr_tpu_extra",
                        types.ModuleType("x"))
    assert run.forbidden_modules() == [] or "jax" in sys.modules
    monkeypatch.setitem(sys.modules, "jaxlib.xla", types.ModuleType("x"))
    assert "jaxlib" in run.forbidden_modules()


def test_the_one_command_parses_the_drivers_arguments():
    a = run.parse(["--workload", "kitti05.live", "--seed", str(2 ** 33),
                   "--seconds", "20", "--trace", "1"])
    assert a == argparse.Namespace(workload="kitti05.live", seed=2 ** 33,
                                   seconds=20.0, trace=1)


# --- the planted faults -----------------------------------------------------

def test_a_planted_fault_is_switched_off_again():
    from monocular_visual_odometry_va4mr_torch.pipeline import vo as vomod

    from vobench import control

    body = vomod.VisualOdometry._step_body
    for kind in ("frozen", "altered"):
        undo = control.plant(kind)
        assert vomod.VisualOdometry._step_body is not body
        undo()
        assert vomod.VisualOdometry._step_body is body
    with pytest.raises(ValueError):
        control.plant("no_such_fault")


def test_a_frozen_step_fails_every_pass_on_the_cpu():
    from vobench import control
    from vobench.tests import tiny

    line, = control.run_kind(tiny.tiny(cellmod.load("kitti05.offline")),
                             "frozen", [11], 0.0, device="cpu", workers=2)
    assert line["check"]["gate_fail_pct"]["value"] == 100.0  # every pass
    assert line["correct"] is False


def test_no_result_from_a_directory_of_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(VB, tmp_path / "vobench",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "vobench.run", "--workload", CELLS[0],
         "--seed", "5", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and '"correct"' not in out.stdout
