"""The port's diagnostics (``diag_e2e``, ``diag_drift``, ``diag_survival``,
``exp_ate``) on the CPU at small sizes, against the JAX side's scripts.

Each prints its fields as JSON lines (the JAX scripts print text rows of
the same quantities).  ``diag_survival`` on the ``xla`` tracker is held
against ``tools/diag_survival.py`` on the same scene (textured, seed 11,
120x160, corners at frame 2, 4 hops): the start count and every hop's
``alive``, ``fwd_ok``, ``back_ok`` and ``fb_pass`` counts equal exactly
(the two gather trackers agree to ~1e-4 px, far inside every gate on this
scene), the median round trip to the JAX script's printed 2 decimals.  On the CPU the ``pallas2``
chain runs the kernel's plain version: its counts are printed, not held.
"""
import dataclasses
import importlib.util
import json
import pathlib
import re

import pytest
import torch

from monocular_visual_odometry_va4mr_torch.core import config as tconfig
from monocular_visual_odometry_va4mr_torch.dataio import synthetic as tsyn
from monocular_visual_odometry_va4mr_torch.tools import (
    bench, diag_drift, diag_e2e, diag_survival, exp_ate, harness)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SMALL = (120, 160)


def lines(capsys):
    return [json.loads(s) for s in capsys.readouterr().out.splitlines()
            if s.startswith("{")]


def jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def narrow(preset):
    """``preset`` with 256-slot tables and 300 corners: the CPU's size."""
    def cfg():
        c = preset()
        return c.replace(
            capacity=dataclasses.replace(c.capacity, max_landmarks=256,
                                         max_candidates=256),
            detector=dataclasses.replace(c.detector, max_corners=300))
    return cfg


@pytest.fixture
def small(monkeypatch, tmp_path):
    monkeypatch.setattr(harness, "BUILD", tmp_path / "build")
    monkeypatch.setattr(tsyn, "SCENE_CACHE", tmp_path / "scene_cache")
    monkeypatch.setattr(harness, "render_frames",
                        lambda scene, n: [scene.render(i) for i in range(n)])
    for name in ("parking", "kitti"):
        monkeypatch.setitem(tconfig.PRESETS, name,
                            narrow(tconfig.PRESETS[name]))
    monkeypatch.setattr(tconfig, "kitti_config", narrow(tconfig.kitti_config))
    torch.set_num_threads(2)
    return tmp_path


E2E_SUMMARY = {"scene", "backend", "frames", "lost", "finite", "ate_rmse",
               "fps"}  # tools/diag_e2e.py:77-79
FRAME_KEYS = {"frame", "status", "n_inliers", "n_tracked"}


@pytest.mark.parametrize("backend", ["pallas2", "xla"])
def test_diag_e2e_lines(small, capsys, backend):
    """The default tracker (``pallas2``: on the CPU the kernel's plain
    version) and the gather tracker."""
    assert diag_e2e.main(["--device", "cpu", "--frames", "12", "--height",
                          str(SMALL[0]), "--width", str(SMALL[1]),
                          "--backend", backend]) == 0
    out = lines(capsys)
    frames, summary = out[:-1], out[-1]
    assert E2E_SUMMARY <= set(summary)
    assert summary["backend"] == summary["tracker"] == backend
    assert summary["frames"] == len(frames) == 12 - 4
    assert [r["frame"] for r in frames] == list(range(4, 12))
    for r in frames:
        assert FRAME_KEYS <= set(r)
    assert summary["lost"] == sum(1 for r in frames if r["status"])
    assert summary["klt_lk_launches"] == summary["klt_v1_launches"] == 0
    assert summary["device"] == "cpu"


def test_diag_e2e_quiet_prints_the_summary_alone(small, capsys):
    assert diag_e2e.main(["--device", "cpu", "--frames", "8", "--height",
                          str(SMALL[0]), "--width", str(SMALL[1]),
                          "--backend", "xla", "--quiet", "--scene",
                          "blob"]) == 0
    (summary,) = lines(capsys)
    assert summary["scene"] == "blob" and summary["frames"] == 4


DRIFT_KEYS = {"frame", "lm", "inl", "cand", "promo", "old", "ang_ok", "st",
              "pose_err", "step", "lm_gt_reproj_med", "lm_gt_reproj_p90",
              "zmed"}  # tools/diag_drift.py:96-102


def test_diag_drift_lines(small, capsys):
    assert diag_drift.main(["--device", "cpu", "--frames", "12", "--height",
                            str(SMALL[0]), "--width", str(SMALL[1])]) == 0
    out = lines(capsys)
    boot, rows = out[0], out[1:]
    assert boot["bootstrap"] and boot["tracker"] == "xla"
    assert boot["scale"] == pytest.approx(4.0, rel=1e-3)  # 4 frames, ~1 m
    assert [r["frame"] for r in rows] == list(range(5, 12))
    for r in rows:
        assert DRIFT_KEYS <= set(r) and r["device"] == "cpu"
    assert rows[0]["step"] is None and rows[1]["step"] > 0
    assert all(r["pose_err"] >= 0 for r in rows)


HOP = re.compile(r"hop (\d+): alive=\s*(\d+) fwd_ok=\s*(\d+) "
                 r"back_ok=\s*(\d+) fb<[\d.]+px=\s*(\d+) fb_med=([\d.na]+)")


def test_diag_survival_matches_the_jax_script(small, monkeypatch, capsys):
    from monocular_visual_odometry_va4mr_tpu.dataio import synthetic as jsyn

    kw = dict(f0=2, hops=4, image_shape=SMALL, num_frames=8, backend="xla")
    # The JAX script caches its frames under /tmp; render them here.
    monkeypatch.setattr(jsyn, "render_all_cached", lambda scene, tag: [
        scene.render(i) for i in range(scene.num_frames)])
    jax_tool("diag_survival").main(**kw)
    text = capsys.readouterr().out
    start = int(re.search(r"start: (\d+) corners", text).group(1))
    ref = [tuple(int(g) for g in m.groups()[:5]) + (float(m.group(6)),)
           for m in HOP.finditer(text)]
    assert len(ref) == 4
    rows = diag_survival.survival(**kw, device="cpu")
    assert rows[0]["start"] == start and rows[0]["tracker"] == "xla"
    for (h, alive, fwd, back, fb, med), r in zip(ref, rows[1:]):
        assert (r["hop"], r["alive"], r["fwd_ok"], r["back_ok"],
                r["fb_pass"]) == (h, alive, fwd, back, fb)
        assert r["fb_med"] == pytest.approx(med, abs=5e-3)
    assert rows[-1]["fb_pass"] > 0.5 * start


def test_diag_survival_lines(small, monkeypatch, capsys):
    """The default tracker: the multilevel chain, on the CPU the plain
    version of the kernel."""
    monkeypatch.setattr(diag_survival, "IMAGE_SHAPE", SMALL)
    monkeypatch.setattr(diag_survival, "NUM_FRAMES", 8)
    assert diag_survival.main(["--device", "cpu", "--hops", "2",
                               "--f0", "2"]) == 0
    out = lines(capsys)
    assert out[0]["tracker"] == "ml-pallas2" and out[0]["start"] > 0
    assert out[0]["klt_lk_launches"] == 0
    assert [r["hop"] for r in out[1:]] == [0, 1]
    for r in out[1:]:
        assert {"alive", "fwd_ok", "back_ok", "fb_pass", "fb_med"} <= set(r)
        assert r["fb_pass"] <= r["back_ok"] <= r["fwd_ok"] <= r["alive"]


def test_exp_ate_lines(small, monkeypatch, capsys):
    monkeypatch.setattr(bench, "NUM_FRAMES", 16)
    monkeypatch.setattr(bench, "IMAGE_SHAPE", SMALL)
    monkeypatch.setattr(exp_ate, "REPS", 1)
    assert exp_ate.main(["--device", "cpu", "base", "ba4"]) == 0
    out = lines(capsys)
    assert [r["variant"] for r in out] == ["base", "ba4"]
    for r in out:
        assert {"variant", "ate", "lost", "fps"} <= set(r)
        assert r["tracker"] == "xla" and r["klt_lk_launches"] == 0
        assert r["device"] == "cpu"


def test_exp_ate_variants_are_the_jax_scripts():
    """Every JAX variant is here and changes the same fields the same way."""
    from monocular_visual_odometry_va4mr_tpu.core import config as jconfig

    jax = jax_tool("exp_ate")
    assert set(exp_ate.VARIANTS) == set(jax.VARIANTS)
    tbase, jbase = tconfig.kitti_config(), jconfig.kitti_config()
    for name in jax.VARIANTS:
        t, j = exp_ate.VARIANTS[name](tbase), jax.VARIANTS[name](jbase)
        for part in ("ba", "klt", "capacity", "detector", "landmarks", "pnp"):
            assert (dataclasses.asdict(getattr(t, part))
                    == dataclasses.asdict(getattr(j, part))), (name, part)
