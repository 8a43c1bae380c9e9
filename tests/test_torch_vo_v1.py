"""The slice with the v1 tracker (``klt.backend="pallas"``): the port's KLT
bootstrap and per-frame step (with in-step BA) against the JAX pipeline on
the CPU, the reference's ``klt_pallas.track_features_pallas`` and
``klt_pallas2.track_multilevel`` patched to interpret mode.

Scene, config and RANSAC draws are those of ``tests/test_torch_vo.py``
(``slice_runs``).  Tolerances: about 1 feature in 8 meets the reference
kernel's template row wrap (ROADMAP.md Queue 3), which moves its tracked
position by up to a few tenths of a pixel (``tests/test_torch_klt_v1.py``),
so the poses are held to the "tracks differ" tolerances of the pallas2
slice test: 0.5 deg, 5e-2 in translation (|t| = 1 at the bootstrap) and
0.5 for BA landmarks valid in both (measured: 0.02 deg, 2e-3, the same
track counts).  Masks agree on >= 97% of slots, status is equal, PnP inlier
counts within 3% (+1).
"""
import numpy as np
import pytest

from test_torch_vo import (LM_TOL_TRACK_DIFF, MASK_AGREE, N_STEPS,
                           ROT_TOL_TRACK_DIFF_DEG, T_TOL_TRACK_DIFF, rot_deg,
                           slice_runs)


@pytest.fixture(scope="module")
def runs_v1():
    return slice_runs("pallas")


def assert_states_agree(j, t):
    assert int(j["status"]) == int(t["status"])
    assert abs(int(j["n_tracked"]) - int(t["n_tracked"])) <= 1
    assert rot_deg(j["T_CW"], t["T_CW"]) < ROT_TOL_TRACK_DIFF_DEG
    np.testing.assert_allclose(t["T_CW"][:3, 3], j["T_CW"][:3, 3],
                               atol=T_TOL_TRACK_DIFF)
    for name in ("lm_valid", "cand_valid"):
        assert np.mean(j[name] == t[name]) >= MASK_AGREE, name
    assert abs(int(j["n_inliers"]) - int(t["n_inliers"])) <= (
        0.03 * int(j["n_inliers"]) + 1)


def test_v1_bootstrap_matches_reference(runs_v1):
    j, t = runs_v1["j_boot"], runs_v1["t_boot"]
    assert int(j["status"]) == 0, "reference bootstrap failed on the scene"
    assert_states_agree(j, t)
    assert j["lm_valid"].sum() >= 8


@pytest.mark.parametrize("k", range(N_STEPS))
def test_v1_step_matches_reference(runs_v1, k):
    j, t = runs_v1["j_steps"][k], runs_v1["t_steps"][k]
    assert int(t["frame_idx"]) == int(j["frame_idx"]) == 2 + k
    assert_states_agree(j, t)


def test_v1_in_step_ba_ran(runs_v1):
    """Frame 4 is the only BA trigger; the ring and the map agree with the
    reference's after it."""
    calls = runs_v1["ba_calls"]
    assert calls == [[], [], [calls[-1][0]]] and calls[-1][0] >= 8
    j, t = runs_v1["j_steps"][-1], runs_v1["t_steps"][-1]
    for a, b in zip(j["ba_T"], t["ba_T"]):
        assert rot_deg(a, b) < ROT_TOL_TRACK_DIFF_DEG
        np.testing.assert_allclose(b[:3, 3], a[:3, 3], atol=T_TOL_TRACK_DIFF)
    both = j["lm_valid"] & t["lm_valid"]
    np.testing.assert_allclose(t["lm_xyz"][both], j["lm_xyz"][both], rtol=0,
                               atol=LM_TOL_TRACK_DIFF)
