"""The slice with the v1 tracker (``klt.backend="pallas"``): the port's KLT
bootstrap and per-frame step (with in-step BA) against the JAX pipeline on
the CPU, the reference's ``klt_pallas.track_features_pallas`` and
``klt_pallas2.track_multilevel`` patched to interpret mode.

Scene, config and RANSAC draws are those of ``tests/test_torch_vo.py``
(``slice_runs``).  The port's v1 tracker reads the template rows and columns
the reference kernel's rolls read, so the two packages track the same
features, and every step is held to the "same tracks" tolerances of the
``pallas2`` slice test: 0.01 deg, 1e-3 in translation (|t| = 1 at the
bootstrap) and 1e-3 for BA landmarks valid in both, with equal tracked
counts, landmark and candidate masks and status (measured: 3.5e-4 deg,
4e-5, 4e-4), PnP inlier counts within 3% (+1) (measured: equal).
"""
import numpy as np
import pytest

from test_torch_vo import (LM_TOL, N_STEPS, ROT_TOL_DEG, T_TOL, rot_deg,
                           slice_runs)


@pytest.fixture(scope="module")
def runs_v1():
    return slice_runs("pallas")


def assert_states_agree(j, t):
    assert int(j["status"]) == int(t["status"])
    assert int(j["n_tracked"]) == int(t["n_tracked"])
    assert rot_deg(j["T_CW"], t["T_CW"]) < ROT_TOL_DEG
    np.testing.assert_allclose(t["T_CW"][:3, 3], j["T_CW"][:3, 3], atol=T_TOL)
    for name in ("lm_valid", "cand_valid"):
        np.testing.assert_array_equal(t[name], j[name], err_msg=name)
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
        assert rot_deg(a, b) < ROT_TOL_DEG
        np.testing.assert_allclose(b[:3, 3], a[:3, 3], atol=T_TOL)
    both = j["lm_valid"] & t["lm_valid"]
    np.testing.assert_allclose(t["lm_xyz"][both], j["lm_xyz"][both], rtol=0,
                               atol=LM_TOL)
