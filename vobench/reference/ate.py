"""Sim(3) alignment and the absolute trajectory error: a frozen copy of the
port's ``evalx/ate.py`` (``umeyama_alignment``), with the per-frame errors
the comparison reads.  NumPy only."""
from __future__ import annotations

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Least-squares similarity transform aligning src -> dst.

    Args:
      src, dst: (N, 3) corresponding points (trajectory positions).

    Returns (s, R, t) with dst ~= s * R @ src + t.
    """
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    var_s = (xs**2).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / var_s) if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def aligned_errors(estimated: np.ndarray, ground_truth: np.ndarray):
    """Per-frame position errors (N,) after Sim(3) alignment of
    ``estimated`` onto ``ground_truth``, both (N, 3), and the scale."""
    s, R, t = umeyama_alignment(estimated, ground_truth, True)
    aligned = (s * (R @ estimated.T)).T + t
    return np.linalg.norm(aligned - ground_truth, axis=1), s


def ate_rmse(estimated: np.ndarray, ground_truth: np.ndarray) -> float:
    """Absolute trajectory error RMSE after Sim(3) alignment."""
    err, _ = aligned_errors(estimated, ground_truth)
    return float(np.sqrt((err**2).mean()))


def path_length(positions: np.ndarray) -> float:
    return float(np.sum(np.linalg.norm(np.diff(positions, axis=0), axis=1)))
