"""The fixed-shape per-frame VO state (port of ``core/state.py``).

``FrameState`` is a dataclass of tensors with the reference's fields; one
step hands it to the next.  One departure: ``frame_idx`` is a Python int,
because the host needs it anyway (the in-step BA cadence is decided on the
host, ``pipeline/vo.py``), and keeping it on the host costs no sync.

``to_numpy`` / ``from_numpy`` carry a state across to and from the JAX
package: a dict of numpy arrays, one entry per field, with
``prev_pyramid`` as a tuple (``from_numpy`` also takes a JAX ``FrameState``
itself).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .config import PipelineConfig

STATUS_TRACKING = 0
STATUS_LOST = 1


@dataclasses.dataclass
class FrameState:
    # --- pose ---
    frame_idx: int
    T_CW: torch.Tensor  # (4,4) f32 current extrinsics (world -> camera)

    # --- landmark-backed tracks ---
    lm_xyz: torch.Tensor  # (K,3) world-frame landmarks
    lm_uv: torch.Tensor  # (K,2) current pixel coords
    lm_valid: torch.Tensor  # (K,) bool
    lm_inlier: torch.Tensor  # (K,) bool, last PnP-RANSAC inlier mask
    lm_gen: torch.Tensor  # (K,) int32 slot generation, bumps on re-allocation

    # --- landmark anchor observation (sliding re-triangulation) ---
    lm_first_uv: torch.Tensor  # (K,2)
    lm_T_CW_first: torch.Tensor  # (K,4,4)
    lm_anchor_age: torch.Tensor  # (K,) int32

    # --- candidate tracks ---
    cand_uv: torch.Tensor  # (M,2)
    cand_first_uv: torch.Tensor  # (M,2)
    cand_T_CW_first: torch.Tensor  # (M,4,4)
    cand_first_frame: torch.Tensor  # (M,) int32
    cand_valid: torch.Tensor  # (M,) bool

    # --- in-step BA observation ring (length 1 when off) ---
    ba_T: torch.Tensor  # (Wb,4,4)
    ba_uv: torch.Tensor  # (Wb,K,2)
    ba_mask: torch.Tensor  # (Wb,K) bool
    ba_gen: torch.Tensor  # (Wb,K) int32

    # --- previous-frame flat pyramid for KLT ---
    prev_pyramid: Tuple[torch.Tensor, ...]

    # --- health/metrics (0-d device tensors) ---
    status: torch.Tensor  # () int32, STATUS_*
    n_inliers: torch.Tensor  # () int32
    n_tracked: torch.Tensor  # () int32

    def replace(self, **kw) -> "FrameState":
        return dataclasses.replace(self, **kw)

    def to_numpy(self) -> dict:
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name == "prev_pyramid":
                out[f.name] = tuple(p.detach().cpu().numpy() for p in v)
            elif f.name == "frame_idx":
                out[f.name] = np.asarray(v, np.int32)
            else:
                out[f.name] = v.detach().cpu().numpy()
        return out

    @staticmethod
    def from_numpy(d, device=None) -> "FrameState":
        """A state from a dict of arrays, one per field, or from any object
        with the fields as attributes (a JAX ``FrameState``: each field is
        read through ``np.asarray``)."""
        kw = {}
        for f in dataclasses.fields(FrameState):
            v = d[f.name] if isinstance(d, dict) else getattr(d, f.name)
            if f.name == "prev_pyramid":
                kw[f.name] = tuple(torch.as_tensor(np.array(p)).to(device)
                                   for p in v)
            elif f.name == "frame_idx":
                kw[f.name] = int(v)
            else:
                kw[f.name] = torch.as_tensor(np.array(v)).to(device)
        return FrameState(**kw)


def init_state(config: PipelineConfig, pyramid: Tuple[torch.Tensor, ...],
               device=None) -> FrameState:
    """Blank state at the identity pose."""
    K = config.capacity.max_landmarks
    M = config.capacity.max_candidates
    Wb = max(1, config.ba.window if config.ba.every else 1)
    f32, i32 = torch.float32, torch.int32

    def eyes(n):
        return torch.eye(4, dtype=f32, device=device).repeat(n, 1, 1)

    def zeros(shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return FrameState(
        frame_idx=0,
        T_CW=torch.eye(4, dtype=f32, device=device),
        lm_xyz=zeros((K, 3)),
        lm_uv=zeros((K, 2)),
        lm_valid=zeros((K,), torch.bool),
        lm_inlier=zeros((K,), torch.bool),
        lm_gen=zeros((K,), i32),
        lm_first_uv=zeros((K, 2)),
        lm_T_CW_first=eyes(K),
        lm_anchor_age=zeros((K,), i32),
        cand_uv=zeros((M, 2)),
        cand_first_uv=zeros((M, 2)),
        cand_T_CW_first=eyes(M),
        cand_first_frame=zeros((M,), i32),
        cand_valid=zeros((M,), torch.bool),
        ba_T=eyes(Wb),
        ba_uv=zeros((Wb, K, 2)),
        ba_mask=zeros((Wb, K), torch.bool),
        ba_gen=zeros((Wb, K), i32),
        prev_pyramid=pyramid,
        status=zeros((), i32),
        n_inliers=zeros((), i32),
        n_tracked=zeros((), i32),
    )
