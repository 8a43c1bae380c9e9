"""Pinhole camera model (port of ``core/camera.py``).

The intrinsics are four Python floats, rounded to float32 as the reference
stores them, so the camera lives on no device: every method takes its
device from the tensors it is given, or from ``device``.  Its constant
tensors are made once per device (``linalg.constant``), so a captured step
(``pipeline/vo.py``) reads them without a copy from the host.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .linalg import constant, matmul


class Camera(NamedTuple):
    """Pinhole intrinsics (float32-rounded Python floats)."""

    fx: float
    fy: float
    cx: float
    cy: float

    @staticmethod
    def from_matrix(K) -> "Camera":
        K = np.asarray(K, dtype=np.float32)
        return Camera(fx=float(K[0, 0]), fy=float(K[1, 1]),
                      cx=float(K[0, 2]), cy=float(K[1, 2]))

    def _scalars(self, device):
        return constant([self.fx, self.fy, self.cx, self.cy], device)

    def matrix(self, device=None) -> torch.Tensor:
        """Dense 3x3 intrinsics matrix K."""
        return constant([[self.fx, 0.0, self.cx],
                         [0.0, self.fy, self.cy],
                         [0.0, 0.0, 1.0]], device)

    def inv_matrix(self, device=None) -> torch.Tensor:
        """Closed-form K^-1, computed in float32 like the reference."""
        fx, fy, cx, cy = self._scalars(device)
        z = torch.zeros_like(fx)
        o = torch.ones_like(fx)
        return torch.stack([
            torch.stack([1.0 / fx, z, -cx / fx]),
            torch.stack([z, 1.0 / fy, -cy / fy]),
            torch.stack([z, z, o]),
        ])

    def project(self, xyz_cam: torch.Tensor) -> torch.Tensor:
        """Camera-frame points (..., 3) -> pixel coords (..., 2)."""
        z = xyz_cam[..., 2]
        u = self.fx * xyz_cam[..., 0] / z + self.cx
        v = self.fy * xyz_cam[..., 1] / z + self.cy
        return torch.stack([u, v], -1)

    def backproject(self, uv: torch.Tensor) -> torch.Tensor:
        """Pixel coords (..., 2) -> unit-depth rays (..., 3)."""
        x = (uv[..., 0] - self.cx) / self.fx
        y = (uv[..., 1] - self.cy) / self.fy
        return torch.stack([x, y, torch.ones_like(x)], -1)

    def normalize(self, uv: torch.Tensor) -> torch.Tensor:
        """Pixel coords (..., 2) -> normalized image coords (..., 2)."""
        x = (uv[..., 0] - self.cx) / self.fx
        y = (uv[..., 1] - self.cy) / self.fy
        return torch.stack([x, y], -1)


def world_to_cam(T_CW: torch.Tensor, xyz_w: torch.Tensor) -> torch.Tensor:
    """Apply a camera-from-world transform (4, 4) to points (..., 3)."""
    return matmul(xyz_w, T_CW[:3, :3].T) + T_CW[:3, 3]


def projection_matrix(cam: Camera, T_CW: torch.Tensor) -> torch.Tensor:
    """3x4 projection P = K [R|t] from camera-from-world (..., 4, 4)."""
    return matmul(cam.matrix(T_CW.device), T_CW[..., :3, :4])
