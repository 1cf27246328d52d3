"""Host fly camera and its ray-gen frame (`raypt/core/camera.py`).

Closed form of the reference's perspective unprojection: the near-plane
lower-left corner in camera space is (-aspect*t*n, -t*n, -n) with
t = tan(fov_y/2); R = Ry(yaw) @ Rx(pitch) takes it to world space.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .math3d import euler_to_mat
from .types import CameraRays


@dataclasses.dataclass
class Camera:
    """Angles and fov_y in degrees; near plane 1."""
    position: tuple = (0.0, 0.0, 0.0)
    angle_x: float = 0.0      # pitch
    angle_y: float = 0.0      # yaw
    fov_y: float = 90.0
    near: float = 1.0
    viewport_width: int = 1024
    viewport_height: int = 768

    @property
    def aspect(self) -> float:
        return self.viewport_width / self.viewport_height

    def rotation(self) -> np.ndarray:
        return euler_to_mat(math.radians(self.angle_x),
                            math.radians(self.angle_y))

    def rays(self) -> CameraRays:
        t = math.tan(math.radians(self.fov_y) * 0.5)
        n = self.near
        half_w = self.aspect * t * n
        half_h = t * n
        rot = self.rotation()
        origin = np.asarray(self.position, np.float32)
        llc_cam = np.array([-half_w, -half_h, -n], np.float32)
        horizontal = rot @ np.array([2 * half_w, 0, 0], np.float32)
        vertical = rot @ np.array([0, 2 * half_h, 0], np.float32)
        lower_left = origin + rot @ llc_cam
        return CameraRays(*(torch.from_numpy(np.asarray(x, np.float32))
                            for x in (origin, lower_left, horizontal,
                                      vertical)))
