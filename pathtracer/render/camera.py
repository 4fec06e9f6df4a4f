"""Pinhole look-at camera with orbit controls.

Capability parity with the reference Sensor
(`reference/include/rendering/sensor.h`): vertical-fov look-at view
plane, (u, v) in [0,1]^2 ray generation with normalized directions (the
reference Ray ctor normalizes, ray.h:9-12), and spherical yaw/pitch/radius
orbiting around the look-at point. Implemented as a frozen pytree so the
whole camera can be traced through jit and donated between frames.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..core.math_utils import normalize


def _unit(v):
    return v / np.linalg.norm(v)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Camera:
    """View-plane parametrization: ray(u,v) = llc + u*horizontal + v*vertical - origin."""

    origin: jax.Array            # (3,)
    lower_left_corner: jax.Array  # (3,)
    horizontal: jax.Array        # (3,)
    vertical: jax.Array          # (3,)

    def get_rays(self, u, v):
        """Batched ray generation.

        Args:
            u, v: (...,) screen coordinates in [0, 1] (v=0 is the bottom row,
                matching the reference's y-up framebuffer; PNG export flips).
        Returns:
            (origins, directions): (..., 3) each, directions unit length.
        """
        d = (
            self.lower_left_corner
            + u[..., None] * self.horizontal
            + v[..., None] * self.vertical
            - self.origin
        )
        o = jnp.broadcast_to(self.origin, d.shape)
        return o, normalize(d)


@dataclass
class CameraController:
    """Host-side mutable camera state (orbit parameters + intrinsics).

    Mirrors Sensor's host API: updateCamera recomputes the view plane,
    orbit(yaw, pitch, radius) moves the origin on a sphere around look_at
    (sensor.h:38-67). Produces immutable `Camera` pytrees for the device.
    """

    lookfrom: np.ndarray
    lookat: np.ndarray
    vup: np.ndarray
    vfov: float       # vertical fov, degrees, top to bottom
    aspect: float
    yaw: float = 90.0
    pitch: float = 0.0

    def __post_init__(self):
        self.lookfrom = np.asarray(self.lookfrom, np.float32)
        self.lookat = np.asarray(self.lookat, np.float32)
        self.vup = np.asarray(self.vup, np.float32)
        self.radius = float(np.linalg.norm(self.lookfrom - self.lookat))

    @staticmethod
    def default(aspect: float = 1.0) -> "CameraController":
        """Reference AppConfig defaults: eye (0.5,3,8.5) -> (0,2.5,0), fov 40
        (application_state.h:282-292)."""
        return CameraController(
            lookfrom=np.array([0.5, 3.0, 8.5]),
            lookat=np.array([0.0, 2.5, 0.0]),
            vup=np.array([0.0, 1.0, 0.0]),
            vfov=40.0,
            aspect=aspect,
        )

    def orbit(self, d_yaw: float = 0.0, d_pitch: float = 0.0, d_radius: float = 0.0):
        """Orbit update matching Sensor::updateCameraOrbit + UI clamps
        (callbacks.h:117-150: pitch clamped to +/-89 deg)."""
        self.yaw += d_yaw
        self.pitch = float(np.clip(self.pitch + d_pitch, -89.0, 89.0))
        self.radius = max(self.radius + d_radius, 1e-3)
        yaw_r = math.radians(self.yaw)
        pitch_r = math.radians(self.pitch)
        self.lookfrom = self.lookat + self.radius * np.array(
            [
                math.cos(pitch_r) * math.cos(yaw_r),
                math.sin(pitch_r),
                math.cos(pitch_r) * math.sin(yaw_r),
            ],
            np.float32,
        )

    def build(self) -> Camera:
        """Compute the view plane (Sensor::updateCamera, sensor.h:38-51)."""
        theta = math.radians(self.vfov)
        half_height = math.tan(theta / 2.0)
        half_width = self.aspect * half_height
        w = _unit(self.lookfrom - self.lookat)
        u = _unit(np.cross(self.vup, w))
        v = np.cross(w, u)
        llc = self.lookfrom - half_width * u - half_height * v - w
        return Camera(
            origin=jnp.asarray(self.lookfrom, jnp.float32),
            lower_left_corner=jnp.asarray(llc, jnp.float32),
            horizontal=jnp.asarray(2.0 * half_width * u, jnp.float32),
            vertical=jnp.asarray(2.0 * half_height * v, jnp.float32),
        )
