"""Camera tests: look-at view plane, ray generation, orbit semantics
(reference sensor.h)."""

import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer.render.camera import CameraController


def make(fov=40.0, aspect=1.0):
    return CameraController(
        lookfrom=np.array([0.0, 0.0, 5.0]),
        lookat=np.array([0.0, 0.0, 0.0]),
        vup=np.array([0.0, 1.0, 0.0]),
        vfov=fov,
        aspect=aspect,
    )


class TestRays:
    def test_center_ray_points_at_target(self):
        cam = make().build()
        o, d = cam.get_rays(jnp.array([0.5]), jnp.array([0.5]))
        np.testing.assert_allclose(np.asarray(o)[0], [0, 0, 5], atol=1e-6)
        np.testing.assert_allclose(
            np.asarray(d)[0], [0, 0, -1], atol=1e-6
        )

    def test_directions_unit_length(self):
        cam = make(aspect=1.5).build()
        u = jnp.linspace(0, 1, 9)
        v = jnp.linspace(0, 1, 9)
        uu, vv = jnp.meshgrid(u, v)
        _, d = cam.get_rays(uu.ravel(), vv.ravel())
        np.testing.assert_allclose(
            np.linalg.norm(np.asarray(d), axis=-1), 1.0, atol=1e-5
        )

    def test_fov(self):
        """Vertical extent: the v=0 and v=1 rays subtend vfov degrees."""
        cam = make(fov=60.0).build()
        _, d = cam.get_rays(
            jnp.array([0.5, 0.5]), jnp.array([0.0, 1.0])
        )
        d = np.asarray(d)
        angle = np.degrees(np.arccos(np.clip(np.dot(d[0], d[1]), -1, 1)))
        assert angle == pytest.approx(60.0, abs=0.2)

    def test_v_zero_is_bottom(self):
        cam = make().build()
        _, d = cam.get_rays(jnp.array([0.5]), jnp.array([0.0]))
        assert float(d[0, 1]) < 0  # looking downward


class TestOrbit:
    def test_radius_preserved(self):
        cc = make()
        r0 = cc.radius
        cc.orbit(d_yaw=33.0, d_pitch=10.0)
        assert np.linalg.norm(cc.lookfrom - cc.lookat) == pytest.approx(
            r0, rel=1e-5
        )

    def test_pitch_clamped(self):
        cc = make()
        cc.orbit(d_pitch=500.0)
        assert cc.pitch == 89.0
        cc.orbit(d_pitch=-500.0)
        assert cc.pitch == -89.0

    def test_zoom_changes_radius(self):
        cc = make()
        r0 = cc.radius
        cc.orbit(d_radius=-1.0)
        assert cc.radius == pytest.approx(r0 - 1.0)

    def test_yaw_rotates_around_target(self):
        cc = make()
        cc.orbit(d_yaw=90.0)
        p1 = cc.lookfrom.copy()
        cc.orbit(d_yaw=90.0)
        p2 = cc.lookfrom.copy()
        # after two 90-degree steps the camera is on the opposite side
        # (same height), up to float error
        assert not np.allclose(p1, p2)
        assert p1[1] == pytest.approx(p2[1], abs=1e-5)
