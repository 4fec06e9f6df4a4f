"""Unit tests for core math: frames, warps, spherical conversions.

Oracle formulas come from the reference's math_utils.h / integrator.h
(cited in the implementation); tests verify algebraic properties and
distributions rather than transliterated code.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer.core import math_utils as mu


def random_unit(n, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


class TestFrame:
    def test_orthonormal(self):
        n = jnp.asarray(random_unit(256), jnp.float32)
        t, b = mu.build_frame(n)
        np.testing.assert_allclose(mu.dot(t, t), 1.0, rtol=1e-4)
        np.testing.assert_allclose(mu.dot(b, b), 1.0, rtol=1e-4)
        assert float(jnp.max(jnp.abs(mu.dot(t, b)))) < 1e-4
        assert float(jnp.max(jnp.abs(mu.dot(t, n)))) < 1e-4
        assert float(jnp.max(jnp.abs(mu.dot(b, n)))) < 1e-4
        # right-handed: t x b == n
        np.testing.assert_allclose(
            np.asarray(mu.cross(t, b)), np.asarray(n), atol=1e-4
        )

    def test_singular_branch(self):
        n = jnp.array([[0.0, 0.0, -1.0]])
        t, b = mu.build_frame(n)
        np.testing.assert_allclose(np.asarray(t), [[0.0, -1.0, 0.0]])
        np.testing.assert_allclose(np.asarray(b), [[-1.0, 0.0, 0.0]])

    def test_local_roundtrip(self):
        n = jnp.asarray(random_unit(64, 1), jnp.float32)
        d = jnp.asarray(random_unit(64, 2), jnp.float32)
        local = mu.to_local(d, n)
        back = mu.from_local(local, n)
        np.testing.assert_allclose(np.asarray(back), np.asarray(d), atol=1e-4)


class TestSpherical:
    def test_roundtrip(self):
        n = jnp.asarray(random_unit(64, 3), jnp.float32)
        d = jnp.asarray(random_unit(64, 4), jnp.float32)
        theta, phi = mu.world_to_spherical(d, n)
        back = mu.from_local(mu.spherical_to_local(theta, phi), n)
        np.testing.assert_allclose(np.asarray(back), np.asarray(d), atol=1e-4)

    def test_theta_meaning(self):
        n = jnp.array([[0.0, 1.0, 0.0]])
        theta, _ = mu.world_to_spherical(jnp.array([[0.0, 1.0, 0.0]]), n)
        assert float(theta[0]) == pytest.approx(0.0, abs=1e-4)
        theta, _ = mu.world_to_spherical(jnp.array([[1.0, 0.0, 0.0]]), n)
        assert float(theta[0]) == pytest.approx(np.pi / 2, abs=1e-4)


class TestCosineSampling:
    def test_distribution(self):
        """E[cos theta] = 2/3 and pdf = cos/pi for cosine sampling."""
        key = jax.random.key(0)
        m = 1 << 15
        u = jax.random.uniform(key, (2, m))
        n = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0]), (m, 3))
        d, pdf = mu.cosine_sample_hemisphere(n, u[0], u[1])
        cos_t = np.asarray(mu.dot(d, n))
        assert cos_t.min() >= 0.0
        assert np.mean(cos_t) == pytest.approx(2.0 / 3.0, abs=0.01)
        np.testing.assert_allclose(
            np.asarray(pdf), cos_t / np.pi, atol=1e-5
        )

    def test_unbiased_vs_uniform_integral(self):
        """MC estimate of integral over hemisphere of cos/pi must be 1."""
        key = jax.random.key(1)
        m = 1 << 15
        u = jax.random.uniform(key, (2, m))
        n = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0]), (m, 3))
        d, pdf = mu.cosine_sample_hemisphere(n, u[0], u[1])
        est = np.mean(np.asarray(mu.cosine_pdf(d, n) / jnp.maximum(pdf, 1e-9)))
        assert est == pytest.approx(1.0, abs=1e-3)


class TestMisc:
    def test_power_heuristic(self):
        assert float(mu.power_heuristic(jnp.float32(0.0), jnp.float32(1.0))) == 0.0
        assert float(mu.power_heuristic(jnp.float32(1.0), jnp.float32(0.0))) == 1.0
        w = float(mu.power_heuristic(jnp.float32(1.0), jnp.float32(1.0)))
        assert w == pytest.approx(0.5)
        # weights of complementary strategies sum to 1
        a, b = 0.3, 1.7
        s = float(mu.power_heuristic(jnp.float32(a), jnp.float32(b))) + float(
            mu.power_heuristic(jnp.float32(b), jnp.float32(a))
        )
        assert s == pytest.approx(1.0, abs=1e-6)

    def test_reflect(self):
        d = jnp.array([[1.0, -1.0, 0.0]]) / np.sqrt(2)
        n = jnp.array([[0.0, 1.0, 0.0]])
        r = mu.reflect(d, n)
        np.testing.assert_allclose(
            np.asarray(r), [[1.0 / np.sqrt(2), 1.0 / np.sqrt(2), 0.0]],
            atol=1e-6,
        )

    def test_luminance(self):
        assert float(mu.luminance(jnp.array([1.0, 1.0, 1.0]))) == pytest.approx(
            1.0, abs=1e-4
        )
        assert float(mu.luminance(jnp.array([0.0, 1.0, 0.0]))) == pytest.approx(
            0.7152
        )
