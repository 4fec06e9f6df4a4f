"""Intersection tests: affine batched intersector vs a scalar
Möller-Trumbore oracle (the algorithm in the reference triangle.h:64-96,
re-implemented in straightforward NumPy)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer.ops.intersect import closest_hit, occluded
from pathtracer.scene.builtin import cornell_box
from pathtracer.scene.mesh import PrimList, make_triangle_corners


def mt_oracle(o, d, v0, v1, v2, t_min=1e-4):
    """Scalar Möller-Trumbore: returns t or inf."""
    e1, e2 = v1 - v0, v2 - v0
    h = np.cross(d, e2)
    a = np.dot(e1, h)
    if abs(a) < 1e-12:
        return np.inf
    f = 1.0 / a
    s = o - v0
    u = f * np.dot(s, h)
    if u < 0.0 or u > 1.0:
        return np.inf
    q = np.cross(s, e1)
    v = f * np.dot(d, q)
    if v < 0.0 or u + v > 1.0:
        return np.inf
    t = f * np.dot(e2, q)
    if t <= 1e-8 or t < t_min:
        return np.inf
    return t


def random_tri_scene(n_tris, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, (n_tris, 3)).astype(np.float32)
    b = a + rng.uniform(-1, 1, (n_tris, 3)).astype(np.float32)
    c = a + rng.uniform(-1, 1, (n_tris, 3)).astype(np.float32)
    corners = np.stack([a, b, c, c], axis=1)
    prims = PrimList(
        corners=corners,
        is_quad=np.zeros(n_tris, bool),
        albedo=np.full((n_tris, 3), 0.5, np.float32),
        emission=np.zeros((n_tris, 3), np.float32),
        material=np.zeros(n_tris, np.int32),
    )
    return prims, (a, b, c)


class TestClosestHit:
    def test_matches_oracle_random(self):
        prims, (a, b, c) = random_tri_scene(24, seed=7)
        geom = prims.build()
        rng = np.random.default_rng(11)
        n_rays = 200
        o = rng.uniform(-2, 2, (n_rays, 3)).astype(np.float32)
        d = rng.normal(size=(n_rays, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)

        hit = closest_hit(geom, jnp.asarray(o), jnp.asarray(d))
        t_got = np.asarray(hit.t)
        prim_got = np.asarray(hit.prim)
        valid_got = np.asarray(hit.valid)

        for r in range(n_rays):
            ts = np.array(
                [mt_oracle(o[r], d[r], a[i], b[i], c[i]) for i in range(24)]
            )
            t_ref = ts.min()
            if np.isinf(t_ref):
                assert not valid_got[r]
            else:
                assert valid_got[r]
                assert t_got[r] == pytest.approx(t_ref, rel=2e-4)
                assert prim_got[r] == int(np.argmin(ts))

    def test_quad_equals_two_triangles(self):
        """A quad must intersect exactly like its two canonical triangles
        (quad.h:49-132 splits as (v00,v10,v11)+(v00,v11,v01))."""
        q = np.array(
            [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32
        )
        quad_prims = PrimList(
            corners=q[None],
            is_quad=np.array([True]),
            albedo=np.full((1, 3), 0.5, np.float32),
            emission=np.zeros((1, 3), np.float32),
            material=np.zeros(1, np.int32),
        )
        tri_corners = np.stack(
            [
                make_triangle_corners(q[0], q[1], q[2]),
                make_triangle_corners(q[0], q[2], q[3]),
            ]
        )
        tri_prims = PrimList(
            corners=tri_corners,
            is_quad=np.zeros(2, bool),
            albedo=np.full((2, 3), 0.5, np.float32),
            emission=np.zeros((2, 3), np.float32),
            material=np.zeros(2, np.int32),
        )
        gq, gt = quad_prims.build(), tri_prims.build()
        rng = np.random.default_rng(3)
        o = np.concatenate(
            [rng.uniform(0, 1, (64, 2)), np.full((64, 1), 2.0)], axis=-1
        ).astype(np.float32)
        d = rng.normal(size=(64, 3)).astype(np.float32)
        d[:, 2] = -np.abs(d[:, 2]) - 0.5
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        hq = closest_hit(gq, jnp.asarray(o), jnp.asarray(d))
        ht = closest_hit(gt, jnp.asarray(o), jnp.asarray(d))
        np.testing.assert_array_equal(
            np.asarray(hq.valid), np.asarray(ht.valid)
        )
        np.testing.assert_allclose(
            np.asarray(hq.t)[np.asarray(hq.valid)],
            np.asarray(ht.t)[np.asarray(ht.valid)],
            rtol=1e-5,
        )

    def test_t_min_respected(self):
        prims, _ = random_tri_scene(4, seed=1)
        geom = prims.build()
        # A ray that starts exactly on a triangle surface must not self-hit
        # with t_min=1e-4 ... verified via the Cornell floor instead:
        g = cornell_box("quads").build()
        o = jnp.array([[0.0, 0.0, -2.0]])  # on the floor
        d = jnp.array([[0.0, 1.0, 0.0]])
        hit = closest_hit(g, o, d)
        # must hit the light/ceiling above, not the floor itself
        assert bool(hit.valid[0])
        assert float(hit.t[0]) > 1.0

    def test_normals_are_primitive_normals(self):
        g = cornell_box("quads").build()
        o = jnp.array([[0.0, 2.5, 2.0]])
        d = jnp.array([[0.0, 0.0, -1.0]])
        hit = closest_hit(g, o, d)
        assert bool(hit.valid[0])
        # back wall normal +z
        np.testing.assert_allclose(
            np.asarray(hit.n)[0], [0.0, 0.0, 1.0], atol=1e-5
        )


class TestOccluded:
    def test_blocked_and_clear(self):
        g = cornell_box("quads").build()
        # floor center to light center: must be blocked only if a box is in
        # between; pick a segment through the tall box
        o = jnp.array([[-1.15, 0.01, -3.55], [2.4, 2.5, -0.3]])
        d = jnp.array([[0.0, 1.0, 0.0], [0.0, 1.0, 0.0]])
        max_d = jnp.array([5.3, 2.0])
        blocked = np.asarray(occluded(g, o, d, max_d))
        assert bool(blocked[0])       # tall box above
        assert not bool(blocked[1])   # clear column near right wall

    def test_exclusion(self):
        g = cornell_box("quads").build()
        # segment from floor straight up to ceiling, excluding both
        # endpoint prims; the light quad is prim 0 and blocks the column
        # at the light location.
        floor_idx = 3
        ceil_idx = 2
        o = jnp.array([[0.0, 0.0, -2.75]])
        d = jnp.array([[0.0, 1.0, 0.0]])
        max_d = jnp.array([5.5 - 2e-4])
        a = jnp.array([floor_idx])
        bidx = jnp.array([ceil_idx])
        blocked = np.asarray(occluded(g, o, d, max_d, a, bidx))
        assert bool(blocked[0])  # the light itself blocks
        # exclude the light too -> clear
        blocked2 = np.asarray(
            occluded(g, o, d, max_d, jnp.array([0]), bidx)
        )
        # still blocked by floor? floor excluded? floor is exclude no...
        # here we exclude light + ceiling; floor remains but t=0 < eps.
        assert not bool(blocked2[0])


class TestTriangleBlocking:
    """Brute queries sweep triangles in _TRI_BLOCK blocks above the
    threshold (bounds the (B, T) all-pairs intermediates). Structure
    (valid/prim/occlusion) must match exactly; t only to ~1 ulp (XLA
    fuses the FMA chains differently per compilation)."""

    def test_blocked_matches_single_block(self, monkeypatch):
        import pathtracer.ops.intersect as it
        from pathtracer.scene.builtin import cornell_box
        from pathtracer.scene.mesh import subdivide

        geom = subdivide(cornell_box("quads"), 3).build()  # 2048 tris
        key = jax.random.key(11)
        ko, kd = jax.random.split(key)
        o = jax.random.uniform(ko, (512, 3), minval=-2.0, maxval=2.0) \
            + jnp.array([0.0, 2.75, 0.0])
        d = jax.random.normal(kd, (512, 3))
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)

        ref = it.closest_hit(geom, o, d)          # single-block (T<=4096)
        ref_occ = it.occluded(geom, o, d, jnp.full((512,), 3.0))
        monkeypatch.setattr(it, "_TRI_BLOCK", 256)
        blk = it.closest_hit(geom, o, d)
        blk_occ = it.occluded(geom, o, d, jnp.full((512,), 3.0))
        for f in ("valid", "prim", "n", "albedo", "emission"):
            np.testing.assert_array_equal(
                np.asarray(getattr(ref, f)), np.asarray(getattr(blk, f))
            )
        m = np.asarray(ref.valid)
        np.testing.assert_allclose(
            np.asarray(blk.t)[m], np.asarray(ref.t)[m], rtol=3e-7
        )
        np.testing.assert_array_equal(np.asarray(ref_occ),
                                      np.asarray(blk_occ))
