"""BVH tests: build invariants and traversal equivalence against the
brute-force intersector (which is itself oracle-tested)."""

import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer.ops.bvh import (
    BVH,
    LEAF_SIZE,
    build_bvh,
    bvh_closest_hit,
    bvh_occluded,
)
from pathtracer.ops.intersect import closest_hit, occluded
from pathtracer.scene.builtin import cornell_box
from pathtracer.scene.mesh import PrimList, subdivide


def random_rays(n, seed, lo=-4, hi=4):
    r = np.random.default_rng(seed)
    o = r.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


@pytest.fixture(scope="module")
def cbox_sub2():
    prims = subdivide(cornell_box("quads"), 2)
    geom = prims.build()
    return geom, build_bvh(geom)


class TestBuild:
    def test_invariants(self, cbox_sub2):
        geom, bvh = cbox_sub2
        nm = np.asarray(bvh.node_min)
        nx = np.asarray(bvh.node_max)
        cnt = np.asarray(bvh.node_count)
        left = np.asarray(bvh.node_left)
        right = np.asarray(bvh.node_right)
        order = np.asarray(bvh.tri_order)
        m = bvh.num_nodes
        # every triangle appears exactly once
        assert sorted(order.tolist()) == list(range(geom.num_tris))
        # boxes well-formed
        assert (nx >= nm - 1e-6).all()
        # leaves small; inner children in range and child boxes inside
        for i in range(m):
            if cnt[i] > 0:
                assert cnt[i] <= LEAF_SIZE
                assert 0 <= left[i] and left[i] + cnt[i] <= geom.num_tris
            else:
                for c in (left[i], right[i]):
                    assert 0 < c < m
                    assert (nm[c] >= nm[i] - 1e-5).all()
                    assert (nx[c] <= nx[i] + 1e-5).all()

    def test_root_covers_scene(self, cbox_sub2):
        geom, bvh = cbox_sub2
        v0 = np.asarray(geom.tri_v0)
        np.testing.assert_array_less(
            np.asarray(bvh.node_min)[0] - 1e-5, v0.min(0) + 1e-3
        )


class TestTraversal:
    def test_matches_bruteforce_closest(self, cbox_sub2):
        geom, bvh = cbox_sub2
        o, d = random_rays(256, seed=3)
        brute = closest_hit(geom, o, d)
        fast = bvh_closest_hit(geom, bvh, o, d)
        np.testing.assert_array_equal(
            np.asarray(brute.valid), np.asarray(fast.valid)
        )
        v = np.asarray(brute.valid)
        np.testing.assert_allclose(
            np.asarray(fast.t)[v], np.asarray(brute.t)[v], rtol=1e-5
        )
        np.testing.assert_array_equal(
            np.asarray(fast.prim)[v], np.asarray(brute.prim)[v]
        )

    def test_matches_bruteforce_occluded(self, cbox_sub2):
        geom, bvh = cbox_sub2
        o, d = random_rays(256, seed=4, lo=-2, hi=2)
        dist = jnp.full((256,), 3.0)
        a = np.asarray(occluded(geom, o, d, dist))
        b = np.asarray(bvh_occluded(geom, bvh, o, d, dist))
        np.testing.assert_array_equal(a, b)

    def test_occluded_exclusion(self, cbox_sub2):
        geom, bvh = cbox_sub2
        # rays from inside, excluding the hit primitive pair must change
        # *some* answers vs no exclusion
        o, d = random_rays(128, seed=5, lo=-1, hi=1)
        dist = jnp.full((128,), 10.0)
        hit = closest_hit(geom, o, d)
        a = np.asarray(
            bvh_occluded(geom, bvh, o, d, dist, hit.prim, hit.prim)
        )
        ref = np.asarray(occluded(geom, o, d, dist, hit.prim, hit.prim))
        np.testing.assert_array_equal(a, ref)

    def test_t_max_respected(self, cbox_sub2):
        geom, bvh = cbox_sub2
        o = jnp.array([[0.0, 2.5, 8.0]])
        d = jnp.array([[0.0, 0.0, -1.0]])
        far = bvh_closest_hit(geom, bvh, o, d)
        assert bool(far.valid[0])
        near = bvh_closest_hit(geom, bvh, o, d, t_max=1.0)
        assert not bool(near.valid[0])
