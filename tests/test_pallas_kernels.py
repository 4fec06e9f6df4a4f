"""Fused hit kernels (ops/intersect_triton), run in the Pallas interpreter
on the CPU: they must match the (oracle-tested) XLA brute force exactly,
keep its semantics, and never pick interpret mode by themselves."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pathtracer.ops.intersect_triton as it
from pathtracer.ops.intersect import closest_hit, occluded
from pathtracer.render.camera import CameraController
from pathtracer.scene.builtin import cornell_box
from pathtracer.scene.mesh import PrimList, subdivide


def pack(geom, guide_table=None):
    return it.pack_triangles(geom, guide_table, interpret=True)


def rays(n, seed=0):
    cam = CameraController.default().build()
    u = jax.random.uniform(jax.random.key(seed), (2, n))
    return cam.get_rays(u[0], u[1])


def soup(n_tris, seed=0):
    """n_tris random triangles in [-1, 1]^3 (one logical primitive each),
    one in ten emissive."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1.0, 1.0, (n_tris, 3))
    b = a + rng.uniform(-0.4, 0.4, (n_tris, 3))
    c = a + rng.uniform(-0.4, 0.4, (n_tris, 3))
    corners = np.stack([a, b, c, c], axis=1).astype(np.float32)
    emission = np.zeros((n_tris, 3), np.float32)
    emission[::10] = 1.0
    return PrimList(
        corners=corners,
        is_quad=np.zeros(n_tris, bool),
        albedo=rng.uniform(0.1, 0.9, (n_tris, 3)).astype(np.float32),
        emission=emission,
        material=(rng.uniform(size=n_tris) < 0.2).astype(np.int32),
    ).build()


def random_rays(n, seed):
    k1, k2 = jax.random.split(jax.random.key(seed))
    o = jax.random.uniform(k1, (n, 3), minval=-1.5, maxval=1.5)
    d = jax.random.normal(k2, (n, 3))
    return o, d / jnp.linalg.norm(d, axis=-1, keepdims=True)


def assert_same_hits(hit, ref):
    """Same hits; t to 1e-5 relative plus 1e-6 absolute: the interpreter
    and XLA:CPU fuse the multiply-adds differently, which shows in the
    last bits where origins sit close to a surface (on the card the two
    agree bitwise, chip_smoke phase b)."""
    m = np.asarray(ref.valid)
    np.testing.assert_array_equal(np.asarray(hit.valid), m)
    np.testing.assert_allclose(
        np.asarray(hit.t)[m], np.asarray(ref.t)[m], rtol=1e-5, atol=1e-6
    )
    for f in ("prim", "n", "albedo", "emission", "material"):
        np.testing.assert_array_equal(
            np.asarray(getattr(hit, f))[m], np.asarray(getattr(ref, f))[m],
            err_msg=f,
        )


class TestClosest:
    def test_matches_bruteforce(self):
        geom = cornell_box("quads").build()
        o, d = rays(1024)
        hit = it.kernel_closest_hit(pack(geom), o, d)
        ref = closest_hit(geom, o, d)
        m = np.asarray(ref.valid)
        assert (np.asarray(hit.valid) == m).all()
        np.testing.assert_allclose(
            np.asarray(hit.t)[m], np.asarray(ref.t)[m], rtol=1e-5
        )

    def test_multi_chunk_triangles(self):
        """More triangles than one TRI_BLOCK exercises the block loop."""
        geom = subdivide(cornell_box("quads"), 2).build()  # 512 tris
        o, d = rays(1024, seed=3)
        assert_same_hits(it.kernel_closest_hit(pack(geom), o, d),
                         closest_hit(geom, o, d))

    def test_attributes_exact(self):
        geom = cornell_box("quads", mirror_tall_box=True).build()
        o, d = rays(1024, seed=1)
        hit = it.kernel_closest_hit(pack(geom), o, d)
        ref = closest_hit(geom, o, d)
        m = np.asarray(ref.valid)
        for field in ("n", "albedo", "emission"):
            np.testing.assert_array_equal(
                np.asarray(getattr(hit, field))[m],
                np.asarray(getattr(ref, field))[m],
                err_msg=field,
            )
        np.testing.assert_array_equal(
            np.asarray(hit.material)[m], np.asarray(ref.material)[m]
        )
        assert hit.guide is None

    def test_t_min(self):
        geom = cornell_box("quads").build()
        # ray resting on the floor pointing up: t_min must skip the floor
        o = jnp.broadcast_to(jnp.array([0.0, 0.0, -2.75]), (1024, 3))
        d = jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0]), (1024, 3))
        t, _, _ = it.closest_record(pack(geom), o, d, t_min=1e-4)
        assert float(t[0]) > 1.0  # hits the light, not the floor

    def test_miss_lanes(self):
        geom = cornell_box("quads").build()
        o = jnp.broadcast_to(jnp.array([0.0, 2.5, 20.0]), (1000, 3))
        d = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0]), (1000, 3))
        hit = it.kernel_closest_hit(pack(geom), o, d)
        assert not bool(hit.valid.any())
        assert float(jnp.sum(hit.emission)) == 0.0
        assert not bool(hit.prim.any())


class TestKernelVsReference:
    """Any triangle count (padding to whole triangle blocks) and any ray
    count (padding to whole ray blocks)."""

    @pytest.mark.parametrize("n_rays", [1000, 4096])
    @pytest.mark.parametrize("n_tris", [1, 32, 200, 1030])
    def test_closest_matches_reference(self, n_tris, n_rays):
        geom = soup(n_tris, seed=n_tris)
        o, d = random_rays(n_rays, seed=n_tris + n_rays)
        hit = it.kernel_closest_hit(pack(geom), o, d)
        ref = closest_hit(geom, o, d)
        assert_same_hits(hit, ref)
        assert hit.t.shape == (n_rays,) and hit.n.shape == (n_rays, 3)
        if n_tris > 1:
            assert int(ref.valid.sum()) > 0

    @pytest.mark.parametrize("excl", ["none", "a", "ab", "scaled"])
    def test_anyhit_matches_occluded(self, excl):
        geom = soup(200, seed=7)
        o, d = random_rays(1000, seed=8)
        ref_hit = closest_hit(geom, o, d)
        maxd = jnp.where(ref_hit.valid, ref_hit.t * 1.5, 2.0)
        ex_a = ex_b = None
        if excl in ("a", "ab"):
            ex_a = ref_hit.prim
        if excl == "ab":
            ex_b = (ref_hit.prim + 1) % geom.num_prims
        if excl == "scaled":
            maxd = maxd * 4.0
        got = it.kernel_occluded(pack(geom), o, d, maxd, ex_a, ex_b)
        want = occluded(geom, o, d, maxd, ex_a, ex_b)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert 0 < int(want.sum()) < 1000


class TestNoImplicitInterpret:
    def test_closest_without_interpret_raises_off_gpu(self):
        geom = cornell_box("quads").build()
        p = it.pack_triangles(geom)
        assert p.interpret is False      # interpret is opt-in only
        o, d = rays(128)
        with pytest.raises(RuntimeError, match="only for the GPU"):
            it.kernel_closest_hit(p, o, d)

    def test_anyhit_without_interpret_raises_off_gpu(self):
        geom = cornell_box("quads").build()
        o, d = rays(128)
        with pytest.raises(RuntimeError, match="interpret=True"):
            it.kernel_occluded(it.pack_triangles(geom), o, d,
                               jnp.ones((128,)))


class TestGuideAugmentedPack:
    """pack_triangles(guide_table=...): the hit kernel must deliver exactly
    prim_table[hit.prim], and a guided render through the augmented pack
    must be bitwise identical to the fetch-in-integrator path."""

    def test_guide_rows_match_table(self):
        from pathtracer.core.math_utils import luminance
        from pathtracer.ops.guiding import build_cdfs
        from pathtracer.render.radiosity import solve_radiosity

        geom = cornell_box("quads").build()
        sol = solve_radiosity(geom, jax.random.key(1),
                              num_iterations=4, mc_samples=8)
        cdfs = build_cdfs(luminance(sol.rad_grid))
        p = pack(geom, guide_table=np.asarray(cdfs.prim_table))
        o, d = rays(1024, seed=3)
        hit = it.kernel_closest_hit(p, o, d)
        assert hit.guide is not None and hit.guide.shape == (1024, 16)
        m = np.asarray(hit.valid)
        want = np.asarray(cdfs.prim_table)[np.asarray(hit.prim)[m]]
        np.testing.assert_array_equal(np.asarray(hit.guide)[m], want)

    def test_guided_render_bitwise(self):
        from pathtracer.core.constants import SAMPLING_MIS
        from pathtracer.core.math_utils import luminance
        from pathtracer.ops.guiding import build_cdfs
        from pathtracer.render.radiosity import solve_radiosity
        from pathtracer.render.renderer import (
            ProgressiveRenderer,
            RenderSettings,
        )

        geom = cornell_box("quads").build()
        cam = CameraController.default().build()
        sol = solve_radiosity(geom, jax.random.key(1),
                              num_iterations=4, mc_samples=8)
        cdfs = build_cdfs(luminance(sol.rad_grid))
        s = RenderSettings(width=64, height=64, max_depth=3,
                           spp_per_pass=2, ray_chunk=4096,
                           wavefront=True, sampling_mode=SAMPLING_MIS)

        def render(with_pack):
            accel = pack(geom) if with_pack else None
            r = ProgressiveRenderer(geom, cam, s, cdfs=cdfs, accel=accel)
            if with_pack:  # renderer must have auto-augmented the pack
                assert r.accel.has_guide
            r.step()
            return np.asarray(r.film.accum)

        np.testing.assert_array_equal(render(True), render(False))


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: chip_smoke.py phase (b) runs this check "
                    "on the card")


@pytest.mark.gpu
def test_compiled_kernels_match_xla_on_card(gpu):
    """The Triton-compiled kernels (no interpreter) against XLA's
    closest_hit / occluded at the smoke test's tolerance."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke

    chip_smoke.phase_kernels(n=4096)
