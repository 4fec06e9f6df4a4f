"""Multi-chip tests on the 8-device virtual CPU mesh (SURVEY.md §4d):
tiled rendering equals a consistent full-image estimate; sharded form
factors match the single-device result."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer.core import rng
from pathtracer.parallel.sharding import (
    TiledRenderer,
    make_mesh,
    mc_form_factors_sharded,
)
from pathtracer.render.camera import CameraController
from pathtracer.render.radiosity import mc_form_factors
from pathtracer.render.renderer import (
    ProgressiveRenderer,
    RenderSettings,
)
from pathtracer.scene.builtin import cornell_box


@pytest.fixture(scope="module")
def scene():
    geom = cornell_box("quads").build()
    cam = CameraController.default().build()
    return geom, cam


def test_eight_devices_available():
    assert len(jax.devices()) == 8


class TestTiledRender:
    def test_matches_single_chip_statistically(self, scene):
        """Sharded and unsharded renders use different RNG streams but the
        same estimator: per-image means must agree within MC noise."""
        geom, cam = scene
        s = RenderSettings(
            width=64, height=64, max_depth=4, spp_per_pass=32,
            ray_chunk=512,
        )
        single = ProgressiveRenderer(geom, cam, s, seed=5)
        single.step()
        tiled = TiledRenderer(geom, cam, s, seed=9)
        tiled.step()
        a = np.asarray(single.film.mean_radiance())
        b = np.asarray(tiled.gather_film().mean_radiance())
        assert b.shape == a.shape
        assert np.mean(b) == pytest.approx(np.mean(a), rel=0.05)
        # band structure check: per-row means must track between renders
        # (no dark/bright bands at tile boundaries)
        ra = a.mean(axis=(1, 2))
        rb = b.mean(axis=(1, 2))
        corr = np.corrcoef(ra, rb)[0, 1]
        assert corr > 0.95

    def test_matches_single_chip_bitwise(self, scene):
        """RNG is keyed by GLOBAL pixel id and the tiled path reuses the
        full camera + global pixel coords, so with the same seed the
        gathered sharded film is bitwise identical to single-chip."""
        geom, cam = scene
        s = RenderSettings(
            width=64, height=64, max_depth=4, spp_per_pass=4,
            ray_chunk=512,
        )
        single = ProgressiveRenderer(geom, cam, s, seed=5)
        single.step()
        tiled = TiledRenderer(geom, cam, s, seed=5)
        tiled.step()
        np.testing.assert_array_equal(
            np.asarray(tiled.gather_film().accum),
            np.asarray(single.film.accum),
        )

    def test_nondivisible_height_padded(self, scene):
        geom, cam = scene
        s = RenderSettings(
            width=30, height=50, max_depth=2, spp_per_pass=8, ray_chunk=256,
        )
        tiled = TiledRenderer(geom, cam, s, seed=1)
        tiled.step()
        film = tiled.gather_film()
        assert film.accum.shape == (50, 30, 3)
        assert int(film.spp) == 8

    def test_ray_counter_psum(self, scene):
        geom, cam = scene
        s = RenderSettings(
            width=32, height=32, max_depth=2, spp_per_pass=4, ray_chunk=128,
        )
        tiled = TiledRenderer(geom, cam, s, seed=2)
        tiled.step()
        # every primary ray hits the box or misses; counter counts lanes
        # alive at each bounce over ALL tiles: at least all primaries
        # (padded rows included), at most depth * lanes
        lanes = 32 * 32 * 4  # = spp * pixels (hpad == 32 here)
        assert tiled.total_rays >= lanes
        assert tiled.total_rays <= 2 * lanes

    def test_second_pass_reuses_executable(self, scene):
        """The film starts with the shardings a pass returns, so pass 2
        does not compile the tiled program again."""
        from pathtracer.parallel.sharding import render_pass_tiled

        geom, cam = scene
        s = RenderSettings(
            width=16, height=24, max_depth=2, spp_per_pass=1, ray_chunk=64,
        )
        tiled = TiledRenderer(geom, cam, s, seed=4)
        tiled.step()
        compiled = render_pass_tiled._cache_size()
        tiled.step()
        tiled.step()
        assert render_pass_tiled._cache_size() == compiled
        assert int(tiled.film.spp) == 3


class TestShardedFormFactors:
    def test_matches_unsharded_bitwise(self):
        """Global-chunk RNG keying makes the row-sharded FF build
        BITWISE equal to the single-chip matrix (same effective
        row_chunk) — the film-sharding invariant, for the solver."""
        geom = cornell_box("quads").build()
        key = rng.base_key(3)
        ff_s, gc_s, gv_s = mc_form_factors_sharded(
            geom, key, n_samples=32, row_chunk=2
        )
        ff_u, gc_u, gv_u = mc_form_factors(
            geom, key, n_samples=32, row_chunk=2
        )
        assert ff_s.shape == ff_u.shape == (16, 16)
        np.testing.assert_array_equal(np.asarray(ff_s),
                                      np.asarray(ff_u))
        np.testing.assert_array_equal(np.asarray(gc_s),
                                      np.asarray(gc_u))
        np.testing.assert_array_equal(np.asarray(gv_s),
                                      np.asarray(gv_u))
        np.testing.assert_allclose(np.diag(np.asarray(ff_s)), 0.0)
        # row_chunk > n/devices: the effective chunk must still match
        # the single-chip build (devices past the real rows idle)
        ff_s2, _, _ = mc_form_factors_sharded(
            geom, key, n_samples=8, row_chunk=16
        )
        ff_u2, _, _ = mc_form_factors(geom, key, n_samples=8,
                                      row_chunk=16)
        np.testing.assert_array_equal(np.asarray(ff_s2),
                                      np.asarray(ff_u2))

    def test_launch_split_invariant(self):
        """Row bands launched apart, each keyed by its global chunk
        offset, rebuild the one-launch matrix bitwise (what every
        row-banded caller relies on)."""
        import jax.numpy as jnp

        from pathtracer.render.radiosity import mc_form_factors_rows

        geom = cornell_box("quads").build()
        key = rng.base_key(9)
        one, gc1, gv1 = mc_form_factors(
            geom, key, n_samples=16, row_chunk=2
        )
        rows = jnp.arange(geom.num_prims, dtype=jnp.int32)
        parts = [
            mc_form_factors_rows(geom, key, rows[s:s + 4], n_samples=16,
                                 row_chunk=2, chunk_offset=s // 2)
            for s in range(0, geom.num_prims, 4)
        ]
        split, gv2 = (np.concatenate([np.asarray(p[i]) for p in parts])
                      for i in (0, 2))
        np.testing.assert_array_equal(np.asarray(one), split)
        np.testing.assert_array_equal(np.asarray(gv1), gv2)


class TestShardedShooting:
    def test_matches_single_chip(self):
        """Row-sharded matrix-free shooting == single-chip shooting:
        same top-k shooters (replicated unshot), same global-chunk MC
        streams, local reflect + all_gather. Bitwise on radiosity."""
        import jax

        from pathtracer.parallel.sharding import (
            make_mesh,
            solve_radiosity_shooting_sharded,
        )
        from pathtracer.render.radiosity import (
            solve_radiosity_shooting,
        )
        from pathtracer.scene.builtin import cornell_box
        from pathtracer.scene.mesh import subdivide

        geom = subdivide(cornell_box("quads"), 1).build()  # 64 prims
        key = jax.random.key(11)
        # row_chunk=16 > n/devices=8: the sharded solver must still use
        # the single-chip effective chunk (regression: it once clamped
        # to n//n_dev, silently diverging for larger row_chunks)
        single = solve_radiosity_shooting(
            geom, key, steps=12, shooters_per_step=16,
            mc_samples=16, row_chunk=16, check_every=4,
        )
        sharded = solve_radiosity_shooting_sharded(
            geom, key, mesh=make_mesh(8), steps=12,
            shooters_per_step=16, mc_samples=16, row_chunk=16,
            check_every=4,
        )
        np.testing.assert_array_equal(
            np.asarray(sharded.radiosity), np.asarray(single.radiosity)
        )
        np.testing.assert_array_equal(
            np.asarray(sharded.unshot), np.asarray(single.unshot)
        )
        np.testing.assert_array_equal(
            np.asarray(sharded.rad_grid), np.asarray(single.rad_grid)
        )
        assert sharded.form_factors.size == 0


class TestTiledGuided:
    def test_tiled_mis_render(self, scene):
        """Guided MIS sampling through the multi-chip tiled path."""
        from pathtracer.core.constants import SAMPLING_MIS
        from pathtracer.ops.guiding import build_cdfs
        import jax.numpy as jnp

        geom, cam = scene
        cdfs = build_cdfs(jnp.ones((geom.num_prims, 256)))
        s = RenderSettings(
            width=32, height=32, max_depth=3, spp_per_pass=8,
            ray_chunk=128, sampling_mode=SAMPLING_MIS,
        )
        tiled = TiledRenderer(geom, cam, s, cdfs=cdfs, seed=4)
        tiled.step()
        film = tiled.gather_film()
        img = np.asarray(film.mean_radiance())
        assert img.shape == (32, 32, 3)
        assert img.mean() > 0
        # same seed => the row-band tiled MIS film must be bitwise
        # identical to single-chip (the sharding invariant, same as the
        # BSDF test above — guided modes included)
        single = ProgressiveRenderer(geom, cam, s, cdfs=cdfs, seed=4)
        single.step()
        np.testing.assert_array_equal(
            img, np.asarray(single.film.mean_radiance())
        )


class TestShardedSolve:
    def test_sharded_solve_matches_single(self):
        """Row-sharded radiosity solve == single-chip solve (the FF
        build is keyed identically; the iteration math is the same
        gather/reflect/rebin per row)."""
        import jax
        import jax.numpy as jnp

        from pathtracer.parallel.sharding import (
            make_mesh,
            solve_radiosity_sharded,
        )
        from pathtracer.render.radiosity import solve_radiosity
        from pathtracer.scene.builtin import cornell_box
        from pathtracer.scene.mesh import subdivide

        from pathtracer.render.radiosity import (
            radiosity_step,
            rebin_radiosity_grid,
        )

        geom = subdivide(cornell_box("quads"), 1).build()  # 64 prims
        key = jax.random.key(7)
        mesh = make_mesh(8)
        sharded = solve_radiosity_sharded(
            geom, key, mesh=mesh, num_iterations=4, mc_samples=8,
            row_chunk=8,
        )
        # replay the iteration math single-chip on the SAME (gathered)
        # form factors: the row-sharded gather/reflect/all-gather/rebin
        # must agree with the reference single-chip loop
        ff = jnp.asarray(sharded.form_factors)
        radiosity = geom.emission
        unshot = geom.emission
        for _ in range(4):
            radiosity, unshot = radiosity_step(geom, ff, radiosity,
                                               unshot)
        rad_grid = rebin_radiosity_grid(geom, ff, radiosity)
        assert jnp.allclose(radiosity, sharded.radiosity,
                            rtol=1e-5, atol=1e-6)
        assert jnp.allclose(rad_grid, sharded.rad_grid,
                            rtol=1e-4, atol=1e-5)

        # and statistically: an independent single-chip solve (different
        # MC sample streams) lands close in the mean
        single = solve_radiosity(geom, key, num_iterations=4,
                                 mc_samples=8, row_chunk=8)
        assert jnp.allclose(
            jnp.mean(single.radiosity), jnp.mean(sharded.radiosity),
            rtol=0.05,
        )


class TestTiledAccel:
    """Multi-device tiled rendering through each intersection structure
    (ops/dispatch), replicated like the scene. Per-pixel sums are
    lane-order invariant (pixel-keyed RNG, same-pixel respawn), so the
    gathered film must be bitwise identical to the single-device render
    through the same structure."""

    @pytest.mark.parametrize("backend", ["triton", "bvh"])
    def test_tiled_matches_single_chip_bitwise(self, backend):
        from pathtracer.ops.dispatch import build_accel
        from pathtracer.scene.mesh import subdivide

        geom = subdivide(cornell_box("quads"), 2).build()  # 512 tris
        cam = CameraController.default().build()
        s = RenderSettings(
            width=32, height=32, max_depth=3, spp_per_pass=1,
            ray_chunk=1024,
        )
        accel = build_accel(geom, backend, interpret=True)
        single = ProgressiveRenderer(geom, cam, s, seed=7, accel=accel)
        single.step()
        tiled = TiledRenderer(geom, cam, s, seed=7, accel=accel)
        tiled.step()
        np.testing.assert_array_equal(
            np.asarray(tiled.gather_film().accum),
            np.asarray(single.film.accum),
        )
        assert tiled.total_rays > 0
