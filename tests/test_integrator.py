"""Statistical integrator tests (SURVEY.md §4b): white-furnace unbiasedness
for every sampling mode, emission handling, Russian roulette, mirror lobe."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer.core.constants import (
    MATERIAL_MIRROR,
    SAMPLING_BSDF,
    SAMPLING_MIS,
    SAMPLING_RADIOSITY,
)
from pathtracer.core import rng as rng_mod
from pathtracer.ops.guiding import build_cdfs
from pathtracer.render.integrator import trace
from pathtracer.scene.mesh import PrimList


def closed_cube(albedo=0.5, emit=0.5):
    """Closed cube interior: every face emits `emit` and reflects `albedo`.

    Inside it, the expected path radiance is analytically
        L = emit * sum_{k=0}^{D-1} albedo^k
    independent of geometry — a white-furnace test that exercises
    intersection, offsets, RR, and the sampling warp end to end.
    """
    s = 1.0
    faces = []
    # six inward-facing quads of a [-1,1]^3 cube
    defs = [
        ([-s, -s, -s], [2 * s, 0, 0], [0, 2 * s, 0]),   # back z=-1, +z
        ([s, -s, s], [-2 * s, 0, 0], [0, 2 * s, 0]),    # front z=+1, -z
        ([-s, -s, s], [0, 0, -2 * s], [0, 2 * s, 0]),   # left x=-1, +x
        ([s, -s, -s], [0, 0, 2 * s], [0, 2 * s, 0]),    # right x=+1, -x
        ([-s, -s, s], [2 * s, 0, 0], [0, 0, -2 * s]),   # floor y=-1, +y
        ([-s, s, -s], [2 * s, 0, 0], [0, 0, 2 * s]),    # ceil y=+1, -y
    ]
    for o, u, v in defs:
        o, u, v = (np.asarray(x, np.float32) for x in (o, u, v))
        faces.append(np.stack([o, o + u, o + u + v, o + v]))
    n = len(faces)
    return PrimList(
        corners=np.stack(faces),
        is_quad=np.ones(n, bool),
        albedo=np.full((n, 3), albedo, np.float32),
        emission=np.full((n, 3), emit, np.float32),
        material=np.zeros(n, np.int32),
    )


def furnace_expected(albedo, emit, depth):
    return emit * sum(albedo**k for k in range(depth))


def random_inside_rays(n, seed=0):
    r = np.random.default_rng(seed)
    o = r.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def run_furnace(mode, depth=4, albedo=0.5, emit=0.5, n=1 << 14, cdfs=None,
                **kw):
    geom = closed_cube(albedo, emit).build()
    o, d = random_inside_rays(n)
    radiance, stats = trace(
        geom, o, d, rng_mod.base_key(42), max_depth=depth, mode=mode,
        cdfs=cdfs, **kw,
    )
    return float(jnp.mean(radiance)), stats


class TestFurnace:
    def test_bsdf_mode(self):
        got, _ = run_furnace(SAMPLING_BSDF, depth=4)
        assert got == pytest.approx(furnace_expected(0.5, 0.5, 4), rel=0.01)

    def test_depth_one_is_pure_emission(self):
        got, _ = run_furnace(SAMPLING_BSDF, depth=1)
        assert got == pytest.approx(0.5, abs=1e-5)

    def test_rr_unbiased_deep(self):
        """Depth 8 engages RR (depth > 2); estimate must stay unbiased."""
        got, _ = run_furnace(SAMPLING_BSDF, depth=8, albedo=0.8, n=1 << 15)
        assert got == pytest.approx(
            furnace_expected(0.8, 0.5, 8), rel=0.02
        )

    def test_grid_mode_uniform_grid(self):
        """Pure grid sampling with a uniform valid grid stays ~unbiased
        (small tolerated bias from the reference's cell-centered pdf
        approximation, grid.h:258-273 — we replicate it faithfully)."""
        geom = closed_cube().build()
        cdfs = build_cdfs(jnp.ones((geom.num_prims, 256)))
        got, _ = run_furnace(SAMPLING_RADIOSITY, depth=4, cdfs=cdfs)
        assert got == pytest.approx(furnace_expected(0.5, 0.5, 4), rel=0.05)

    def test_mis_mode_uniform_grid(self):
        geom = closed_cube().build()
        cdfs = build_cdfs(jnp.ones((geom.num_prims, 256)))
        got, _ = run_furnace(
            SAMPLING_MIS, depth=4, cdfs=cdfs, mis_bsdf_fraction=0.5
        )
        assert got == pytest.approx(furnace_expected(0.5, 0.5, 4), rel=0.05)

    def test_invalid_grid_falls_back_to_cosine(self):
        """All-zero grids are invalid -> integrator must behave exactly
        like BSDF mode (integrator.h:259-262 fallback)."""
        geom = closed_cube().build()
        cdfs = build_cdfs(jnp.zeros((geom.num_prims, 256)))
        got, _ = run_furnace(SAMPLING_RADIOSITY, depth=4, cdfs=cdfs)
        assert got == pytest.approx(furnace_expected(0.5, 0.5, 4), rel=0.01)


class TestStats:
    def test_ray_counts(self):
        n = 1 << 10
        _, stats = run_furnace(SAMPLING_BSDF, depth=3, n=n)
        alive = np.asarray(stats.depth_alive)
        # closed cube: nothing ever escapes, no RR at depth<=2
        assert alive.tolist() == [n, n, n]
        assert int(stats.rays) == 3 * n

    def test_ray_counts_include_nee_shadow_rays(self):
        """With nee=True every live diffuse vertex below the last-depth
        gate fires one occlusion ray; Mrays accounting must count it.
        Closed cube, depth 3: 3n path rays + 2n shadow
        rays (depths 0 and 1; depth 2 is the gated last vertex)."""
        n = 1 << 10
        _, stats = run_furnace(SAMPLING_BSDF, depth=3, n=n, nee=True)
        assert np.asarray(stats.depth_alive).tolist() == [n, n, n]
        assert int(stats.rays) == 5 * n


class TestMirror:
    def test_mirror_bounce_reaches_light(self):
        """Camera ray hits a mirror floor; the only light is positioned so
        that just the reflected direction sees it."""
        floor = np.array(
            [[-2, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2]], np.float32
        )[:, [0, 1, 2]]
        # quad with +y normal: corners (o, o+u, o+u+v, o+v), u=+x, v=-z
        o = np.array([-2, 0, 2], np.float32)
        u = np.array([4, 0, 0], np.float32)
        v = np.array([0, 0, -4], np.float32)
        floor = np.stack([o, o + u, o + u + v, o + v])
        light = np.stack(
            [
                np.array([-0.5, 3, -0.5], np.float32),
                np.array([0.5, 3, -0.5], np.float32),
                np.array([0.5, 3, 0.5], np.float32),
                np.array([-0.5, 3, 0.5], np.float32),
            ]
        )
        prims = PrimList(
            corners=np.stack([floor, light]),
            is_quad=np.array([True, True]),
            albedo=np.array([[0.9, 0.9, 0.9], [0.0, 0.0, 0.0]], np.float32),
            emission=np.array([[0, 0, 0], [5.0, 5.0, 5.0]], np.float32),
            material=np.array([MATERIAL_MIRROR, 0], np.int32),
        )
        geom = prims.build()
        # ray from (0, 3, 0) downward is reflected straight back up into
        # the light: L = beta * Le = 0.9 * 5
        ro = jnp.array([[0.0, 2.0, 0.0]])
        rd = jnp.array([[0.0, -1.0, 0.0]])
        radiance, _ = trace(
            geom, ro, rd, rng_mod.base_key(0), max_depth=3,
            mode=SAMPLING_BSDF,
        )
        np.testing.assert_allclose(
            np.asarray(radiance)[0], [4.5, 4.5, 4.5], rtol=1e-5
        )


class TestWavefront:
    def test_furnace_matches_analytic(self):
        """The same-pixel-respawn wavefront integrator is an unbiased
        estimator of the same integral as the scan integrator."""
        from pathtracer.render.camera import CameraController
        from pathtracer.render.integrator import trace_wavefront

        geom = closed_cube(0.5, 0.5).build()
        cam = CameraController(
            lookfrom=np.zeros(3) + 1e-3,
            lookat=np.array([0.0, 0.0, -1.0]),
            vup=np.array([0.0, 1.0, 0.0]),
            vfov=60.0,
            aspect=1.0,
        ).build()
        n = 1 << 12
        x = jnp.arange(n, dtype=jnp.float32) % 64
        y = jnp.arange(n, dtype=jnp.float32) // 64
        total, rays, iters = trace_wavefront(
            geom, cam, x, y, rng_mod.base_key(9),
            width=64, height=64, spp=8, max_depth=4,
            mode=SAMPLING_BSDF,
        )
        mean = float(jnp.mean(total / 8.0))
        assert mean == pytest.approx(furnace_expected(0.5, 0.5, 4), rel=0.02)
        assert int(rays) > 0
        # occupancy: iterations should be well under spp * max_depth
        # (every path in the closed cube runs full depth -> equality here)
        assert int(iters) <= 8 * 4 + 4

    def test_respawn_quota_exact(self):
        """Every lane must complete exactly `spp` samples: radiance sums
        scale linearly with spp."""
        from pathtracer.render.camera import CameraController
        from pathtracer.render.integrator import trace_wavefront

        geom = closed_cube(0.0, 1.0).build()  # pure emission, depth 1
        cam = CameraController(
            lookfrom=np.zeros(3) + 1e-3,
            lookat=np.array([0.0, 0.0, -1.0]),
            vup=np.array([0.0, 1.0, 0.0]),
            vfov=60.0,
            aspect=1.0,
        ).build()
        n = 256
        x = jnp.arange(n, dtype=jnp.float32) % 16
        y = jnp.arange(n, dtype=jnp.float32) // 16
        for spp in (1, 4):
            total, _, _ = trace_wavefront(
                geom, cam, x, y, rng_mod.base_key(1),
                width=16, height=16, spp=spp, max_depth=1,
                mode=SAMPLING_BSDF,
            )
            np.testing.assert_allclose(
                np.asarray(total), spp * 1.0, rtol=1e-5
            )

    def test_sorted_wavefront_matches_unsorted(self):
        """Ray sorting is a pure permutation: RNG draws are keyed by lane
        id (which travels with the permutation), so sorting must not
        change ANY lane's radiance — bitwise."""
        from pathtracer.render.camera import CameraController
        from pathtracer.render.integrator import trace_wavefront

        geom = closed_cube(0.5, 0.5).build()
        cam = CameraController(
            lookfrom=np.zeros(3) + 1e-3,
            lookat=np.array([0.0, 0.0, -1.0]),
            vup=np.array([0.0, 1.0, 0.0]),
            vfov=60.0,
            aspect=1.0,
        ).build()
        n = 1 << 12
        x = jnp.arange(n, dtype=jnp.float32) % 64
        y = jnp.arange(n, dtype=jnp.float32) // 64
        kw = dict(width=64, height=64, spp=8, max_depth=4,
                  mode=SAMPLING_BSDF)
        t_plain, r1, _ = trace_wavefront(
            geom, cam, x, y, rng_mod.base_key(9), **kw
        )
        t_sorted, r2, _ = trace_wavefront(
            geom, cam, x, y, rng_mod.base_key(9), sort_rays=True, **kw
        )
        expect = furnace_expected(0.5, 0.5, 4)
        assert float(jnp.mean(t_plain / 8)) == pytest.approx(expect, rel=0.02)
        np.testing.assert_array_equal(
            np.asarray(t_sorted), np.asarray(t_plain)
        )
        assert int(r2) == int(r1)


class TestChunkInvariance:
    """RNG is keyed by global pixel id (core.rng.lane_uniforms), so the
    film must be bitwise identical for any ray_chunk setting — the chunk
    size is purely a memory/performance knob (CLAUDE.md invariant)."""

    @pytest.mark.parametrize("wavefront", [True, False])
    def test_render_pass_bitwise_chunk_invariant(self, wavefront):
        from pathtracer.render.camera import CameraController
        from pathtracer.render.renderer import (
            ProgressiveRenderer,
            RenderSettings,
        )
        from pathtracer.scene.builtin import cornell_box

        geom = cornell_box("quads").build()
        cam = CameraController.default().build()
        films = []
        for chunk in (256, 1024):
            s = RenderSettings(
                width=32, height=32, max_depth=3, spp_per_pass=4,
                ray_chunk=chunk, wavefront=wavefront,
            )
            r = ProgressiveRenderer(geom, cam, s, seed=3)
            r.step()
            films.append(np.asarray(r.film.accum))
        np.testing.assert_array_equal(films[0], films[1])
        assert np.isfinite(films[0]).all() and films[0].max() > 0


class TestPixelQueues:
    """Queue mode ((B, K) pixel arrays) is pure scheduling: because
    draws are keyed by (pixel, sample, depth), the per-pixel radiance
    sums must be BITWISE identical to the flat (K=1) render — for any
    pairing, with or without in-flight ray sorting."""

    @staticmethod
    def _open_scene():
        """One emissive quad covering half the view: half the pixels
        miss immediately (cheap lanes), half bounce (expensive lanes) —
        the load shape queue balancing exists for."""
        from pathtracer.render.camera import CameraController

        o = np.array([-2.0, -2.0, -3.0])
        u = np.array([2.0, 0.0, 0.0])
        v = np.array([0.0, 2.0, 0.0])
        corners = np.stack([o, o + u, o + u + v, o + v])[None].astype(
            np.float32
        )
        prims = PrimList(
            corners=corners,
            is_quad=np.ones(1, bool),
            albedo=np.full((1, 3), 0.7, np.float32),
            emission=np.full((1, 3), 0.4, np.float32),
            material=np.zeros(1, np.int32),
        )
        geom = prims.build()
        cam = CameraController(
            lookfrom=np.array([0.0, 0.0, 1.0]),
            lookat=np.array([0.0, 0.0, -1.0]),
            vup=np.array([0.0, 1.0, 0.0]),
            vfov=70.0,
            aspect=1.0,
        ).build()
        return geom, cam

    @pytest.mark.parametrize("sort_rays", [False, True])
    def test_queued_matches_flat_bitwise(self, sort_rays):
        from pathtracer.render.integrator import trace_wavefront

        geom, cam = self._open_scene()
        n = 512
        ids = jnp.arange(n, dtype=jnp.int32)
        x = (ids % 32).astype(jnp.float32)
        y = (ids // 32).astype(jnp.float32)
        kw = dict(width=32, height=16, spp=4, max_depth=3,
                  mode=SAMPLING_BSDF)
        key = rng_mod.base_key(11)
        flat, rays_f, _ = trace_wavefront(
            geom, cam, x, y, key, sort_rays=sort_rays, **kw
        )

        # adversarial pairing: first half of the frame with the second,
        # reversed — lanes advance slots at very different iterations
        perm = jnp.concatenate([ids[: n // 2], ids[n // 2:][::-1]])
        q = perm.reshape(2, n // 2).T                      # (256, 2)
        total, rays_q, _ = trace_wavefront(
            geom, cam, x[q], y[q], key, lane_ids=ids[q],
            sort_rays=sort_rays, **kw
        )
        assert total.shape == (n // 2, 2, 3)
        per_pixel = jnp.zeros((n, 3)).at[q.reshape(-1)].set(
            total.reshape(-1, 3)
        )
        np.testing.assert_array_equal(
            np.asarray(per_pixel), np.asarray(flat)
        )
        assert int(rays_q) == int(rays_f)
        assert float(jnp.abs(flat).max()) > 0

    def test_balanced_render_pass_bitwise(self):
        """ProgressiveRenderer with balance_lanes=K (probe + dealt lane
        queues) must produce a bitwise-identical film to balance off."""
        from pathtracer.render.camera import CameraController
        from pathtracer.render.renderer import (
            ProgressiveRenderer,
            RenderSettings,
        )
        from pathtracer.scene.builtin import cornell_box

        geom = cornell_box("quads").build()
        cam = CameraController.default().build()
        films = []
        for k in (0, 2):
            s = RenderSettings(
                width=64, height=64, max_depth=3, spp_per_pass=4,
                ray_chunk=2048, balance_lanes=k,
            )
            r = ProgressiveRenderer(geom, cam, s, seed=5)
            r.step()
            if k:
                assert r._assignment is not None  # probe + deal ran
            films.append(np.asarray(r.film.accum))
        np.testing.assert_array_equal(films[0], films[1])
        assert np.isfinite(films[0]).all() and films[0].max() > 0

    def test_balance_fallback_untileable(self):
        """Shapes that don't tile (npix % (1024*K) != 0) must fall back
        to the unbalanced path, bitwise-unchanged."""
        from pathtracer.render.camera import CameraController
        from pathtracer.render.renderer import (
            ProgressiveRenderer,
            RenderSettings,
        )
        from pathtracer.scene.builtin import cornell_box

        geom = cornell_box("quads").build()
        cam = CameraController.default().build()
        films = []
        for k in (0, 3):   # 4096 % (1024*3) != 0
            s = RenderSettings(
                width=64, height=64, max_depth=2, spp_per_pass=2,
                ray_chunk=1024, balance_lanes=k,
            )
            r = ProgressiveRenderer(geom, cam, s, seed=1)
            r.step()
            if k:
                assert r._assignment is None
            films.append(np.asarray(r.film.accum))
        np.testing.assert_array_equal(films[0], films[1])


class TestNextEventEstimation:
    """NEE (additive capability; the reference's integrator.h has no
    light sampling): unbiasedness, last-vertex gating, variance win,
    and scan/wavefront estimator agreement."""

    def test_furnace_unbiased(self):
        """MIS-weighted NEE must not shift the furnace mean (the +0.65%
        last-vertex truncation bias is gated off — see _shade)."""
        got, _ = run_furnace(SAMPLING_BSDF, depth=5, n=1 << 14, nee=True)
        assert got == pytest.approx(furnace_expected(0.5, 0.5, 5),
                                    rel=0.01)

    def test_depth_one_matches_pure_emission(self):
        """max_depth=1 has no non-final vertex: NEE must add nothing
        and the estimate reduces to directly visible emission."""
        got, _ = run_furnace(SAMPLING_BSDF, depth=1, nee=True)
        assert got == pytest.approx(0.5, abs=1e-5)

    def test_nee_off_columns_unchanged(self):
        """Enabling NEE appends RNG columns; with the term masked out
        lane draws for the base estimator are identical, so a scene
        with NO sampleable lights renders bitwise-identically."""
        from pathtracer.render.integrator import (
            build_nee_pack, nee_hit_weight,
        )
        geom = closed_cube(emit=0.0).build()    # no emitters: poa == 0
        o, d = random_inside_rays(2048)
        key = rng_mod.base_key(7)
        r0, _ = trace(geom, o, d, key, max_depth=4)
        r1, _ = trace(geom, o, d, key, max_depth=4, nee=True)
        np.testing.assert_array_equal(np.asarray(r0), np.asarray(r1))

    def test_hit_weight_sentinel_and_off_table(self):
        """prev_pdf < 0 (camera/mirror) and off-table emitters must both
        give hit-side weight exactly 1."""
        from pathtracer.render.integrator import (
            build_nee_pack, nee_hit_weight,
        )
        from pathtracer.ops.intersect import closest_hit
        geom = closed_cube(emit=0.5).build()
        pack = build_nee_pack(geom)
        o, d = random_inside_rays(64)
        hit = closest_hit(geom, o, d, t_min=1e-4)
        w_cam = nee_hit_weight(pack, hit, d, jnp.full((64,), -1.0))
        np.testing.assert_array_equal(np.asarray(w_cam), 1.0)
        # competing strategies: weight strictly inside (0, 1)
        w = np.asarray(nee_hit_weight(pack, hit, d, jnp.full((64,), 0.3)))
        assert (w > 0.0).all() and (w < 1.0).all()

    def test_wavefront_matches_scan_mean(self):
        """Same estimator in both integrators: cbox means agree within
        combined MC error at equal spp."""
        from pathtracer.render.camera import CameraController
        from pathtracer.render.renderer import (
            ProgressiveRenderer,
            RenderSettings,
        )
        from pathtracer.scene.builtin import cornell_box

        geom = cornell_box("quads").build()
        cam = CameraController.default().build()
        means = []
        for wavefront in (True, False):
            s = RenderSettings(width=32, height=32, max_depth=5,
                               spp_per_pass=64, ray_chunk=1024,
                               wavefront=wavefront, nee=True)
            r = ProgressiveRenderer(geom, cam, s, seed=3)
            r.step()
            means.append(float(np.asarray(r.film.accum).mean()) / 64)
        assert means[0] == pytest.approx(means[1], rel=0.02)

    def test_variance_reduction_on_small_emitter(self):
        """The capability claim: on the cbox (small ceiling light) NEE
        at 8 spp must beat BSDF-only at 8 spp by >2x RMSE against a
        256-spp NEE reference (measured ~7x at 16 spp / 128^2)."""
        from pathtracer.render.camera import CameraController
        from pathtracer.render.renderer import (
            ProgressiveRenderer,
            RenderSettings,
        )
        from pathtracer.scene.builtin import cornell_box

        geom = cornell_box("quads").build()
        cam = CameraController.default().build()

        def film(nee, spp, seed):
            s = RenderSettings(width=32, height=32, max_depth=5,
                               spp_per_pass=spp, ray_chunk=1024, nee=nee)
            r = ProgressiveRenderer(geom, cam, s, seed=seed)
            r.step()
            return np.asarray(r.film.accum, np.float64) / spp

        ref = film(True, 256, 1)
        rmse_bsdf = np.sqrt(np.mean((film(False, 8, 2) - ref) ** 2))
        rmse_nee = np.sqrt(np.mean((film(True, 8, 3) - ref) ** 2))
        assert rmse_nee * 2.0 < rmse_bsdf

    def test_furnace_unbiased_mis_mode(self):
        """NEE composed with one-sample guided MIS: the forward density
        is the true mixture p_b*cos/pi + p_g*grid, used on both the
        NEE side and the hit side — furnace mean must be unchanged."""
        geom = closed_cube().build()
        cdfs = build_cdfs(jnp.ones((geom.num_prims, 256)))
        got, _ = run_furnace(SAMPLING_MIS, depth=4, cdfs=cdfs,
                             mis_bsdf_fraction=0.5, nee=True, n=1 << 15)
        assert got == pytest.approx(furnace_expected(0.5, 0.5, 4),
                                    rel=0.05)

    def test_furnace_unbiased_grid_mode(self):
        """NEE composed with pure grid guiding (forward density = grid
        pdf where valid, cosine fallback elsewhere)."""
        geom = closed_cube().build()
        cdfs = build_cdfs(jnp.ones((geom.num_prims, 256)))
        got, _ = run_furnace(SAMPLING_RADIOSITY, depth=4, cdfs=cdfs,
                             nee=True, n=1 << 15)
        assert got == pytest.approx(furnace_expected(0.5, 0.5, 4),
                                    rel=0.05)

    def test_guided_nee_invalid_grid_matches_bsdf_nee(self):
        """All-invalid grids: guided+NEE must degrade to EXACTLY the
        BSDF+NEE estimator in value (same fallback directions, same
        cosine forward density in both MIS weights) — the draw columns
        differ (6+3 vs 3+3) so compare means, not bits."""
        geom = closed_cube(emit=0.5).build()
        cdfs = build_cdfs(jnp.zeros((geom.num_prims, 256)))
        o, d = random_inside_rays(1 << 14)
        key = rng_mod.base_key(9)
        r_b, _ = trace(geom, o, d, key, max_depth=4, nee=True)
        r_g, _ = trace(geom, o, d, key, max_depth=4, nee=True,
                       mode=SAMPLING_RADIOSITY, cdfs=cdfs)
        mb = float(jnp.mean(r_b))
        mg = float(jnp.mean(r_g))
        assert mg == pytest.approx(mb, rel=0.02)
