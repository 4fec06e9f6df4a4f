"""Radiosity solver tests: closed-form form factors, reciprocity,
progressive-refinement convergence, history semantics (SURVEY.md §4a)."""

import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer.core import rng
from pathtracer.render.radiosity import (
    RADIOSITY_HISTORY,
    analytic_form_factors,
    direction_to_cell,
    mc_form_factors,
    radiosity_step,
    rebin_radiosity_grid,
    sample_uniform_on_prims,
    solve_radiosity,
)
from pathtracer.scene.mesh import PrimList


def parallel_squares(dist=1.0, side=1.0, emit=0.0):
    """Two coaxial parallel squares facing each other."""
    s = side / 2.0
    # bottom at y=0, normal +y: (o, o+u, o+u+v, o+v) with cross(u,v)=+y
    o = np.array([-s, 0, s], np.float32)
    u = np.array([side, 0, 0], np.float32)
    v = np.array([0, 0, -side], np.float32)
    bottom = np.stack([o, o + u, o + u + v, o + v])
    # top at y=dist, normal -y
    o2 = np.array([-s, dist, -s], np.float32)
    u2 = np.array([side, 0, 0], np.float32)
    v2 = np.array([0, 0, side], np.float32)
    top = np.stack([o2, o2 + u2, o2 + u2 + v2, o2 + v2])
    n = 2
    return PrimList(
        corners=np.stack([bottom, top]),
        is_quad=np.ones(n, bool),
        albedo=np.full((n, 3), 0.5, np.float32),
        emission=np.full((n, 3), emit, np.float32),
        material=np.zeros(n, np.int32),
    )


def exact_parallel_square_ff(c):
    """Closed-form FF between coaxial parallel unit squares, ratio
    c = side/dist (standard radiative-transfer formula)."""
    x = c
    x2 = x * x
    a = np.log((1 + x2) ** 2 / (1 + 2 * x2))
    b = 2 * x * np.sqrt(1 + x2) * np.arctan(x / np.sqrt(1 + x2))
    d = 2 * x * np.arctan(x)
    return (2.0 / (np.pi * x2)) * (0.5 * a + b - d)


class TestFormFactors:
    def test_analytic_matches_formula(self):
        """The centroid point-to-point kernel must reproduce its own
        formula cos*cos*A/(pi r^2) for unobstructed facing patches."""
        geom = parallel_squares(dist=4.0, side=1.0).build()
        ff = np.asarray(analytic_form_factors(geom))
        expect = 1.0 * 1.0 * 1.0 / (np.pi * 16.0)
        assert ff[0, 1] == pytest.approx(expect, rel=1e-5)
        assert ff[1, 0] == pytest.approx(expect, rel=1e-5)
        assert ff[0, 0] == 0.0 and ff[1, 1] == 0.0

    def test_mc_converges_to_exact(self):
        """MC pairwise sampling approximates the true closed-form FF for
        parallel squares (the centroid kernel cannot)."""
        geom = parallel_squares(dist=2.0, side=1.0).build()
        ff, _, _ = mc_form_factors(geom, rng.base_key(3), n_samples=512)
        exact = exact_parallel_square_ff(0.5)
        # The reference estimator uses avg-cos/avg-dist ratios (a slight
        # approximation of E[cos cos / r^2]); allow a few percent.
        assert float(ff[0, 1]) == pytest.approx(exact, rel=0.08)

    def test_unbiased_estimator_beats_reference(self):
        """estimator='unbiased' (per-sample double-area MC) must land
        on the exact closed-form FF within MC noise; the reference's
        ratio-of-averages combiner (same draws) is measurably biased
        low on large close patches (the Jensen gap documented in
        benchmarks/radiosity_forensics.py)."""
        geom = parallel_squares(dist=1.0, side=2.0).build()
        exact = exact_parallel_square_ff(2.0)
        ff_u, _, _ = mc_form_factors(
            geom, rng.base_key(3), n_samples=2048,
            estimator="unbiased",
        )
        ff_r, _, _ = mc_form_factors(
            geom, rng.base_key(3), n_samples=2048,
        )
        err_u = abs(float(ff_u[0, 1]) - exact) / exact
        err_r = abs(float(ff_r[0, 1]) - exact) / exact
        assert err_u < 0.03, (err_u, exact, float(ff_u[0, 1]))
        assert err_u < err_r  # the reference combiner's Jensen bias

    def test_mc_reciprocity(self):
        """A_i F_ij ~= A_j F_ji (detailed balance; statistical)."""
        geom = parallel_squares(dist=1.5, side=1.0).build()
        ff, _, _ = mc_form_factors(geom, rng.base_key(5), n_samples=512)
        a = np.asarray(geom.area)
        lhs = a[0] * float(ff[0, 1])
        rhs = a[1] * float(ff[1, 0])
        assert lhs == pytest.approx(rhs, rel=0.1)

    def test_occluder_blocks(self):
        prims = parallel_squares(dist=2.0, side=1.0)
        # big blocker quad between them
        o = np.array([-3, 1.0, 3], np.float32)
        u = np.array([6, 0, 0], np.float32)
        v = np.array([0, 0, -6], np.float32)
        blocker = np.stack([o, o + u, o + u + v, o + v])
        prims = PrimList(
            corners=np.concatenate([prims.corners, blocker[None]]),
            is_quad=np.ones(3, bool),
            albedo=np.full((3, 3), 0.5, np.float32),
            emission=np.zeros((3, 3), np.float32),
            material=np.zeros(3, np.int32),
        )
        geom = prims.build()
        ff, _, _ = mc_form_factors(geom, rng.base_key(7), n_samples=64)
        assert float(ff[0, 1]) == 0.0
        ffa = analytic_form_factors(geom)
        assert float(ffa[0, 1]) == 0.0

    def test_backface_culled(self):
        """Flip the top square's orientation -> not facing -> FF 0."""
        prims = parallel_squares()
        prims.corners[1] = prims.corners[1][::-1].copy()
        geom = prims.build()
        ff, _, _ = mc_form_factors(geom, rng.base_key(1), n_samples=16)
        assert float(ff[0, 1]) == 0.0


class TestSampling:
    def test_uniform_points_on_quad(self):
        geom = parallel_squares().build()
        n = 4096
        r = np.random.default_rng(0)
        idx = jnp.zeros(n, jnp.int32)
        p = np.asarray(
            sample_uniform_on_prims(
                geom, idx,
                jnp.asarray(r.uniform(size=n), jnp.float32),
                jnp.asarray(r.uniform(size=n), jnp.float32),
            )
        )
        assert abs(p[:, 0].mean()) < 0.02
        assert abs(p[:, 2].mean()) < 0.02
        np.testing.assert_allclose(p[:, 1], 0.0, atol=1e-6)
        assert p[:, 0].min() >= -0.5 and p[:, 0].max() <= 0.5
        # uniformity: variance of U(-0.5,0.5) is 1/12
        assert p[:, 0].var() == pytest.approx(1 / 12, rel=0.1)

    def test_triangle_sampling_inside(self):
        tri = PrimList(
            corners=np.array(
                [[[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 1, 0]]], np.float32
            ),
            is_quad=np.array([False]),
            albedo=np.full((1, 3), 0.5, np.float32),
            emission=np.zeros((1, 3), np.float32),
            material=np.zeros(1, np.int32),
        )
        geom = tri.build()
        r = np.random.default_rng(1)
        n = 2048
        p = np.asarray(
            sample_uniform_on_prims(
                geom, jnp.zeros(n, jnp.int32),
                jnp.asarray(r.uniform(size=n), jnp.float32),
                jnp.asarray(r.uniform(size=n), jnp.float32),
            )
        )
        assert (p[:, 0] >= -1e-6).all() and (p[:, 1] >= -1e-6).all()
        assert (p[:, 0] + p[:, 1] <= 1 + 1e-5).all()
        # centroid of uniform samples -> triangle centroid (1/3, 1/3)
        assert p[:, 0].mean() == pytest.approx(1 / 3, abs=0.02)
        assert p[:, 1].mean() == pytest.approx(1 / 3, abs=0.02)


class TestIterations:
    def test_two_plate_equilibrium(self):
        """B = E + rho F B has closed form for two symmetric plates:
        B = E (1 + rho F + (rho F)^2 + ...) pairwise ->
        B_i = E + rho F B_j; symmetric => B = E / (1 - rho F)."""
        geom = parallel_squares(dist=1.0, side=1.0, emit=1.0).build()
        ff = analytic_form_factors(geom)
        f = float(ff[0, 1])
        radiosity = geom.emission
        unshot = geom.emission
        for _ in range(50):
            radiosity, unshot = radiosity_step(geom, ff, radiosity, unshot)
        expect = 1.0 / (1.0 - 0.5 * f)
        np.testing.assert_allclose(
            np.asarray(radiosity)[0], expect, rtol=1e-5
        )

    def test_energy_clamp(self):
        """reflected <= incident per channel even with albedo > 1
        (form_factors.h:459-463 guard)."""
        prims = parallel_squares(emit=1.0)
        prims.albedo = np.full((2, 3), 2.0, np.float32)
        geom = prims.build()
        ff = analytic_form_factors(geom)
        radiosity, unshot = radiosity_step(
            geom, ff, geom.emission, geom.emission
        )
        incident = np.asarray(ff) @ np.asarray(geom.emission)
        np.testing.assert_allclose(
            np.asarray(unshot), incident, rtol=1e-6
        )

    def test_rebin_conserves_total(self):
        """Sum over grid cells == sum_j B_j F_ij for each receiver."""
        geom = parallel_squares(emit=1.0).build()
        ff = analytic_form_factors(geom)
        B = jnp.ones((2, 3))
        grid = rebin_radiosity_grid(geom, ff, B)
        total = np.asarray(grid).sum(axis=1)
        expect = np.asarray(ff) @ np.ones((2, 3))
        np.testing.assert_allclose(total, expect, rtol=1e-5)

    def test_history_ring(self):
        geom = parallel_squares(emit=1.0).build()
        sol = solve_radiosity(
            geom, rng.base_key(0), num_iterations=3, use_monte_carlo=False
        )
        assert int(sol.history_count) == 3
        # most recent snapshot is the state *before* the last iteration
        h0 = np.asarray(sol.history_at(0))
        h2 = np.asarray(sol.history_at(2))
        np.testing.assert_allclose(h2, np.asarray(geom.emission))
        assert (h0 >= h2 - 1e-6).all()
        # steps beyond history_count are zero
        assert np.asarray(sol.history_at(5)).sum() == 0.0


class TestShooting:
    """Matrix-free progressive shooting must converge to the gather
    solver's fixed point (same MC estimator, independent draws)."""

    def test_matches_gather_solution(self):
        import jax

        from pathtracer.render.radiosity import (
            solve_radiosity_shooting,
        )
        from pathtracer.scene.builtin import cornell_box
        from pathtracer.scene.mesh import subdivide

        geom = subdivide(cornell_box("quads"), 1).build()  # 64 prims
        key = jax.random.key(12345)
        gather = solve_radiosity(geom, key, num_iterations=20,
                                 mc_samples=64)
        shoot = solve_radiosity_shooting(
            geom, key, steps=40, shooters_per_step=16,
            mc_samples=64, check_every=4,
        )
        bg = np.asarray(gather.radiosity)
        bs = np.asarray(shoot.radiosity)
        rel = np.linalg.norm(bs - bg) / np.linalg.norm(bg)
        assert rel < 0.01, rel                 # MC-noise-level agreement
        # unshot power drained to the early-exit tolerance
        assert float(jnp.abs(shoot.unshot).sum()) < 0.05
        # matrix-free: no (N, N) array anywhere
        assert shoot.form_factors.size == 0
        # deterministic under the same key
        shoot2 = solve_radiosity_shooting(
            geom, key, steps=40, shooters_per_step=16,
            mc_samples=64, check_every=4,
        )
        np.testing.assert_array_equal(
            np.asarray(shoot2.radiosity), bs
        )

    def test_ambient_closes_underconverged_tail(self):
        """Stopping shooting early leaves undelivered unshot power; the
        Cohen ambient completion must move the result TOWARD the
        converged gather solution (and never hurt a drained solve)."""
        import jax

        from pathtracer.render.radiosity import (
            solve_radiosity_shooting,
        )
        from pathtracer.scene.builtin import cornell_box
        from pathtracer.scene.mesh import subdivide

        geom = subdivide(cornell_box("quads"), 1).build()
        key = jax.random.key(3)
        gather = solve_radiosity(geom, key, num_iterations=20,
                                 mc_samples=64)
        bg = np.asarray(gather.radiosity)

        def err(sol):
            return (np.linalg.norm(np.asarray(sol.radiosity) - bg)
                    / np.linalg.norm(bg))

        kw = dict(steps=6, shooters_per_step=8, mc_samples=64,
                  check_every=0)
        early_amb = solve_radiosity_shooting(geom, key, ambient=True,
                                             **kw)
        early_raw = solve_radiosity_shooting(geom, key, ambient=False,
                                             **kw)
        # 6x8 = 48 shots over 64 prims: meaningfully under-converged
        assert float(jnp.abs(early_raw.unshot).sum()) > 0.5
        assert err(early_amb) < err(early_raw)
        # ambient is an additive display completion; unshot diagnostics
        # are untouched
        np.testing.assert_array_equal(
            np.asarray(early_amb.unshot), np.asarray(early_raw.unshot)
        )

    def test_transport_stats_conserve_energy(self):
        """The measured per-channel transport stats that calibrate the
        ambient term must satisfy conservation: delivered <= shot (the
        open front loses energy) and reflected <= delivered (albedo
        < 1 plus the per-channel energy clamp)."""
        import jax

        from pathtracer.render.radiosity import (
            _shoot_step,
        )
        from pathtracer.scene.builtin import cornell_box
        from pathtracer.scene.mesh import subdivide
        from pathtracer.core.constants import GRID_SIZE

        geom = subdivide(cornell_box("quads"), 1).build()
        n = geom.num_prims
        z = jnp.zeros((n, GRID_SIZE, 3), jnp.float32)
        zc = jnp.zeros((n, GRID_SIZE), jnp.float32)
        _, _, _, _, st = _shoot_step(
            geom, jax.random.key(0), geom.emission, geom.emission,
            z, zc, jnp.int32(0), k=8, n_samples=64, row_chunk=8,
            accel=None,
        )
        shot, delivered, reflected = np.asarray(st)
        assert (shot > 0).all()
        assert (delivered <= shot + 1e-4).all()
        assert (reflected <= delivered + 1e-5).all()
        assert (delivered > 0).all()   # the light faces the scene

    def test_grids_match_gather_rebin(self):
        """Converged shooting grids carry sum_j B_j x geometry — the
        gather solver's rebin quantity — accumulated incrementally at
        sample directions. Cell-level totals agree up to MC noise and
        binning granularity; compare per-prim grid luminance sums."""
        import jax

        from pathtracer.core.math_utils import luminance
        from pathtracer.render.radiosity import (
            solve_radiosity_shooting,
        )
        from pathtracer.scene.builtin import cornell_box
        from pathtracer.scene.mesh import subdivide

        geom = subdivide(cornell_box("quads"), 1).build()
        key = jax.random.key(7)
        shoot = solve_radiosity_shooting(
            geom, key, steps=40, shooters_per_step=16,
            mc_samples=32, check_every=4,
        )
        g = np.asarray(luminance(shoot.rad_grid))   # (N, 256)
        assert (g >= 0).all()
        # every reflective prim facing the scene received energy
        recv = g.sum(axis=1)
        lit = np.asarray(luminance(shoot.radiosity)) > 1e-3
        assert (recv[lit & (np.asarray(geom.emission).sum(1) == 0)]
                > 0).all()


class TestDirectionToCell:
    def test_up_is_row_zero(self):
        n = jnp.array([[0.0, 1.0, 0.0]])
        cell = int(direction_to_cell(jnp.array([[0.0, 1.0, 0.0]]), n)[0])
        assert 0 <= cell < 16  # theta row 0

    def test_down_is_last_row(self):
        n = jnp.array([[0.0, 1.0, 0.0]])
        cell = int(direction_to_cell(jnp.array([[0.0, -1.0, 0.0]]), n)[0])
        assert cell >= 15 * 16


class TestGridRefresh:
    """solve_radiosity_shooting(grid_refresh=m): the post-solve dense
    rebin replaces the sample-sparse shooting grids; B/unshot must be
    untouched and the refreshed grids must carry energy."""

    def test_refresh_replaces_grids_keeps_b(self):
        import jax

        from pathtracer.render.radiosity import (
            solve_radiosity_shooting,
        )
        from pathtracer.scene.builtin import cornell_box
        from pathtracer.scene.mesh import subdivide

        geom = subdivide(cornell_box("quads"), 1).build()  # 64 prims
        kw = dict(steps=8, shooters_per_step=8, mc_samples=2,
                  check_every=0)
        base = solve_radiosity_shooting(geom, jax.random.key(3), **kw)
        ref = solve_radiosity_shooting(
            geom, jax.random.key(3), grid_refresh=16,
            grid_refresh_samples=4, **kw,
        )
        np.testing.assert_array_equal(
            np.asarray(base.radiosity), np.asarray(ref.radiosity)
        )
        np.testing.assert_array_equal(
            np.asarray(base.unshot), np.asarray(ref.unshot)
        )
        g = np.asarray(ref.rad_grid)
        assert g.sum() > 0
        assert not np.array_equal(g, np.asarray(base.rad_grid))
