"""Guided-sampling CDF tests: build vs a scalar oracle, sampling
distribution chi-square, pdf consistency (SURVEY.md §4b)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer.core.constants import (
    GRID_HALF_RES,
    GRID_RES,
    GRID_SIZE,
)
from pathtracer.ops.guiding import (
    build_cdfs,
    build_cdfs_from_radiosity_grid,
    grid_pdf,
    sample_grid,
    top_k_mask,
)


def scalar_cdf_oracle(pdf):
    """Scalar implementation of the reference CDF build
    (application_state.h:516-567) for one 256-cell grid."""
    row_sums = np.zeros(8)
    total = 0.0
    for v in range(8):
        row_sums[v] = pdf[v * 16 : (v + 1) * 16].sum()
        total += row_sums[v]
    marginal = np.zeros(8)
    running = 0.0
    inv_total = 1.0 / total if total > 1e-6 else 0.0
    for v in range(8):
        running += row_sums[v]
        marginal[v] = running * inv_total
    marginal[7] = 1.0
    row_cdfs = np.zeros(256)
    for v in range(8):
        off = v * 16
        if row_sums[v] < 1e-6:
            for u in range(16):
                row_cdfs[off + u] = (u + 1) / 16.0
        else:
            run = 0.0
            for u in range(16):
                run += pdf[off + u]
                row_cdfs[off + u] = run / row_sums[v]
            row_cdfs[off + 15] = 1.0
    for v in range(8, 16):
        off = v * 16
        for u in range(16):
            row_cdfs[off + u] = (u + 1) / 16.0
    return row_sums, marginal, row_cdfs, total


class TestBuild:
    def test_matches_scalar_oracle(self):
        r = np.random.default_rng(0)
        pdf = r.uniform(0, 2, (5, 256)).astype(np.float32)
        pdf[1] = 0.0                      # invalid grid
        pdf[2, :32] = 0.0                 # two empty rows
        pack = build_cdfs(jnp.asarray(pdf))
        for i in range(5):
            rs, marg, rows, tot = scalar_cdf_oracle(pdf[i].astype(np.float64))
            np.testing.assert_allclose(
                np.asarray(pack.row_sums)[i], rs, rtol=1e-4
            )
            np.testing.assert_allclose(
                np.asarray(pack.marginal_cdf)[i], marg, atol=1e-5
            )
            np.testing.assert_allclose(
                np.asarray(pack.row_cdfs)[i], rows, atol=1e-5
            )
            assert float(pack.total_weight[i]) == pytest.approx(
                tot, rel=1e-4
            )
        assert not bool(pack.valid[1])
        assert bool(pack.valid[0])

    def test_luminance_source(self):
        rad = np.zeros((1, 256, 3), np.float32)
        rad[0, :, 1] = 1.0  # pure green
        pack = build_cdfs_from_radiosity_grid(jnp.asarray(rad))
        np.testing.assert_allclose(np.asarray(pack.pdf), 0.7152, rtol=1e-4)

    def test_top_k(self):
        pdf = jnp.asarray(
            np.arange(256, dtype=np.float32)[None, :]
        )
        masked = np.asarray(top_k_mask(pdf, 10))
        assert (masked > 0).sum() == 10
        assert masked[0, -1] == 255.0
        assert masked[0, 0] == 0.0


class TestSampling:
    def _make_pack(self, concentration_cell=20):
        pdf = np.full((1, 256), 0.01, np.float32)
        pdf[0, concentration_cell] = 50.0
        return build_cdfs(jnp.asarray(pdf))

    def test_sampled_cells_match_distribution(self):
        """Chi-square-style check: empirical cell frequencies track the
        marginal x conditional probabilities."""
        pack = self._make_pack()
        m = 1 << 14
        key = jax.random.key(0)
        u = jax.random.uniform(key, (4, m))
        n = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0]), (m, 3))
        prim = jnp.zeros(m, jnp.int32)
        d, pdf_val = sample_grid(pack, prim, n, u[0], u[1], u[2], u[3])
        d = np.asarray(d)
        assert (d[:, 2] > 0).all()  # upper hemisphere only
        # hot cell 20 -> theta row 1, phi col 4; prob of that cell:
        p_hot = 50.0 / float(pack.total_weight[0])
        theta = np.arccos(np.clip(d[:, 2], -1, 1))
        phi = np.arctan2(d[:, 1], d[:, 0])
        phi = np.where(phi < 0, phi + 2 * np.pi, phi)
        row = np.minimum((theta / (np.pi / 2) * 8).astype(int), 7)
        col = np.minimum((phi / (2 * np.pi) * 16).astype(int), 15)
        cell = row * 16 + col
        freq_hot = (cell == 20).mean()
        assert freq_hot == pytest.approx(p_hot, rel=0.05)

    def test_pdf_integrates_to_one(self):
        """MC integral of the returned pdf over its own samples:
        E[1] = integral pdf dw -> mean(1) trivially; instead check
        E[f/pdf] = integral f dw for f = 1 over hemisphere = 2 pi."""
        pack = self._make_pack()
        m = 1 << 15
        key = jax.random.key(1)
        u = jax.random.uniform(key, (4, m))
        n = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0]), (m, 3))
        prim = jnp.zeros(m, jnp.int32)
        _, pdf_val = sample_grid(pack, prim, n, u[0], u[1], u[2], u[3])
        est = float(jnp.mean(1.0 / jnp.maximum(pdf_val, 1e-9)))
        # cell-center pdf approximation admits a few % bias (replicated
        # from grid.h:258-273)
        assert est == pytest.approx(2 * np.pi, rel=0.08)

    def test_grid_pdf_consistent_with_sample(self):
        """grid_pdf(direction) must return the same cell pdf the sampler
        reported for the cells it drew."""
        pack = self._make_pack()
        m = 512
        key = jax.random.key(2)
        u = jax.random.uniform(key, (4, m))
        n = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0]), (m, 3))
        prim = jnp.zeros(m, jnp.int32)
        d, pdf_s = sample_grid(pack, prim, n, u[0], u[1], u[2], u[3])
        pdf_q = grid_pdf(pack, prim, d, n)
        np.testing.assert_allclose(
            np.asarray(pdf_q), np.asarray(pdf_s), rtol=1e-4
        )

    def test_below_horizon_pdf_zero(self):
        pack = self._make_pack()
        n = jnp.array([[0.0, 0.0, 1.0]])
        d = jnp.array([[0.0, 0.0, -1.0]])
        assert float(grid_pdf(pack, jnp.zeros(1, jnp.int32), d, n)[0]) == 0.0


class TestFetchRows:
    """_fetch_rows: the one-hot HIGHEST-precision matmul path (small
    tables) must be bitwise identical to the XLA row gather it
    replaces — bf16x3 splits each f32 into three bf16 terms that a
    one-hot contraction sums back exactly."""

    def test_onehot_bitwise_equals_gather(self):
        import pathtracer.ops.guiding as g

        key = jax.random.key(3)
        # adversarial values: denormal-ish, huge, negative, exact ints
        table = jax.random.uniform(key, (256, 32), minval=-1e6,
                                   maxval=1e6)
        table = table.at[0, 0].set(1.1754944e-38)
        table = table.at[1, 1].set(3.4e38)
        idx = jax.random.randint(jax.random.key(4), (4096,), 0, 256)
        via_mm = g._fetch_rows(table, idx)
        assert np.array_equal(np.asarray(via_mm),
                              np.asarray(table[idx]))

    def test_large_table_falls_back(self, monkeypatch):
        import pathtracer.ops.guiding as g

        table = jax.random.uniform(jax.random.key(5), (2048, 16))
        idx = jax.random.randint(jax.random.key(6), (512,), 0, 2048)
        out = g._fetch_rows(table, idx)   # > _ONEHOT_MAX_ROWS: gather
        assert np.array_equal(np.asarray(out), np.asarray(table[idx]))
