"""Grid-filter tests: wrap/clamp topology, edge preservation,
normalization (reference grid_filter.h semantics)."""

import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer.ops.filters import (
    bilateral_filter_rgb,
    bilateral_filter_scalar,
    filter_pdfs,
    gaussian_filter_rgb,
    gaussian_filter_scalar,
    normalize_pdf,
)


def scalar_gaussian_oracle(grid, sigma):
    """Direct scalar port of gaussianFilterCellFloat semantics
    (grid_filter.h:371-387): phi wraps, theta clamps."""
    out = np.zeros_like(grid)
    for ci in range(16):
        for cj in range(16):
            ws = 0.0
            tot = 0.0
            for di in range(-2, 3):
                for dj in range(-2, 3):
                    ni = ci + di
                    nj = (cj + dj) % 16
                    if ni < 0 or ni >= 16:
                        continue
                    w = np.exp(-(di * di + dj * dj) / (2 * sigma * sigma))
                    ws += grid[ni, nj] * w
                    tot += w
            out[ci, cj] = ws / tot if tot > 1e-6 else grid[ci, cj]
    return out


class TestGaussian:
    def test_matches_scalar_oracle(self):
        r = np.random.default_rng(0)
        g = r.uniform(0, 1, (3, 256)).astype(np.float32)
        got = np.asarray(gaussian_filter_scalar(jnp.asarray(g), 1.5))
        for i in range(3):
            expect = scalar_gaussian_oracle(g[i].reshape(16, 16), 1.5)
            np.testing.assert_allclose(
                got[i].reshape(16, 16), expect, rtol=1e-4
            )

    def test_constant_grid_unchanged(self):
        g = jnp.full((2, 256), 3.0)
        out = np.asarray(gaussian_filter_scalar(g))
        np.testing.assert_allclose(out, 3.0, rtol=1e-5)

    def test_phi_wraps(self):
        """A spike at phi=0 must bleed into phi=15 (circular azimuth)."""
        g = np.zeros((1, 16, 16), np.float32)
        g[0, 8, 0] = 1.0
        out = np.asarray(
            gaussian_filter_scalar(jnp.asarray(g.reshape(1, 256)), 1.5)
        ).reshape(16, 16)
        assert out[8, 15] > 0.0    # wrapped neighbor
        assert out[8, 14] > 0.0
        assert out[8, 8] == 0.0    # beyond radius 2

    def test_theta_clamps(self):
        """A spike at theta row 0 must NOT bleed to row 15."""
        g = np.zeros((1, 16, 16), np.float32)
        g[0, 0, 8] = 1.0
        out = np.asarray(
            gaussian_filter_scalar(jnp.asarray(g.reshape(1, 256)), 1.5)
        ).reshape(16, 16)
        assert out[15, 8] == 0.0
        assert out[14, 8] == 0.0
        assert out[1, 8] > 0.0


class TestBilateral:
    def test_edge_preserving_vs_gaussian(self):
        """A hard step edge must survive bilateral better than Gaussian."""
        g = np.zeros((1, 16, 16), np.float32)
        g[0, :, :8] = 1.0  # step in phi
        flat = jnp.asarray(g.reshape(1, 256))
        bil = np.asarray(
            bilateral_filter_scalar(flat, 1.5, 0.1)
        ).reshape(16, 16)
        gau = np.asarray(gaussian_filter_scalar(flat, 1.5)).reshape(16, 16)
        # measure edge contrast at columns 7|8 (middle, away from wrap)
        assert (bil[8, 7] - bil[8, 8]) > (gau[8, 7] - gau[8, 8])

    def test_rgb_filter_shapes(self):
        r = np.random.default_rng(1)
        g = jnp.asarray(r.uniform(0, 1, (4, 256, 3)).astype(np.float32))
        out_b = bilateral_filter_rgb(g)
        out_g = gaussian_filter_rgb(g)
        assert out_b.shape == (4, 256, 3)
        assert out_g.shape == (4, 256, 3)
        # smoothing reduces variance
        assert float(out_g.var()) < float(g.var())


class TestPdfPipeline:
    def test_normalize(self):
        r = np.random.default_rng(2)
        g = jnp.asarray(r.uniform(0, 5, (3, 256)).astype(np.float32))
        out = np.asarray(normalize_pdf(g))
        np.testing.assert_allclose(out.sum(-1), 1.0, rtol=1e-5)
        z = np.asarray(normalize_pdf(jnp.zeros((1, 256))))
        assert z.sum() == 0.0  # all-zero left untouched

    def test_filter_pdfs_normalized(self):
        r = np.random.default_rng(3)
        counts = jnp.asarray(r.uniform(0, 9, (4, 256)).astype(np.float32))
        rad = jnp.asarray(r.uniform(0, 2, (4, 256, 3)).astype(np.float32))
        ff, rl = filter_pdfs(counts, rad, use_bilateral=True)
        np.testing.assert_allclose(np.asarray(ff).sum(-1), 1.0, rtol=1e-4)
        np.testing.assert_allclose(np.asarray(rl).sum(-1), 1.0, rtol=1e-4)
        ff2, rl2 = filter_pdfs(counts, rad, use_bilateral=False)
        np.testing.assert_allclose(np.asarray(ff2).sum(-1), 1.0, rtol=1e-4)
