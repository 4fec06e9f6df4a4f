"""Directional-grid filters: bilateral and Gaussian smoothing.

Capability parity with `reference/include/rendering/grid_filter.h`:
5x5 kernel (radius 2), phi (azimuth) wraps circularly, theta (polar) clamps
at the poles (out-of-range taps dropped from the normalization), bilateral
range weights from BT.709 luminance, defaults sigma_spatial=1.5 /
sigma_range=0.3. Implemented as 25 stacked shifted copies per grid —
a fully fused VPU computation over the whole (N, 16, 16) batch, replacing
the reference's one-thread-per-cell kernels.

Also provides the float-buffer PDF pipeline (grid_filter.h:334-507):
luminance extraction, filtering of the visibility-count grids, and
per-primitive PDF normalization feeding precompute-CDFs-from-filtered.
"""

from __future__ import annotations


from functools import partial

import jax
import jax.numpy as jnp

from ..core.constants import GRID_RES
from ..core.math_utils import luminance

KERNEL_RADIUS = 2          # 5x5 (grid_filter.h:27)
DEFAULT_SIGMA_SPATIAL = 1.5
DEFAULT_SIGMA_RANGE = 0.3


def _gaussian(d2, sigma):
    return jnp.exp(-d2 / (2.0 * sigma * sigma))


def _neighbor_stack(grid):
    """Stack the 25 neighborhood taps of each cell.

    Args:
        grid: (N, 16, 16, C) with axes (prim, theta, phi, channels).
    Returns:
        (taps, valid, d2): taps (25, N, 16, 16, C); valid (25, 1, 16, 1)
        theta-range mask; d2 (25,) squared spatial distances.
    """
    taps, valids, d2s = [], [], []
    theta_idx = jnp.arange(GRID_RES)
    for di in range(-KERNEL_RADIUS, KERNEL_RADIUS + 1):
        ok = (theta_idx + di >= 0) & (theta_idx + di < GRID_RES)
        shifted_t = jnp.roll(grid, -di, axis=1)
        for dj in range(-KERNEL_RADIUS, KERNEL_RADIUS + 1):
            taps.append(jnp.roll(shifted_t, -dj, axis=2))
            valids.append(ok[None, :, None])
            d2s.append(float(di * di + dj * dj))
    return (
        jnp.stack(taps),
        jnp.stack(valids)[:, :, :, :, None].astype(jnp.float32),
        jnp.asarray(d2s, jnp.float32),
    )


def _filter_grid(grid, sigma_spatial, sigma_range, bilateral: bool):
    """Core 5x5 filter over (N, 256, C)-shaped grids."""
    n = grid.shape[0]
    c = grid.shape[-1]
    g = grid.reshape(n, GRID_RES, GRID_RES, c)
    taps, valid, d2 = _neighbor_stack(g)
    w_spatial = _gaussian(d2, sigma_spatial)[:, None, None, None, None]
    w = w_spatial * valid
    if bilateral:
        if c == 3:
            center_l = luminance(g)
            tap_l = luminance(taps)
        else:
            center_l = g[..., 0]
            tap_l = taps[..., 0]
        rd = jnp.abs(tap_l - center_l[None])
        w = w * _gaussian(rd * rd, sigma_range)[..., None]
    total = jnp.sum(w, axis=0)
    out = jnp.sum(taps * w, axis=0) / jnp.maximum(total, 1e-30)
    out = jnp.where(total > 1e-6, out, g)
    return out.reshape(grid.shape)


@partial(jax.jit, static_argnames=())
def bilateral_filter_rgb(rad_grid, sigma_spatial=DEFAULT_SIGMA_SPATIAL,
                         sigma_range=DEFAULT_SIGMA_RANGE):
    """(N, 256, 3) radiosity grids -> filtered, edge-preserving
    (filter_radiosity_grids, grid_filter.h:183-223)."""
    return _filter_grid(rad_grid, sigma_spatial, sigma_range, True)


@partial(jax.jit, static_argnames=())
def gaussian_filter_rgb(rad_grid, sigma=DEFAULT_SIGMA_SPATIAL):
    """(N, 256, 3) -> Gaussian-smoothed
    (filter_radiosity_grids_gaussian, grid_filter.h:294-326)."""
    return _filter_grid(rad_grid, sigma, 0.0, False)


@partial(jax.jit, static_argnames=())
def bilateral_filter_scalar(grid, sigma_spatial=DEFAULT_SIGMA_SPATIAL,
                            sigma_range=DEFAULT_SIGMA_RANGE):
    """(N, 256) float grids -> filtered (bilateral_filter_float_kernel,
    grid_filter.h:401-428)."""
    return _filter_grid(grid[..., None], sigma_spatial, sigma_range,
                        True)[..., 0]


@partial(jax.jit, static_argnames=())
def gaussian_filter_scalar(grid, sigma=DEFAULT_SIGMA_SPATIAL):
    return _filter_grid(grid[..., None], sigma, 0.0, False)[..., 0]


@jax.jit
def normalize_pdf(grid):
    """Per-primitive normalization to sum 1; all-zero grids left as-is
    (normalize_pdf_kernel, grid_filter.h:431-440)."""
    s = jnp.sum(grid, axis=-1, keepdims=True)
    return jnp.where(s > 1e-12, grid / jnp.maximum(s, 1e-30), grid)


def filter_pdfs(
    grid_counts,
    rad_grid,
    *,
    use_bilateral: bool = True,
    sigma_spatial: float = DEFAULT_SIGMA_SPATIAL,
    sigma_range: float = DEFAULT_SIGMA_RANGE,
):
    """Float-PDF pipeline (filter_pdfs_for_primitives,
    grid_filter.h:447-507): filter the visibility-count grid and the
    radiosity-luminance grid, then normalize each primitive's PDF.

    Returns:
        (filtered_formfactor, filtered_radiosity): (N, 256) each.
    """
    lum = luminance(rad_grid)
    if use_bilateral:
        ff = bilateral_filter_scalar(grid_counts, sigma_spatial, sigma_range)
        rl = bilateral_filter_scalar(lum, sigma_spatial, sigma_range)
    else:
        ff = gaussian_filter_scalar(grid_counts, sigma_spatial)
        rl = gaussian_filter_scalar(lum, sigma_spatial)
    return normalize_pdf(ff), normalize_pdf(rl)
