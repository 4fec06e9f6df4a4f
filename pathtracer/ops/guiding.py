"""Radiosity-guided directional sampling: precomputed 2-level CDFs.

Batched version of the reference's `PrecomputedCDF` machinery
(`reference/include/rendering/render_config.h:24-31`, the OpenMP host
build in `application_state.h:492-682`, and the device sampler in
`grid.h:141-273`). The per-primitive 16x16 grid of incoming radiosity is
reduced to luminance, row-summed over the 8 upper-hemisphere theta rows, and
turned into a marginal (theta) + conditional (phi) CDF pair — all as batched
cumsums over (N, 8, 16) arrays instead of per-primitive loops. Sampling
inverts both CDFs with vectorized rank counts (the reference's
linearSearchCDF) and jitters within the chosen cell.

All constants (0.999999 clamp, the pi/2-0.01 theta clamp, the 0.01
sin-theta floor, 1e-6/1e-8 guards) are kept bit-identical so estimates
match the reference statistically.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import jax
import jax.numpy as jnp

from ..core.constants import (
    GRID_D_PHI,
    GRID_D_THETA,
    GRID_HALF_RES,
    GRID_INV_HALF_RES,
    GRID_INV_RES,
    GRID_RES,
    GRID_SIZE,
)
from ..core.math_utils import (
    PI,
    TWO_PI,
    from_local,
    luminance,
    spherical_to_local,
    world_to_spherical,
)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class CDFPack:
    """Per-primitive sampling distributions (N primitives)."""

    pdf: jax.Array           # (N, 256) raw cell weights (luminance)
    row_sums: jax.Array      # (N, 8) upper-hemisphere row sums
    marginal_cdf: jax.Array  # (N, 8) theta-row CDF
    row_cdfs: jax.Array      # (N, 256) conditional phi CDFs (all 16 rows)
    total_weight: jax.Array  # (N,)
    valid: jax.Array         # (N,) bool
    # [marginal(8) | total(1) | valid(1) | pad] — everything the sampler
    # needs per primitive before the theta row is chosen, as ONE row so
    # the hot loop does a single (B,)->(B,16) gather instead of three
    # chained per-lane gathers.
    prim_table: jax.Array    # (N, 16)
    # [conditional phi CDF(16) | pdf row(16)] per (prim, UPPER theta)
    # row: the two tables the sampler needs AFTER choosing theta share
    # the same prim*8+theta index, so one 32-wide row fetch replaces
    # two 16-wide ones. Only the 8 upper-hemisphere rows are stored —
    # sampled theta_idx and the binned tb_idx both live in [0, 8).
    theta_table: jax.Array   # (N*8, 32)


@jax.jit
def build_cdfs(pdf: jax.Array) -> CDFPack:
    """Build CDFs from per-cell weights, (N, 256) -> CDFPack.

    Vectorized port of SceneState::precomputeCDFs (application_state.h:
    516-567): upper 8 rows drive sampling; empty rows and all lower-
    hemisphere rows get a uniform conditional CDF.

    Jitted: one device dispatch instead of ~40 eager ones, each of which
    would pay its own dispatch and compile.
    """
    pdf = jnp.asarray(pdf, jnp.float32)
    n = pdf.shape[0]
    grid = pdf.reshape(n, GRID_RES, GRID_RES)
    upper = grid[:, :GRID_HALF_RES]                       # (N, 8, 16)

    row_sums = jnp.sum(upper, axis=-1)                    # (N, 8)
    total = jnp.sum(row_sums, axis=-1)                    # (N,)
    inv_total = jnp.where(total > 1e-6, 1.0 / jnp.maximum(total, 1e-30), 0.0)
    marginal = jnp.cumsum(row_sums, axis=-1) * inv_total[:, None]
    marginal = marginal.at[:, -1].set(1.0)

    # Conditional CDFs for the upper rows; uniform where the row is empty.
    uniform_cdf = (
        jnp.arange(1, GRID_RES + 1, dtype=jnp.float32) * GRID_INV_RES
    )
    row_ok = row_sums >= 1e-6  # row_sum < 1e-6 -> uniform fill
    inv_rows = 1.0 / jnp.maximum(row_sums, 1e-30)
    cond = jnp.cumsum(upper, axis=-1) * inv_rows[..., None]
    cond = cond.at[..., -1].set(1.0)
    cond = jnp.where(row_ok[..., None], cond, uniform_cdf)

    lower = jnp.broadcast_to(
        uniform_cdf, (n, GRID_RES - GRID_HALF_RES, GRID_RES)
    )
    row_cdfs = jnp.concatenate([cond, lower], axis=1).reshape(n, GRID_SIZE)

    valid = total > 1e-6
    prim_table = jnp.concatenate(
        [
            marginal,
            total[:, None],
            valid[:, None].astype(jnp.float32),
            jnp.zeros((n, 6), jnp.float32),
        ],
        axis=1,
    )
    theta_table = jnp.concatenate(
        [
            cond.reshape(n * GRID_HALF_RES, GRID_RES),
            upper.reshape(n * GRID_HALF_RES, GRID_RES),
        ],
        axis=1,
    )
    return CDFPack(
        pdf=pdf,
        row_sums=row_sums,
        marginal_cdf=marginal,
        row_cdfs=row_cdfs,
        total_weight=total,
        valid=valid,
        prim_table=prim_table,
        theta_table=theta_table,
    )


def build_cdfs_from_radiosity_grid(rad_grid: jax.Array) -> CDFPack:
    """CDFs from the (N, 256, 3) directional radiosity grid via BT.709
    luminance (application_state.h:516-519)."""
    return build_cdfs(luminance(rad_grid))


def top_k_mask(pdf: jax.Array, k: int) -> jax.Array:
    """Keep only each primitive's k largest cells (SamplingMode::TOPK,
    render_config.h:43; the reference left this enum unreachable — we make
    it real). k <= 0 means keep everything."""
    if k <= 0 or k >= GRID_SIZE:
        return pdf
    thresh = jnp.sort(pdf, axis=-1)[:, GRID_SIZE - k][:, None]
    return jnp.where(pdf >= thresh, pdf, 0.0)


def _rank_cdf(cdf, xi):
    """First index i with xi < cdf[i] == count of cdf[i] <= xi
    (grid.h:248-255). cdf: (..., K), xi: (...,) -> int32 in [0, K-1]."""
    xi = jnp.clip(xi, 0.0, 0.999999)
    idx = jnp.sum((cdf <= xi[..., None]).astype(jnp.int32), axis=-1)
    return jnp.minimum(idx, cdf.shape[-1] - 1)


def _cell_pdf_math(cell, total_weight, theta_idx):
    """computePDFForCell's arithmetic (grid.h:258-273) given an already-
    fetched cell value: probability over the cell's solid angle with the
    reference's floors. Pure math — no gathers."""
    prob = cell / jnp.maximum(total_weight, 1e-6)
    theta_c = (theta_idx.astype(jnp.float32) + 0.5) * GRID_INV_HALF_RES * (
        PI * 0.5
    )
    sin_t = jnp.maximum(jnp.sin(theta_c), 0.01)
    solid = sin_t * GRID_D_THETA * GRID_D_PHI
    val = prob / jnp.maximum(solid, 1e-6)
    return jnp.where(cell < 1e-8, 1e-6, val)


# cos(k*pi/16), k=1..7: the theta-bin UPPER edges as cosines. For a
# local direction with z = cos(theta), bin(theta) = #{k : z <= edge_k}
# — '<=' so an exactly-on-edge z lands in the same bin as
# floor(acos(z)*16/pi) does (acos is exact on cos(k*pi/16) in reals).
COS_THETA_EDGES = jnp.asarray(
    [math.cos(k * math.pi / 16.0) for k in range(1, GRID_HALF_RES)],
    jnp.float32,
)

_ONEHOT_MAX_ROWS = 1024
# The (B, R) one-hot is a real f32 XLA intermediate; gate on its bytes,
# not on rows alone (64k lanes x 1024 rows would be 256 MB).
_ONEHOT_MAX_BYTES = 64 * 1024 * 1024
# Small tables are fetched with a one-hot contraction, large ones with a
# gather; both are exact (a HIGHEST-precision one-hot contraction sums
# exactly one f32 term per output). The contraction was chosen where
# per-lane gathers were slow; on the H100 it runs as cuBLAS f32 gemms
# (PERF.md, open question on the guided-MIS row fetch).


def _fetch_rows(table, idx):
    """table (R, C), idx (B,) int32 -> (B, C), bitwise == table[idx]."""
    r = table.shape[0]
    if r <= _ONEHOT_MAX_ROWS and r * idx.size * 4 <= _ONEHOT_MAX_BYTES:
        onehot = (
            idx[:, None] == jnp.arange(r, dtype=idx.dtype)[None, :]
        ).astype(jnp.float32)
        return jax.lax.dot_general(
            onehot, table,
            dimension_numbers=(((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
        )
    return table[idx]


def _pdf_row(cdfs, prim, theta_idx):
    """Fetch each lane's (16,) pdf theta-row (see _fetch_rows ladder)."""
    return _fetch_rows(
        cdfs.pdf.reshape(-1, GRID_RES), prim * GRID_RES + theta_idx
    )


def _select16(row, idx):
    """row (..., 16), idx (...,) -> row[idx], exactly, without a gather."""
    lanes = jnp.arange(GRID_RES, dtype=jnp.int32)
    return jnp.sum(
        jnp.where(lanes == idx[..., None], row, 0.0), axis=-1
    )


def _pdf_for_cell(cdfs, prim, total_weight, theta_idx, phi_idx):
    """computePDFForCell (grid.h:258-273)."""
    cell = _select16(_pdf_row(cdfs, prim, theta_idx), phi_idx)
    return _cell_pdf_math(cell, total_weight, theta_idx)


def sample_grid(cdfs: CDFPack, prim, normal, xi1, xi2, jt, jp,
                row16=None):
    """Sample a direction from each ray's hit-primitive grid.

    Port of Grid::sample (grid.h:141-188). Args are per-ray batches:
    prim (B,) int32, normal (B,3) shading normals, xi/j* (B,) uniforms.
    Passing a prefetched `row16 = cdfs.prim_table[prim]` saves two
    per-lane gathers in the hot loop.

    Returns:
        (dir, pdf): world-space unit directions and grid PDFs. Lanes whose
        grid is invalid return garbage — callers must mask with
        cdfs.valid[prim] (the integrator falls back to cosine sampling
        there, mirroring grid.h:142-144).
    """
    if row16 is None:
        marg = cdfs.marginal_cdf[prim]                    # (B, 8)
        total = cdfs.total_weight[prim]
    else:
        marg = row16[:, :GRID_HALF_RES]
        total = row16[:, GRID_HALF_RES]
    theta_idx = _rank_cdf(marg, xi1)
    # ONE (B,)->(B,32) gather of the winning theta row: conditional phi
    # CDF + pdf row share the prim*16+theta index (see theta_table)
    row32 = _fetch_rows(cdfs.theta_table,
                        prim * GRID_HALF_RES + theta_idx)
    phi_idx = _rank_cdf(row32[:, :GRID_RES], xi2)

    theta = (theta_idx.astype(jnp.float32) + jt) * GRID_INV_HALF_RES * (
        PI * 0.5
    )
    theta = jnp.minimum(theta, PI * 0.5 - 0.01)
    phi = (phi_idx.astype(jnp.float32) + jp) * GRID_INV_RES * TWO_PI

    d = from_local(spherical_to_local(theta, phi), normal)
    cell = _select16(row32[:, GRID_RES:], phi_idx)
    pdf = _cell_pdf_math(cell, total, theta_idx)
    return d, pdf


def grid_pdf(cdfs: CDFPack, prim, direction, normal):
    """Grid::computePDF (grid.h:200-216): PDF of a given world direction
    under the primitive's grid distribution; 0 below the horizon."""
    theta, phi = world_to_spherical(direction, normal)
    theta_idx = (theta * (2.0 / PI) * GRID_HALF_RES).astype(jnp.int32)
    phi_idx = (phi * (0.5 / PI) * GRID_RES).astype(jnp.int32)
    theta_idx = jnp.clip(theta_idx, 0, GRID_HALF_RES - 1)
    phi_idx = jnp.clip(phi_idx, 0, GRID_RES - 1)
    pdf = _pdf_for_cell(cdfs, prim, cdfs.total_weight[prim],
                        theta_idx, phi_idx)
    return jnp.where(theta > PI * 0.5, 0.0, pdf)


def sample_grid_mis(cdfs: CDFPack, prim, normal, xi1, xi2, jt, jp, d_b,
                    row16=None, d_b_bins=None):
    """Grid sample + this grid's PDF of a second (BSDF-sampled) world
    direction `d_b` — the two distribution queries one-sample MIS needs
    (integrator.h:112-166) — with gathers coalesced for the hot loop:

      1. one (B,)->(B,16) `prim_table` row (marginal CDF, total, valid),
      2. one (B,)->(B,32) winning `theta_table` row — the conditional
         phi CDF and the pdf row share the prim*16+theta index,
      3. one (B,)->(B,32) `theta_table` row for d_b's theta (pdf half
         used), with in-register one-hot cell selects instead of
         single-element per-lane gathers (see _pdf_row).

    vs the 7 chained per-lane gathers of the naive composition
    (sample_grid + grid_pdf + valid). Bitwise-identical values to
    sample_grid/grid_pdf for the generic (d_b_bins=None) path; the
    analytic-bin path derives d_b's cell from the pre-transform uniforms
    (z=sqrt(1-u)) while grid_pdf goes through from_local/normalize +
    acos/atan2, so lanes landing exactly on a bin edge can round into
    the adjacent cell — agreement is up to bin-edge rounding of that
    frame round-trip, not bitwise.

    Returns (d_g, pdf_gg, pdf_bg, g_valid).
    """
    if row16 is None:
        row16 = _fetch_rows(cdfs.prim_table, prim)        # (B, 16)
    marg = row16[:, :GRID_HALF_RES]
    total = row16[:, GRID_HALF_RES]
    g_valid = row16[:, GRID_HALF_RES + 1] > 0.0

    theta_idx = _rank_cdf(marg, xi1)
    row32 = _fetch_rows(cdfs.theta_table,
                        prim * GRID_HALF_RES + theta_idx)  # (B, 32)
    phi_idx = _rank_cdf(row32[:, :GRID_RES], xi2)

    theta = (theta_idx.astype(jnp.float32) + jt) * GRID_INV_HALF_RES * (
        PI * 0.5
    )
    theta = jnp.minimum(theta, PI * 0.5 - 0.01)
    phi = (phi_idx.astype(jnp.float32) + jp) * GRID_INV_RES * TWO_PI
    d_g = from_local(spherical_to_local(theta, phi), normal)

    # d_b's cell under this grid (grid.h:200-216). When the caller
    # sampled d_b itself in the SAME Frisvad frame (the integrator's
    # Malley cosine draw), it passes the bins directly (d_b_bins =
    # (tb_idx, pb_idx, below_horizon)) — the local angles are known
    # analytically from the uniforms, so the to_local + acos + atan2
    # round-trip the generic path needs here disappears.
    if d_b_bins is None:
        tb, pb = world_to_spherical(d_b, normal)
        tb_idx = jnp.clip(
            (tb * (2.0 / PI) * GRID_HALF_RES).astype(jnp.int32),
            0, GRID_HALF_RES - 1,
        )
        pb_idx = jnp.clip(
            (pb * (0.5 / PI) * GRID_RES).astype(jnp.int32),
            0, GRID_RES - 1,
        )
        below = tb > PI * 0.5
    else:
        tb_idx, pb_idx, below = d_b_bins

    val_g = _select16(row32[:, GRID_RES:], phi_idx)
    row32_b = _fetch_rows(cdfs.theta_table,
                          prim * GRID_HALF_RES + tb_idx)
    val_b = _select16(row32_b[:, GRID_RES:], pb_idx)
    pdf_gg = _cell_pdf_math(val_g, total, theta_idx)
    pdf_bg = jnp.where(
        below, 0.0, _cell_pdf_math(val_b, total, tb_idx)
    )
    return d_g, pdf_gg, pdf_bg, g_valid
