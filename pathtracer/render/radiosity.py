"""Radiosity solver: form factors + progressive refinement + guiding grids.

Batched re-design of the reference radiosity stack
(`reference/include/rendering/form_factors.h` and
`RadiosityState::runSolver`, `application_state.h:688-777`):

  * the N^2 pair loop (one CUDA thread per (i,j), 8x8 blocks) becomes
    row-blocked batched computation: `lax.map` over row chunks with a
    `lax.scan` over Monte-Carlo samples inside — static shapes, bounded
    memory, no atomics (directional-grid binning is a one-hot contraction
    at HIGHEST precision instead of atomicAdd, form_factors.h:331-337);
  * the progressive-refinement gather `incident_i = sum_j F_ij unshot_j`
    (form_factors.h:444-455) is literally `F @ unshot` — one (N,N)x(N,3)
    matmul per iteration;
  * per-pair curand states (seed 12345+idx) become threefry keys folded
    with (row-chunk, sample) — reproducible and order-independent.

Estimator semantics preserved exactly: centroid back-face culling, adaptive
sample counts by approximate form factor, source/target exclusion in the
any-hit visibility test, avg-of-valid-samples FF estimate clamped to [0,1],
the per-channel `reflected <= incident` energy guard, and the radiosity
history ring buffer.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from functools import partial

import jax
import jax.numpy as jnp

from ..core import rng as rng_mod
from ..core.constants import GRID_RES, GRID_SIZE
from ..core.math_utils import PI, dot, luminance, to_local
from ..ops import dispatch
from ..scene.mesh import Geometry

RADIOSITY_HISTORY = 10  # reference ring-buffer depth (application_state.h:47)


# ---------------------------------------------------------------------------
# Direction -> grid cell (full-sphere 16x16, local frame of the receiver)
# ---------------------------------------------------------------------------


def direction_to_cell(world_dir, normal):
    """direction_to_grid_indices_local (form_factors.h:107-128): local
    spherical coords of the *receiver's* frame, theta rows cover [0, pi]
    (rows 0-7 = upper hemisphere, matching the sampler's row convention).

    Returns int32 flat cell ids in [0, 256)."""
    local = to_local(world_dir, normal)
    lz = jnp.clip(local[..., 2], -1.0, 1.0)
    theta = jnp.arccos(jnp.minimum(lz, 1.0))
    phi = jnp.arctan2(local[..., 1], local[..., 0])
    phi = jnp.where(phi < 0.0, phi + 2.0 * PI, phi)
    gt = jnp.minimum(theta / PI * GRID_RES, GRID_RES - 1).astype(jnp.int32)
    gp = jnp.minimum(
        phi / (2.0 * PI) * GRID_RES, GRID_RES - 1
    ).astype(jnp.int32)
    gt = jnp.clip(gt, 0, GRID_RES - 1)
    gp = jnp.clip(gp, 0, GRID_RES - 1)
    return gt * GRID_RES + gp


# ---------------------------------------------------------------------------
# Uniform surface sampling of logical primitives (primitive.h:150-191)
# ---------------------------------------------------------------------------


def sample_uniform_on_prims(geom: Geometry, prim_idx, r1, r2):
    """Area-uniform points on logical primitives.

    Quads split into triangles (v00,v10,v01) / (v10,v11,v01) chosen by area
    ratio with r1 remapped; triangles (stored (a,b,c,c)) always take the
    first branch with ratio 1, reproducing triangle barycentric sampling.
    """
    return sample_on_corners(geom.corners[prim_idx], r1, r2)


def sample_on_corners(c, r1, r2):
    """Area-uniform point on a 4-corner primitive encoding (..., 4, 3)
    — the corners-only core of sample_uniform_on_prims, shared with the
    integrator's next-event light sampling (primitive.h:150-191)."""
    v00, v10, v11, v01 = c[..., 0, :], c[..., 1, :], c[..., 2, :], c[..., 3, :]

    a1 = 0.5 * jnp.linalg.norm(
        jnp.cross(v10 - v00, v01 - v00), axis=-1
    )
    a2 = 0.5 * jnp.linalg.norm(
        jnp.cross(v11 - v10, v11 - v01), axis=-1
    )
    ratio = a1 / jnp.maximum(a1 + a2, 1e-20)

    take1 = r1 < ratio
    r1a = r1 / jnp.maximum(ratio, 1e-12)
    r1b = (r1 - ratio) / jnp.maximum(1.0 - ratio, 1e-12)
    r1m = jnp.where(take1, r1a, r1b)

    sq = jnp.sqrt(jnp.clip(r1m, 0.0, 1.0))
    u = 1.0 - sq
    v = sq * (1.0 - r2)
    w = sq * r2

    p1 = v00 * u[..., None] + v10 * v[..., None] + v01 * w[..., None]
    p2 = v10 * u[..., None] + v11 * v[..., None] + v01 * w[..., None]
    return jnp.where(take1[..., None], p1, p2)


# ---------------------------------------------------------------------------
# Form factors
# ---------------------------------------------------------------------------


def _pair_culling(geom: Geometry, rows, cols=None):
    """Shared centroid-based early culling (form_factors.h:243-262).

    Returns (dir_norm, dist, cos_i, cos_j, facing) with shapes (R, C, ...)
    where cols defaults to all N primitives."""
    if cols is None:
        cols = jnp.arange(geom.num_prims)
    ci = geom.centroid[rows][:, None, :]          # (R, 1, 3)
    cj = geom.centroid[cols][None, :, :]          # (1, C, 3)
    d = cj - ci                                   # (R, C, 3)
    dist = jnp.linalg.norm(d, axis=-1)
    dn = d / jnp.maximum(dist, 1e-20)[..., None]
    ni = geom.normal[rows][:, None, :]
    nj = geom.normal[cols][None, :, :]
    cos_i = dot(ni, dn)
    cos_j = -dot(nj, dn)
    same = rows[:, None] == cols[None, :]
    facing = (cos_i > 0.0) & (cos_j > 0.0) & (dist >= 1e-6) & ~same
    return dn, dist, cos_i, cos_j, facing


@partial(jax.jit, static_argnames=("row_chunk",))
def _analytic_ff_rows(geom: Geometry, row_ids, row_chunk: int,
                      accel=None):
    n = geom.num_prims
    rc = row_chunk

    def do_rows(rows):
        dn, dist, cos_i, cos_j, facing = _pair_culling(geom, rows)
        ni = geom.normal[rows][:, None, :]
        o = (
            geom.centroid[rows][:, None, :] + ni * 1e-4
        ) * jnp.ones_like(dn)
        flat = lambda x: x.reshape(-1, *x.shape[2:])
        blocked = dispatch.occluded(
            geom,
            accel,
            flat(o),
            flat(dn),
            # non-facing pairs never use their blocked value: a zero
            # segment ends every traversal at once
            flat(jnp.where(facing, dist - 2e-4, 0.0)),
            jnp.repeat(rows, n),
            jnp.tile(jnp.arange(n), rows.shape[0]),
        ).reshape(dist.shape)
        ff = (
            cos_i * cos_j * geom.area[None, :] / (PI * dist * dist)
        )
        ff = jnp.where(facing & ~blocked, jnp.maximum(ff, 0.0), 0.0)
        return ff

    return jax.lax.map(do_rows, row_ids.reshape(-1, rc))


def analytic_form_factors(geom: Geometry, row_chunk: int = 64,
                          accel=None):
    """Point-to-point form factors with centroid visibility
    (calculate_form_factors_kernel, form_factors.h:354-404), in one
    launch like mc_form_factors."""
    n = geom.num_prims
    rc = min(row_chunk, n)
    npad = ((n + rc - 1) // rc) * rc
    row_ids = jnp.where(jnp.arange(npad) < n, jnp.arange(npad), 0)
    ff = _analytic_ff_rows(geom, row_ids, rc, accel)
    return ff.reshape(npad, n)[:n]


@partial(jax.jit,
         static_argnames=("n_samples", "row_chunk", "estimator"))
def mc_form_factors_rows(
    geom: Geometry,
    key: jax.Array,
    row_ids: jax.Array,
    n_samples: int = 64,
    row_chunk: int = 16,
    accel=None,
    col_ids=None,
    col_weight=None,
    chunk_offset=0,
    estimator: str = "reference",
):
    """Monte-Carlo form factors for an explicit set of receiver rows —
    the building block for the single-chip solve, the shard_map
    row-parallel solve (each device computes its own receiver band),
    and the matrix-free shooting solver (col_ids = the shooter batch).

    Args:
        row_ids: (R,) int32 receiver primitive ids, R % row_chunk == 0.
        col_ids: optional (C,) int32 source primitive ids (default: all
            N primitives).
        col_weight: optional (C, 3) radiance binned into the receiver
            grids per unblocked sample (default: geom.emission[cols] —
            the solver-start semantics, form_factors.h:313-323).
        chunk_offset: RNG stream offset added to the local chunk index.
            A device computing the row band starting at global chunk g
            passes chunk_offset=g so its MC draws are bitwise identical
            to the same rows of a single-chip call — sharding the FF
            build is then purely a performance decision.
        estimator: "reference" reproduces the reference's ratio-of-
            averages combiner bit-for-bit (avg_ci*avg_cj/avg_d^2,
            form_factors.h:339-347) — measured ~30% biased LOW on
            large adjacent patches (Jensen; dense-quadrature check in
            benchmarks/radiosity_forensics.py). "unbiased" uses the
            per-sample double-area estimator A_j/pi * mean_s[vis *
            ci*cj/r^2] — same draws, same visibility, true form
            factors.
    Returns:
        (ff, grid_counts, rad_grid) with leading dimension R; ff has
        trailing dimension C.
    """
    rc = min(row_chunk, row_ids.shape[0])
    n = geom.num_prims
    cols = jnp.arange(n) if col_ids is None else col_ids
    w_cols = (
        geom.emission[cols] if col_weight is None else col_weight
    )                                                 # (C, 3)
    fkey = rng_mod.stream_key(key, rng_mod.STREAM_FORMFACTOR)

    def do_rows(args):
        chunk_idx, rows = args
        dn_c, dist_c, cos_i_c, cos_j_c, facing = _pair_culling(
            geom, rows, cols
        )
        ni = geom.normal[rows][:, None, :]
        nj = geom.normal[cols][None, :, :]

        # Adaptive sample count (form_factors.h:264-269).
        approx = (
            cos_i_c * cos_j_c * geom.area[cols][None, :]
            / (PI * jnp.maximum(dist_c * dist_c, 1e-12))
        )
        actual = jnp.where(
            approx < 0.001,
            max(1, n_samples // 4),
            jnp.where(approx < 0.01, max(2, n_samples // 2), n_samples),
        )
        actual = jnp.where(facing, actual, 0)

        ckey = jax.random.fold_in(fkey, chunk_idx)
        rows_b = jnp.broadcast_to(rows[:, None], dist_c.shape)
        cols_b = jnp.broadcast_to(cols[None, :], dist_c.shape)

        def one_sample(carry, s):
            (vis, ci_sum, cj_sum, d_sum, nvalid, gcount, gradv) = carry
            skey = jax.random.fold_in(ckey, s)
            u = jax.random.uniform(skey, (4,) + dist_c.shape)
            p_i = sample_uniform_on_prims(geom, rows_b, u[0], u[1])
            p_j = sample_uniform_on_prims(geom, cols_b, u[2], u[3])
            seg = p_j - p_i
            r = jnp.linalg.norm(seg, axis=-1)
            sd = seg / jnp.maximum(r, 1e-20)[..., None]
            ct_i = dot(ni, sd)
            ct_j = -dot(nj, sd)
            active = (
                (s < actual) & (r >= 1e-6) & (ct_i > 0.0) & (ct_j > 0.0)
            )

            flat = lambda x: x.reshape(-1, *x.shape[2:])
            # Inactive lanes (back-face culled, r too small, s beyond
            # the adaptive count) never consume their blocked value —
            # zero their segment so a traversal ends at once. ok is
            # unchanged for every backend (blocked(maxd=0) is False and
            # is masked by `active` anyway).
            blocked = dispatch.occluded(
                geom,
                accel,
                flat(p_i + ni * 1e-4 * jnp.ones_like(sd)),
                flat(sd),
                flat(jnp.where(active, r - 2e-4, 0.0)),
                flat(rows_b),
                flat(cols_b),
            ).reshape(r.shape)
            ok = active & ~blocked

            okf = ok.astype(jnp.float32)
            vis += okf
            if estimator == "unbiased":
                # d_sum reuses its slot as the per-sample accumulator
                d_sum += jnp.where(
                    ok, ct_i * ct_j / jnp.maximum(r * r, 1e-12), 0.0
                )
            else:
                ci_sum += jnp.where(ok, ct_i, 0.0)
                cj_sum += jnp.where(ok, ct_j, 0.0)
                d_sum += jnp.where(ok, r, 0.0)
            nvalid += ok.astype(jnp.int32)

            # Direction-binned accumulation onto receiver i's grid
            # (form_factors.h:313-323): one-hot contraction over j replaces
            # atomics; summed over columns immediately.
            cell = direction_to_cell(sd, ni)           # (R, C)
            onehot = jax.nn.one_hot(cell, GRID_SIZE) * okf[..., None]
            gcount += jnp.sum(onehot, axis=1)          # (R, 256)
            gw = ct_i * ct_j / jnp.maximum(r * r, 1e-12)
            contrib = (
                w_cols[None, :, :]
                * (gw * geom.area[cols][None, :])[..., None]
            )                                          # (R, C, 3)
            gradv += jnp.einsum(
                "rnc,rnd->rcd", onehot,
                jnp.where(ok[..., None], contrib, 0.0),
                precision=jax.lax.Precision.HIGHEST,
            )
            return (vis, ci_sum, cj_sum, d_sum, nvalid, gcount, gradv), None

        z = jnp.zeros(dist_c.shape, jnp.float32)
        init = (
            z, z, z, z,
            jnp.zeros(dist_c.shape, jnp.int32),
            jnp.zeros((rc, GRID_SIZE), jnp.float32),
            jnp.zeros((rc, GRID_SIZE, 3), jnp.float32),
        )
        (vis, ci_s, cj_s, d_s, nv, gcount, gradv), _ = jax.lax.scan(
            one_sample, init, jnp.arange(n_samples)
        )

        if estimator == "unbiased":
            # per-sample mean over the ATTEMPTED (adaptive) count:
            # blocked/inactive samples contribute 0, so this is the
            # true double-area MC estimate of A_j/pi E[vis ci cj / r^2]
            ff = (
                d_s / jnp.maximum(actual, 1).astype(jnp.float32)
                * geom.area[cols][None, :] / PI
            )
        else:
            nvf = jnp.maximum(nv, 1).astype(jnp.float32)
            avg_ci = ci_s / nvf
            avg_cj = cj_s / nvf
            avg_d = d_s / nvf
            vis_frac = vis / jnp.maximum(actual, 1).astype(jnp.float32)
            ff = vis_frac * (
                avg_ci * avg_cj * geom.area[cols][None, :]
            ) / (PI * jnp.maximum(avg_d * avg_d, 1e-12))
        ff = jnp.where(nv > 0, jnp.clip(ff, 0.0, 1.0), 0.0)
        return ff, gcount, gradv

    r_total = row_ids.shape[0]
    chunk_ids = chunk_offset + jnp.arange(r_total // rc, dtype=jnp.int32)
    ff, gcount, gradv = jax.lax.map(
        do_rows, (chunk_ids, row_ids.reshape(-1, rc))
    )
    return (
        ff.reshape(r_total, cols.shape[0]),
        gcount.reshape(r_total, GRID_SIZE),
        gradv.reshape(r_total, GRID_SIZE, 3),
    )


def mc_form_factors(
    geom: Geometry,
    key: jax.Array,
    n_samples: int = 64,
    row_chunk: int = 16,
    accel=None,
    estimator: str = "reference",
):
    """Full (N, N) Monte-Carlo form factors + guiding grids
    (calculate_form_factors_mc_kernel, form_factors.h:220-352), in one
    launch: mc_form_factors_rows over every receiver row.

    Returns:
        (ff, grid_counts, rad_grid):
          ff (N, N) float32 — clamped [0, 1];
          grid_counts (N, 256) — unblocked-sample counts per direction cell
            (the reference's per-primitive `grid` payload);
          rad_grid (N, 256, 3) — emission-weighted geometry accumulation
            (radiosity at solver start = Le), form_factors.h:313-323.
    """
    n = geom.num_prims
    rc = min(row_chunk, n)
    npad = ((n + rc - 1) // rc) * rc
    row_ids = jnp.where(jnp.arange(npad) < n, jnp.arange(npad), 0)
    ff, gc, gv = mc_form_factors_rows(
        geom, key, row_ids, n_samples=n_samples, row_chunk=rc,
        accel=accel, estimator=estimator,
    )
    return ff[:n], gc[:n], gv[:n]


# ---------------------------------------------------------------------------
# Progressive refinement + grid rebinning
# ---------------------------------------------------------------------------


@jax.jit
def radiosity_step(geom: Geometry, ff, radiosity, unshot):
    """One progressive-refinement iteration (radiosity_iteration_kernel,
    form_factors.h:444-467): gather, reflect with the per-channel
    energy clamp, accumulate."""
    incident = jnp.dot(
        ff, unshot, precision=jax.lax.Precision.HIGHEST
    )
    reflected = jnp.minimum(geom.albedo * incident, incident)
    return radiosity + reflected, reflected


def rebin_rows(geom: Geometry, ff_rows, rows, radiosity):
    """Directional-grid rebin for receiver rows `rows` given their FF
    rows (update_radiosity_grid, form_factors.h:408-442): cell by the
    centroid-to-centroid direction, contribution B_j * F_ij. Shared by
    the single-chip row sweep and the row-sharded multi-chip solver."""
    n = geom.num_prims
    ci = geom.centroid[rows][:, None, :]
    cj = geom.centroid[None, :, :]
    d = cj - ci
    dist = jnp.linalg.norm(d, axis=-1)
    dn = d / jnp.maximum(dist, 1e-20)[..., None]
    ni = geom.normal[rows][:, None, :]
    same = rows[:, None] == jnp.arange(n)[None, :]
    w = jnp.where(
        same | (ff_rows <= 0.0) | (dist < 1e-6), 0.0, ff_rows
    )
    cell = direction_to_cell(dn, ni)
    onehot = jax.nn.one_hot(cell, GRID_SIZE)
    contrib = radiosity[None, :, :] * w[..., None]
    return jnp.einsum("rnc,rnd->rcd", onehot, contrib,
                      precision=jax.lax.Precision.HIGHEST)


@partial(jax.jit, static_argnames=("row_chunk",))
def rebin_radiosity_grid(geom: Geometry, ff, radiosity, row_chunk: int = 64):
    """Rebuild the (N, 256, 3) directional radiosity grids from the current
    solution, streamed over receiver-row blocks so the (rows, N) geometry
    intermediates stay bounded at any N."""
    n = geom.num_prims
    rc = min(row_chunk, n)
    npad = ((n + rc - 1) // rc) * rc
    row_ids = jnp.where(jnp.arange(npad) < n, jnp.arange(npad), 0)

    out = jax.lax.map(
        lambda rows: rebin_rows(geom, ff[rows], rows, radiosity),
        row_ids.reshape(-1, rc),
    )
    return out.reshape(npad, GRID_SIZE, 3)[:n]


# ---------------------------------------------------------------------------
# Solver
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class RadiositySolution:
    """Solved state — the per-primitive payload the reference keeps inline
    in each Primitive (triangle.h:98-112), as flat arrays."""

    form_factors: jax.Array   # (N, N)
    radiosity: jax.Array      # (N, 3)
    unshot: jax.Array         # (N, 3)
    grid_counts: jax.Array    # (N, 256) visibility-count grid
    rad_grid: jax.Array       # (N, 256, 3) directional radiosity grid
    history: jax.Array        # (HISTORY, N, 3) ring buffer
    history_index: jax.Array  # () int32 next write slot
    history_count: jax.Array  # () int32 entries filled

    def history_at(self, step: int) -> jax.Array:
        """step=0 most recent (primitive.h:205-218)."""
        idx = (
            self.history_index - 1 - step
        ) % RADIOSITY_HISTORY
        empty = step >= self.history_count
        return jnp.where(empty, 0.0, self.history[idx])

    def history_delta(self, step1: int, step2: int) -> jax.Array:
        return self.history_at(step1) - self.history_at(step2)


def solve_radiosity(
    geom: Geometry,
    key: jax.Array | None = None,
    *,
    num_iterations: int = 10,
    use_monte_carlo: bool = True,
    mc_samples: int = 64,
    filter_fn=None,
    row_chunk: int = 16,
    accel=None,
    estimator: str = "reference",
) -> RadiositySolution:
    """Full solver (RadiosityState::runSolver, application_state.h:688-777).

    Args:
        filter_fn: optional (N,256,3)->(N,256,3) grid filter applied each
            iteration (the solver-loop filtering hook,
            application_state.h:758-766).
    """
    if key is None:
        key = rng_mod.base_key(12345)
    if use_monte_carlo:
        ff, grid_counts, rad_grid = mc_form_factors(
            geom, key, n_samples=mc_samples, row_chunk=row_chunk,
            accel=accel, estimator=estimator,
        )
    else:
        ff = analytic_form_factors(
            geom, row_chunk=max(row_chunk, 32), accel=accel,
        )
        grid_counts = jnp.zeros((geom.num_prims, GRID_SIZE), jnp.float32)
        rad_grid = jnp.zeros((geom.num_prims, GRID_SIZE, 3), jnp.float32)

    radiosity = geom.emission
    unshot = geom.emission

    # One fused dispatch per iteration (gather + reflect + rebin +
    # optional grid filter), streamed over receiver-row blocks.
    @partial(jax.jit, static_argnames=("rc",))
    def iterate(geom, ff, radiosity, unshot, rc):
        radiosity, unshot = radiosity_step(geom, ff, radiosity, unshot)
        rad_grid = rebin_radiosity_grid(geom, ff, radiosity,
                                        row_chunk=rc)
        if filter_fn is not None:
            rad_grid = filter_fn(rad_grid)
        return radiosity, unshot, rad_grid

    history = jnp.zeros(
        (RADIOSITY_HISTORY, geom.num_prims, 3), jnp.float32
    )
    h_idx = 0
    h_cnt = 0
    for _ in range(num_iterations):
        history = history.at[h_idx].set(radiosity)
        h_idx = (h_idx + 1) % RADIOSITY_HISTORY
        h_cnt = min(h_cnt + 1, RADIOSITY_HISTORY)

        radiosity, unshot, rad_grid = iterate(
            geom, ff, radiosity, unshot, min(row_chunk * 4, 64)
        )

    return RadiositySolution(
        form_factors=ff,
        radiosity=radiosity,
        unshot=unshot,
        grid_counts=grid_counts,
        rad_grid=rad_grid,
        history=history,
        history_index=jnp.int32(h_idx),
        history_count=jnp.int32(h_cnt),
    )


# ---------------------------------------------------------------------------
# Matrix-free progressive shooting (beyond the N^2 matrix)
# ---------------------------------------------------------------------------


@partial(jax.jit,
         static_argnames=("n_samples", "row_chunk", "k", "estimator",
                          "sort_shooters"))
def _shoot_step(geom: Geometry, key, radiosity, unshot, rad_grid,
                grid_counts, step_idx, *, k, n_samples, row_chunk,
                accel, estimator="reference",
                sort_shooters=False):
    """One batched shooting step: pick the top-k unshot-power sources,
    estimate the (N, k) form-factor block with the standard MC
    estimator (same per-pair semantics as the gather solver), reflect
    with the per-channel energy clamp, and accumulate the receivers'
    directional grids with the shot radiance at the sample directions."""
    n = geom.num_prims
    power = luminance(unshot) * geom.area
    _, shooters = jax.lax.top_k(power, k)              # (k,)
    if sort_shooters:
        # top_k returns shooters in descending-power order — spatially
        # scattered. The flattened visibility batch is (receiver,
        # shooter)-major, so neighbouring segments share one receiver
        # and span CONSECUTIVE shooter-list entries; sorting by prim id
        # (= subdivision order = spatially adjacent patches) makes
        # neighbouring segments coherent. Pure batch scheduling: the
        # solve stays bitwise deterministic (the sort is deterministic),
        # only the MC draw<->pair pairing changes.
        shooters = jnp.sort(shooters)

    rc = min(row_chunk, n)
    npad = ((n + rc - 1) // rc) * rc
    row_ids = jnp.where(jnp.arange(npad) < n, jnp.arange(npad), 0)
    shot = unshot[shooters]                            # (k, 3)
    skey = jax.random.fold_in(key, step_idx)
    ff_blk, gcount, gradv = mc_form_factors_rows(
        geom, skey, row_ids, n_samples=n_samples, row_chunk=rc,
        accel=accel,
        col_ids=shooters, col_weight=shot, estimator=estimator,
    )
    ff_blk = ff_blk[:n]                                # (N, k)

    # gather from the batch + reflect (radiosity_iteration_kernel
    # semantics, form_factors.h:444-467, restricted to the shot columns)
    incident = jnp.dot(
        ff_blk, shot, precision=jax.lax.Precision.HIGHEST
    )                                                  # (N, 3)
    reflected = jnp.minimum(geom.albedo * incident, incident)
    radiosity = radiosity + reflected
    # every shooter's unshot is delivered exactly once; receivers bank
    # the reflection for a later shot (top_k indices are distinct)
    unshot = unshot.at[shooters].set(0.0) + reflected
    rad_grid = rad_grid + gradv[:n]
    grid_counts = grid_counts + gcount[:n]
    stats = transport_stats(geom, shooters, shot, incident, reflected)
    return radiosity, unshot, rad_grid, grid_counts, stats


def transport_stats(geom: Geometry, shooters, shot, incident, reflected):
    """Measured per-channel transport statistics of one shooting step:
    (shot, delivered, reflected) power sums — how much of the shot
    power arrived anywhere (open scenes lose the rest through the
    opening) and how much of THAT was re-banked. These calibrate the
    ambient completion of the residual tail (ambient_correction). The
    sharded solver calls this on its all-gathered full vectors so the
    stats — and the ambient term — stay bitwise-equal across layouts."""
    a = geom.area[:, None]
    return jnp.stack([
        jnp.sum(shot * geom.area[shooters][:, None], axis=0),
        jnp.sum(incident * a, axis=0),
        jnp.sum(reflected * a, axis=0),
    ])                                                 # (3 stats, 3 ch)


def ambient_correction(geom: Geometry, unshot, stats=None) -> jax.Array:
    """Ambient completion of the undelivered Neumann-series tail
    (Cohen et al. 1988, 'A progressive refinement approach'), calibrated
    by the solve's own measured transport when `stats` is given.

    Cohen's closed-environment form assumes every shot watt lands
    somewhere (sum_i F_ji = 1) and amplifies by R = 1/(1-rho_bar). Open
    scenes (the Cornell box has no front wall) lose a large fraction of
    every shot through the opening, and the closed form overestimates
    the completion by exactly that loss, compounded by R — measured ~2x
    too large on cbox. With `stats = (shot, delivered, reflected)`
    per-channel power sums accumulated over the solve, the correction
    uses the MEASURED delivery efficiency eta = delivered/shot and
    re-bank ratio rho_eff = reflected/delivered instead:

        incident-from-tail = eta * U * 1/(1 - rho_eff*eta)   per channel
        B_i += rho_i * incident-from-tail * (uniform mixing: / sum A)

    Returns the (N, 3) additive completion of `radiosity`."""
    a = geom.area
    a_sum = jnp.sum(a)
    u_pow = jnp.sum(unshot * a[:, None], axis=0)                  # (3,)
    if stats is None:
        rho_bar = jnp.sum(geom.albedo * a[:, None], axis=0) / a_sum
        eta = jnp.ones(3)
        rho_eff = rho_bar
    else:
        shot_c, deliv_c, refl_c = stats
        eta = deliv_c / jnp.maximum(shot_c, 1e-12)
        rho_eff = refl_c / jnp.maximum(deliv_c, 1e-12)
    amb = eta * u_pow / jnp.maximum(1.0 - rho_eff * eta, 1e-3) / a_sum
    return geom.albedo * amb


def solve_radiosity_shooting(
    geom: Geometry,
    key: jax.Array | None = None,
    *,
    steps: int = 64,
    shooters_per_step: int = 128,
    mc_samples: int = 4,
    row_chunk: int | None = None,
    accel=None,
    rel_tol: float = 1e-3,
    check_every: int = 8,
    ambient: bool = True,
    estimator: str = "reference",
    sort_shooters: bool = False,
    grid_refresh: int = 0,
    grid_refresh_samples: int = 16,
) -> RadiositySolution:
    """Matrix-free progressive-refinement shooting (Cohen-style).

    The gather solver (solve_radiosity) materializes the (N, N) form-
    factor matrix — 1 GB at subdivision 5 and 17 GB at subdivision 6,
    the reference's architectural scale ceiling (it allocates N^2
    floats + N^2 curand states up front, application_state.h:705-715).
    Shooting never forms the matrix: each step picks the
    `shooters_per_step` primitives with the largest unshot power
    (luminance x area), estimates only their (N, k) form-factor block
    with the SAME MC estimator / adaptive sample counts / pair-excluded
    any-hit visibility as the gather solver, distributes the unshot
    radiance, and banks the reflections for later steps. O(N k) memory
    and rays per step; converges to the same fixed point (the clamped
    Jacobi iteration and shooting solve the same linear system).

    Directional grids accumulate the shot radiance at the MC sample
    directions; since every unit of a primitive's radiosity is shot
    exactly once, the converged grids carry sum_j B_j x geometry — the
    same quantity the gather solver's rebin computes from the full
    matrix (update_radiosity_grid, form_factors.h:408-442), without
    needing it.

    Stops early when the total unshot power falls below rel_tol x the
    initial emitted power (checked every check_every steps — each check
    costs one device fetch). With ambient=True (default) the returned
    radiosity additionally carries the Cohen ambient completion of
    whatever unshot tail remains at the stop (see ambient_correction);
    `unshot` itself is returned uncorrected for diagnostics.

    grid_refresh > 0 adds a post-solve GRID REFRESH: the shooting-
    accumulated grids are correct in expectation (every unit of B is
    shot exactly once) but sample-SPARSE when the bright prims are few
    — a 2-primitive light contributes ~mc_samples draws per receiver
    grid over the whole solve, and the resulting spiky 256-cell pdf
    guides worse than cosine (measured on the stress scene: 0.75x).
    The refresh re-bins against the top-`grid_refresh` prims by
    converged power (luminance(B) x area) with `grid_refresh_samples`
    MC samples per pair — the dense analogue of the gather solver's
    per-iteration update_radiosity_grid rebin (form_factors.h:408-442),
    restricted to the columns that carry the energy. Cost ~= one
    shooting step per refresh column batch; B itself is untouched."""
    if key is None:
        key = rng_mod.base_key(12345)
    n = geom.num_prims
    k = min(shooters_per_step, n)
    if row_chunk is None:
        # visibility batches of ~32k segments per dispatch: big enough
        # to amortize per-call cost, small enough that the (rc, k, 256)
        # grid one-hot stays around 100 MB
        row_chunk = max(16, 32768 // k)
    rad_grid = jnp.zeros((n, GRID_SIZE, 3), jnp.float32)
    grid_counts = jnp.zeros((n, GRID_SIZE), jnp.float32)

    def step_fn(radiosity, unshot, rad_grid, grid_counts, step):
        return _shoot_step(
            geom, key, radiosity, unshot, rad_grid, grid_counts,
            jnp.int32(step), k=k, n_samples=mc_samples,
            row_chunk=row_chunk, accel=accel,
            estimator=estimator, sort_shooters=sort_shooters,
        )

    sol = drive_shooting(
        geom, step_fn, rad_grid, grid_counts, steps=steps,
        rel_tol=rel_tol, check_every=check_every, ambient=ambient,
    )
    if grid_refresh > 0:
        sol = refresh_grids(
            geom, key, sol, top=grid_refresh,
            n_samples=grid_refresh_samples, row_chunk=row_chunk,
            accel=accel, estimator=estimator,
        )
    return sol


def refresh_grids(
    geom: Geometry,
    key: jax.Array,
    sol: "RadiositySolution",
    *,
    top: int = 128,
    n_samples: int = 16,
    row_chunk: int = 256,
    accel=None,
    estimator: str = "reference",
) -> "RadiositySolution":
    """Dense directional-grid rebin against the top-`top` prims by
    converged power — see solve_radiosity_shooting(grid_refresh=...).
    Returns the solution with rad_grid/grid_counts REPLACED by the
    refreshed estimate (B/unshot untouched)."""
    n = geom.num_prims
    m = min(top, n)
    power = luminance(sol.radiosity) * geom.area
    _, cols = jax.lax.top_k(power, m)
    rc = min(max(16, 32768 // m), n)
    npad = ((n + rc - 1) // rc) * rc
    row_ids = jnp.where(jnp.arange(npad) < n, jnp.arange(npad), 0)
    rkey = jax.random.fold_in(
        rng_mod.stream_key(key, rng_mod.STREAM_FORMFACTOR), 0x47524944
    )
    _, gcount, gradv = mc_form_factors_rows(
        geom, rkey, row_ids, n_samples=n_samples, row_chunk=rc,
        accel=accel,
        col_ids=cols, col_weight=sol.radiosity[cols],
        estimator=estimator,
    )
    return replace(sol, rad_grid=gradv[:n], grid_counts=gcount[:n])


def drive_shooting(
    geom: Geometry,
    step_fn,
    rad_grid,
    grid_counts,
    *,
    steps: int,
    rel_tol: float,
    check_every: int,
    ambient: bool,
) -> RadiositySolution:
    """Shared host loop for the shooting solvers (single-chip and
    sharded): history ring, transport-stat accumulation, early exit,
    ambient completion. `step_fn(radiosity, unshot, rad_grid,
    grid_counts, step) -> (radiosity, unshot, rad_grid, grid_counts,
    stats)` supplies the per-step transport; grids may be sharded
    (row-padded — callers crop)."""
    n = geom.num_prims
    radiosity = geom.emission
    unshot = geom.emission
    # a host fetch waits for the device — only pay it when the
    # early-exit check will run
    p0 = (
        float(jnp.sum(luminance(geom.emission) * geom.area))
        if check_every else 0.0
    )

    history = jnp.zeros((RADIOSITY_HISTORY, n, 3), jnp.float32)
    h_idx = 0
    h_cnt = 0
    stats = jnp.zeros((3, 3), jnp.float32)    # shot/delivered/reflected
    for step in range(steps):
        history = history.at[h_idx].set(radiosity)
        h_idx = (h_idx + 1) % RADIOSITY_HISTORY
        h_cnt = min(h_cnt + 1, RADIOSITY_HISTORY)
        radiosity, unshot, rad_grid, grid_counts, st = step_fn(
            radiosity, unshot, rad_grid, grid_counts, step
        )
        stats = stats + st
        if check_every and (step + 1) % check_every == 0:
            rem = float(jnp.sum(luminance(unshot) * geom.area))
            if rem < rel_tol * p0:
                break

    if ambient:
        radiosity = radiosity + ambient_correction(geom, unshot, stats)
    return RadiositySolution(
        form_factors=jnp.zeros((0, 0), jnp.float32),   # matrix-free
        radiosity=radiosity,
        unshot=unshot,
        grid_counts=grid_counts,
        rad_grid=rad_grid,
        history=history,
        history_index=jnp.int32(h_idx),
        history_count=jnp.int32(h_cnt),
    )
