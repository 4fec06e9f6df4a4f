"""Wavefront Monte-Carlo path integrator.

Wavefront form of the reference megakernel
(`reference/include/rendering/integrator.h:189-268`): instead of one
CUDA thread looping over its private path, the whole ray batch advances one
bounce per loop iteration — intersection goes through ops/dispatch (fused
kernel, brute force or BVH), termination (miss / Russian roulette /
throughput cutoff) is a lane mask, and sampling-mode selection is branch-free
`jnp.where` lane blending. Estimator semantics match the reference exactly:

  per bounce:  intersect(t_min=1e-4)  ->  L += beta * Le
               RR for depth > 2 with p = min(max(beta), 0.95)
               beta *= albedo;  kill if |beta| < 1e-5
               shading normal = facing-forward geometric normal
               next direction per SamplingMode (BSDF / grid / one-sample MIS
               with power heuristic and the 10x firefly clamps)
               respawn at p + n*1e-4

plus one additive capability: a perfect-mirror lobe (MATERIAL_MIRROR) that
the reference README promises but its code never implements.

RNG: counter-based threefry. Per bounce the integrator draws each lane's
uniforms keyed by (pass key, depth, lane id) via rng.lane_uniforms —
draws depend only on the lane's logical id (its global pixel index), so
results are bitwise reproducible at any batch/chunk split, under lane
permutation, and across device shardings.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.constants import (
    FIREFLY_CLAMP,
    MATERIAL_MIRROR,
    RAY_EPS,
    RR_MAX_PROB,
    RR_START_DEPTH,
    SAMPLING_BSDF,
    SAMPLING_MIS,
    THROUGHPUT_EPS,
)
from ..core.math_utils import (
    PI,
    cosine_pdf,
    cosine_sample_hemisphere,
    dot,
    length,
    luminance,
    power_heuristic,
    reflect,
)
from ..core import rng
from ..ops import dispatch
from ..ops.guiding import (
    CDFPack,
    COS_THETA_EDGES,
    GRID_RES,
    _fetch_rows as fetch_rows,
    sample_grid,
    sample_grid_mis,
)
from ..scene.mesh import Geometry


class TraceStats(NamedTuple):
    rays: jax.Array          # scalar: total rays traced (sum of live lanes)
    depth_alive: jax.Array   # (max_depth,) live-lane counts per bounce


def _sample_bsdf(sn, u, v):
    d, _ = cosine_sample_hemisphere(sn, u, v)
    return d, jnp.ones(sn.shape[:-1], sn.dtype)


def _sample_pure_grid(cdfs, prim, sn, draws, row16=None):
    """Pure grid-guided sampling with the cos/(pi*pdf) reweighting and
    firefly clamp (integrator.h:244-257). Returns (dir, weight, valid,
    pdf) — pdf is the grid density of the returned direction (the
    forward-strategy density NEE's MIS weights need) — with the
    grid-validity flag coming out of the same prim_table fetch the
    sampler uses (one fetch, not two). `row16` may arrive pre-selected
    from the fused hit kernel (Hit.guide)."""
    if row16 is None:
        row16 = fetch_rows(cdfs.prim_table, prim)
    d, pdf = sample_grid(
        cdfs, prim, sn, draws[:, 0], draws[:, 1], draws[:, 2], draws[:, 3],
        row16=row16,
    )
    cos_t = jnp.maximum(dot(d, sn), 0.0)
    w = cos_t / (PI * jnp.maximum(pdf, 1e-6))
    return d, jnp.clip(w, 0.0, FIREFLY_CLAMP), row16[:, 9] > 0.0, pdf


def _sample_mis(cdfs, prim, sn, draws, bsdf_prob, row16=None):
    """One-sample MIS with power heuristic (integrator.h:112-166).
    Returns (dir, weight, valid, pdf_mix) where pdf_mix is the true
    marginal density of the one-sample procedure at the returned
    direction — p_b * pdf_cos + p_g * pdf_grid — the forward-strategy
    density NEE's MIS weights compete against. Both distribution
    queries go through guiding.sample_grid_mis, which coalesces the
    per-lane fetches; `row16` may arrive pre-selected from the fused
    hit kernel."""
    p_b = jnp.clip(bsdf_prob, 0.01, 0.99)
    p_g = 1.0 - p_b
    use_bsdf = draws[:, 5] < p_b

    # BSDF branch direction. Malley's construction fixes d_b's LOCAL
    # angles analytically (z = sqrt(1-u), phi = 2*pi*v in the same
    # Frisvad frame the grid uses), so its grid cell comes from seven
    # compares + a floor instead of the to_local + acos + atan2
    # round-trip world_to_spherical would pay.
    u, v = draws[:, 0], draws[:, 1]
    d_b, _ = cosine_sample_hemisphere(sn, u, v)
    cos_b = jnp.maximum(dot(d_b, sn), 0.0)
    pdf_bb = cos_b / PI
    z_b = jnp.sqrt(jnp.maximum(0.0, 1.0 - u))
    tb_idx = jnp.sum(
        (z_b[:, None] <= COS_THETA_EDGES[None, :]).astype(jnp.int32),
        axis=1,
    )
    pb_idx = jnp.clip((v * GRID_RES).astype(jnp.int32), 0, GRID_RES - 1)
    below = jnp.zeros_like(tb_idx, bool)   # z_b >= 0 by construction

    d_g, pdf_gg, pdf_bg, g_valid = sample_grid_mis(
        cdfs, prim, sn, draws[:, 0], draws[:, 1], draws[:, 2], draws[:, 3],
        d_b, row16=row16, d_b_bins=(tb_idx, pb_idx, below),
    )
    w_b = power_heuristic(pdf_bb, pdf_bg) / p_b
    w_b = jnp.where(pdf_bb > 1e-6, w_b, 0.0)

    cos_g = jnp.maximum(dot(d_g, sn), 0.0)
    pdf_gb = cos_g / PI
    w_g = power_heuristic(pdf_gg, pdf_gb) * cos_g / (
        PI * jnp.maximum(pdf_gg, 1e-30) * p_g
    )
    w_g = jnp.where(
        (pdf_gg > 1e-6) & (cos_g > 0.0),
        jnp.minimum(w_g, FIREFLY_CLAMP),
        0.0,
    )

    d = jnp.where(use_bsdf[:, None], d_b, d_g)
    w = jnp.where(use_bsdf, w_b, w_g)
    pdf_mix = jnp.where(
        use_bsdf,
        p_b * pdf_bb + p_g * pdf_bg,
        p_b * pdf_gb + p_g * pdf_gg,
    )
    return d, w, g_valid, pdf_mix



def _num_draws(mode: int, nee: bool = False) -> int:
    """Uniforms consumed per bounce: (u, v, rr) for BSDF; (s0..s3, rr,
    mis-select) for guided modes; +3 (light pick, u, v) with NEE.
    NEE columns are APPENDED, so enabling it never re-keys the existing
    modes' draws — NEE-off renders stay bitwise-golden."""
    base = 3 if mode == SAMPLING_BSDF else 6
    return base + (3 if nee else 0)


# --- Next-event estimation (additive capability; reference has none —
# its renders pay full brute-force variance on small emitters) ---------

MAX_NEE_LIGHTS = 128  # top emitters by power carried in the light table


def build_nee_pack(geom: Geometry) -> dict:
    """Light table for next-event estimation: the top-MAX_NEE_LIGHTS
    primitives by emitted power (luminance x area), with a power CDF
    for picking and per-light area pdfs. `poa` maps EVERY primitive to
    its pick-probability/area (zero off-table), so the hit-side MIS
    weight is exact for any table size: emitters the table omits get
    pdf_light = 0 and full weight on the BSDF strategy — the estimator
    stays unbiased, the table only bounds which lights NEE targets."""
    power = luminance(geom.emission) * geom.area            # (N,)
    kl = min(MAX_NEE_LIGHTS, int(geom.num_prims))
    pw, ids = jax.lax.top_k(power, kl)
    tot = jnp.maximum(jnp.sum(pw), 1e-20)
    p = pw / tot
    pdf_a = jnp.where(
        pw > 0.0, p / jnp.maximum(geom.area[ids], 1e-20), 0.0
    )
    poa = jnp.zeros(geom.num_prims, jnp.float32).at[ids].set(pdf_a)
    return dict(
        ids=ids,
        cdf=jnp.cumsum(p),
        pdf_a=pdf_a,
        corners=geom.corners[ids],
        normal=geom.normal[ids],
        emission=geom.emission[ids],
        poa=poa,
    )


def pick_light(pack, u):
    """Light-table rows for uniforms u (B,): the power-CDF pick, read by
    direct index (exact, integer ids stay integers). Returns (corners
    (B, 4, 3), normal, emission, pdf_a, prim id)."""
    kl = pack["cdf"].shape[0]
    idx = jnp.sum((u[:, None] >= pack["cdf"][None, :]).astype(jnp.int32),
                  axis=1)
    idx = jnp.clip(idx, 0, kl - 1)
    return (pack["corners"][idx], pack["normal"][idx],
            pack["emission"][idx], pack["pdf_a"][idx], pack["ids"][idx])


def _nee_term(pack, occl_fn, hit, sn, beta, active, u3, fwd_pdf):
    """Direct-light contribution of one path vertex via next-event
    estimation, MIS power-heuristic-weighted against the forward
    (direction-sampling) strategy, whose solid-angle density along the
    shadow direction is `fwd_pdf(ld, cos_x)` — cos/pi for BSDF mode,
    the grid/mixture density for guided modes (must be the SAME
    function the sampler reports for its own directions, so the two
    weights are complementary per light path).

    Uses pre-RR, pre-albedo beta (the vertex's own contribution, like
    the emission add) with the diffuse BRDF albedo/pi applied
    explicitly. Emitters are DOUBLE-SIDED, matching the hit estimator
    (which adds Le on any hit regardless of side)."""
    corners, n_l, le, pdf_a, prim_l = pick_light(pack, u3[:, 0])

    from .radiosity import sample_on_corners

    y = sample_on_corners(corners, u3[:, 1], u3[:, 2])
    seg = y - hit.p
    r = jnp.linalg.norm(seg, axis=-1)
    ld = seg / jnp.maximum(r, 1e-20)[:, None]
    cos_x = dot(sn, ld)
    cos_y = jnp.abs(dot(n_l, ld))                  # double-sided emitter
    ok = (
        active
        & (cos_x > 0.0)
        & (cos_y > 1e-8)
        & (pdf_a > 0.0)
        & (r > 1e-5)
    )
    blocked = occl_fn(
        hit.p + sn * RAY_EPS,
        ld,
        jnp.where(ok, r - 2.0 * RAY_EPS, 0.0),
        hit.prim,
        prim_l,
    )
    ok = ok & ~blocked
    pdf_l = pdf_a * r * r / jnp.maximum(cos_y, 1e-8)
    pdf_b = fwd_pdf(ld, cos_x)
    w = power_heuristic(pdf_l, pdf_b)
    scale = jnp.minimum(
        cos_x / (PI * jnp.maximum(pdf_l, 1e-12)) * w, FIREFLY_CLAMP
    )
    return jnp.where(
        ok[:, None], beta * hit.albedo * le * scale[:, None], 0.0
    )


def nee_hit_weight(pack, hit, d_in, prev_pdf):
    """MIS weight for emission picked up by a forward-sampled ray:
    power heuristic of the previous vertex's solid-angle forward pdf
    (cosine, grid, or one-sample mixture — whatever _shade sampled
    with) against the light-sampling pdf of this hit point.
    prev_pdf < 0 is the sentinel
    for camera rays and delta/mirror bounces — light sampling never
    competes there, weight 1. Off-table emitters have poa = 0 ->
    pdf_light = 0 -> weight 1 (see build_nee_pack)."""
    poa = pack["poa"][hit.prim]                    # (B,) gather
    cos_y = jnp.abs(dot(hit.n, d_in))
    t_safe = jnp.where(jnp.isfinite(hit.t), hit.t, 0.0)
    pdf_l = poa * t_safe * t_safe / jnp.maximum(cos_y, 1e-8)
    return jnp.where(
        prev_pdf < 0.0, 1.0, power_heuristic(prev_pdf, pdf_l)
    )


def _shade(hit, d, beta, live, draws, mode, cdfs, mis_frac, do_rr,
           nee=None, emis_w=None, nee_active=None):
    """Post-intersection bounce: emission contribution, Russian roulette,
    albedo, direction sampling, mirror override, respawn origin.

    Shared by the per-depth scan integrator and the wavefront-with-respawn
    integrator. `do_rr` is a per-lane bool mask (depth > 2).

    With next-event estimation: `nee = (pack, occl_fn)` adds the
    MIS-weighted direct-light term at this vertex (computed with the
    vertex's pre-RR beta, like the emission add — RR only gates the
    continuation), and `emis_w` (B,) scales the hit-emission term by
    the caller-computed hit-side MIS weight. Both default to the
    reference estimator exactly. `nee_active` masks the light sample
    off at the LAST path vertex (depth == max_depth-1): its shadow
    segment would gather emission one vertex beyond the depth bound,
    which the BSDF side never collects — without the mask the MIS
    pair is incomplete there and the estimate is biased high by
    ~the light-weighted share of albedo^max_depth (measured +0.65%
    on the depth-5 furnace).

    Returns (o_next, d_next, beta, live, contribution, pdf_b) where
    pdf_b is the solid-angle pdf of the sampled direction (-1 sentinel
    for mirror bounces), consumed by the next vertex's hit-side weight.
    """
    rr_col = 2 if mode == SAMPLING_BSDF else 4
    w_emis = 1.0 if emis_w is None else emis_w[:, None]
    contribution = jnp.where(
        live[:, None], beta * hit.emission * w_emis, 0.0
    )
    is_mirror = hit.material == MATERIAL_MIRROR
    sn = jnp.where((dot(d, hit.n) < 0.0)[:, None], hit.n, -hit.n)
    if nee is not None:
        pack, occl_fn = nee
        active = live & ~is_mirror
        if nee_active is not None:
            active = active & nee_active

        if mode == SAMPLING_BSDF:
            def fwd_pdf(ld, cos_x):
                return jnp.maximum(cos_x, 0.0) / PI
        else:
            # Guided modes: the forward strategy's density along the
            # shadow direction is the grid density (pure-grid mode) or
            # the one-sample mixture p_b*cos/pi + p_g*grid (MIS mode),
            # falling back to cos/pi where the lane's grid is invalid —
            # the SAME function whose value at the sampled direction
            # the samplers return below, keeping the NEE/hit MIS
            # weights complementary.
            from ..ops.guiding import grid_pdf

            if hit.guide is not None:
                g_valid_ld = hit.guide[:, 9] > 0.0
            else:
                g_valid_ld = fetch_rows(cdfs.prim_table, hit.prim)[:, 9] > 0.0

            def fwd_pdf(ld, cos_x):
                pdf_c = jnp.maximum(cos_x, 0.0) / PI
                pdf_g = grid_pdf(cdfs, hit.prim, ld, sn)
                if mode == SAMPLING_MIS:
                    p_b = jnp.clip(mis_frac, 0.01, 0.99)
                    mix = p_b * pdf_c + (1.0 - p_b) * pdf_g
                else:
                    mix = pdf_g
                return jnp.where(g_valid_ld, mix, pdf_c)

        contribution = contribution + _nee_term(
            pack, occl_fn, hit, sn, beta, active, draws[:, -3:], fwd_pdf,
        )

    # Russian roulette (integrator.h:207-212)
    max_beta = jnp.max(beta, axis=-1)
    rr_p = jnp.minimum(max_beta, RR_MAX_PROB)
    rr_kill = do_rr & (draws[:, rr_col] > rr_p)
    live = live & ~rr_kill
    rr_div = jnp.where(do_rr & live, jnp.maximum(rr_p, 1e-12), 1.0)
    beta = beta / rr_div[:, None]

    beta = beta * hit.albedo
    live = live & (length(beta) >= THROUGHPUT_EPS)

    if mode == SAMPLING_BSDF:
        nd, w = _sample_bsdf(sn, draws[:, 0], draws[:, 1])
        pdf_fwd = jnp.maximum(dot(nd, sn), 0.0) / PI
    else:
        if mode == SAMPLING_MIS:
            nd_g, w_g, g_valid, pdf_g = _sample_mis(
                cdfs, hit.prim, sn, draws, mis_frac, row16=hit.guide
            )
        else:
            nd_g, w_g, g_valid, pdf_g = _sample_pure_grid(
                cdfs, hit.prim, sn, draws, row16=hit.guide
            )
        nd_c, w_c = _sample_bsdf(sn, draws[:, 0], draws[:, 1])
        nd = jnp.where(g_valid[:, None], nd_g, nd_c)
        w = jnp.where(g_valid, w_g, w_c)
        pdf_fwd = jnp.where(
            g_valid, pdf_g, jnp.maximum(dot(nd, sn), 0.0) / PI
        )

    # Mirror lobe (additive capability): specular reflection, no pdf
    # weighting; tint already applied via beta *= albedo.
    nd = jnp.where(is_mirror[:, None], reflect(d, sn), nd)
    w = jnp.where(is_mirror, 1.0, w)

    beta = beta * w[:, None]
    o_next = hit.p + sn * RAY_EPS
    pdf_b = jnp.where(is_mirror, -1.0, pdf_fwd)
    return o_next, nd, beta, live, contribution, pdf_b


def _occlusion_fn(geom, accel):
    """NEE shadow-ray test through the scene's intersection path."""

    def occl_fn(so, sd, maxd, ex_a, ex_b):
        return dispatch.occluded(geom, accel, so, sd, maxd, ex_a, ex_b)

    return occl_fn


def trace(
    geom: Geometry,
    origins: jax.Array,
    directions: jax.Array,
    key: jax.Array,
    *,
    max_depth: int,
    mode: int = SAMPLING_BSDF,
    cdfs: CDFPack | None = None,
    mis_bsdf_fraction: float | jax.Array = 0.5,
    accel=None,
    lane_ids: jax.Array | None = None,
    nee: bool = False,
) -> tuple[jax.Array, TraceStats]:
    """Trace a batch of paths to completion.

    Args:
        origins, directions: (B, 3) primary rays (directions unit length).
        key: threefry key for this batch (already folded with the sample
            index; lanes are differentiated by `lane_ids`, not position).
        lane_ids: (B,) int32 logical lane ids (global pixel indices);
            defaults to arange(B). All randomness is keyed per lane id,
            making results invariant to chunking/padding/sharding.
        max_depth: static path length bound (reference hardcodes 5 at its
            call sites, integrator.h:389 — here it is honest config).
        mode: SAMPLING_* constant (static).
        cdfs: CDFPack, required for any mode except SAMPLING_BSDF.
        mis_bsdf_fraction: Scene::mis_bsdf_fraction equivalent.
        accel: the scene's intersection structure (ops/dispatch: None
            for brute force, a BVH, or a TrianglePack for the fused
            kernel) — the RayTracingManager backend switch,
            ray_tracing_backend.h:50-76.

    Returns:
        (radiance, stats): (B, 3) per-path radiance estimates.
    """
    if mode != SAMPLING_BSDF and cdfs is None:
        raise ValueError("guided sampling modes require a CDFPack")

    b = origins.shape[0]
    if lane_ids is None:
        lane_ids = jnp.arange(b, dtype=jnp.int32)
    mis_frac = jnp.asarray(mis_bsdf_fraction, jnp.float32)

    if nee:
        nee_pack = build_nee_pack(geom)
        occl_fn = _occlusion_fn(geom, accel)

    def bounce(carry, depth):
        o, d, beta, radiance, alive, prev_pdf = carry
        n_alive = jnp.sum(alive)

        hit = dispatch.closest_hit(geom, accel, o, d, t_min=RAY_EPS)
        live = alive & hit.valid
        # Shadow rays are real traced work: count one per vertex that
        # runs the NEE occlusion test (live diffuse vertices below the
        # last-depth gate) so Mrays/s stays an honest cost metric when
        # nee=True. Kept out of depth_alive, which stays
        # a pure live-lane count.
        n_shadow = (
            jnp.sum(
                live & (hit.material != MATERIAL_MIRROR)
                & (depth < max_depth - 1)
            )
            if nee else jnp.zeros((), jnp.int32)
        )

        draws = rng.lane_uniforms(
            jax.random.fold_in(key, depth), lane_ids,
            _num_draws(mode, nee),
        )
        emis_w = (
            nee_hit_weight(nee_pack, hit, d, prev_pdf) if nee else None
        )
        o, nd, beta, live, contrib, pdf_b = _shade(
            hit, d, beta, live, draws, mode, cdfs, mis_frac,
            depth > RR_START_DEPTH,
            nee=(nee_pack, occl_fn) if nee else None,
            emis_w=emis_w,
            nee_active=depth < max_depth - 1,
        )
        radiance = radiance + contrib
        if nee:
            prev_pdf = pdf_b
        return (o, nd, beta, radiance, live, prev_pdf), (n_alive, n_shadow)

    init = (
        origins,
        directions,
        jnp.ones((b, 3), jnp.float32),
        jnp.zeros((b, 3), jnp.float32),
        jnp.ones((b,), bool),
        jnp.full((b,), -1.0, jnp.float32),
    )
    (_, _, _, radiance, _, _), (per_depth, per_shadow) = jax.lax.scan(
        bounce, init, jnp.arange(max_depth)
    )
    stats = TraceStats(
        rays=jnp.sum(per_depth) + jnp.sum(per_shadow),
        depth_alive=per_depth,
    )
    return radiance, stats


def _morton30(p, lo, inv_ext):
    """30-bit Morton code of points p within [lo, lo + 1/inv_ext)."""
    q = jnp.clip((p - lo) * inv_ext * 1023.0, 0.0, 1023.0).astype(
        jnp.uint32
    )

    def expand(v):
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    return (
        (expand(q[..., 0]) << 2)
        | (expand(q[..., 1]) << 1)
        | expand(q[..., 2])
    ).astype(jnp.int32)


def trace_primary(geom: Geometry, origins, directions, accel=None):
    """Primary-hit query used by the radiosity visualization integrator
    (render_radiosity, integrator.h:460-504) and by picking."""
    return dispatch.closest_hit(geom, accel, origins, directions,
                                t_min=RAY_EPS)


def trace_wavefront(
    geom: Geometry,
    camera,
    pixel_x: jax.Array,
    pixel_y: jax.Array,
    key: jax.Array,
    *,
    width: int,
    height: int,
    spp: int,
    max_depth: int,
    mode: int = SAMPLING_BSDF,
    cdfs: CDFPack | None = None,
    mis_bsdf_fraction: float | jax.Array = 0.5,
    accel=None,
    sort_rays: bool = False,
    lane_ids: jax.Array | None = None,
    return_lane_steps: bool = False,
    nee: bool = False,
) -> tuple[jax.Array, ...]:
    """Persistent wavefront with same-pixel respawn.

    Each lane owns one pixel and traces `spp` full paths for it. When a
    lane's path terminates (miss, Russian roulette, throughput cutoff, or
    max_depth) it immediately respawns the *next camera sample of its own
    pixel* — so lane occupancy stays near 100% without any compaction
    sort or film scatter (the pixel binding is static; the film update is
    a plain reshape). This is the batched answer to the reference
    megakernel's per-thread path loop (SURVEY.md §7): the classic sort/compaction
    wavefront pays a permutation per bounce, the same-pixel respawn pays
    only the tail of the very last sample per lane.

    With sort_rays=True, lanes are additionally re-sorted every iteration
    by the Morton code of their ray origin (dead lanes last) — "ray
    sorting": bounce batches regain spatial coherence, at the cost of one
    argsort + state gather per iteration. Lane->pixel binding travels with
    the lanes and results are un-permuted before returning, so callers
    see the original lane order either way.

    RNG is keyed per (pass, pixel, sample, depth): lane ids are logical
    (global pixel index, via `lane_ids`) and the sample/depth counters
    ride `lane_uniforms`' sub_ids word — so a (pixel, sample) path's
    draws are independent of WHEN its lane reaches it. Estimates are
    therefore bitwise invariant not only to chunk layout, padding, and
    sharding but to lane *scheduling* itself (sorting, cost-balanced
    pixel queues, any respawn order). They differ from the per-depth
    scan integrator (both are unbiased estimators of the same
    integral).

    Pixel QUEUES (cost-balanced lanes): pass pixel_x/pixel_y/lane_ids as
    (B, K) arrays and each lane owns K pixels, tracing `spp` samples for
    queue slot 0, then slot 1, ... Because draws are keyed by (pixel,
    sample, depth) and each pixel's samples stay within one lane in
    sample order, the per-pixel radiance sums are BITWISE IDENTICAL to
    the K=1 render — queues are pure scheduling. Pairing expensive
    pixels with cheap ones flattens the per-lane total-work distribution
    so the while_loop (which runs to the LAST live lane) finishes near
    the mean instead of K x the worst pixel: on open scenes where miss
    lanes park early (stress100k: 47% occupancy) this is the difference
    between ~15 useful steps per 32 paid and ~29 per 32.

    Returns:
        (radiance_sum, rays, iters): per-(lane, slot) radiance SUM over
        spp samples — (B, 3), or (B, K, 3) in queue mode; total
        live-lane bounce count; loop iterations.
    """
    if mode != SAMPLING_BSDF and cdfs is None:
        raise ValueError("guided sampling modes require a CDFPack")

    queue_mode = pixel_x.ndim == 2
    k = pixel_x.shape[1] if queue_mode else 1
    b = pixel_x.shape[0]
    if lane_ids is None:
        if queue_mode:
            raise ValueError("queue mode requires explicit lane_ids")
        lane_ids = jnp.arange(b, dtype=jnp.int32)
    mis_frac = jnp.asarray(mis_bsdf_fraction, jnp.float32)
    max_iters = k * (spp * max_depth + max_depth)
    scene_lo = jnp.min(geom.corners.reshape(-1, 3), axis=0)
    scene_hi = jnp.max(geom.corners.reshape(-1, 3), axis=0)
    if sort_rays:
        inv_ext = 1.0 / jnp.maximum(scene_hi - scene_lo, 1e-6)
    # Lanes that finished every sample stay in the batch (static shapes)
    # but should cost as little intersection work as possible: park them
    # on a ray that starts outside the scene AABB pointing away, which
    # the BVH rejects at its root box.
    park_o = scene_hi + 1.0
    park_d = jnp.array([1.0, 0.0, 0.0], jnp.float32)

    # Purpose-split keys, hoisted: per-draw identity lives entirely in
    # the (pixel, sample, depth) counter words, not in the key chain.
    key_cam = jax.random.fold_in(key, 101)
    key_path = jax.random.fold_in(key, 7)

    if nee:
        nee_pack = build_nee_pack(geom)
        occl_fn = _occlusion_fn(geom, accel)

    def spawn(mask, o, d, pid, sample_idx):
        # px/py are DERIVED from the global pixel id (pid = y*width + x
        # at every call site — renderer.py computes lane coords exactly
        # this way), so the loop carries one int32 id instead of two f32
        # coordinate arrays (+ their (B, K) queues in queue mode).
        px = (pid % width).astype(jnp.float32)
        py = (pid // width).astype(jnp.float32)
        jit2 = rng.lane_uniforms(key_cam, pid, 2, sub_ids=sample_idx)
        u = (px + jit2[:, 0]) / width
        v = (py + jit2[:, 1]) / height
        co, cd = camera.get_rays(u, v)
        return (
            jnp.where(mask[:, None], co, o),
            jnp.where(mask[:, None], cd, d),
        )

    def qsel(q, slot):
        """Per-lane queue read without a gather: K is tiny and static,
        so a one-hot select chain beats XLA's per-lane row gather."""
        acc = q[:, 0]
        for j in range(1, k):
            acc = jnp.where(slot == j, q[:, j], acc)
        return acc

    def cond(state):
        return jnp.any(state["alive"]) & (state["it"] < max_iters)

    def body(state):
        s = dict(state)
        o, d, beta, alive = s["o"], s["d"], s["beta"], s["alive"]
        depth, done, pid, slot = s["depth"], s["done"], s["pid"], s["slot"]
        s["rays"] = s["rays"] + jnp.sum(alive)
        if return_lane_steps:
            s["steps"] = s["steps"] + alive.astype(jnp.int32)

        hit = dispatch.closest_hit(geom, accel, o, d, t_min=RAY_EPS)
        live = alive & hit.valid
        if nee:
            # One shadow ray per vertex that runs the NEE occlusion
            # test (same gating as _shade's `active`): Mrays/s counts
            # the real traced work.
            s["rays"] = s["rays"] + jnp.sum(
                live & (hit.material != MATERIAL_MIRROR)
                & (depth < max_depth - 1)
            )
        # (sample, depth) counter: `done` counts STARTED samples, so the
        # in-flight sample index is done-1; depth here is pre-increment.
        draws = rng.lane_uniforms(
            key_path, pid, _num_draws(mode, nee),
            sub_ids=(done - 1) * (max_depth + 1) + depth,
        )
        emis_w = (
            nee_hit_weight(nee_pack, hit, d, s["prev_pdf"])
            if nee else None
        )
        o, d, beta, live, contrib, pdf_b = _shade(
            hit, d, beta, live, draws, mode, cdfs, mis_frac,
            depth > RR_START_DEPTH,
            nee=(nee_pack, occl_fn) if nee else None,
            emis_w=emis_w,
            nee_active=depth < max_depth - 1,
        )
        # Accumulate into the current queue slot (one-hot over K).
        if k == 1:
            s["total"] = s["total"] + contrib[:, None, :]
        else:
            oneh = (slot[:, None] == jnp.arange(k)[None, :]).astype(
                jnp.float32
            )
            s["total"] = s["total"] + contrib[:, None, :] * oneh[:, :, None]

        depth = depth + 1
        live = live & (depth < max_depth)

        path_end = alive & ~live
        respawn_now = path_end & (done < spp)
        # Queue advance: sample budget spent and another pixel waits —
        # move to it and respawn its sample 0 in the SAME iteration (no
        # idle step between pixels).
        adv = path_end & (done >= spp) & (slot + 1 < k)
        slot = slot + adv.astype(jnp.int32)
        done = jnp.where(adv, 0, done)
        pid = jnp.where(adv, qsel(s["pidq"], slot), pid)

        respawn = respawn_now | adv
        o, d = spawn(respawn, o, d, pid, done)
        beta = jnp.where(respawn[:, None], 1.0, beta)
        depth = jnp.where(respawn, 0, depth)
        done = done + respawn.astype(jnp.int32)
        alive = live | respawn
        o = jnp.where(alive[:, None], o, park_o)
        d = jnp.where(alive[:, None], d, park_d)
        s.update(o=o, d=d, beta=beta, alive=alive, depth=depth,
                 done=done, pid=pid, slot=slot)
        if nee:
            # camera (re)spawns carry the sentinel: no light-sampling
            # competitor for directly visible emission
            s["prev_pdf"] = jnp.where(respawn, -1.0, pdf_b)

        if sort_rays:
            # 3-bit direction octant above 27 bits of origin Morton:
            # coherence needs rays that start together AND point the
            # same way.
            octant = (
                (d[:, 0] > 0).astype(jnp.int32)
                + 2 * (d[:, 1] > 0).astype(jnp.int32)
                + 4 * (d[:, 2] > 0).astype(jnp.int32)
            )
            code = (octant << 27) | (
                _morton30(o, scene_lo, inv_ext) >> 3
            )
            code = jnp.where(alive, code, jnp.int32(2**30))
            perm = jnp.argsort(code)
            for name in ("o", "d", "beta", "total", "alive", "depth",
                         "done", "orig", "pid", "slot", "pidq", "steps",
                         "prev_pdf"):
                if name in s:
                    s[name] = s[name][perm]

        s["it"] = s["it"] + 1
        return s

    pidq0 = lane_ids.astype(jnp.int32).reshape(b, k)
    pid0 = pidq0[:, 0]
    o0 = jnp.zeros((b, 3), jnp.float32)
    d0 = jnp.ones((b, 3), jnp.float32)
    o0, d0 = spawn(jnp.ones((b,), bool), o0, d0, pid0,
                   jnp.zeros((b,), jnp.int32))
    state = dict(
        o=o0,
        d=d0,
        beta=jnp.ones((b, 3), jnp.float32),
        total=jnp.zeros((b, k, 3), jnp.float32),
        alive=jnp.ones((b,), bool),
        depth=jnp.zeros((b,), jnp.int32),
        done=jnp.ones((b,), jnp.int32),   # sample 0 already spawned
        pid=pid0,
        slot=jnp.zeros((b,), jnp.int32),  # queue slot
        pidq=pidq0,
        rays=jnp.zeros((), jnp.int32),
        it=jnp.zeros((), jnp.int32),
    )
    if sort_rays:
        state["orig"] = jnp.arange(b, dtype=jnp.int32)
    if nee:
        state["prev_pdf"] = jnp.full((b,), -1.0, jnp.float32)
    if return_lane_steps:
        state["steps"] = jnp.zeros((b,), jnp.int32)
    out = jax.lax.while_loop(cond, body, state)
    total, rays, it = out["total"], out["rays"], out["it"]
    if sort_rays:
        unperm = jnp.argsort(out["orig"])
        total = total[unperm]
        if return_lane_steps:
            out["steps"] = out["steps"][unperm]
    if not queue_mode:
        total = total[:, 0, :]
    if return_lane_steps:
        return total, rays, it, out["steps"]
    return total, rays, it
