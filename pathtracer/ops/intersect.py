"""Batched ray-scene intersection.

Batched re-design of the reference's per-thread Möller-Trumbore + BVH
stack walk (`reference/include/rendering/triangle.h:64-96`,
`scene.h:50-195`). Instead of branchy per-ray traversal, every triangle
carries a precomputed affine inverse M^-1 of [e1 e2 n] (built in
scene/mesh.py). Transforming ray origin/direction by all triangles at once
is a chain of elementwise multiply-adds over (B, T), after which (t, u, v)
and the hit test are elementwise too and the closest hit is an argmin
reduction. This is the plain float32 reference every other path
(ops/intersect_triton, ops/bvh) is tested against, and the CPU's path for
small scenes (ops/dispatch).

Semantics match the reference exactly:
  * closest hit honors t > 1e-8, t >= t_min, t < t_max
    (triangle.h:64-96, scene.h:39 with t_min=1e-4, t_max=inf);
  * any-hit/occlusion supports excluding two primitive ids (the form-factor
    visibility test's source/target exclusion, form_factors.h:144-209);
  * the returned normal is the *logical primitive's* stored geometric
    normal, as in quad.h:121 / triangle.h — not the sub-triangle's.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from ..scene.mesh import Geometry

_T_EPS = 1e-8  # Möller-Trumbore epsilon (triangle.h:66)


def _row_apply(inv, row, x, y, z):
    """(inv[:, row] . [x y z]) for all (ray, triangle) pairs -> (B, T).

    Written as explicit multiply-adds on purpose: a K=3 contraction gains
    nothing from a matrix unit, and a DEFAULT-precision f32 dot may run in
    reduced precision (TF32 on the GPU), which quantizes ray directions
    into visible banding artifacts. The elementwise form stays full f32
    and XLA fuses the whole chain.
    """
    return (
        x * inv[None, :, row, 0]
        + y * inv[None, :, row, 1]
        + z * inv[None, :, row, 2]
    )


def intersect_tuv(geom: Geometry, o, d):
    """All-pairs hit parameter for rays x triangles.

    Args:
        o, d: (B, 3) ray origins / directions.
    Returns:
        t: (B, T) ray parameter (inf where no geometric hit).
    """
    inv = geom.tri_inv
    ro = o[:, None, :] - geom.tri_v0[None, :, :]        # (B, T, 3)
    rx, ry, rz = ro[..., 0], ro[..., 1], ro[..., 2]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]        # (B, 1)

    # Local frame (u, v, s): triangle spans u,v>=0, u+v<=1 at s=0.
    os_ = _row_apply(inv, 2, rx, ry, rz)
    ds_ = _row_apply(inv, 2, dx, dy, dz)
    t = -os_ / ds_
    u = _row_apply(inv, 0, rx, ry, rz) + t * _row_apply(inv, 0, dx, dy, dz)
    v = _row_apply(inv, 1, rx, ry, rz) + t * _row_apply(inv, 1, dx, dy, dz)
    hit = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > _T_EPS)
    hit &= jnp.isfinite(t)
    return jnp.where(hit, t, jnp.inf)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Hit:
    """SoA surface-interaction record (surface_interaction_record.h:17-51)."""

    valid: jax.Array   # (B,) bool
    t: jax.Array       # (B,)
    prim: jax.Array    # (B,) int32 logical primitive id (0 where miss)
    p: jax.Array       # (B, 3) hit position
    n: jax.Array       # (B, 3) geometric normal of the logical primitive
    albedo: jax.Array  # (B, 3)
    emission: jax.Array  # (B, 3)
    material: jax.Array  # (B,) int32
    # Optional (B, 16) guided-sampling row (CDFPack.prim_table of the
    # hit primitive), loaded by the fused hit kernel when its pack
    # carries a guide table — saves the guided integrator its per-lane
    # prim_table fetch. None elsewhere.
    guide: jax.Array | None = None


# All-pairs intermediates are (B, T); above this triangle count the
# brute queries sweep T in blocks (running min / any) so memory stays
# bounded — a 64k-ray batch against 32k triangles would otherwise
# materialize a 24 GB (B, T, 3) and OOM at compile. Small scenes keep
# the single-block path. The block combine's strict '<' preserves
# argmin's first-min-wins tie-break, but values can differ from the
# single-block path in the last ulp (XLA fuses the multiply-add chains
# differently per compilation), so the equivalence is exact-structure /
# ~1-ulp-t, not bitwise.
_TRI_BLOCK = 4096


@dataclass(frozen=True)
class _GeomBlock:
    """Duck-typed triangle block for intersect_tuv."""

    tri_inv: jax.Array
    tri_v0: jax.Array


def _closest_tri_blocked(geom: Geometry, o, d, t_min):
    """(t, tri_idx) closest over triangle blocks of _TRI_BLOCK."""
    tpad = ((geom.tri_inv.shape[0] + _TRI_BLOCK - 1) // _TRI_BLOCK)
    inv = jnp.concatenate([
        geom.tri_inv,
        jnp.zeros((tpad * _TRI_BLOCK - geom.tri_inv.shape[0], 3, 3)),
    ])
    v0 = jnp.concatenate([
        geom.tri_v0,
        jnp.zeros((tpad * _TRI_BLOCK - geom.tri_v0.shape[0], 3)),
    ])

    def block(carry, s):
        t_cur, id_cur = carry
        blk = _GeomBlock(
            tri_inv=jax.lax.dynamic_slice_in_dim(inv, s, _TRI_BLOCK),
            tri_v0=jax.lax.dynamic_slice_in_dim(v0, s, _TRI_BLOCK),
        )
        t_all = intersect_tuv(blk, o, d)
        t_all = jnp.where(t_all >= t_min, t_all, jnp.inf)
        idx = jnp.argmin(t_all, axis=-1)
        t_blk = jnp.take_along_axis(t_all, idx[:, None], axis=-1)[:, 0]
        better = t_blk < t_cur
        return (
            jnp.where(better, t_blk, t_cur),
            jnp.where(better, idx + s, id_cur),
        ), None

    b = o.shape[0]
    init = (jnp.full((b,), jnp.inf), jnp.zeros((b,), jnp.int32))
    (t, tri_idx), _ = jax.lax.scan(
        block, init,
        jnp.arange(0, tpad * _TRI_BLOCK, _TRI_BLOCK, dtype=jnp.int32),
    )
    return t, tri_idx


def closest_hit(geom: Geometry, o, d, t_min=1e-4, t_max=jnp.inf) -> Hit:
    """Closest-hit query for a ray batch (Scene::intersect semantics)."""
    if geom.tri_inv.shape[0] > _TRI_BLOCK:
        t, tri_idx = _closest_tri_blocked(geom, o, d, t_min)
    else:
        t_all = intersect_tuv(geom, o, d)
        t_all = jnp.where(t_all >= t_min, t_all, jnp.inf)
        tri_idx = jnp.argmin(t_all, axis=-1)
        t = jnp.take_along_axis(t_all, tri_idx[:, None], axis=-1)[:, 0]
    valid = jnp.isfinite(t) & (t < t_max)
    prim = jnp.where(valid, geom.tri_prim[tri_idx], 0)
    p = o + t[:, None] * d
    p = jnp.where(valid[:, None], p, 0.0)
    return Hit(
        valid=valid,
        t=jnp.where(valid, t, jnp.inf),
        prim=prim,
        p=p,
        n=geom.normal[prim],
        albedo=geom.albedo[prim],
        emission=jnp.where(
            valid[:, None], geom.emission[prim], 0.0
        ),
        material=geom.material[prim],
    )


def occluded(
    geom: Geometry, o, d, max_dist, exclude_a=None, exclude_b=None,
    eps: float = 1e-5,
):
    """Any-hit visibility query: True where the segment is blocked.

    Matches visibility_test_anyhit (form_factors.h:144-209): triangles whose
    logical primitive equals exclude_a or exclude_b are ignored; a hit
    counts when eps < t < max_dist.

    Args:
        o, d: (B, 3); d unit length.
        max_dist: (B,) segment length.
        exclude_a, exclude_b: optional (B,) int32 primitive ids.
    """
    t = geom.tri_inv.shape[0]
    if t <= _TRI_BLOCK:
        return _occluded_block(geom, geom.tri_prim, o, d, max_dist,
                               exclude_a, exclude_b, eps)

    tpad = ((t + _TRI_BLOCK - 1) // _TRI_BLOCK) * _TRI_BLOCK
    inv = jnp.concatenate([geom.tri_inv,
                           jnp.zeros((tpad - t, 3, 3))])
    v0 = jnp.concatenate([geom.tri_v0, jnp.zeros((tpad - t, 3))])
    prim = jnp.concatenate([
        geom.tri_prim, jnp.full((tpad - t,), -1, geom.tri_prim.dtype)
    ])

    def block(any_hit, s):
        blk = _GeomBlock(
            tri_inv=jax.lax.dynamic_slice_in_dim(inv, s, _TRI_BLOCK),
            tri_v0=jax.lax.dynamic_slice_in_dim(v0, s, _TRI_BLOCK),
        )
        pblk = jax.lax.dynamic_slice_in_dim(prim, s, _TRI_BLOCK)
        return any_hit | _occluded_block(
            blk, pblk, o, d, max_dist, exclude_a, exclude_b, eps
        ), None

    out, _ = jax.lax.scan(
        block, jnp.zeros((o.shape[0],), bool),
        jnp.arange(0, tpad, _TRI_BLOCK, dtype=jnp.int32),
    )
    return out


def _occluded_block(geom, tri_prim, o, d, max_dist, exclude_a, exclude_b,
                    eps):
    t_all = intersect_tuv(geom, o, d)  # (B, T)
    blocked = (t_all > eps) & (t_all < max_dist[:, None])
    if exclude_a is not None:
        blocked &= tri_prim[None, :] != exclude_a[:, None]
    if exclude_b is not None:
        blocked &= tri_prim[None, :] != exclude_b[:, None]
    return jnp.any(blocked, axis=-1)
