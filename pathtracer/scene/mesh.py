"""Structure-of-arrays scene geometry.

The reference stores a 13KB tagged-union `Primitive` (union{Triangle,Quad} +
inline 16x16 grids, `reference/include/rendering/primitive.h:21-79`)
in an AoS device array. That layout is hostile to XLA: variable-size unions,
pointer identity, per-object payloads. Here every *logical primitive* (a
triangle or a planar quad) is a row in flat arrays, and intersection runs
against a canonical triangle list with a `tri_prim` index map back to logical
primitives — mirroring how the reference's OptiX path splits quads into two
triangles while keeping `original_prim_idx` (optix_wrapper.h:357-392).

Unified corner encoding: a logical primitive is four corners
(v00, v10, v11, v01). A triangle (a, b, c) is stored as (a, b, c, c), which
makes the reference's quad formulas exact for triangles too:
  * area   = 0.5*(|cross(v10-v00, v01-v00)| + |cross(v11-v10, v11-v01)|)
             (quad.h:31) — second term vanishes for (a,b,c,c);
  * sampling splits into triangles (v00,v10,v01) / (v10,v11,v01) by area
    (primitive.h:150-191) — the second has zero area for (a,b,c,c);
  * canonical intersection triangles are (v00,v10,v11) and (v00,v11,v01)
    (quad.h:49-132) — the second is degenerate for triangles and is not
    emitted.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..core.constants import MATERIAL_DIFFUSE

# Host mirror of uploaded geometry arrays. Host-side code (triangle
# packing, BVH build, attribute tables) needs numpy views of device
# arrays; build_geometry seeds the mirror at upload time, so host_array()
# is a dict hit and nothing is downloaded from the device. Entries die
# with their device array (weakref callback).
_HOST_MIRROR: dict = {}


def _seed_host(dev, host: np.ndarray) -> None:
    k = id(dev)
    try:
        ref = weakref.ref(dev, lambda _, k=k: _HOST_MIRROR.pop(k, None))
    except TypeError:
        return
    _HOST_MIRROR[k] = (ref, host)


def host_array(a) -> np.ndarray:
    """numpy view of (possibly device) array `a`, downloading at most
    once per array object; free for arrays built by build_geometry."""
    if isinstance(a, np.ndarray):
        return a
    ent = _HOST_MIRROR.get(id(a))
    if ent is not None and ent[0]() is a:
        return ent[1]
    h = np.asarray(a)
    _seed_host(a, h)
    return h


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Geometry:
    """Device-resident scene geometry (all float32 / int32).

    Triangle-level arrays (length T) drive intersection; primitive-level
    arrays (length N) carry shading and radiosity attributes.
    """

    # --- canonical triangles (T) ---
    tri_v0: jax.Array      # (T, 3)
    tri_e1: jax.Array      # (T, 3) v1 - v0
    tri_e2: jax.Array      # (T, 3) v2 - v0
    tri_inv: jax.Array     # (T, 3, 3) inverse of [e1 e2 n] — affine intersector
    tri_prim: jax.Array    # (T,) int32 triangle -> logical primitive

    # --- logical primitives (N) ---
    corners: jax.Array     # (N, 4, 3) v00, v10, v11, v01 (tri: a,b,c,c)
    normal: jax.Array      # (N, 3) geometric normal (quad.h:27-29 convention)
    albedo: jax.Array      # (N, 3) diffuse rgb ("bsdf" in the reference)
    emission: jax.Array    # (N, 3) Le
    area: jax.Array        # (N,)
    centroid: jax.Array    # (N, 3)
    material: jax.Array    # (N,) int32 MATERIAL_DIFFUSE / MATERIAL_MIRROR
    is_quad: jax.Array     # (N,) bool

    @property
    def num_tris(self) -> int:
        return self.tri_v0.shape[0]

    @property
    def num_prims(self) -> int:
        return self.corners.shape[0]


def _tri_area(a, b, c):
    return 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=-1)


def build_geometry(
    corners: np.ndarray,
    is_quad: np.ndarray,
    albedo: np.ndarray,
    emission: np.ndarray,
    material: np.ndarray | None = None,
    normal: np.ndarray | None = None,
) -> Geometry:
    """Host-side geometry build: canonicalize to triangles, precompute the
    per-triangle affine inverse used by the batched intersector.

    Args:
        corners: (N, 4, 3) float — v00, v10, v11, v01 (triangles as a,b,c,c).
        is_quad: (N,) bool.
        albedo / emission: (N, 3) float.
        material: (N,) int; defaults to all-diffuse.
        normal: (N, 3) optional override (e.g. OBJ `vn`); defaults to
            cross(v10-v00, v01-v00) normalized (quad.h:27-29).
    """
    corners = np.asarray(corners, np.float32)
    n_prims = corners.shape[0]
    is_quad = np.asarray(is_quad, bool)
    albedo = np.asarray(albedo, np.float32).reshape(n_prims, 3)
    emission = np.asarray(emission, np.float32).reshape(n_prims, 3)
    if material is None:
        material = np.full((n_prims,), MATERIAL_DIFFUSE, np.int32)
    material = np.asarray(material, np.int32)

    v00, v10, v11, v01 = (corners[:, i] for i in range(4))

    geom_normal = np.cross(v10 - v00, v01 - v00)
    nrm = np.linalg.norm(geom_normal, axis=-1, keepdims=True)
    geom_normal = geom_normal / np.maximum(nrm, 1e-20)
    if normal is not None:
        provided = np.asarray(normal, np.float32)
        has = np.linalg.norm(provided, axis=-1) > 1e-12
        geom_normal = np.where(has[:, None], provided, geom_normal)

    # Area per the reference quad formula; exact triangle area for (a,b,c,c).
    area = _tri_area(v00, v10, v01) + _tri_area(v10, v11, v01)

    # Centroid: triangle -> mean of 3 distinct verts; quad -> mean of 4.
    centroid_q = corners.mean(axis=1)
    centroid_t = (v00 + v10 + v11) / 3.0
    centroid = np.where(is_quad[:, None], centroid_q, centroid_t)

    # Canonical triangles: (v00,v10,v11) always; (v00,v11,v01) for quads only.
    tri_a = np.stack([v00, v10, v11], axis=1)            # (N,3,3)
    tri_b = np.stack([v00, v11, v01], axis=1)
    tris = [tri_a]
    maps = [np.arange(n_prims, dtype=np.int32)]
    q_idx = np.nonzero(is_quad)[0].astype(np.int32)
    if q_idx.size:
        tris.append(tri_b[q_idx])
        maps.append(q_idx)
    tri_verts = np.concatenate(tris, axis=0)
    tri_prim = np.concatenate(maps, axis=0)

    v0 = tri_verts[:, 0]
    e1 = tri_verts[:, 1] - v0
    e2 = tri_verts[:, 2] - v0
    n = np.cross(e1, e2)

    # Affine intersector: M = [e1 e2 n] columns; p_local = M^-1 (p - v0)
    # gives (u, v, s); a ray hits where s-coordinate crosses 0. Degenerate
    # triangles get a zero inverse, which yields d_z'=o_z'=0 -> t=nan and is
    # masked out by the finite-t check in the intersector.
    m = np.stack([e1, e2, n], axis=-1)                    # (T,3,3)
    # det(m) with columns (e1, e2, n) and n = e1 x e2 is exactly
    # n.(e1 x e2) = |n|^2 — a dot product instead of a batched LAPACK
    # LU (660x faster at 2.1M tris). Only the >1e-18 degeneracy mask
    # consumes it, so the ulp-level difference vs linalg.det cannot
    # change any non-degenerate triangle's inverse.
    det = np.einsum("ij,ij->i", n, n)
    ok = det > 1e-18
    m_safe = np.where(ok[:, None, None], m, np.eye(3, dtype=np.float32))
    inv = np.linalg.inv(m_safe).astype(np.float32)
    inv = np.where(ok[:, None, None], inv, np.zeros_like(inv))

    def up(h):
        h = np.ascontiguousarray(h)
        dev = jnp.asarray(h)
        _seed_host(dev, h)
        return dev

    return Geometry(
        tri_v0=up(v0),
        tri_e1=up(e1),
        tri_e2=up(e2),
        tri_inv=up(inv),
        tri_prim=up(tri_prim),
        corners=up(corners),
        normal=up(geom_normal.astype(np.float32)),
        albedo=up(albedo),
        emission=up(emission),
        area=up(area.astype(np.float32)),
        centroid=up(centroid.astype(np.float32)),
        material=up(material),
        is_quad=up(is_quad),
    )


# ---------------------------------------------------------------------------
# Host-side primitive-list transforms (pre-build): quad->tri conversion and
# 4-way loop subdivision, matching application_state.h:323-365 and
# form_factors.h:471-574.
# ---------------------------------------------------------------------------


@dataclass
class PrimList:
    """Mutable host-side primitive soup used by loaders before build."""

    corners: np.ndarray    # (N, 4, 3)
    is_quad: np.ndarray    # (N,)
    albedo: np.ndarray     # (N, 3)
    emission: np.ndarray   # (N, 3)
    material: np.ndarray   # (N,)
    normal: np.ndarray | None = None  # (N, 3) optional provided normals

    @property
    def num_prims(self) -> int:
        return self.corners.shape[0]

    def build(self) -> Geometry:
        return build_geometry(
            self.corners, self.is_quad, self.albedo, self.emission,
            self.material, self.normal,
        )


def make_triangle_corners(a, b, c):
    """Triangle (a,b,c) in the unified 4-corner encoding."""
    return np.stack([a, b, c, c], axis=-2)


def convert_quads_to_triangles(prims: PrimList) -> PrimList:
    """Split each quad into triangles (v00,v10,v11) + (v00,v11,v01),
    copying material/emission (application_state.h:323-365)."""
    out_c, out_q, out_a, out_e, out_m, out_n = [], [], [], [], [], []
    normals = prims.normal
    for i in range(prims.num_prims):
        c = prims.corners[i]
        nrm = normals[i] if normals is not None else np.zeros(3, np.float32)
        if prims.is_quad[i]:
            for tri in ((c[0], c[1], c[2]), (c[0], c[2], c[3])):
                out_c.append(make_triangle_corners(*tri))
                out_q.append(False)
                out_a.append(prims.albedo[i])
                out_e.append(prims.emission[i])
                out_m.append(prims.material[i])
                # triangles recompute their own geometric normal
                out_n.append(np.zeros(3, np.float32))
        else:
            out_c.append(c)
            out_q.append(False)
            out_a.append(prims.albedo[i])
            out_e.append(prims.emission[i])
            out_m.append(prims.material[i])
            out_n.append(nrm)
    return PrimList(
        corners=np.asarray(out_c, np.float32),
        is_quad=np.asarray(out_q, bool),
        albedo=np.asarray(out_a, np.float32),
        emission=np.asarray(out_e, np.float32),
        material=np.asarray(out_m, np.int32),
        normal=np.asarray(out_n, np.float32),
    )


def subdivide(prims: PrimList, levels: int) -> PrimList:
    """4-way loop subdivision, `levels` times (form_factors.h:471-574).

    Triangles split at edge midpoints into 4 triangles; quads split at edge
    midpoints + center into 4 quads. Materials/emission are inherited;
    normals are recomputed per sub-primitive (provided normals dropped, as
    the reference recomputes them in subdivide_triangle).
    """
    if levels <= 0:
        return prims
    corners = prims.corners
    is_quad = prims.is_quad
    albedo, emission, material = prims.albedo, prims.emission, prims.material
    for _ in range(levels):
        new_c, new_q, new_a, new_e, new_m = [], [], [], [], []
        for i in range(corners.shape[0]):
            c = corners[i]
            if is_quad[i]:
                v00, v10, v11, v01 = c
                m01 = 0.5 * (v00 + v10)
                m12 = 0.5 * (v10 + v11)
                m23 = 0.5 * (v11 + v01)
                m30 = 0.5 * (v01 + v00)
                ctr = 0.25 * (v00 + v10 + v11 + v01)
                subs = [
                    (v00, m01, ctr, m30),
                    (m01, v10, m12, ctr),
                    (ctr, m12, v11, m23),
                    (m30, ctr, m23, v01),
                ]
                for s in subs:
                    new_c.append(np.stack(s))
                    new_q.append(True)
            else:
                a, b, cc = c[0], c[1], c[2]
                m0 = 0.5 * (a + b)
                m1 = 0.5 * (b + cc)
                m2 = 0.5 * (cc + a)
                subs = [(a, m0, m2), (m0, b, m1), (m1, cc, m2), (m0, m1, m2)]
                for s in subs:
                    new_c.append(make_triangle_corners(*s))
                    new_q.append(False)
            for _k in range(4):
                new_a.append(albedo[i])
                new_e.append(emission[i])
                new_m.append(material[i])
        corners = np.asarray(new_c, np.float32)
        is_quad = np.asarray(new_q, bool)
        albedo = np.asarray(new_a, np.float32)
        emission = np.asarray(new_e, np.float32)
        material = np.asarray(new_m, np.int32)
    return PrimList(corners, is_quad, albedo, emission, material, None)
