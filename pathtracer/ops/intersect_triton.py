"""Fused ray x triangle closest-hit and any-hit kernels (Pallas, Triton route).

The XLA brute force (ops/intersect.py) builds a (B, T) slab of hit
distances per bounce, reduces it with argmin, re-reads the winner with
take_along_axis and then gathers five attribute tables. Here one program
owns a block of BLOCK_RAYS rays, held in registers, and streams the
triangle constants through a loop of TRI_BLOCK triangles at a time
inside the block. It keeps the running (t, id) and finally loads the
winner's attribute row — plus its guided-sampling row when the pack
carries one — by direct index. Nothing of size (B, T) reaches device
memory.

The per-pair arithmetic is ops.intersect.intersect_tuv term for term,
and the semantics are those of ops.intersect.closest_hit / occluded:
  * first-minimum tie-break (strict '<' across triangle blocks, lowest
    index within one);
  * a hit needs t > 1e-8, t >= t_min, finite t and u, v >= 0, u+v <= 1;
  * degenerate and padding triangles carry a zero inverse, so t = NaN
    and every ordered comparison rejects them;
  * any-hit counts eps < t < max_dist on triangles whose logical
    primitive is neither exclude_a nor exclude_b (form_factors.h:144-209),
    and a block stops as soon as all its rays are blocked.

On the GPU the kernels compile through Triton. Tests run them on the CPU
with interpret=True, which is chosen only by that explicit flag: a call
without it on any platform but the GPU raises.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..scene.mesh import Geometry, host_array
from .intersect import Hit

BLOCK_RAYS = 128   # rays per program (a power of two)
TRI_BLOCK = 16     # triangles per inner-loop step (a power of two)
NUM_WARPS = 4
ATTR_COLS = 16     # attribute row: normal(3) albedo(3) emission(3) pad
_T_EPS = 1e-8      # Möller-Trumbore epsilon (triangle.h:66)
_BIG_ID = 2**30


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["geo", "ids", "attr"],
    meta_fields=["interpret"],
)
@dataclass(frozen=True)
class TrianglePack:
    """Per-triangle constants of one scene, padded to a whole number of
    TRI_BLOCK steps (padding rows are degenerate and never hit).

    geo:  (16, Tpad) f32, one constant per row: the affine inverse
          M^-1 of [e1 e2 n] row-major in rows 0-8, v0 in rows 9-11.
    ids:  (Tpad, 2) int32: logical primitive id, material id.
    attr: (Tpad, 16) f32 rows [normal | albedo | emission | pad], or
          (Tpad, 32) with the primitive's guided-sampling row
          (CDFPack.prim_table) in columns 16-31.
    interpret: run the kernels in the Pallas interpreter (CPU tests).
    """

    geo: jax.Array
    ids: jax.Array
    attr: jax.Array
    interpret: bool = field(default=False)

    @property
    def has_guide(self) -> bool:
        return self.attr.shape[1] > ATTR_COLS


def _tri_pad(t: int) -> int:
    return max(TRI_BLOCK, -(-t // TRI_BLOCK) * TRI_BLOCK)


def pack_triangles(geom: Geometry, guide_table=None,
                   interpret: bool = False) -> TrianglePack:
    """Host-side pack of `geom` for the kernels. `guide_table` ((N, 16),
    CDFPack.prim_table) appends each triangle's guided-sampling row so
    the hit kernel delivers it with the shading attributes."""
    inv = host_array(geom.tri_inv)
    t = inv.shape[0]
    tpad = _tri_pad(t)
    prim = host_array(geom.tri_prim)
    geo = np.zeros((16, tpad), np.float32)
    geo[0:9, :t] = inv.reshape(t, 9).T
    geo[9:12, :t] = host_array(geom.tri_v0).T
    ids = np.zeros((tpad, 2), np.int32)
    ids[:, 0] = -2                       # padding: no logical primitive
    ids[:t, 0] = prim
    ids[:t, 1] = host_array(geom.material)[prim]
    cols = ATTR_COLS if guide_table is None else 2 * ATTR_COLS
    attr = np.zeros((tpad, cols), np.float32)
    attr[:t, 0:3] = host_array(geom.normal)[prim]
    attr[:t, 3:6] = host_array(geom.albedo)[prim]
    attr[:t, 6:9] = host_array(geom.emission)[prim]
    if guide_table is not None:
        attr[:t, ATTR_COLS:] = np.asarray(guide_table)[prim]
    return TrianglePack(
        geo=jnp.asarray(geo), ids=jnp.asarray(ids), attr=jnp.asarray(attr),
        interpret=interpret,
    )


# ---------------------------------------------------------------------------
# Kernel bodies
# ---------------------------------------------------------------------------


def _block_t(geo_ref, c, o, d):
    """(t, hit) for the program's rays x triangle block c, each (R, TB).
    Same expression order as ops.intersect.intersect_tuv."""
    sl = pl.ds(c * TRI_BLOCK, TRI_BLOCK)

    def g(k):
        return geo_ref[k, sl][None, :]

    ox, oy, oz, dx, dy, dz = (a[:, None] for a in (*o, *d))
    rx, ry, rz = ox - g(9), oy - g(10), oz - g(11)

    def row(r, x, y, z):
        return x * g(3 * r) + y * g(3 * r + 1) + z * g(3 * r + 2)

    t = -row(2, rx, ry, rz) / row(2, dx, dy, dz)
    u = row(0, rx, ry, rz) + t * row(0, dx, dy, dz)
    v = row(1, rx, ry, rz) + t * row(1, dx, dy, dz)
    hit = (
        (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t > _T_EPS) & (t < jnp.inf)
    )
    return t, hit


def _load_rays(o_ref, d_ref):
    return (
        (o_ref[:, 0], o_ref[:, 1], o_ref[:, 2]),
        (d_ref[:, 0], d_ref[:, 1], d_ref[:, 2]),
    )


def _closest_kernel(geo_ref, ids_ref, attr_ref, o_ref, d_ref,
                    t_out, ids_out, attr_out, *, t_min):
    o, d = _load_rays(o_ref, d_ref)
    n_blocks = geo_ref.shape[1] // TRI_BLOCK

    def step(c, carry):
        t_best, i_best = carry
        t, hit = _block_t(geo_ref, c, o, d)
        t = jnp.where(hit & (t >= t_min), t, jnp.inf)
        t_blk = jnp.min(t, axis=1)
        cols = jax.lax.broadcasted_iota(jnp.int32, t.shape, 1) + (
            c * TRI_BLOCK
        )
        i_blk = jnp.min(
            jnp.where(t == t_blk[:, None], cols, _BIG_ID), axis=1
        )
        better = t_blk < t_best
        return (
            jnp.where(better, t_blk, t_best),
            jnp.where(better, i_blk, i_best),
        )

    rays = t_out.shape[0]
    t_best, i_best = jax.lax.fori_loop(
        0, n_blocks, step,
        (jnp.full((rays,), jnp.inf, jnp.float32),
         jnp.zeros((rays,), jnp.int32)),
    )
    t_out[...] = t_best
    ids_out[...] = ids_ref[i_best, :]
    attr_out[...] = attr_ref[i_best, :]


def _anyhit_kernel(geo_ref, ids_ref, o_ref, d_ref, maxd_ref, exa_ref,
                   exb_ref, out_ref, *, eps):
    o, d = _load_rays(o_ref, d_ref)
    maxd = maxd_ref[...][:, None]
    exa = exa_ref[...][:, None]
    exb = exb_ref[...][:, None]
    n_blocks = geo_ref.shape[1] // TRI_BLOCK

    def cond(carry):
        c, blocked = carry
        return (c < n_blocks) & (jnp.min(blocked) == 0)

    def step(carry):
        c, blocked = carry
        t, hit = _block_t(geo_ref, c, o, d)
        prim = ids_ref[pl.ds(c * TRI_BLOCK, TRI_BLOCK), 0][None, :]
        ok = hit & (t > eps) & (t < maxd) & (prim != exa) & (prim != exb)
        return c + 1, jnp.maximum(
            blocked, jnp.max(ok.astype(jnp.int32), axis=1)
        )

    rays = out_ref.shape[0]
    _, blocked = jax.lax.while_loop(
        cond, step, (jnp.int32(0), jnp.zeros((rays,), jnp.int32))
    )
    out_ref[...] = blocked


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check_platform(interpret: bool) -> None:
    if not interpret and jax.default_backend() != "gpu":
        raise RuntimeError(
            "the Triton intersection kernels compile only for the GPU "
            f"(default backend is '{jax.default_backend()}'); build the "
            "pack with interpret=True to run them in the Pallas "
            "interpreter"
        )


def _pad_rays(b: int, *arrays):
    """Pad ray arrays to a whole number of BLOCK_RAYS with copies of
    ray 0 (their results are sliced away)."""
    pad = (-b) % BLOCK_RAYS
    if not pad:
        return arrays
    return tuple(
        jnp.concatenate([a, jnp.broadcast_to(a[:1], (pad,) + a.shape[1:])])
        for a in arrays
    )


def _whole(a):
    return pl.BlockSpec(a.shape, lambda i: (0,) * a.ndim)


def _rows(width=None):
    if width is None:
        return pl.BlockSpec((BLOCK_RAYS,), lambda i: (i,))
    return pl.BlockSpec((BLOCK_RAYS, width), lambda i: (i, 0))


def _call(kernel, grid, in_specs, out_specs, out_shape, interpret, name):
    return pl.pallas_call(
        kernel,
        grid=grid,
        in_specs=in_specs,
        out_specs=out_specs,
        out_shape=out_shape,
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=NUM_WARPS, num_stages=1
        ),
        interpret=interpret,
        name=name,
    )


@partial(jax.jit, static_argnames=("t_min",))
def closest_record(pack: TrianglePack, o, d, t_min=1e-4):
    """(t, ids, attr) of the closest hit for each ray: t is inf on a miss;
    ids (B, 2) and attr (B, 16|32) are the winning triangle's rows (of
    triangle 0 on a miss)."""
    _check_platform(pack.interpret)
    b0 = o.shape[0]
    o, d = _pad_rays(b0, o, d)
    b = o.shape[0]
    n_attr = pack.attr.shape[1]
    t, ids, attr = _call(
        partial(_closest_kernel, t_min=t_min),
        grid=(b // BLOCK_RAYS,),
        in_specs=[_whole(pack.geo), _whole(pack.ids), _whole(pack.attr),
                  _rows(3), _rows(3)],
        out_specs=[_rows(), _rows(2), _rows(n_attr)],
        out_shape=[
            jax.ShapeDtypeStruct((b,), jnp.float32),
            jax.ShapeDtypeStruct((b, 2), jnp.int32),
            jax.ShapeDtypeStruct((b, n_attr), jnp.float32),
        ],
        interpret=pack.interpret,
        name="closest_hit",
    )(pack.geo, pack.ids, pack.attr, o, d)
    return t[:b0], ids[:b0], attr[:b0]


def kernel_closest_hit(pack: TrianglePack, o, d, t_min=1e-4,
                       t_max=jnp.inf) -> Hit:
    """Drop-in equivalent of ops.intersect.closest_hit; Hit.guide is set
    when the pack carries guided-sampling rows."""
    t, ids, attr = closest_record(pack, o, d, t_min=t_min)
    valid = t < t_max
    return Hit(
        valid=valid,
        t=jnp.where(valid, t, jnp.inf),
        prim=jnp.where(valid, ids[:, 0], 0),
        p=jnp.where(valid[:, None], o + t[:, None] * d, 0.0),
        n=attr[:, 0:3],
        albedo=attr[:, 3:6],
        emission=jnp.where(valid[:, None], attr[:, 6:9], 0.0),
        material=ids[:, 1],
        guide=attr[:, ATTR_COLS:] if pack.has_guide else None,
    )


@partial(jax.jit, static_argnames=("eps",))
def kernel_occluded(pack: TrianglePack, o, d, max_dist, exclude_a=None,
                    exclude_b=None, eps: float = 1e-5):
    """Drop-in equivalent of ops.intersect.occluded: True where the
    segment is blocked."""
    _check_platform(pack.interpret)
    b0 = o.shape[0]
    none = jnp.full((b0,), -1, jnp.int32)
    exclude_a = none if exclude_a is None else exclude_a.astype(jnp.int32)
    exclude_b = none if exclude_b is None else exclude_b.astype(jnp.int32)
    max_dist = jnp.broadcast_to(
        jnp.asarray(max_dist, jnp.float32), (b0,)
    )
    o, d, max_dist, exclude_a, exclude_b = _pad_rays(
        b0, o, d, max_dist, exclude_a, exclude_b
    )
    b = o.shape[0]
    blocked = _call(
        partial(_anyhit_kernel, eps=eps),
        grid=(b // BLOCK_RAYS,),
        in_specs=[_whole(pack.geo), _whole(pack.ids), _rows(3), _rows(3),
                  _rows(), _rows(), _rows()],
        out_specs=_rows(),
        out_shape=jax.ShapeDtypeStruct((b,), jnp.int32),
        interpret=pack.interpret,
        name="any_hit",
    )(pack.geo, pack.ids, o, d, max_dist, exclude_a, exclude_b)
    return blocked[:b0] > 0
