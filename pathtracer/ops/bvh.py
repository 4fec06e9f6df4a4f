"""BVH acceleration structure: host build + vectorized device traversal.

Capability parity with the reference accel stack
(`reference/include/rendering/bvh.h`, `ray_tracing_backend.h`):
  * host build: recursive split at the midpoint of the largest centroid
    axis, <=4 triangles per leaf, degenerate-extent guard with median-split
    fallback (bvh.h:76-219) — producing *flat SoA arrays* (no pointers);
    triangles are additionally Morton-ordered before building so leaves are
    spatially coherent (an LBVH-style improvement the reference lacks);
  * device traversal: the reference walks a per-thread stack with
    divergent branches (scene.h:50-110). Here every ray advances in
    lockstep through a `lax.while_loop`: each iteration pops one node per
    ray (per-ray stacks live in a (B, DEPTH) register array), tests its
    AABB against the ray's current best-t, intersects up to LEAF_SIZE
    triangles on leaves, and pushes children near-first. Rays that finish
    early idle until the batch drains — the classic divergence trade
    (SURVEY.md §7 hard parts) — which still wins asymptotically once the
    scene is large enough that brute force O(T) per ray loses.

ops/dispatch picks the BVH for large scenes (the fused kernel or the
brute force below the threshold), like the reference's RayTracingManager
picks OptiX vs software. The lockstep loop reads its predicate back to
the host every step; the reference's per-thread traversal is the kernel
to write for large scenes (ROADMAP R1).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..scene.mesh import Geometry, host_array

LEAF_SIZE = 4        # max triangles per leaf (bvh.h:156)
STACK_DEPTH = 48     # per-ray traversal stack entries
_T_EPS = 1e-8


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class BVH:
    """Flat BVH. Node i: leaf iff count[i] > 0; inner nodes store child
    ids in (left, right); leaves store (first, count) into tri_order."""

    node_min: jax.Array    # (M, 3)
    node_max: jax.Array    # (M, 3)
    node_left: jax.Array   # (M,) int32: child id or first-tri offset
    node_right: jax.Array  # (M,) int32: child id (leaves: unused)
    node_count: jax.Array  # (M,) int32: 0 for inner, tri count for leaf
    tri_order: jax.Array   # (T,) int32 triangle permutation

    @property
    def num_nodes(self) -> int:
        return self.node_min.shape[0]


def _morton3(x: np.ndarray) -> np.ndarray:
    """Interleave 10-bit quantized coords into 30-bit Morton codes."""
    def expand(v):
        v = v.astype(np.uint64)
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    q = np.clip((x * 1023.0), 0, 1023).astype(np.uint64)
    return (
        (expand(q[:, 0]) << 2) | (expand(q[:, 1]) << 1) | expand(q[:, 2])
    )


def _tree_depth(n_left, n_right, n_count) -> int:
    """Max root-to-leaf depth of a flat BVH (level-order sweep)."""
    n_left = np.asarray(n_left)
    n_right = np.asarray(n_right)
    n_count = np.asarray(n_count)
    frontier = np.array([0], np.int32)
    depth = 0
    while frontier.size:
        depth += 1
        inner = frontier[n_count[frontier] == 0]
        frontier = np.concatenate([n_left[inner], n_right[inner]])
    return depth


def _check_stack(bvh: BVH) -> BVH:
    """Traversal pushes at most one deferred sibling per level, so the
    per-ray stack needs depth+1 slots; overflow would silently skip
    subtrees (dropped child pushes in the can1/can2 guards)."""
    depth = _tree_depth(bvh.node_left, bvh.node_right, bvh.node_count)
    if depth + 1 > STACK_DEPTH:
        raise ValueError(
            f"BVH depth {depth} exceeds traversal stack "
            f"({STACK_DEPTH} entries); raise ops.bvh.STACK_DEPTH or use "
            "the brute or triton backend for this scene"
        )
    return bvh


def build_bvh(geom: Geometry, prefer_native: bool = True) -> BVH:
    """Host-side build over the canonical triangle list.

    Prefers the C++ implementation (native/libtpt_native.so, ~100x faster,
    identical output); falls back to this NumPy implementation."""
    v0 = host_array(geom.tri_v0)
    e1 = host_array(geom.tri_e1)
    e2 = host_array(geom.tri_e2)
    v1, v2 = v0 + e1, v0 + e2
    tmin = np.minimum(np.minimum(v0, v1), v2)
    tmax = np.maximum(np.maximum(v0, v1), v2)
    centroid = (tmin + tmax) * 0.5
    t = v0.shape[0]

    if prefer_native:
        from ..utils.native import native_build_bvh

        fields = native_build_bvh(tmin, tmax, LEAF_SIZE)
        if fields is not None:
            return _check_stack(
                BVH(**{k: jnp.asarray(v) for k, v in fields.items()})
            )

    # Morton pre-sort for leaf coherence.
    lo, hi = centroid.min(0), centroid.max(0)
    norm = (centroid - lo) / np.maximum(hi - lo, 1e-12)
    order = np.argsort(_morton3(norm), kind="stable").astype(np.int32)

    n_min, n_max, n_left, n_right, n_count = [], [], [], [], []

    def new_node():
        n_min.append(np.zeros(3, np.float32))
        n_max.append(np.zeros(3, np.float32))
        n_left.append(0)
        n_right.append(0)
        n_count.append(0)
        return len(n_min) - 1

    # Iterative build (explicit stack) to dodge recursion limits on big
    # meshes. Each task: (node_id, start, end) over `order`.
    root = new_node()
    tasks = [(root, 0, t)]
    while tasks:
        node, start, end = tasks.pop()
        idx = order[start:end]
        bb_min = tmin[idx].min(0)
        bb_max = tmax[idx].max(0)
        n_min[node] = bb_min.astype(np.float32)
        n_max[node] = bb_max.astype(np.float32)
        count = end - start
        if count <= LEAF_SIZE:
            n_left[node] = start
            n_count[node] = count
            continue
        cen = centroid[idx]
        c_lo, c_hi = cen.min(0), cen.max(0)
        extent = c_hi - c_lo
        axis = int(np.argmax(extent))
        if extent[axis] < 1e-12:
            mid = start + count // 2  # degenerate: median split
        else:
            cut = 0.5 * (c_lo[axis] + c_hi[axis])
            side = cen[:, axis] < cut
            k = int(side.sum())
            if k == 0 or k == count:
                mid = start + count // 2  # empty partition: median
            else:
                # partition `order[start:end]` by side
                seg = order[start:end]
                order[start:end] = np.concatenate([seg[side], seg[~side]])
                mid = start + k
        left = new_node()
        right = new_node()
        n_left[node] = left
        n_right[node] = right
        tasks.append((left, start, mid))
        tasks.append((right, mid, end))

    return _check_stack(BVH(
        node_min=jnp.asarray(np.stack(n_min)),
        node_max=jnp.asarray(np.stack(n_max)),
        node_left=jnp.asarray(np.asarray(n_left, np.int32)),
        node_right=jnp.asarray(np.asarray(n_right, np.int32)),
        node_count=jnp.asarray(np.asarray(n_count, np.int32)),
        tri_order=jnp.asarray(order),
    ))


def _slab_test(node_min, node_max, o, inv_d, t_best):
    """Ray/AABB slab test (scene.h:64-84): hit iff [tmin, tmax] overlaps
    (eps, t_best)."""
    t1 = (node_min - o) * inv_d
    t2 = (node_max - o) * inv_d
    tmin = jnp.max(jnp.minimum(t1, t2), axis=-1)
    tmax = jnp.min(jnp.maximum(t1, t2), axis=-1)
    return (tmax >= jnp.maximum(tmin, 0.0)) & (tmin < t_best) & (
        tmax > _T_EPS
    )


def _tri_hit(geom: Geometry, tri_idx, o, d):
    """Single-triangle intersection per ray via the per-triangle affine
    inverse (same math as ops/intersect.py, gathered per lane)."""
    inv = geom.tri_inv[tri_idx]               # (B, 3, 3)
    ro = o - geom.tri_v0[tri_idx]
    hi = jax.lax.Precision.HIGHEST
    op = jnp.einsum("bij,bj->bi", inv, ro, precision=hi)
    dp = jnp.einsum("bij,bj->bi", inv, d, precision=hi)
    t = -op[:, 2] / dp[:, 2]
    u = op[:, 0] + t * dp[:, 0]
    v = op[:, 1] + t * dp[:, 1]
    ok = (
        (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t > _T_EPS) & jnp.isfinite(t)
    )
    return jnp.where(ok, t, jnp.inf)


@partial(jax.jit, static_argnames=())
def bvh_closest_tuv(geom: Geometry, bvh: BVH, o, d, t_min, t_max):
    """(t, tri_idx) closest hit for a ray batch via lockstep traversal."""
    b = o.shape[0]
    safe_d = jnp.where(jnp.abs(d) > 1e-8, d, 1e-8)
    inv_d = 1.0 / safe_d

    stack = jnp.zeros((b, STACK_DEPTH), jnp.int32)
    sp = jnp.ones((b,), jnp.int32)          # root pushed at slot 0
    t_best = jnp.full((b,), jnp.inf)
    best_tri = jnp.zeros((b,), jnp.int32)

    def cond(state):
        _, sp, _, _ = state
        return jnp.any(sp > 0)

    def body(state):
        stack, sp, t_best, best_tri = state
        active = sp > 0
        node = jnp.where(active, _stack_top(stack, sp), 0)
        sp = jnp.where(active, sp - 1, sp)

        nmin = bvh.node_min[node]
        nmax = bvh.node_max[node]
        box_hit = active & _slab_test(nmin, nmax, o, inv_d, t_best)

        count = bvh.node_count[node]
        is_leaf = count > 0
        first = bvh.node_left[node]

        # Leaf: up to LEAF_SIZE triangle tests per ray (static unroll).
        leaf_act = box_hit & is_leaf
        for k in range(LEAF_SIZE):
            valid_k = leaf_act & (k < count)
            tri = bvh.tri_order[
                jnp.clip(first + k, 0, bvh.tri_order.shape[0] - 1)
            ]
            t = _tri_hit(geom, tri, o, d)
            t = jnp.where(valid_k & (t >= t_min), t, jnp.inf)
            better = t < t_best
            t_best = jnp.where(better, t, t_best)
            best_tri = jnp.where(better, tri, best_tri)

        # Inner: push both children (right then left so left pops first).
        push = box_hit & ~is_leaf
        left = bvh.node_left[node]
        right = bvh.node_right[node]
        can2 = push & (sp + 1 < STACK_DEPTH)
        stack = _scatter_push(stack, sp, right, can2)
        sp = sp + can2.astype(jnp.int32)
        can1 = push & (sp < STACK_DEPTH)
        stack = _scatter_push(stack, sp, left, can1)
        sp = sp + can1.astype(jnp.int32)
        return stack, sp, t_best, best_tri

    stack, sp, t_best, best_tri = jax.lax.while_loop(
        cond, body, (stack, sp, t_best, best_tri)
    )
    t_best = jnp.where(t_best < t_max, t_best, jnp.inf)
    return t_best, best_tri


def _scatter_push(stack, sp, value, mask):
    """stack[b, sp[b]] = value[b] where mask — expressed as a one-hot
    blend over the (small) stack axis, a (B, DEPTH) select."""
    slot = jnp.clip(sp, 0, STACK_DEPTH - 1)
    onehot = (
        jnp.arange(STACK_DEPTH, dtype=jnp.int32)[None, :] == slot[:, None]
    ) & mask[:, None]
    return jnp.where(onehot, value[:, None], stack)


def _stack_top(stack, sp):
    """stack[b, sp[b]-1] via a one-hot reduction (same rationale)."""
    top = jnp.maximum(sp - 1, 0)
    onehot = (
        jnp.arange(STACK_DEPTH, dtype=jnp.int32)[None, :] == top[:, None]
    )
    return jnp.sum(jnp.where(onehot, stack, 0), axis=1)


def bvh_closest_hit(geom: Geometry, bvh: BVH, o, d, t_min=1e-4,
                    t_max=jnp.inf):
    """Drop-in equivalent of ops.intersect.closest_hit using the BVH."""
    from .intersect import Hit

    t, tri_idx = bvh_closest_tuv(geom, bvh, o, d, t_min, t_max)
    valid = jnp.isfinite(t)
    prim = jnp.where(valid, geom.tri_prim[tri_idx], 0)
    p = o + t[:, None] * d
    p = jnp.where(valid[:, None], p, 0.0)
    return Hit(
        valid=valid,
        t=t,
        prim=prim,
        p=p,
        n=geom.normal[prim],
        albedo=geom.albedo[prim],
        emission=jnp.where(valid[:, None], geom.emission[prim], 0.0),
        material=geom.material[prim],
    )


@partial(jax.jit, static_argnames=())
def bvh_occluded(geom: Geometry, bvh: BVH, o, d, max_dist,
                 exclude_a=None, exclude_b=None, eps: float = 1e-5):
    """Any-hit occlusion via traversal with early lane termination."""
    b = o.shape[0]
    safe_d = jnp.where(jnp.abs(d) > 1e-8, d, 1e-8)
    inv_d = 1.0 / safe_d
    if exclude_a is None:
        exclude_a = jnp.full((b,), -1, jnp.int32)
    if exclude_b is None:
        exclude_b = jnp.full((b,), -1, jnp.int32)

    stack = jnp.zeros((b, STACK_DEPTH), jnp.int32)
    sp = jnp.ones((b,), jnp.int32)
    blocked = jnp.zeros((b,), bool)

    def cond(state):
        _, sp, blocked = state
        return jnp.any((sp > 0) & ~blocked)

    def body(state):
        stack, sp, blocked = state
        active = (sp > 0) & ~blocked
        node = jnp.where(active, _stack_top(stack, sp), 0)
        sp = jnp.where(active, sp - 1, sp)

        box_hit = active & _slab_test(
            bvh.node_min[node], bvh.node_max[node], o, inv_d, max_dist
        )
        count = bvh.node_count[node]
        is_leaf = count > 0
        first = bvh.node_left[node]
        leaf_act = box_hit & is_leaf
        for k in range(LEAF_SIZE):
            valid_k = leaf_act & (k < count)
            tri = bvh.tri_order[
                jnp.clip(first + k, 0, bvh.tri_order.shape[0] - 1)
            ]
            prim = geom.tri_prim[tri]
            excl = (prim == exclude_a) | (prim == exclude_b)
            t = _tri_hit(geom, tri, o, d)
            hit = valid_k & ~excl & (t > eps) & (t < max_dist)
            blocked = blocked | hit

        push = box_hit & ~is_leaf & ~blocked
        left = bvh.node_left[node]
        right = bvh.node_right[node]
        can2 = push & (sp + 1 < STACK_DEPTH)
        stack = _scatter_push(stack, sp, right, can2)
        sp = sp + can2.astype(jnp.int32)
        can1 = push & (sp < STACK_DEPTH)
        stack = _scatter_push(stack, sp, left, can1)
        sp = sp + can1.astype(jnp.int32)
        return stack, sp, blocked

    _, _, blocked = jax.lax.while_loop(
        cond, body, (stack, sp, blocked)
    )
    return blocked
