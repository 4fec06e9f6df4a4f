"""The one place that decides how rays meet triangles.

`select_backend(platform, num_tris)` names the intersection path for a
scene, `build_accel` builds its structure, and `closest_hit` / `occluded`
route every query — camera and bounce rays, NEE shadow rays, form-factor
visibility, picking — through it:

  * gpu: the fused Triton kernel (ops/intersect_triton) up to
    GPU_KERNEL_MAX_TRIS triangles, the BVH (ops/bvh) beyond;
  * cpu: the XLA brute force (ops/intersect) up to CPU_BRUTE_MAX_TRIS
    triangles, the BVH beyond.

An accel is None (brute force), a BVH, or a TrianglePack; all three give
the same hits (ops/intersect.closest_hit is the reference).
"""

from __future__ import annotations

import jax

from ..core.constants import RAY_EPS
from ..scene.mesh import Geometry
from . import intersect
from .bvh import BVH, build_bvh, bvh_closest_hit, bvh_occluded
from .intersect_triton import (
    TrianglePack,
    kernel_closest_hit,
    kernel_occluded,
    pack_triangles,
)

BACKENDS = ("brute", "triton", "bvh")

# Largest scene the fused kernel serves on the GPU: the largest measured
# size at which it beats the BVH in every caller, by wall time through
# App on an H100 (PERF.md, "the threshold by wall time"). At 8,192
# triangles it wins render passes by 2.5-3.3x and form-factor passes by
# 1.4-2.0x; at 16,384 it still wins renders by 1.5-1.6x but loses the
# form-factor pass by 1.24x. Sizes in between were not measured.
GPU_KERNEL_MAX_TRIS = 8192
CPU_BRUTE_MAX_TRIS = 2048


def current_platform() -> str:
    """Platform of the device new arrays land on: the `jax.default_device`
    setting where one is in force, else the default backend."""
    dev = jax.config.jax_default_device
    if dev is None:
        return jax.default_backend()
    return dev if isinstance(dev, str) else dev.platform


def select_backend(platform: str, num_tris: int) -> str:
    if platform == "gpu":
        return "triton" if num_tris <= GPU_KERNEL_MAX_TRIS else "bvh"
    if platform == "cpu":
        return "brute" if num_tris <= CPU_BRUTE_MAX_TRIS else "bvh"
    raise ValueError(f"no intersection path for platform '{platform}'")


def build_accel(geom: Geometry, backend: str, interpret: bool = False):
    """Structure for `backend`: None, a BVH or a TrianglePack.
    `interpret` (tests only) runs the Triton kernels in the interpreter."""
    if backend == "brute":
        return None
    if backend == "bvh":
        return build_bvh(geom)
    if backend == "triton":
        return pack_triangles(geom, interpret=interpret)
    raise ValueError(
        f"unknown intersection backend '{backend}' (expected one of "
        f"{BACKENDS})"
    )


def closest_hit(geom: Geometry, accel, o, d, t_min=RAY_EPS,
                t_max=jax.numpy.inf) -> intersect.Hit:
    if accel is None:
        return intersect.closest_hit(geom, o, d, t_min=t_min, t_max=t_max)
    if isinstance(accel, BVH):
        return bvh_closest_hit(geom, accel, o, d, t_min=t_min, t_max=t_max)
    if isinstance(accel, TrianglePack):
        return kernel_closest_hit(accel, o, d, t_min=t_min, t_max=t_max)
    raise TypeError(f"not an accel: {type(accel).__name__}")


def occluded(geom: Geometry, accel, o, d, max_dist, exclude_a=None,
             exclude_b=None):
    """True where the segment (o, o + max_dist * d) is blocked by a
    triangle of neither excluded primitive."""
    if accel is None:
        return intersect.occluded(geom, o, d, max_dist, exclude_a, exclude_b)
    if isinstance(accel, BVH):
        return bvh_occluded(geom, accel, o, d, max_dist, exclude_a,
                            exclude_b)
    if isinstance(accel, TrianglePack):
        return kernel_occluded(accel, o, d, max_dist, exclude_a, exclude_b)
    raise TypeError(f"not an accel: {type(accel).__name__}")
