"""Vector math, frames, and hemisphere warps — fully batched jnp.

Capability parity with the reference's scalar device helpers
(`reference/include/core/math_utils.h`, the Frisvad frame in
`integrator.h:62-85` / `grid.h:302-312`, and the local grid binning in
`form_factors.h:107-128`), re-designed as array programs: every function
accepts arbitrary leading batch dimensions with a trailing axis of size 3.
"""

from __future__ import annotations

import math

import jax.numpy as jnp

PI = math.pi
TWO_PI = 2.0 * math.pi


def dot(a, b):
    """Batched dot product over the trailing axis (keeps no dims)."""
    return jnp.sum(a * b, axis=-1)


def cross(a, b):
    return jnp.cross(a, b)


def length(v):
    return jnp.sqrt(jnp.sum(v * v, axis=-1))


def normalize(v, eps: float = 1e-20):
    """Unit vector; safe on zero-length input (returns ~0)."""
    return v * (1.0 / jnp.maximum(length(v), eps))[..., None]


def luminance(rgb):
    """ITU-R BT.709 luminance, matching grid.h:68-70 coefficients."""
    return (
        0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]
    )


def reflect(d, n):
    """Mirror reflection of incident direction d about normal n."""
    return d - 2.0 * dot(d, n)[..., None] * n


def build_frame(n):
    """Frisvad orthonormal basis (tangent, bitangent) for unit normal n.

    Bit-compatible with the reference's buildFrame (grid.h:302-312),
    including the z < -0.9999999 singular branch, expressed branch-free
    with jnp.where so it vectorizes.

    Args:
        n: (..., 3) unit normals.
    Returns:
        (tangent, bitangent): each (..., 3).
    """
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    singular = nz < -0.9999999

    # Regular branch. Guard the denominator so the singular lanes don't
    # produce inf/nan that could poison gradients through where().
    a = 1.0 / jnp.where(singular, 1.0, 1.0 + nz)
    b = -nx * ny * a
    t_reg = jnp.stack([1.0 - nx * nx * a, b, -nx], axis=-1)
    b_reg = jnp.stack([b, 1.0 - ny * ny * a, -ny], axis=-1)

    t_sing = jnp.broadcast_to(jnp.array([0.0, -1.0, 0.0], n.dtype), n.shape)
    b_sing = jnp.broadcast_to(jnp.array([-1.0, 0.0, 0.0], n.dtype), n.shape)

    s = singular[..., None]
    return jnp.where(s, t_sing, t_reg), jnp.where(s, b_sing, b_reg)


def to_local(d, n):
    """World direction -> local (x, y, z) coords in the Frisvad frame of n."""
    t, b = build_frame(n)
    return jnp.stack([dot(d, t), dot(d, b), dot(d, n)], axis=-1)


def from_local(local, n):
    """Local (x, y, z) in the Frisvad frame of n -> world direction (unit)."""
    t, b = build_frame(n)
    w = (
        t * local[..., 0:1]
        + b * local[..., 1:2]
        + n * local[..., 2:3]
    )
    return normalize(w)


def world_to_spherical(d, n):
    """Direction -> (theta, phi) in the local frame of n.

    theta in [0, pi] measured from n, phi in [0, 2pi). Matches
    grid.h:315-327 / form_factors.h:107-121 conventions.
    """
    local = to_local(d, n)
    lz = jnp.clip(local[..., 2], -1.0, 1.0)
    theta = jnp.arccos(lz)
    phi = jnp.arctan2(local[..., 1], local[..., 0])
    phi = jnp.where(phi < 0.0, phi + TWO_PI, phi)
    return theta, phi


def spherical_to_local(theta, phi):
    """(theta, phi) -> local unit direction (z along the normal)."""
    sin_t = jnp.sin(theta)
    return jnp.stack(
        [sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), jnp.cos(theta)], axis=-1
    )


def cosine_sample_hemisphere(n, u, v):
    """Cosine-weighted hemisphere sample via Malley's method.

    Matches sampleCosineHemisphere (integrator.h:62-85): concentric disk via
    (sqrt(u), 2*pi*v), z = sqrt(1-u), lifted through the Frisvad frame.

    Args:
        n: (..., 3) shading normals.
        u, v: (...,) uniforms in [0, 1).
    Returns:
        (dir, pdf): unit directions (..., 3) and cosine pdf (...,).
    """
    r = jnp.sqrt(u)
    phi = TWO_PI * v
    x = r * jnp.cos(phi)
    y = r * jnp.sin(phi)
    z = jnp.sqrt(jnp.maximum(0.0, 1.0 - u))
    d = from_local(jnp.stack([x, y, z], axis=-1), n)
    pdf = jnp.maximum(dot(d, n), 0.0) / PI
    return d, pdf


def cosine_pdf(d, n):
    """PDF of cosine-weighted hemisphere sampling (grid.h:276-278)."""
    return jnp.maximum(dot(d, n), 0.0) / PI


def uniform_sample_sphere(u, v):
    """Uniform direction on the unit sphere (math_utils.h:94-110)."""
    z = 1.0 - 2.0 * u
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = TWO_PI * v
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def power_heuristic(pdf_a, pdf_b):
    """MIS power heuristic: pdf_a^2 / (pdf_a^2 + pdf_b^2).

    Matches misPowerHeuristic (integrator.h:91-96) including the
    pdf_a <= 0 -> 0 guard.
    """
    a2 = pdf_a * pdf_a
    b2 = pdf_b * pdf_b
    w = a2 / jnp.maximum(a2 + b2, 1e-30)
    return jnp.where(pdf_a <= 0.0, 0.0, w)
