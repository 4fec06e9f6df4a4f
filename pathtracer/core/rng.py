"""Counter-based RNG key plumbing.

The reference carries a mutable curandState per pixel (seed 2023+pixel,
integrator.h:274-280) and per form-factor pair (seed 12345+idx,
form_factors.h:84-88). Here we use JAX's counter-based threefry instead:
keys are *derived*, never stored, by folding structured coordinates
(pixel, sample, bounce, purpose) into a base key. This is bitwise
reproducible, stateless, and shards trivially across devices.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Stream identifiers so distinct consumers of randomness never collide.
STREAM_CAMERA = 0      # pixel-jitter for primary rays
STREAM_PATH = 1        # per-bounce sampling decisions in the integrator
STREAM_FORMFACTOR = 2  # MC form-factor surface samples
STREAM_MISC = 3


def base_key(seed: int = 2023) -> jax.Array:
    """Root key for a render; default seed mirrors the reference's 2023."""
    return jax.random.key(seed)


def stream_key(key: jax.Array, stream: int) -> jax.Array:
    return jax.random.fold_in(key, stream)


def pixel_key(key: jax.Array, pixel_index, sample_index) -> jax.Array:
    """Key for one (pixel, spp-sample) pair. Works under vmap: the
    pixel/sample indices may be traced arrays."""
    k = jax.random.fold_in(key, pixel_index)
    return jax.random.fold_in(k, sample_index)


def bounce_key(key: jax.Array, depth) -> jax.Array:
    """Key for one path vertex; depth may be traced (scan carry)."""
    return jax.random.fold_in(key, depth)


def uniforms(key: jax.Array, n: int, shape=()) -> jnp.ndarray:
    """n independent uniforms in [0, 1) with the given batch shape."""
    return jax.random.uniform(key, shape + (n,))


def lane_uniforms(
    key: jax.Array,
    lane_ids: jax.Array,
    n: int,
    sub_ids: jax.Array | None = None,
) -> jax.Array:
    """(B, n) uniforms where row i depends ONLY on (key, lane_ids[i]).

    Unlike `jax.random.uniform(key, (B, n))` — whose values depend on a
    lane's *position* in the batch — this is invariant to batch layout:
    chunk size, padding, lane permutation, and device sharding all
    produce identical draws for the same logical lane id. The renderer
    keys every per-path draw this way (lane id = global pixel index), so
    renders are bitwise identical across ray_chunk settings and across
    single-chip vs shard_map-tiled execution.

    Implementation: ONE counter-mode threefry sweep. threefry_2x32 is a
    2-word block cipher that pairs element i with element i+N/2 of the
    flat counter array — position-dependent — so both cipher words are
    set explicitly per block: word0 = lane id, word1 = draw-pair index.
    Each block yields two independent 32-bit outputs (draws 2k, 2k+1),
    so the hot-loop cost equals the positional `uniform(key, (B, n))`
    this replaces. Bits convert via the standard mantissa fill.

    `sub_ids` (optional, per-lane int32) extends the counter with a
    second per-lane coordinate packed into the high bits of word1
    (sub_ids*256 + draw-pair index; requires n <= 512): draws then
    depend only on (key, lane_ids[i], sub_ids[i]). The wavefront
    integrator keys every path draw by (pixel, sample, depth) this way,
    making renders invariant to lane *scheduling* — not just batch
    layout. sub_ids=None reproduces the original counter bitwise."""
    from jax.extend import random as jex_random

    kd = jax.random.key_data(key).astype(jnp.uint32)        # (2,)
    b = lane_ids.shape[0]
    half = (n + 1) // 2
    w0 = jnp.broadcast_to(
        lane_ids.astype(jnp.uint32)[:, None], (b, half)
    ).reshape(-1)
    w1 = jnp.broadcast_to(
        jnp.arange(half, dtype=jnp.uint32)[None, :], (b, half)
    )
    if sub_ids is not None:
        if n > 512:
            raise ValueError("sub_ids packing supports n <= 512")
        w1 = w1 + sub_ids.astype(jnp.uint32)[:, None] * jnp.uint32(256)
    w1 = w1.reshape(-1)
    out = jex_random.threefry_2x32(kd, jnp.concatenate([w0, w1]))
    m = b * half
    bits = jnp.stack(
        [out[:m].reshape(b, half), out[m:].reshape(b, half)], axis=-1
    ).reshape(b, 2 * half)[:, :n]
    return jax.lax.bitcast_convert_type(
        (bits >> 9) | jnp.uint32(0x3F800000), jnp.float32
    ) - 1.0
