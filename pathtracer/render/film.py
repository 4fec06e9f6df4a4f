"""Progressive accumulation film.

The reference re-renders every frame from scratch (its `d_prev_image` is
allocated but never read — application_state.h:102, SURVEY.md §3.2);
progressive accumulation is an additive capability. The film is a
serializable pytree: linear radiance sum + sample count (+ the pass
counter for RNG resume), so offline renders can checkpoint and resume
exactly.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.tonemap import tonemap_pt


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Film:
    accum: jax.Array      # (H, W, 3) f32 linear radiance sum (row 0 = v=0)
    spp: jax.Array        # () int32 samples accumulated per pixel
    passes: jax.Array     # () int32 number of render passes folded in

    @staticmethod
    def create(width: int, height: int) -> "Film":
        return Film(
            accum=jnp.zeros((height, width, 3), jnp.float32),
            spp=jnp.zeros((), jnp.int32),
            passes=jnp.zeros((), jnp.int32),
        )

    @property
    def height(self) -> int:
        return self.accum.shape[0]

    @property
    def width(self) -> int:
        return self.accum.shape[1]

    def mean_radiance(self) -> jax.Array:
        return self.accum / jnp.maximum(self.spp, 1).astype(jnp.float32)

    def to_srgb(self) -> jax.Array:
        """(H, W, 3) uint8, row 0 still the bottom scanline."""
        return tonemap_pt(self.mean_radiance())

    def to_image(self) -> np.ndarray:
        """(H, W, 3) uint8 with row 0 = top, ready for PNG export (the
        reference flips on write, ui_windows.h:205)."""
        return np.asarray(self.to_srgb())[::-1]

    # --- checkpoint / resume (SURVEY.md §5: additive capability) ---

    def save(self, path: str) -> None:
        np.savez(
            path,
            accum=np.asarray(self.accum),
            spp=np.asarray(self.spp),
            passes=np.asarray(self.passes),
        )

    @staticmethod
    def load(path: str) -> "Film":
        z = np.load(path)
        return Film(
            accum=jnp.asarray(z["accum"]),
            spp=jnp.asarray(z["spp"]),
            passes=jnp.asarray(z["passes"]),
        )
