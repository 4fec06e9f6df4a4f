"""pathtracer — a JAX global-illumination renderer.

Rebuild of the capabilities of the reference CUDA path tracer
(USharma002/CUDA-PathTracer, see SURVEY.md) as a JAX/XLA/Pallas wavefront
renderer: Monte-Carlo path tracing, a radiosity solver with MC form factors,
radiosity-guided path sampling (per-primitive directional CDFs + one-sample
MIS), grid filtering, OBJ/PBRT scene IO, and shard_map multi-device tiling.
"""

import os

import jax

__version__ = "0.1.0"

# Persistent compilation cache. Where JAX_COMPILATION_CACHE_DIR is set,
# JAX reads it itself and the package sets nothing; otherwise compiled
# programs are kept in a fixed directory inside the checkout (listed in
# .gitignore), so every process of this checkout finds them again.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)

# Partitionable threefry: identical random streams regardless of sharding.
jax.config.update("jax_threefry_partitionable", True)
