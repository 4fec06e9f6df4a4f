"""Grid / sampling constants — single source of truth.

Re-design of the reference configuration header
(`reference/include/rendering/render_config.h:7-17`): the directional
guiding grid is 16x16 cells over the full sphere; only the upper 8 theta rows
(the hemisphere above the surface) participate in importance sampling.
"""

import math

GRID_RES = 16                      # 16x16 directional grid
GRID_SIZE = GRID_RES * GRID_RES    # 256 cells
GRID_HALF_RES = GRID_RES // 2      # 8 upper-hemisphere theta rows

GRID_INV_RES = 1.0 / GRID_RES
GRID_INV_HALF_RES = 1.0 / GRID_HALF_RES
GRID_D_THETA = (math.pi * 0.5) / GRID_HALF_RES   # theta step over hemisphere
GRID_D_PHI = (2.0 * math.pi) / GRID_RES          # phi step

# Integrator epsilons (reference: integrator.h:199,266)
RAY_EPS = 1e-4          # t_min for scattered rays and respawn offset
THROUGHPUT_EPS = 1e-5   # early termination on |beta|
RR_START_DEPTH = 2      # Russian roulette kicks in for depth > 2
RR_MAX_PROB = 0.95
FIREFLY_CLAMP = 10.0    # guided-sampling weight clamp (integrator.h:159,256)

# Sampling modes (reference: render_config.h:38-44)
SAMPLING_BSDF = 0
SAMPLING_FORMFACTOR = 1
SAMPLING_RADIOSITY = 2
SAMPLING_MIS = 3
SAMPLING_TOPK = 4

SAMPLING_MODE_NAMES = {
    "bsdf": SAMPLING_BSDF,
    "formfactor": SAMPLING_FORMFACTOR,
    "radiosity": SAMPLING_RADIOSITY,
    "mis": SAMPLING_MIS,
    "topk": SAMPLING_TOPK,
}

# Material models. The reference shades only Lambertian + emissive
# (integrator.h:214-263); MATERIAL_MIRROR is an additive capability (the
# reference README promises reflective materials).
MATERIAL_DIFFUSE = 0
MATERIAL_MIRROR = 1
