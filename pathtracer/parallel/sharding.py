"""Multi-chip rendering: shard_map image-tile partitioning over a Mesh.

The reference is strictly single-GPU (SURVEY.md §2 parallelism checklist:
no NCCL/MPI, no multi-device anything); this module is the scale-out path
it lacks: a 4K frame tiled across cards, and sharded radiosity solves.

  * mesh: flat 1-D `Mesh(devices, ("tile",))` — every card reaches every
    other over NVLink at the same rate, so the mesh follows the
    algorithm alone; the film's image rows are the sharded axis;
    scene/CDF/camera pytrees are replicated (small);
  * each device renders its own row band with the SAME jitted render pass
    used single-chip, with the band's view-plane slice substituted into
    the camera and the tile index folded into its RNG stream (bands are
    statistically independent; the estimator is unchanged);
  * collectives: `psum` of the ray counter (NCCL on the GPU); the film
    stays device-sharded — only PNG export gathers it to host.

Radiosity scale-out: `mc_form_factors_sharded` splits the O(N^2) form-
factor matrix by receiver rows over the mesh — the memory/scale pain point
called out in SURVEY.md §5 — and the refinement matmuls run replicated.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core import rng
from ..ops.guiding import CDFPack
from ..render.camera import Camera
from ..render.film import Film
from ..render.renderer import RenderSettings, render_pass, with_guide_rows
from ..scene.mesh import Geometry


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), ("tile",))


def _pad_rows(height: int, n: int) -> int:
    return ((height + n - 1) // n) * n


@partial(
    jax.jit,
    static_argnames=("settings", "mesh", "n_tiles"),
    donate_argnames=("film",),
)
def render_pass_tiled(
    geom: Geometry,
    cdfs: CDFPack | None,
    camera: Camera,
    film: Film,
    key: jax.Array,
    mis_bsdf_fraction: jax.Array,
    settings: RenderSettings,
    mesh: Mesh,
    n_tiles: int,
    accel=None,
):
    """One progressive pass with the film row-sharded over the mesh.

    `settings` describes the FULL image; each device runs the single-chip
    `render_pass` on a height/n_tiles row band. Padded rows (when height
    is not divisible) render throwaway rays and are cropped on gather.

    RNG lane ids are the GLOBAL pixel indices (band offset y0*width), so
    the gathered film is bitwise identical to a single-chip render of the
    same settings/key — sharding is purely a performance decision
    (tests/test_sharding.py asserts the equality).
    """
    s = settings
    hpad = _pad_rows(s.height, n_tiles)
    band = hpad // n_tiles
    band_settings = RenderSettings(
        width=s.width,
        height=band,
        max_depth=s.max_depth,
        sampling_mode=s.sampling_mode,
        spp_per_pass=s.spp_per_pass,
        ray_chunk=min(s.ray_chunk, band * s.width),
        wavefront=s.wavefront,
        sort_rays=s.sort_rays,
        nee=s.nee,
    )

    def tile_body(film_band, key_rep):
        tile = jax.lax.axis_index("tile")
        # Global pixel ids (offset y0*width) + full-image view_size make
        # the band's camera uv mapping and RNG draws bit-identical to the
        # corresponding rows of a single-chip render.
        new_film, rays = render_pass(
            geom, cdfs, camera, film_band, key_rep,
            mis_bsdf_fraction, band_settings,
            pixel_offset=(tile * band * s.width).astype(jnp.int32),
            view_size=(s.width, s.height),
            accel=accel,
        )
        return new_film, jax.lax.psum(rays, "tile")

    body = shard_map(
        tile_body,
        mesh=mesh,
        in_specs=(
            Film(accum=P("tile"), spp=P(), passes=P()),
            P(),
        ),
        out_specs=(
            Film(accum=P("tile"), spp=P(), passes=P()),
            P(),
        ),
        check_vma=False,
    )
    return body(film, key)


class TiledRenderer:
    """Multi-chip progressive renderer (drop-in for ProgressiveRenderer)."""

    def __init__(
        self,
        geom: Geometry,
        camera: Camera,
        settings: RenderSettings,
        cdfs: CDFPack | None = None,
        mis_bsdf_fraction: float = 0.5,
        seed: int = 2023,
        n_tiles: int | None = None,
        accel=None,
    ):
        self.mesh = make_mesh(n_tiles)
        self.n_tiles = int(self.mesh.devices.size)
        self.geom = geom
        self.camera = camera
        self.settings = settings
        self.cdfs = cdfs
        # The scene's intersection structure (ops/dispatch), replicated
        # across the mesh like the scene itself.
        self.accel = with_guide_rows(accel, geom, cdfs, settings)
        self.mis_bsdf_fraction = jnp.float32(mis_bsdf_fraction)
        self.key = rng.base_key(seed)
        hpad = _pad_rows(settings.height, self.n_tiles)
        # The film starts with the shardings render_pass_tiled returns
        # (rows split, counters replicated), so the second pass reuses
        # the first pass's executable instead of compiling again.
        replicated = NamedSharding(self.mesh, P())
        self.film = Film(
            accum=jax.device_put(
                jnp.zeros((hpad, settings.width, 3), jnp.float32),
                NamedSharding(self.mesh, P("tile")),
            ),
            spp=jax.device_put(jnp.zeros((), jnp.int32), replicated),
            passes=jax.device_put(jnp.zeros((), jnp.int32), replicated),
        )
        self.total_rays = 0

    def step(self) -> None:
        self.film, rays = render_pass_tiled(
            self.geom,
            self.cdfs,
            self.camera,
            self.film,
            self.key,
            self.mis_bsdf_fraction,
            self.settings,
            self.mesh,
            self.n_tiles,
            accel=self.accel,
        )
        jax.block_until_ready(self.film.accum)
        self.total_rays += int(rays)

    def render(self, total_spp: int) -> Film:
        while int(self.film.spp) < total_spp:
            self.step()
        return self.film

    def gather_film(self) -> Film:
        """Fetch + crop the sharded film for export."""
        accum = np.asarray(self.film.accum)[: self.settings.height]
        return Film(
            accum=jnp.asarray(accum),
            spp=self.film.spp,
            passes=self.film.passes,
        )


# ---------------------------------------------------------------------------
# Sharded radiosity form factors: receiver rows across the mesh
# ---------------------------------------------------------------------------


def mc_form_factors_sharded(
    geom: Geometry,
    key: jax.Array,
    *,
    mesh: Mesh | None = None,
    n_samples: int = 64,
    row_chunk: int = 16,
    accel=None,
    estimator: str = "reference",
):
    """(N, N) MC form factors with receiver rows sharded over the mesh.

    Each device computes rows [tile*band, (tile+1)*band) with
    `mc_form_factors_rows` (scene replicated — visibility needs the whole
    scene anyway) and the results concatenate along the sharded axis.
    Returns the same (ff, grid_counts, rad_grid) as mc_form_factors.

    RNG streams are keyed by GLOBAL chunk index (chunk_offset = the
    band's first chunk), so the sharded matrix is BITWISE identical to
    the single-chip `mc_form_factors` of the same key — the same
    invariant the tiled renderer keeps for films.
    """
    from ..render.radiosity import mc_form_factors_rows

    if mesh is None:
        mesh = make_mesh()
    n_dev = int(mesh.devices.size)
    n = geom.num_prims
    # Same effective chunk as the single-chip build (rc = min(row_chunk,
    # n)) so the RNG chunk partitioning — and therefore the matrix — is
    # bitwise identical for ANY row_chunk; bands round up to a multiple
    # of rc (devices past the real rows compute discarded padding).
    rc = min(row_chunk, n)
    band = ((n + n_dev - 1) // n_dev + rc - 1) // rc * rc
    npad = band * n_dev
    row_ids = jnp.where(jnp.arange(npad) < n, jnp.arange(npad), 0)
    row_ids = jax.device_put(
        row_ids, NamedSharding(mesh, P("tile"))
    )

    def body(rows_band, key_rep):
        tile = jax.lax.axis_index("tile")
        return mc_form_factors_rows(
            geom,
            key_rep,
            rows_band,
            n_samples=n_samples,
            row_chunk=rc,
            accel=accel,
            chunk_offset=tile * (band // rc),
            estimator=estimator,
        )

    ff, gc, gv = jax.jit(
        shard_map(
            body,
            mesh=mesh,
            in_specs=(P("tile"), P()),
            out_specs=(P("tile"), P("tile"), P("tile")),
            check_vma=False,
        )
    )(row_ids, key)
    return ff[:n], gc[:n], gv[:n]


def solve_radiosity_sharded(
    geom: Geometry,
    key: jax.Array | None = None,
    *,
    mesh: Mesh | None = None,
    num_iterations: int = 10,
    mc_samples: int = 64,
    row_chunk: int = 16,
    accel=None,
    filter_fn=None,
):
    """Row-sharded radiosity solve (runSolver semantics,
    application_state.h:688-777, scaled out across the mesh).

    The (N, N) form-factor matrix never exists on a single device: each
    device builds and keeps its receiver rows (mc_form_factors_sharded),
    and every iteration is ONE shard_map dispatch that (a) gathers +
    reflects its rows locally — the matvec streams over row bands, (b)
    all-gathers the new radiosity vector (tiny: N x 3) over the mesh,
    and (c) rebins its rows' directional grids in place. Per-device FF
    memory is N^2/devices, so the O(N^2) wall moves out by the mesh
    size.

    Returns the same RadiositySolution as solve_radiosity; radiosity /
    history are replicated, grid fields are row-sharded jax arrays with
    global shape (N, ...).
    """
    from ..core import rng as rng_mod
    from ..render.radiosity import (
        RADIOSITY_HISTORY,
        RadiositySolution,
        rebin_rows,
    )

    if key is None:
        key = rng_mod.base_key(12345)
    if mesh is None:
        mesh = make_mesh()
    n_dev = int(mesh.devices.size)
    n = geom.num_prims

    ff, grid_counts, rad_grid = mc_form_factors_sharded(
        geom, key, mesh=mesh, n_samples=mc_samples, row_chunk=row_chunk,
        accel=accel,
    )

    band = (n + n_dev - 1) // n_dev
    npad = band * n_dev
    ff_pad = jnp.pad(ff, ((0, npad - n), (0, 0)))
    row_ids = jnp.arange(npad, dtype=jnp.int32)
    sh_rows = NamedSharding(mesh, P("tile"))
    ff_pad = jax.device_put(ff_pad, NamedSharding(mesh, P("tile", None)))
    row_ids = jax.device_put(row_ids, sh_rows)

    def body(ff_rows, rows, radiosity, unshot):
        # gather + reflect for this device's receiver rows
        incident = jnp.dot(
            ff_rows, unshot, precision=jax.lax.Precision.HIGHEST
        )
        albedo_rows = geom.albedo[rows]
        reflected = jnp.minimum(albedo_rows * incident, incident)
        reflected = jnp.where((rows < n)[:, None], reflected, 0.0)
        # replicate the new global radiosity/unshot vectors (N x 3 —
        # the only cross-device traffic per iteration)
        refl_full = jax.lax.all_gather(
            reflected, "tile", axis=0, tiled=True
        )[:n]
        new_rad = radiosity + refl_full
        rad_grid_rows = rebin_rows(geom, ff_rows, rows, new_rad)
        if filter_fn is not None:
            rad_grid_rows = filter_fn(rad_grid_rows)
        return new_rad, refl_full, rad_grid_rows

    step = jax.jit(
        shard_map(
            body,
            mesh=mesh,
            in_specs=(P("tile", None), P("tile"), P(), P()),
            out_specs=(P(), P(), P("tile")),
            check_vma=False,
        )
    )

    radiosity = geom.emission
    unshot = geom.emission
    history = jnp.zeros((RADIOSITY_HISTORY, n, 3), jnp.float32)
    h_idx = 0
    h_cnt = 0
    for _ in range(num_iterations):
        history = history.at[h_idx].set(radiosity)
        h_idx = (h_idx + 1) % RADIOSITY_HISTORY
        h_cnt = min(h_cnt + 1, RADIOSITY_HISTORY)
        radiosity, unshot, rad_grid_pad = step(
            ff_pad, row_ids, radiosity, unshot
        )
        rad_grid = rad_grid_pad[:n]

    return RadiositySolution(
        form_factors=ff,
        radiosity=radiosity,
        unshot=unshot,
        grid_counts=grid_counts,
        rad_grid=rad_grid,
        history=history,
        history_index=jnp.int32(h_idx),
        history_count=jnp.int32(h_cnt),
    )


# ---------------------------------------------------------------------------
# Sharded matrix-free shooting: receiver rows across the mesh
# ---------------------------------------------------------------------------


def solve_radiosity_shooting_sharded(
    geom: Geometry,
    key: jax.Array | None = None,
    *,
    mesh: Mesh | None = None,
    steps: int = 64,
    shooters_per_step: int = 128,
    mc_samples: int = 4,
    row_chunk: int | None = None,
    accel=None,
    rel_tol: float = 1e-3,
    check_every: int = 8,
    ambient: bool = True,
    estimator: str = "reference",
    sort_shooters: bool = False,
):
    """Matrix-free progressive shooting with receiver rows sharded.

    The scale-out of `solve_radiosity_shooting` (see its docstring for
    the algorithm/semantics): per step every device estimates its own
    receiver band's (band, k) form-factor block against the replicated
    top-k shooter batch, reflects locally, and one `all_gather` of the
    (N, 3) reflection vector replicates the new radiosity/unshot state
    — the only cross-device traffic. Per-device memory is O(N/devices
    x k); directional grids stay row-sharded. Combined with the
    matrix-free formulation this moves BOTH walls of the reference's
    radiosity architecture (the N^2 matrix, application_state.h:705-715,
    and the single-GPU pass) out by the mesh size.

    RNG streams are keyed by global chunk index and the effective row
    chunk matches the single-chip solver's, so the result is BITWISE
    identical to the single-chip shooting solve for any row_chunk
    (tests/test_sharding.py asserts it).
    """
    from ..core import rng as rng_mod
    from ..core.math_utils import luminance
    from ..render.radiosity import mc_form_factors_rows

    if key is None:
        key = rng_mod.base_key(12345)
    if mesh is None:
        mesh = make_mesh()
    n_dev = int(mesh.devices.size)
    n = geom.num_prims
    k = min(shooters_per_step, n)
    if row_chunk is None:
        row_chunk = max(16, 32768 // k)
    # match the single-chip solver's effective chunk (see
    # mc_form_factors_sharded): bitwise parity holds for ANY row_chunk
    rc = min(row_chunk, n)
    band = ((n + n_dev - 1) // n_dev + rc - 1) // rc * rc
    npad = band * n_dev
    sh_rows = NamedSharding(mesh, P("tile"))
    row_ids = jnp.where(jnp.arange(npad) < n, jnp.arange(npad), 0)
    row_ids = jax.device_put(row_ids, sh_rows)

    from ..core.constants import GRID_SIZE

    rad_grid = jax.device_put(
        jnp.zeros((npad, GRID_SIZE, 3), jnp.float32),
        NamedSharding(mesh, P("tile", None, None)),
    )
    grid_counts = jax.device_put(
        jnp.zeros((npad, GRID_SIZE), jnp.float32),
        NamedSharding(mesh, P("tile", None)),
    )

    def body(rows_band, radiosity, unshot, grid_band, count_band,
             step_key):
        tile = jax.lax.axis_index("tile")
        power = luminance(unshot) * geom.area          # replicated
        _, shooters = jax.lax.top_k(power, k)
        if sort_shooters:
            # id-sort the replicated shooter batch (spatial order —
            # see _shoot_step); same transform on every device, so
            # single-chip bitwise parity is preserved.
            shooters = jnp.sort(shooters)
        shot = unshot[shooters]                        # (k, 3)
        ff_blk, gcount, gradv = mc_form_factors_rows(
            geom, step_key, rows_band,
            n_samples=mc_samples, row_chunk=rc,
            accel=accel,
            col_ids=shooters, col_weight=shot,
            chunk_offset=tile * (band // rc),
            estimator=estimator,
        )
        incident = jnp.dot(
            ff_blk, shot, precision=jax.lax.Precision.HIGHEST
        )                                              # (band, 3)
        albedo_rows = geom.albedo[rows_band]
        reflected = jnp.minimum(albedo_rows * incident, incident)
        real = (jnp.arange(npad // n_dev) + tile * band < n)[:, None]
        reflected = jnp.where(real, reflected, 0.0)
        refl_full = jax.lax.all_gather(
            reflected, "tile", axis=0, tiled=True
        )[:n]
        inc_full = jax.lax.all_gather(
            incident, "tile", axis=0, tiled=True
        )[:n]
        new_rad = radiosity + refl_full
        new_unshot = unshot.at[shooters].set(0.0) + refl_full
        # same stats formula on the same gathered values as the single-
        # chip step — the ambient term stays bitwise-equal across
        # layouts (radiosity.transport_stats is the single source)
        from ..render.radiosity import transport_stats

        st = transport_stats(geom, shooters, shot, inc_full, refl_full)
        return (new_rad, new_unshot, grid_band + gradv,
                count_band + gcount, st)

    step = jax.jit(
        shard_map(
            body,
            mesh=mesh,
            in_specs=(P("tile"), P(), P(), P("tile", None, None),
                      P("tile", None), P()),
            out_specs=(P(), P(), P("tile", None, None),
                       P("tile", None), P()),
            check_vma=False,
        )
    )

    def step_fn(radiosity, unshot, rad_grid_s, grid_counts_s, s):
        return step(row_ids, radiosity, unshot, rad_grid_s,
                    grid_counts_s, jax.random.fold_in(key, s))

    from ..render.radiosity import drive_shooting

    sol = drive_shooting(
        geom, step_fn, rad_grid, grid_counts, steps=steps,
        rel_tol=rel_tol, check_every=check_every, ambient=ambient,
    )
    import dataclasses

    return dataclasses.replace(
        sol,
        grid_counts=sol.grid_counts[:n],
        rad_grid=sol.rad_grid[:n],
    )
