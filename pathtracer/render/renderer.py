"""Render orchestration: jitted progressive render passes.

Equivalent of the reference's per-frame loop (`renderFrame`,
`reference/include/application.h:157-216`) re-shaped for XLA: one
jitted `render_pass` traces `spp_per_pass` samples for every pixel, chunked
into fixed-size ray batches via `lax.map` (static shapes, bounded memory),
and adds into the progressive film. Every random draw is keyed by
(pass, sample, bounce, GLOBAL pixel id) via rng.lane_uniforms — never by a
lane's position in its chunk — so a render is bitwise identical for any
ray_chunk setting, any padding, and any device sharding of the image
(goldens/ and tests/test_golden.py enforce this).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core import rng
from ..core.constants import SAMPLING_BSDF
from ..ops.guiding import CDFPack
from ..ops.tonemap import tonemap_radiosity
from ..scene.mesh import Geometry
from ..utils.logger import get_logger
from .camera import Camera
from .film import Film
from .integrator import trace, trace_primary, trace_wavefront

log = get_logger("Renderer")


@dataclass(frozen=True)
class RenderSettings:
    """Static (compile-time) render parameters. Mirrors the reference
    AppConfig knobs (application_state.h:262-293) that affect tracing."""

    width: int = 800
    height: int = 800
    max_depth: int = 5           # reference hardcodes 5 (integrator.h:389)
    sampling_mode: int = SAMPLING_BSDF
    spp_per_pass: int = 1
    ray_chunk: int = 1 << 16     # rays in flight per lax.map step
    wavefront: bool = True       # same-pixel-respawn wavefront loop
    sort_rays: bool = False      # Morton-sort lanes per bounce (big scenes)
    nee: bool = False            # next-event estimation (additive; the
                                 # reference has none): per-vertex MIS-
                                 # weighted direct-light sampling, in
                                 # any sampling mode (guided modes use
                                 # the grid/mixture density in the MIS
                                 # weights). Estimator changes, so NOT
                                 # golden-comparable with nee off
    balance_lanes: int = 0       # K pixels per lane, cost-balanced (0=off):
                                 # a one-pass probe measures per-tile path
                                 # cost and deals K 1024-pixel tiles to
                                 # each lane-tile so every lane retires
                                 # ~equal work — the wavefront while_loop
                                 # runs to the LAST live lane, so open
                                 # scenes (many early-miss pixels) waste
                                 # half their steps without this. Output
                                 # is bitwise identical to balance off.

    @property
    def num_pixels(self) -> int:
        return self.width * self.height


def build_balance_assignment(lane_steps, npix, k, chunk):
    """Deal 1024-pixel tiles into K-deep cost-balanced lane queues.

    lane_steps: (npix,) measured per-lane live-step counts from a
    spp-1 probe pass in linear lane order. Tiles (1024 consecutive
    pixels) are sorted by total cost and serpentine-dealt K to a
    lane-tile, so every lane's expected total work is ~the mean rather
    than K x its own pixel's.

    Returns (gids (nruns, chunk, K) int32 global pixel ids, inv
    (npix,) int32 flat-slot index of each pixel), or None when the
    shapes don't tile (caller falls back to unbalanced)."""
    lanes_total = npix // k
    if npix % (1024 * k) or lanes_total % chunk:
        return None
    u = npix // 1024
    s_tiles = u // k
    cost = np.asarray(lane_steps).reshape(u, 1024).sum(axis=1)
    order = np.argsort(-cost, kind="stable")
    slots = np.empty((s_tiles, k), np.int64)
    for r in range(k):
        block = order[r * s_tiles:(r + 1) * s_tiles]
        slots[:, r] = block if r % 2 == 0 else block[::-1]
    dealt = cost[slots].sum(axis=1)
    from ..utils.logger import get_logger

    get_logger("Balance").info(
        f"K={k}: tile-cost deal mean {dealt.mean():.0f} max "
        f"{dealt.max():.0f} (spread {dealt.max() / max(dealt.mean(), 1):.2f}x"
        f"; unbalanced spread {k * cost.max() / max(dealt.mean(), 1):.2f}x)"
    )
    gids = (
        slots[:, None, :] * 1024 + np.arange(1024)[None, :, None]
    ).reshape(-1, k)                      # (lanes_total, K)
    inv = np.empty(npix, np.int64)
    inv[gids.reshape(-1)] = np.arange(npix)
    nruns = lanes_total // chunk
    return (
        jnp.asarray(gids.reshape(nruns, chunk, k), jnp.int32),
        jnp.asarray(inv, jnp.int32),
    )


@partial(jax.jit, static_argnames=("settings",))
def probe_pass(geom, cdfs, camera, key, mis_bsdf_fraction, settings,
               gids, accel=None):
    """Per-lane cost probe: one spp-1 wavefront pass returning each
    lane's live-step count (~its pixel's expected path length)."""
    s = settings

    def do_chunk(lane_ids):
        x = (lane_ids % s.width).astype(jnp.float32)
        y = (lane_ids // s.width).astype(jnp.float32)
        _, _, _, steps = trace_wavefront(
            geom, camera, x, y, key,
            width=s.width, height=s.height, spp=1,
            max_depth=s.max_depth, mode=s.sampling_mode, cdfs=cdfs,
            mis_bsdf_fraction=mis_bsdf_fraction, accel=accel,
            lane_ids=lane_ids, return_lane_steps=True,
        )
        return steps

    return jax.lax.map(do_chunk, gids)


@partial(
    jax.jit,
    static_argnames=("settings", "view_size"),
    donate_argnames=("film",),
)
def render_pass(
    geom: Geometry,
    cdfs: CDFPack | None,
    camera: Camera,
    film: Film,
    key: jax.Array,
    mis_bsdf_fraction: jax.Array,
    settings: RenderSettings,
    accel=None,
    pixel_offset=None,
    view_size=None,
    assignment=None,
):
    """Trace settings.spp_per_pass samples per pixel and accumulate.

    `assignment` (optional, wavefront only): cost-balanced lane queues
    from `build_balance_assignment` — a pair (gids (nruns, chunk, K)
    of global pixel ids, inv (npix,) flat-slot index per pixel). Each
    lane traces K pixels sequentially; per-pixel radiance is bitwise
    identical to assignment=None (draws are keyed by (pixel, sample,
    depth), see trace_wavefront).

    A shard_map row band rendering full-image rows [y0, y0+band) passes
    `pixel_offset = y0*width` (traced int32) and `view_size = (W, H)` of
    the FULL image: pixel coordinates, camera uv mapping, and RNG lane
    ids are all derived from the global pixel index, so the band is
    bitwise identical to the same rows of a single-chip render.

    Returns (film, rays_traced).
    """
    s = settings
    vw, vh = view_size if view_size is not None else (s.width, s.height)
    npix = s.num_pixels
    chunk = min(s.ray_chunk, npix)
    npad = ((npix + chunk - 1) // chunk) * chunk
    pix = jnp.arange(npad, dtype=jnp.int32)
    # Padded lanes trace pixel 0 (wasted but static-shape); their
    # results are dropped below.
    pix = jnp.where(pix < npix, pix, 0)
    if pixel_offset is None:
        pixel_offset = jnp.zeros((), jnp.int32)
    gids = (pix + pixel_offset).reshape(-1, chunk)  # global pixel ids

    pass_key = jax.random.fold_in(key, film.passes)

    def do_chunk(lane_ids):
        x = (lane_ids % vw).astype(jnp.float32)
        y = (lane_ids // vw).astype(jnp.float32)

        if s.wavefront:
            radiance_sum, rays, _ = trace_wavefront(
                geom,
                camera,
                x,
                y,
                rng.stream_key(pass_key, rng.STREAM_PATH),
                width=vw,
                height=vh,
                spp=s.spp_per_pass,
                max_depth=s.max_depth,
                mode=s.sampling_mode,
                cdfs=cdfs,
                mis_bsdf_fraction=mis_bsdf_fraction,
                accel=accel,
                sort_rays=s.sort_rays,
                nee=s.nee,
                lane_ids=lane_ids,
            )
            return radiance_sum, rays

        def one_sample(acc, samp):
            radiance_sum, rays = acc
            skey = jax.random.fold_in(pass_key, samp)
            jit2 = rng.lane_uniforms(
                rng.stream_key(skey, rng.STREAM_CAMERA), lane_ids, 2
            )
            u = (x + jit2[:, 0]) / vw
            v = (y + jit2[:, 1]) / vh
            o, d = camera.get_rays(u, v)
            radiance, stats = trace(
                geom,
                o,
                d,
                rng.stream_key(skey, rng.STREAM_PATH),
                max_depth=s.max_depth,
                mode=s.sampling_mode,
                cdfs=cdfs,
                mis_bsdf_fraction=mis_bsdf_fraction,
                accel=accel,
                lane_ids=lane_ids,
                nee=s.nee,
            )
            return (radiance_sum + radiance, rays + stats.rays), None

        (radiance_sum, rays), _ = jax.lax.scan(
            one_sample,
            (jnp.zeros((chunk, 3), jnp.float32), jnp.zeros((), jnp.int32)),
            jnp.arange(s.spp_per_pass),
        )
        return radiance_sum, rays

    if assignment is not None:
        if not s.wavefront:
            raise ValueError("balanced lane queues require wavefront mode")
        qgids, inv = assignment
        radiance, rays = jax.lax.map(
            do_chunk, qgids + pixel_offset
        )                               # (nruns, chunk, K, 3)
        radiance = radiance.reshape(-1, 3)[inv]
        film = Film(
            accum=film.accum + radiance.reshape(s.height, s.width, 3),
            spp=film.spp + s.spp_per_pass,
            passes=film.passes + 1,
        )
        return film, jnp.sum(rays)

    radiance, rays = jax.lax.map(do_chunk, gids)
    radiance = radiance.reshape(npad, 3)[:npix]
    film = Film(
        accum=film.accum + radiance.reshape(s.height, s.width, 3),
        spp=film.spp + s.spp_per_pass,
        passes=film.passes + 1,
    )
    return film, jnp.sum(rays)


@partial(jax.jit,
         static_argnames=("settings", "include_emission", "display"))
def render_radiosity_view(
    geom: Geometry,
    radiosity: jax.Array,
    camera: Camera,
    key: jax.Array,
    settings: RenderSettings,
    include_emission: bool = True,
    display: str = "current",
    accel=None,
):
    """Direct radiosity visualization (render_radiosity,
    integrator.h:460-504): primary hit -> Le + B_i, sqrt gamma, u8.
    The primary hit goes through the scene's `accel` (ops/dispatch).
    With include_emission=False it visualizes an arbitrary per-primitive
    color field (used for radiosity-history delta images).

    display="legacy" reproduces the reference's PUBLISHED sweep PNGs
    instead of its current code: Reinhard + gamma 1/2.2 of B alone
    (see ops.tonemap.tonemap_radiosity_legacy; include_emission is
    ignored — the solver's B already contains Le once).

    Args:
        radiosity: (N, 3) solved per-primitive radiosity.
    Returns:
        (H, W, 3) uint8 image (row 0 = bottom).
    """
    s = settings
    npix = s.num_pixels
    chunk = min(s.ray_chunk, npix)
    npad = ((npix + chunk - 1) // chunk) * chunk
    pix = jnp.arange(npad, dtype=jnp.int32)
    pix = jnp.where(pix < npix, pix, 0)
    chunks = pix.reshape(-1, chunk)

    def do_chunk(args):
        chunk_idx, ids = args
        x = (ids % s.width).astype(jnp.float32)
        y = (ids // s.width).astype(jnp.float32)
        ckey = jax.random.fold_in(key, chunk_idx)

        def one_sample(acc, samp):
            skey = jax.random.fold_in(ckey, samp)
            jit2 = jax.random.uniform(skey, (chunk, 2))
            u = (x + jit2[:, 0]) / s.width
            v = (y + jit2[:, 1]) / s.height
            o, d = camera.get_rays(u, v)
            hit = trace_primary(geom, o, d, accel)
            base = radiosity[hit.prim]
            if include_emission and display != "legacy":
                base = base + hit.emission
            c = jnp.where(hit.valid[:, None], base, 0.0)
            return acc + c, None

        acc, _ = jax.lax.scan(
            one_sample,
            jnp.zeros((chunk, 3), jnp.float32),
            jnp.arange(s.spp_per_pass),
        )
        return acc / s.spp_per_pass

    chunk_ids = jnp.arange(chunks.shape[0], dtype=jnp.int32)
    color = jax.lax.map(do_chunk, (chunk_ids, chunks))
    color = color.reshape(npad, 3)[:npix].reshape(s.height, s.width, 3)
    if display == "legacy":
        from ..ops.tonemap import tonemap_radiosity_legacy

        return tonemap_radiosity_legacy(color)
    return tonemap_radiosity(color)


def pick_primitive(geom: Geometry, camera: Camera, u: float, v: float,
                   accel=None) -> int:
    """Mouse-ray primitive picking (pick_primitive_kernel,
    callbacks.h:22-48). Returns -1 on miss."""
    o, d = camera.get_rays(jnp.array([u]), jnp.array([v]))
    hit = trace_primary(geom, o, d, accel)
    return int(np.where(np.asarray(hit.valid)[0], np.asarray(hit.prim)[0], -1))


def with_guide_rows(accel, geom: Geometry, cdfs: CDFPack | None,
                    settings: RenderSettings):
    """Guided modes on the fused kernel: repack with the CDF prim_table
    rows appended, so the hit kernel delivers each lane's guided-
    sampling row with its shading attributes (no per-lane fetch in the
    integrator). Every other accel passes through unchanged."""
    from ..ops.intersect_triton import TrianglePack, pack_triangles

    if (
        isinstance(accel, TrianglePack)
        and not accel.has_guide
        and cdfs is not None
        and settings.sampling_mode != SAMPLING_BSDF
    ):
        return pack_triangles(geom, np.asarray(cdfs.prim_table),
                              accel.interpret)
    return accel


class ProgressiveRenderer:
    """Host-side progressive render loop with throughput accounting."""

    def __init__(
        self,
        geom: Geometry,
        camera: Camera,
        settings: RenderSettings,
        cdfs: CDFPack | None = None,
        mis_bsdf_fraction: float = 0.5,
        seed: int = 2023,
        accel=None,
    ):
        self.geom = geom
        self.accel = with_guide_rows(accel, geom, cdfs, settings)
        self.camera = camera
        self.settings = settings
        self.cdfs = cdfs
        self.mis_bsdf_fraction = jnp.float32(mis_bsdf_fraction)
        self.key = rng.base_key(seed)
        self.film = Film.create(settings.width, settings.height)
        # Ray/spp counters accumulate ON DEVICE and mirror in Python, so
        # a pass never waits on a device-to-host copy.
        # f32 accumulator of per-pass ray counts: ~1e-7 relative error,
        # only ever used for throughput reporting
        self._rays_dev = jnp.zeros((), jnp.float32)
        self._spp_host = 0
        self.render_seconds = 0.0
        self._assignment = None
        self._assignment_built = False

    def _build_assignment(self):
        """Cost-balanced lane queues (settings.balance_lanes = K > 1):
        probe per-lane path cost once for this camera, then deal tiles
        so each lane retires ~equal work. Scheduling only — the film is
        bitwise identical with or without it."""
        s = self.settings
        npix = s.num_pixels
        k = s.balance_lanes
        chunk = min(s.ray_chunk, max(npix // k, 1))
        if k <= 1 or not s.wavefront or npix % (1024 * k) \
                or (npix // k) % chunk:
            return None
        pchunk = min(s.ray_chunk, npix)
        if npix % pchunk:
            return None
        steps = probe_pass(
            self.geom, self.cdfs, self.camera,
            jax.random.fold_in(self.key, 0xBA1A), self.mis_bsdf_fraction,
            self.settings,
            jnp.arange(npix, dtype=jnp.int32).reshape(-1, pchunk),
            accel=self.accel,
        )
        return build_balance_assignment(
            np.asarray(steps).reshape(-1), npix, k, chunk
        )

    def step(self, block: bool = True) -> Film:
        """One render pass (spp_per_pass samples/pixel).

        block=False skips the device sync: passes pipeline back-to-back
        and `render_seconds` stays meaningful only across a final
        `sync()`."""
        t0 = time.perf_counter()
        if self.settings.balance_lanes > 1 and not self._assignment_built:
            self._assignment = self._build_assignment()
            self._assignment_built = True
        self.film, rays = render_pass(
            self.geom,
            self.cdfs,
            self.camera,
            self.film,
            self.key,
            self.mis_bsdf_fraction,
            self.settings,
            self.accel,
            assignment=self._assignment,
        )
        self._rays_dev = self._rays_dev + rays.astype(jnp.float32)
        self._spp_host += self.settings.spp_per_pass
        if block:
            self._barrier()
        self.render_seconds += time.perf_counter() - t0
        return self.film

    def _barrier(self) -> None:
        """Wait until every queued pass has executed."""
        jax.block_until_ready((self.film.accum, self._rays_dev))

    def sync(self) -> None:
        t0 = time.perf_counter()
        self._barrier()
        self.render_seconds += time.perf_counter() - t0

    def reset_stats(self) -> None:
        """Zero the throughput counters (e.g. after a warmup pass)."""
        self._rays_dev = jnp.zeros((), jnp.float32)
        self.render_seconds = 0.0

    def render(self, total_spp: int) -> Film:
        # Pipelined: no per-pass sync, no per-pass spp fetch.
        while self._spp_host < total_spp:
            self.step(block=False)
        self.sync()
        return self.film

    @property
    def total_rays(self) -> int:
        return int(self._rays_dev)

    @property
    def mrays_per_sec(self) -> float:
        return self.total_rays / 1e6 / max(self.render_seconds, 1e-12)
