"""Application orchestration — the headless equivalent of the reference's
ApplicationState + application lifecycle
(`reference/include/application_state.h`, `application.h`).

Responsibilities, mirroring the reference call stacks (SURVEY.md §3):
  * load_scene: loader dispatch by extension (+ builtins), optional
    quad->triangle conversion and 4-way subdivision, geometry build;
  * run_solver: radiosity pass (MC or analytic form factors, progressive
    refinement, optional in-loop grid filtering);
  * precompute_cdfs: guided-sampling CDFs from raw or filtered grids
    (SceneState::precomputeCDFs / precomputeCDFsFromFiltered);
  * render: progressive path tracing or direct radiosity visualization;
  * save_png / save_checkpoint: framebuffer + resumable state export.

The reference rebuilds everything at startup (initializeApplication runs an
initial solve + CDF precompute, application.h:126-136); here each stage is
explicit and lazy, and `prepare()` reproduces the startup sequence.
"""

from __future__ import annotations

import os
import time

import jax
import numpy as np

from .core import rng
from .core.constants import SAMPLING_BSDF, SAMPLING_FORMFACTOR, SAMPLING_TOPK
from .ops import dispatch
from .ops.filters import filter_pdfs
from .ops.guiding import CDFPack, build_cdfs, top_k_mask
from .core.math_utils import luminance
from .render.camera import Camera, CameraController
from .render.film import Film
from .render.radiosity import RadiositySolution, solve_radiosity
from .render.renderer import (
    ProgressiveRenderer,
    RenderSettings,
    pick_primitive,
    render_radiosity_view,
)
from .scene.builtin import cornell_box
from .scene.mesh import Geometry, PrimList, convert_quads_to_triangles, subdivide
from .scene.obj_loader import load_obj
from .utils.config import Config
from .utils.logger import get_logger
from .utils.profiler import Profiler

log = get_logger("App")

_BUILTINS = {
    "cbox_quads": lambda cfg: cornell_box(
        "quads", mirror_tall_box=cfg.mirror_tall_box
    ),
    "cbox": lambda cfg: cornell_box(
        "tris", mirror_tall_box=cfg.mirror_tall_box
    ),
}


def load_prims(cfg: Config) -> PrimList:
    """Loader dispatch (file_manager.h:291-315 + builtins)."""
    if cfg.scene in _BUILTINS:
        prims = _BUILTINS[cfg.scene](cfg)
    else:
        ext = os.path.splitext(cfg.scene)[1].lower()
        if ext == ".obj":
            prims = load_obj(cfg.scene)
        elif ext == ".pbrt":
            from .scene.pbrt_loader import parse_pbrt

            scene = parse_pbrt(
                cfg.scene, max_triangles=cfg.pbrt_max_triangles
            )
            prims = scene.prims
            # Adopt the .pbrt camera when the user left ours at defaults
            # (additive: the reference discards the pbrt camera).
            default = Config()
            if scene.camera_lookat and (
                cfg.camera_origin == default.camera_origin
                and cfg.look_at == default.look_at
            ):
                eye, tgt, up = scene.camera_lookat
                cfg.camera_origin = tuple(eye)
                cfg.look_at = tuple(tgt)
                cfg.up = tuple(up)
                if scene.camera_fov:
                    cfg.fov = scene.camera_fov
        else:
            raise ValueError(
                f"unsupported scene format '{ext}' "
                "(supported: .obj, .pbrt, builtins "
                f"{sorted(_BUILTINS)})"
            )
    if cfg.convert_quads:
        prims = convert_quads_to_triangles(prims)
    if cfg.subdivision > 0:
        before = prims.num_prims
        prims = subdivide(prims, cfg.subdivision)
        log.info("Subdivision: %d -> %d primitives", before, prims.num_prims)
    return prims


class App:
    """Headless application state (the reference's g_state singleton,
    without the GLFW/ImGui shell — SURVEY.md §7 frontend note)."""

    def __init__(self, config: Config | None = None):
        self.config = config or Config()
        self.profiler = Profiler()
        self.prims: PrimList | None = None
        self.geom: Geometry | None = None
        self.backend: str | None = None
        self.accel = None               # ops/dispatch structure
        self.solution: RadiositySolution | None = None
        self.cdfs: CDFPack | None = None
        self.filtered_formfactor = None   # (N, 256) filtered float PDFs
        self.filtered_radiosity = None
        self._renderer: ProgressiveRenderer | None = None
        self.camera_ctrl: CameraController | None = None

    # ---------------- scene ----------------

    def load_scene(self) -> Geometry:
        cfg = self.config
        with self.profiler.stage("Scene Load"):
            self.prims = load_prims(cfg)
            self.geom = self.prims.build()
        log.info(
            "Scene '%s': %d primitives, %d triangles",
            cfg.scene, self.geom.num_prims, self.geom.num_tris,
        )
        self._select_backend()
        self.camera_ctrl = CameraController(
            lookfrom=np.array(cfg.camera_origin, np.float32),
            lookat=np.array(cfg.look_at, np.float32),
            vup=np.array(cfg.up, np.float32),
            vfov=cfg.fov,
            aspect=cfg.width / cfg.height,
        )
        self.solution = None
        self.cdfs = None
        self._renderer = None
        return self.geom

    def _select_backend(self) -> None:
        """Intersection path for the scene (RayTracingManager parity,
        ray_tracing_backend.h:50-76): chosen by ops/dispatch from the
        platform and the triangle count unless config.backend names
        one."""
        cfg = self.config
        backend = cfg.backend
        if backend == "auto":
            backend = dispatch.select_backend(
                dispatch.current_platform(), self.geom.num_tris
            )
        t0 = time.perf_counter()
        self.backend = backend
        self.accel = dispatch.build_accel(self.geom, backend)
        log.info(
            "Backend: %s (%d tris, built in %.1f ms)",
            backend, self.geom.num_tris, (time.perf_counter() - t0) * 1e3,
        )

    # ---------------- radiosity ----------------

    def run_solver(self) -> RadiositySolution:
        """RadiosityState::runSolver equivalent."""
        cfg = self.config
        if self.geom is None:
            self.load_scene()
        filter_fn = None
        if cfg.enable_grid_filtering:
            from .ops.filters import bilateral_filter_rgb, gaussian_filter_rgb

            if cfg.use_bilateral:
                filter_fn = lambda g: bilateral_filter_rgb(
                    g, cfg.sigma_spatial, cfg.sigma_range
                )
            else:
                filter_fn = lambda g: gaussian_filter_rgb(
                    g, cfg.sigma_spatial
                )
        solver = cfg.radiosity_solver
        if solver == "auto":
            # the (N, N) gather matrix is 1 GB at 16,384 prims — past
            # that the matrix-free shooting solver is the only option
            solver = (
                "shooting" if self.geom.num_prims > 16384 else "gather"
            )
        with self.profiler.stage("Radiosity Solve"):
            t0 = time.perf_counter()
            if solver == "shooting":
                from .render.radiosity import solve_radiosity_shooting

                if filter_fn is not None:
                    # in-loop filtering is a gather-solver feature (the
                    # reference filters between refinement iterations);
                    # shooting grids accumulate incrementally, so filter
                    # at CDF time instead (cdf_source="filtered_*")
                    log.warning(
                        "enable_grid_filtering is ignored by the "
                        "shooting solver; use cdf_source='filtered_"
                        "radiosity' to filter before CDF build"
                    )
                if not cfg.use_monte_carlo:
                    log.warning(
                        "use_monte_carlo=False (analytic FF) is a "
                        "gather-solver feature; the shooting solver is "
                        "MC-only — set radiosity_solver='gather' to "
                        "force it (needs the (N, N) matrix to fit)"
                    )
                # gather's radiosity_iterations / mc_samples do not
                # apply; shooting uses shooting_steps / shooters_per_
                # step / shooting_mc_samples
                self.solution = solve_radiosity_shooting(
                    self.geom,
                    rng.base_key(cfg.seed + 12345),
                    steps=cfg.shooting_steps,
                    shooters_per_step=cfg.shooters_per_step,
                    mc_samples=cfg.shooting_mc_samples,
                    accel=self.accel,
                    grid_refresh=cfg.grid_refresh,
                    estimator=cfg.ff_estimator,
                )
            else:
                self.solution = solve_radiosity(
                    self.geom,
                    rng.base_key(cfg.seed + 12345),
                    num_iterations=cfg.radiosity_iterations,
                    use_monte_carlo=cfg.use_monte_carlo,
                    mc_samples=cfg.mc_samples,
                    filter_fn=filter_fn,
                    accel=self.accel,
                    estimator=cfg.ff_estimator,
                )
            jax.block_until_ready(self.solution.radiosity)
        log.info(
            "Radiosity solved (%s): %d prims, %.1f ms",
            solver, self.geom.num_prims,
            (time.perf_counter() - t0) * 1e3,
        )
        return self.solution

    # ---------------- guided-sampling CDFs ----------------

    def precompute_cdfs(self) -> CDFPack:
        """SceneState::precomputeCDFs[FromFiltered] equivalent; the source
        grid is selected by config.cdf_source / sampling mode."""
        cfg = self.config
        if self.solution is None:
            self.run_solver()
        src = cfg.cdf_source
        if src.startswith("filtered"):
            with self.profiler.stage("Grid Filter"):
                self.filtered_formfactor, self.filtered_radiosity = (
                    filter_pdfs(
                        self.solution.grid_counts,
                        self.solution.rad_grid,
                        use_bilateral=cfg.use_bilateral,
                        sigma_spatial=cfg.sigma_spatial,
                        sigma_range=cfg.sigma_range,
                    )
                )
            pdf = (
                self.filtered_formfactor
                if src == "filtered_formfactor"
                else self.filtered_radiosity
            )
        elif src == "formfactor":
            pdf = self.solution.grid_counts
        elif src == "radiosity":
            pdf = luminance(self.solution.rad_grid)
        else:
            raise ValueError(f"unknown cdf_source '{src}'")

        mode = cfg.sampling_mode_id
        if mode == SAMPLING_TOPK and cfg.top_k > 0:
            pdf = top_k_mask(pdf, cfg.top_k)
        with self.profiler.stage("CDF Build"):
            self.cdfs = build_cdfs(pdf)
        n_valid = int(np.asarray(self.cdfs.valid).sum())
        log.info(
            "CDFs built from '%s': %d/%d primitives valid",
            src, n_valid, self.geom.num_prims,
        )
        return self.cdfs

    # ---------------- rendering ----------------

    def _effective_cdf_source(self) -> None:
        """FORMFACTOR mode defaults its CDF source to the visibility-count
        grid, everything else to radiosity luminance — unless the user
        picked explicitly."""
        cfg = self.config
        if cfg.cdf_source == "radiosity" and (
            cfg.sampling_mode_id == SAMPLING_FORMFACTOR
        ):
            cfg.cdf_source = "formfactor"

    def prepare(self) -> None:
        """Startup sequence parity (initializeApplication,
        application.h:92-148): load scene, solve radiosity, build CDFs
        when a guided mode needs them."""
        if self.geom is None:
            self.load_scene()
        needs_guiding = (
            self.config.sampling_mode_id != SAMPLING_BSDF
            or self.config.integrator == "radiosity"
        )
        if needs_guiding and self.solution is None:
            self.run_solver()
        if (
            self.config.sampling_mode_id != SAMPLING_BSDF
            and self.cdfs is None
        ):
            self._effective_cdf_source()
            self.precompute_cdfs()

    def renderer(self) -> ProgressiveRenderer:
        cfg = self.config
        self.prepare()
        if self._renderer is None:
            spp_pass = cfg.spp_per_pass or min(
                max(cfg.spp, 1), max(1, (1 << 22) // cfg.ray_chunk)
            )
            settings = RenderSettings(
                width=cfg.width,
                height=cfg.height,
                max_depth=cfg.max_depth,
                sampling_mode=(
                    cfg.sampling_mode_id
                    if cfg.sampling_mode_id != SAMPLING_TOPK
                    else 2  # TOPK samples like RADIOSITY over masked CDFs
                ),
                spp_per_pass=min(spp_pass, cfg.spp),
                ray_chunk=cfg.ray_chunk,
                sort_rays=cfg.sort_rays,
                balance_lanes=cfg.balance_lanes,
                nee=cfg.nee,
            )
            if cfg.num_tiles > 1:
                from .parallel.sharding import TiledRenderer

                self._renderer = TiledRenderer(
                    self.geom,
                    self.camera_ctrl.build(),
                    settings,
                    cdfs=self.cdfs,
                    mis_bsdf_fraction=cfg.mis_bsdf_fraction,
                    seed=cfg.seed,
                    n_tiles=cfg.num_tiles,
                    accel=self.accel,
                )
            else:
                self._renderer = ProgressiveRenderer(
                    self.geom,
                    self.camera_ctrl.build(),
                    settings,
                    cdfs=self.cdfs,
                    mis_bsdf_fraction=cfg.mis_bsdf_fraction,
                    seed=cfg.seed,
                    accel=self.accel,
                )
        return self._renderer

    def render(self) -> np.ndarray:
        """Full render to a top-down (H, W, 3) uint8 image."""
        cfg = self.config
        if cfg.integrator == "radiosity":
            self.prepare()
            with self.profiler.stage("Render"):
                img = render_radiosity_view(
                    self.geom,
                    self.solution.radiosity,
                    self.camera_ctrl.build(),
                    rng.base_key(cfg.seed),
                    RenderSettings(
                        width=cfg.width,
                        height=cfg.height,
                        spp_per_pass=max(cfg.spp, 1),
                        ray_chunk=cfg.ray_chunk,
                    ),
                    accel=self.accel,
                )
                jax.block_until_ready(img)
            return np.asarray(img)[::-1]
        r = self.renderer()
        with self.profiler.stage("Render"):
            r.render(cfg.spp)
        film = r.gather_film() if hasattr(r, "gather_film") else r.film
        if hasattr(r, "mrays_per_sec"):
            log.info(
                "Rendered %dx%d @ %d spp: %.1f Mrays/s (%d rays, %.2fs)",
                cfg.width, cfg.height, int(film.spp),
                r.mrays_per_sec, r.total_rays, r.render_seconds,
            )
        return film.to_image()

    def render_history_delta(
        self, step1: int, step2: int, boost: float = 1.0
    ) -> np.ndarray:
        """Radiosity-history difference image |B(step1) - B(step2)| on
        primary hits — the reference's outputs/deltas/delta_i_j
        [_boosted].png artifacts (SURVEY.md C32, primitive.h:193-222)."""
        import jax.numpy as jnp

        self.prepare()
        if self.solution is None:
            self.run_solver()
        cfg = self.config
        delta = jnp.abs(self.solution.history_delta(step1, step2)) * boost
        img = render_radiosity_view(
            self.geom,
            delta,
            self.camera_ctrl.build(),
            rng.base_key(cfg.seed),
            RenderSettings(
                width=cfg.width,
                height=cfg.height,
                spp_per_pass=max(cfg.spp, 1),
                ray_chunk=cfg.ray_chunk,
            ),
            include_emission=False,
            accel=self.accel,
        )
        return np.asarray(img)[::-1]

    def pick(self, u: float, v: float) -> int:
        """Primitive under the cursor (callbacks.h:22-86)."""
        return pick_primitive(self.geom, self.camera_ctrl.build(), u, v,
                              self.accel)

    def orbit(self, d_yaw=0.0, d_pitch=0.0, d_radius=0.0) -> None:
        self.camera_ctrl.orbit(d_yaw, d_pitch, d_radius)
        if self._renderer is not None:
            # camera moved: restart accumulation (reference re-renders
            # every frame anyway)
            self._renderer = None

    # ---------------- export / checkpoint ----------------

    def save_png(self, path: str, image: np.ndarray | None = None) -> None:
        if image is None:
            image = self.render()
        from .utils.png import write_png

        write_png(path, image)
        log.info("Saved %s", path)

    def save_checkpoint(self, path: str) -> None:
        """Film + radiosity solution as npz (resumable offline render)."""
        data = {}
        if self._renderer is not None:
            f = self._renderer.film
            data.update(
                film_accum=np.asarray(f.accum),
                film_spp=np.asarray(f.spp),
                film_passes=np.asarray(f.passes),
            )
        if self.solution is not None:
            data.update(
                radiosity=np.asarray(self.solution.radiosity),
                unshot=np.asarray(self.solution.unshot),
                rad_grid=np.asarray(self.solution.rad_grid),
                grid_counts=np.asarray(self.solution.grid_counts),
                form_factors=np.asarray(self.solution.form_factors),
            )
        np.savez_compressed(path, **data)
        log.info("Checkpoint saved: %s", path)

    def load_checkpoint(self, path: str) -> None:
        import jax.numpy as jnp

        z = np.load(path)
        if "film_accum" in z:
            r = self.renderer()
            r.film = Film(
                accum=jnp.asarray(z["film_accum"]),
                spp=jnp.asarray(z["film_spp"]),
                passes=jnp.asarray(z["film_passes"]),
            )
        if "radiosity" in z and self.solution is not None:
            self.solution = RadiositySolution(
                form_factors=jnp.asarray(z["form_factors"]),
                radiosity=jnp.asarray(z["radiosity"]),
                unshot=jnp.asarray(z["unshot"]),
                grid_counts=jnp.asarray(z["grid_counts"]),
                rad_grid=jnp.asarray(z["rad_grid"]),
                history=self.solution.history,
                history_index=self.solution.history_index,
                history_count=self.solution.history_count,
            )
        log.info("Checkpoint loaded: %s", path)
