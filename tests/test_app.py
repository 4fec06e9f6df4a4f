"""App orchestration tests: the reference lifecycle call stacks
(SURVEY.md §3) through the headless App + Config/CLI plumbing."""

import os

import numpy as np
import pytest

from pathtracer.app import App
from pathtracer.utils.config import Config


def small_cfg(**kw):
    base = dict(
        scene="cbox_quads", width=32, height=32, spp=4, max_depth=3,
        ray_chunk=1024, spp_per_pass=4,
    )
    base.update(kw)
    return Config(**base)


class TestLifecycle:
    def test_render_bsdf(self):
        app = App(small_cfg())
        img = app.render()
        assert img.shape == (32, 32, 3) and img.dtype == np.uint8
        assert img.max() > 0

    def test_prepare_runs_startup_sequence(self):
        """Guided mode triggers solver + CDFs (initializeApplication
        parity: solve + precompute at startup, application.h:126-136)."""
        app = App(small_cfg(sampling_mode="mis", mc_samples=8,
                            radiosity_iterations=3))
        app.prepare()
        assert app.solution is not None
        assert app.cdfs is not None
        img = app.render()
        assert img.max() > 0

    def test_radiosity_integrator(self):
        app = App(small_cfg(integrator="radiosity", mc_samples=8,
                            radiosity_iterations=3))
        img = app.render()
        assert img.shape == (32, 32, 3)
        assert img.max() > 0

    def test_auto_solver_picks_gather_when_matrix_fits(self):
        """radiosity_solver='auto' must use the gather solver (full
        matrix, reference semantics) below the 16,384-prim memory
        threshold."""
        app = App(small_cfg(sampling_mode="mis", mc_samples=8,
                            radiosity_iterations=3,
                            radiosity_solver="auto"))
        app.prepare()
        n = app.geom.num_prims
        assert app.solution.form_factors.shape == (n, n)

    def test_shooting_solver_config(self):
        """radiosity_solver='shooting' routes run_solver through the
        matrix-free path and the guided pipeline consumes its grids."""
        app = App(small_cfg(sampling_mode="mis",
                            radiosity_solver="shooting",
                            shooting_steps=24, shooters_per_step=8,
                            shooting_mc_samples=16))
        app.prepare()
        assert app.solution is not None
        assert app.solution.form_factors.size == 0   # matrix-free
        assert float(np.asarray(app.solution.radiosity).mean()) > 0
        img = app.render()
        assert img.max() > 0

    def test_history_delta_image(self):
        app = App(small_cfg(mc_samples=8, radiosity_iterations=4))
        img = app.render_history_delta(0, 2, boost=4.0)
        assert img.shape == (32, 32, 3)

    def test_pick_and_orbit(self):
        app = App(small_cfg())
        app.load_scene()
        idx = app.pick(0.5, 0.5)
        assert idx >= 0
        app.orbit(d_yaw=15.0)
        assert app._renderer is None  # accumulation restarted

    def test_checkpoint_roundtrip(self, tmp_path):
        app = App(small_cfg(sampling_mode="radiosity", mc_samples=8,
                            radiosity_iterations=2))
        app.render()
        path = str(tmp_path / "ckpt.npz")
        app.save_checkpoint(path)

        app2 = App(small_cfg(sampling_mode="radiosity", mc_samples=8,
                             radiosity_iterations=2))
        app2.prepare()
        app2.load_checkpoint(path)
        np.testing.assert_array_equal(
            np.asarray(app2._renderer.film.accum),
            np.asarray(app._renderer.film.accum),
        )

    def test_unsupported_format_raises(self):
        app = App(small_cfg(scene="scene.xyz"))
        with pytest.raises(ValueError, match="unsupported scene format"):
            app.load_scene()

    def test_topk_mode(self):
        app = App(small_cfg(sampling_mode="topk", top_k=8, mc_samples=8,
                            radiosity_iterations=3))
        app.prepare()
        # at most top_k cells per primitive remain nonzero
        pdf = np.asarray(app.cdfs.pdf)
        assert (np.count_nonzero(pdf, axis=1) <= 8).all()


class TestConfig:
    def test_json_roundtrip(self):
        cfg = Config(spp=77, sampling_mode="mis", sigma_range=0.4)
        cfg2 = Config.from_json(cfg.to_json())
        assert cfg2.spp == 77
        assert cfg2.sampling_mode == "mis"
        assert cfg2.sigma_range == 0.4

    def test_bad_mode_raises(self):
        with pytest.raises(ValueError, match="unknown sampling mode"):
            _ = Config(sampling_mode="nonsense").sampling_mode_id

    def test_cli_parsing(self):
        import argparse

        p = argparse.ArgumentParser()
        Config.add_cli_args(p)
        args = p.parse_args(
            ["--spp", "9", "--sampling-mode", "mis",
             "--camera-origin", "1", "2", "3"]
        )
        cfg = Config.from_cli_args(args)
        assert cfg.spp == 9
        assert cfg.sampling_mode == "mis"
        assert cfg.camera_origin == (1.0, 2.0, 3.0)


class TestViewerSet:
    def test_set_scene_reloads_geometry(self):
        """A /set that changes scene/subdivision must re-run
        load_scene() so new geometry actually renders (reference
        Controls-window reload, ui_windows.h:94-104, 213-224)."""
        from pathtracer.viewer.server import ViewerState

        state = ViewerState.__new__(ViewerState)  # no render thread
        import threading

        state.app = App(small_cfg(scene="cbox"))
        state.app.load_scene()
        state.lock = threading.Lock()
        n_before = state.app.geom.num_prims

        changed = state.apply_settings({"scene": "cbox_quads"})
        assert changed == {"scene"}
        assert state.app.config.scene == "cbox_quads"
        # geometry was reloaded, not stale
        assert state.app.geom.num_prims != n_before
        img = state.app.render()
        assert img.max() > 0

    def test_set_non_geo_key_keeps_geometry(self):
        from pathtracer.viewer.server import ViewerState
        import threading

        state = ViewerState.__new__(ViewerState)
        state.app = App(small_cfg())
        state.app.load_scene()
        state.lock = threading.Lock()
        geom = state.app.geom

        changed = state.apply_settings({"spp": "8"})
        assert changed == {"spp"}
        assert state.app.geom is geom  # no reload
        assert state.app._renderer is None  # accumulation restarted


class TestViewerEndpoints:
    """HTTP-level coverage of the interactive control surface (every
    reference Controls-window action mouse-reachable).
    A real ThreadingHTTPServer on an ephemeral port, no render thread."""

    @pytest.fixture()
    def server(self):
        import threading
        from http.server import ThreadingHTTPServer

        from pathtracer.viewer.server import ViewerState, make_handler

        state = ViewerState.__new__(ViewerState)
        state.app = App(small_cfg(sampling_mode="mis", mc_samples=8,
                                  radiosity_iterations=3))
        state.app.load_scene()
        state.lock = threading.Lock()
        srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        yield state, srv.server_address[1]
        srv.shutdown()

    def _get(self, port, path):
        import urllib.request

        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=30
        ) as r:
            return r.status, r.read()

    def test_page_has_every_controls_widget(self, server):
        _, port = server
        status, body = self._get(port, "/")
        assert status == 200
        page = body.decode()
        # every reference Controls-window action (ui_windows.h:73-246)
        for widget in (
            'id="width"', 'id="height"', 'id="spp"', 'id="scene"',
            'id="convert_quads"', 'id="sampling_mode"',
            'id="mis_bsdf_fraction"', 'id="integrator"',
            'id="radiosity_iterations"', 'id="use_monte_carlo"',
            'id="mc_samples"', 'id="use_bilateral"',
            'id="sigma_spatial"', 'id="sigma_range"',
            "Apply Filter", "Use Raw CDFs", "Calculate Radiosity",
            "Save PNG", 'id="subdivision"', 'id="show_grid"',
            # interactions (callbacks.h:95-150)
            "mousedown", "wheel", "/pick?u=", "/orbit?yaw=",
            # grid + profiler windows
            'id="heatmap"', 'id="prof_enable"', "Reset Stats",
        ):
            assert widget in page, f"missing widget: {widget}"

    def test_state_json(self, server):
        import json as _json

        state, port = server
        state.app.prepare()
        status, body = self._get(port, "/state?prim=1")
        assert status == 200
        s = _json.loads(body)
        assert s["scene"]["num_prims"] == 16
        assert s["config"]["sampling_mode"] == "mis"
        assert s["grid"]["source"] == "RAW Radiosity Grid"
        assert s["grid"]["non_zero"] >= 0
        assert "fps" in s["profiler"]

    def test_filter_and_raw_cdf_buttons(self, server):
        state, port = server
        state.app.prepare()
        status, body = self._get(port, "/filter")
        assert status == 200 and b"filtered" in body
        assert state.app.config.cdf_source == "filtered_radiosity"
        # grid stats now report the filtered source, like the reference
        # Grid window's "Source: FILTERED PDF" label
        assert state.grid_stats(0)["source"] == "FILTERED PDF"
        status, body = self._get(port, "/rawcdfs")
        assert status == 200 and b"raw" in body
        assert state.app.config.cdf_source == "radiosity"

    def test_pick_returns_json(self, server):
        import json as _json

        state, port = server
        status, body = self._get(port, "/pick?u=0.5&v=0.5")
        assert status == 200
        assert isinstance(_json.loads(body)["prim"], int)

    def test_profiler_reset_and_enable(self, server):
        state, port = server
        state.app.profiler.add_stage("x").record(0.01)
        self._get(port, "/profiler/reset")
        assert not state.app.profiler.stages
        self._get(port, "/profiler/enable?on=0")
        assert state.app.profiler.enabled is False
        with state.app.profiler.stage("y"):
            pass
        assert "y" not in state.app.profiler.stages
        self._get(port, "/profiler/enable?on=1")
        assert state.app.profiler.enabled is True

    def test_solver_key_invalidates_solution(self, server):
        """Changing a solver knob re-solves on next prepare (the
        reference re-runs the solver on slider change,
        ui_windows.h:140-147)."""
        state, port = server
        state.app.prepare()
        sol = state.app.solution
        assert sol is not None
        self._get(port, "/set?mc_samples=16")
        assert state.app.solution is None
        state.app.prepare()
        assert state.app.solution is not None

    def test_camera_key_updates_aspect_without_orbit_reset(self, server):
        state, port = server
        state.app.orbit(25.0, 0.0, 0.0)
        yaw = state.app.camera_ctrl.yaw
        self._get(port, "/set?width=64")
        assert state.app.camera_ctrl.aspect == pytest.approx(64 / 32)
        assert state.app.camera_ctrl.yaw == yaw

    def test_scenes_listing(self, server):
        """Scene browser (ImGuiFileDialog parity, ui_windows.h:88-104):
        builtins + every .obj/.pbrt under scenes/, and the page carries
        the dropdown that loads them by mouse."""
        import json as _json

        _, port = server
        status, body = self._get(port, "/scenes")
        assert status == 200
        scenes = _json.loads(body)["scenes"]
        assert "cbox_quads" in scenes and "cbox" in scenes
        assert "scenes/cbox.obj" in scenes
        assert "scenes/stress100k.pbrt" in scenes
        assert not any(s.endswith((".mtl", ".py", ".ply"))
                       for s in scenes)
        _, page = self._get(port, "/")
        assert b'id="scenesel"' in page

    def test_profiler_kernel_endpoint(self, server):
        """Kernel-phase split endpoint (renderProfilerWindow's cycle
        percentages, ui_windows.h:487-550): returns the traced-device
        breakdown JSON; the page renders it as the stacked bar. On the
        CPU test backend the trace has no device track, so percent may
        be empty — the shape contract is what's pinned here (the GPU
        reduction is tested on a recorded trace in
        tests/test_kernel_profile.py)."""
        import json as _json

        _, port = server
        status, body = self._get(port, "/profiler/kernel")
        assert status == 200
        p = _json.loads(body)
        assert set(p) >= {"seconds", "percent", "ops", "device_total"}
        assert isinstance(p["percent"], dict)
        _, page = self._get(port, "/")
        assert b"kprofbar" in page and b"Sample Kernel Split" in page


class TestLegacyRadiosityDisplay:
    def test_legacy_display_light_is_251(self):
        """The reference's published sweep PNGs show the light at
        exactly u8=251 (Reinhard+gamma of B=Le=25, counted once) while
        the current code's sqrt display saturates at 255 — the
        forensically identified transform must reproduce 251."""
        import jax
        import jax.numpy as jnp
        import numpy as np

        from pathtracer.render.camera import CameraController
        from pathtracer.render.renderer import (
            RenderSettings,
            render_radiosity_view,
        )
        from pathtracer.scene.builtin import cornell_box

        geom = cornell_box("quads").build()
        cam = CameraController.default().build()
        s = RenderSettings(width=96, height=96, spp_per_pass=1,
                           ray_chunk=96 * 96)
        rad = geom.emission  # emission-only state (step 0)
        legacy = np.asarray(render_radiosity_view(
            geom, rad, cam, jax.random.key(0), s, display="legacy"))
        current = np.asarray(render_radiosity_view(
            geom, rad, cam, jax.random.key(0), s))
        assert legacy.max() == 251
        assert current.max() == 255


class TestFFEstimatorConfig:
    """Config.ff_estimator routes the form-factor MC combiner choice
    through the App. The estimator-accuracy claim itself
    (per-sample matches closed-form quadrature; the reference's
    ratio-of-averages is Jensen-biased low) is asserted in
    tests/test_radiosity.py::TestFormFactors::
    test_unbiased_estimator_beats_reference."""

    def test_cli_flag_round_trips(self):
        import argparse

        p = argparse.ArgumentParser()
        Config.add_cli_args(p)
        cfg = Config.from_cli_args(
            p.parse_args(["--ff-estimator", "unbiased"])
        )
        assert cfg.ff_estimator == "unbiased"
        assert Config.from_cli_args(p.parse_args([])).ff_estimator == (
            "reference"
        )

    def test_routes_through_gather_solver(self):
        """ff_estimator='unbiased' changes the solved form factors (same
        seed, same draws — only the combiner differs), and the combiner
        shifts them UP on the dominant close-pair terms (the reference's
        ratio-of-averages is Jensen-biased low)."""
        base = dict(sampling_mode="mis", mc_samples=16,
                    radiosity_iterations=3, radiosity_solver="gather")
        app_u = App(small_cfg(ff_estimator="unbiased", **base))
        app_u.load_scene()
        ff_u = np.asarray(app_u.run_solver().form_factors)
        app_r = App(small_cfg(**base))
        app_r.load_scene()
        ff_r = np.asarray(app_r.run_solver().form_factors)
        assert not np.array_equal(ff_u, ff_r)
        # Aggregate energy: the unbiased combiner recovers the Jensen
        # gap, so total transported energy must be strictly larger.
        assert ff_u.sum() > ff_r.sum()


class TestCboxMaterialFidelity:
    """The two bundled Cornell variants must carry the reference's exact
    material values: cbox.obj uses the Blender palette (Khaki/BloodyRed/
    DarkGreen, pure-emitter light) — reference/scenes/cbox.mtl:1-42 —
    while cbox_quads.obj uses white/red/green with a reflective light
    (cbox_quads.mtl:3-17)."""

    def test_tris_variant_blender_palette(self):
        from pathtracer.scene.builtin import cornell_box

        p = cornell_box("tris")
        kds = {tuple(np.round(a.astype(np.float64), 6)) for a in p.albedo}
        assert kds == {
            (0.0, 0.0, 0.0),              # Light Kd=0 (pure emitter)
            (0.8, 0.659341, 0.43956),     # Khaki
            (0.445, 0.0, 0.0),            # BloodyRed
            (0.0, 0.32, 0.0),             # DarkGreen
        }
        assert float(p.emission.max()) == 25.0

    def test_quads_variant_palette(self):
        from pathtracer.scene.builtin import cornell_box

        p = cornell_box("quads")
        kds = {tuple(np.round(a.astype(np.float64), 6)) for a in p.albedo}
        assert kds == {
            (0.8, 0.8, 0.8),
            (0.8, 0.1, 0.1),
            (0.1, 0.8, 0.1),
        }

    def test_bundled_obj_matches_builtin(self):
        """scenes/cbox.obj on disk round-trips to the same materials."""
        from pathtracer.scene.builtin import cornell_box
        from pathtracer.scene.obj_loader import load_obj

        path = os.path.join(
            os.path.dirname(__file__), "..", "scenes", "cbox.obj"
        )
        disk = load_obj(path)
        ref = cornell_box("tris")
        np.testing.assert_allclose(disk.albedo, ref.albedo, atol=1e-6)
        np.testing.assert_allclose(disk.emission, ref.emission, atol=1e-6)
