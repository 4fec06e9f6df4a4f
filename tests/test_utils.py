"""Utility-layer tests: PNG roundtrip, profiler, logger, kernel profile,
heatmaps, film serialization."""

import logging
import time

import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer.render.film import Film
from pathtracer.utils.logger import configure, get_logger, log_ray_stats
from pathtracer.utils.png import (
    png_bytes,
    read_png,
    write_png,
    write_png_bottom_up,
)
from pathtracer.utils.profiler import Profiler
from pathtracer.viewer.heatmap import (
    grid_heatmap,
    heat_colormap,
    top_k_overlay,
)


class TestPng:
    def test_roundtrip(self, tmp_path):
        r = np.random.default_rng(0)
        img = r.integers(0, 256, (37, 23, 3), dtype=np.uint8)
        path = str(tmp_path / "t.png")
        write_png(path, img)
        back = read_png(path)
        np.testing.assert_array_equal(back, img)

    def test_bottom_up_flips(self, tmp_path):
        img = np.zeros((4, 2, 3), np.uint8)
        img[0] = 255  # bottom scanline
        path = str(tmp_path / "b.png")
        write_png_bottom_up(path, img)
        back = read_png(path)
        assert (back[-1] == 255).all()
        assert (back[0] == 0).all()

    def test_bytes_equals_file(self, tmp_path):
        img = np.arange(4 * 4 * 3, dtype=np.uint8).reshape(4, 4, 3)
        path = str(tmp_path / "c.png")
        write_png(path, img)
        with open(path, "rb") as f:
            assert f.read() == png_bytes(img)

    def test_rejects_bad_shape(self):
        with pytest.raises(ValueError):
            png_bytes(np.zeros((4, 4), np.uint8))


class TestProfiler:
    def test_stage_stats(self):
        p = Profiler()
        for _ in range(3):
            with p.stage("Work"):
                time.sleep(0.002)
        s = p.stages["Work"]
        assert s.count == 3
        assert s.avg_ms >= 1.5
        assert s.min_ms <= s.avg_ms <= s.max_ms
        assert "Work" in p.summary()
        assert '"count": 3' in p.to_json()

    def test_frame_fps(self):
        p = Profiler()
        for _ in range(4):
            p.begin_frame()
            time.sleep(0.001)
            p.end_frame()
        assert p.fps > 0


class TestLogger:
    def test_file_sink(self, tmp_path):
        path = str(tmp_path / "log.txt")
        configure(logging.INFO, log_file=path)
        get_logger("Test").info("hello %d", 42)
        configure(logging.INFO)  # reset to console-only
        with open(path) as f:
            content = f.read()
        assert "hello 42" in content
        assert "[Test]" in content

    def test_ray_stats(self):
        rate = log_ray_stats("Test", 2_000_000, 1.0)
        assert rate == pytest.approx(2.0)


class TestHeatmap:
    def test_colormap_ramp(self):
        c = heat_colormap(np.array([0.0, 1 / 6, 0.5, 1.0]))
        assert (c[0] == [0, 0, 0]).all()
        assert c[1][0] > 100 and c[1][1] == 0      # red-ish
        assert (c[3] == [255, 255, 255]).all()      # white

    def test_grid_heatmap_shape(self):
        pdf = np.random.default_rng(1).uniform(0, 1, (4, 256))
        img = grid_heatmap(pdf, 2, cell_px=4)
        assert img.shape == (64, 64, 3)

    def test_top_k_overlay(self):
        pdf = np.arange(256, dtype=np.float32)[None]
        img = top_k_overlay(pdf, 0, k=4, cell_px=1)
        lit = (img.sum(-1) > 0).sum()
        assert lit == 4


class TestFilm:
    def test_save_load(self, tmp_path):
        f = Film.create(8, 8)
        f = Film(
            accum=f.accum + 2.5,
            spp=f.spp + 5,
            passes=f.passes + 2,
        )
        path = str(tmp_path / "film.npz")
        f.save(path)
        g = Film.load(path)
        np.testing.assert_array_equal(
            np.asarray(g.accum), np.asarray(f.accum)
        )
        assert int(g.spp) == 5 and int(g.passes) == 2
        np.testing.assert_allclose(
            np.asarray(g.mean_radiance()), 0.5, rtol=1e-6
        )

    def test_to_image_flips(self):
        f = Film.create(2, 2)
        accum = jnp.zeros((2, 2, 3)).at[0].set(100.0)  # bottom row bright
        f = Film(accum=accum, spp=f.spp + 1, passes=f.passes)
        img = f.to_image()
        assert img[-1].sum() > img[0].sum()


class TestProfilerSvg:
    def test_svg_renders_history_and_guides(self):
        from pathtracer.utils.profiler import Profiler
        from pathtracer.viewer.profgraph import profiler_svg

        p = Profiler()
        for i in range(130):          # overflow the 120-frame ring
            p.begin_frame()
            with p.stage("Render"):
                pass
            p.frame_history.append(1.0 / (45.0 + i % 10))
            p._frame_start = None
        svg = profiler_svg(p)
        assert svg.startswith("<svg")
        assert "polyline" in svg          # FPS curve present
        assert svg.count("stroke-opacity") == 2   # 60/30 fps guides
        assert "Render" in svg            # stage legend
        assert len(p.frame_history) == 120
