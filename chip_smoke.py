"""Quickest proof that the renderer runs on the GPU, end to end.

    python chip_smoke.py          # one GPU: phases (a)-(d)
    python chip_smoke.py --four   # four GPUs: the tiled 4K render and the
                                  # sharded shooting solve, each against
                                  # its single-card run, and nothing else

Phases on one card, each through the entry points a user calls (App,
ProgressiveRenderer, the solver) at full size:
  (a) cbox_quads through App: MC gather radiosity solve, CDF build, and
      1024x1024 depth-5 renders with BSDF sampling, guided MIS, NEE and
      the mirror scene. Films must be finite and nonzero, and the guided
      film must agree statistically with CPU renders of the same
      configuration (stat_agree), while the same film rendered with
      albedo x0.8 must not.
  (b) the fused hit kernels against XLA's closest_hit / occluded on the
      card, 65,536 rays x the 32- and 8,192-triangle scenes: t to a
      relative 1e-6, primitive ids equal except at t ties, any-hit flags
      equal.
  (c) scenes/stress100k.pbrt (101,704 triangles) through App's automatic
      backend choice, which lands on the BVH, with and without NEE.
  (d) the sub-4 cbox (4,096 primitives) gather solve through
      App.run_solver.
Each phase prints its first-call seconds (compile + run) and its warm
seconds. The card's name and power limit come on an early line; the last
line is one JSON object {"ok": true, "device": {...}}. Without a GPU, or
when any phase fails, the script exits non-zero and prints no such line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np


def result_line(platform: str, kind: str, count: int) -> str:
    return json.dumps(
        {"ok": True,
         "device": {"platform": platform, "kind": kind, "count": count}}
    )


def block_mean(img: np.ndarray, f: int) -> np.ndarray:
    """(H, W, C) -> (H/f, W/f, C) box average: a 1024^2 film averaged in
    4x4 blocks is the box-filtered 256^2 image of the same scene."""
    h, w, c = img.shape
    return img.reshape(h // f, f, w // f, f, c).mean(axis=(1, 3))


def stat_agree(test, ref_a, ref_b, spp_ratio: float, block: int = 16,
               limit: float = 1.5):
    """Statistical agreement of a film with two independent reference
    renders of the same configuration (per-pixel means, equal shapes).

    All three are averaged in block x block tiles first, so that pixel
    noise (fireflies) averages out and a bias that covers a region
    survives. Per tile and channel, with m = (a + b) / 2 the references'
    mean, (a - b) / 2 has the variance of m; the test film adds its own
    variance, 1 / spp_ratio of one reference's (spp_ratio = test samples
    per pixel over reference samples per pixel). So for an unbiased film

        z = rms(test - m) / rms((a - b) / 2) / sqrt(1 + 2 / spp_ratio)

    is about 1, and a bias b per tile raises z^2 by b^2 / var(m). On the
    guided cbox (CPU calibration, 128^2 in 8x8 tiles, 64-spp references,
    8x the samples in the test film) unbiased films gave z of 0.99-1.16,
    albedo x0.8 gave 2.1-2.2 and emission x1.1 3.9-4.4. Returns (ok, z)
    with ok = z <= limit."""
    test, ref_a, ref_b = (block_mean(np.asarray(x, np.float64), block)
                          for x in (test, ref_a, ref_b))
    m = 0.5 * (ref_a + ref_b)
    d_test = np.sqrt(np.mean((test - m) ** 2))
    d_noise = np.sqrt(np.mean((0.5 * (ref_a - ref_b)) ** 2))
    z = float(d_test / d_noise / np.sqrt(1.0 + 2.0 / spp_ratio))
    return bool(np.isfinite(z)) and z <= limit, z


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out


class Phases:
    """Runs named phases, prints their timings, records failures."""

    def __init__(self):
        self.failed = []

    def run(self, name, fn):
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:  # noqa: BLE001 — every failure fails the run
            self.failed.append(name)
            print(f"[{name}] FAILED after {time.perf_counter() - t0:.1f} s",
                  flush=True)
            traceback.print_exc()
            return
        print(f"[{name}] ok in {time.perf_counter() - t0:.1f} s", flush=True)


def timed(label, fn):
    """First call (compile + run) and one warm call of fn; prints both."""
    t0 = time.perf_counter()
    out = fn()
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = fn()
    warm = time.perf_counter() - t0
    print(f"  {label}: first {first:.2f} s, warm {warm:.3f} s", flush=True)
    return out


def film_mean(film) -> np.ndarray:
    return np.asarray(film.accum, np.float64) / max(int(film.spp), 1)


def check_film(label, img):
    if img.size == 0 or not np.isfinite(img).all():
        raise AssertionError(f"{label}: film has non-finite values")
    if not img.max() > 0.0:
        raise AssertionError(f"{label}: film is all zero")


# ---------------------------------------------------------------------------
# One card
# ---------------------------------------------------------------------------


def phase_app(width: int = 1024, ref_width: int = 256, seed: int = 2023):
    import jax

    from pathtracer.app import App
    from pathtracer.ops import dispatch
    from pathtracer.render.renderer import ProgressiveRenderer
    from pathtracer.utils.config import Config

    def app_render(label, **kw):
        cfg = Config(scene="cbox_quads", width=width, height=width,
                     max_depth=5, spp=16, seed=seed, **kw)
        app = App(cfg)
        app.prepare()
        if app.backend != "triton":
            raise AssertionError(f"cbox backend is {app.backend}")

        def one_pass():
            app._renderer = None
            r = app.renderer()
            r.render(cfg.spp)
            return r

        r = timed(f"a.{label} {width}x{width} 16 spp", one_pass)
        img = film_mean(r.film)
        check_film(label, img)
        print(f"    {r.mrays_per_sec:.1f} Mrays/s wall "
              f"({r.total_rays} rays), film mean {img.mean():.5f}",
              flush=True)
        return app, img

    # guided MIS: the solve and the CDFs through App, timed warm too
    cfg = Config(scene="cbox_quads", width=width, height=width, max_depth=5,
                 spp=16, seed=seed, sampling_mode="mis")
    app = App(cfg)
    app.load_scene()
    timed("a.solve cbox MC gather (10 it x 64 samples)", app.run_solver)
    timed("a.cdfs", app.precompute_cdfs)
    rad = np.asarray(app.solution.radiosity)
    if not (np.isfinite(rad).all() and rad.mean() > 0):
        raise AssertionError("cbox radiosity is not finite and positive")

    def mis_pass():
        app._renderer = None
        r = app.renderer()
        r.render(cfg.spp)
        return r

    r = timed(f"a.mis {width}x{width} 16 spp", mis_pass)
    mis = film_mean(r.film)
    check_film("mis", mis)
    print(f"    {r.mrays_per_sec:.1f} Mrays/s wall, film mean "
          f"{mis.mean():.5f}", flush=True)

    app_render("bsdf")
    app_render("nee", nee=True)
    app_render("mirror", mirror_tall_box=True)

    # negative control: the same guided pass with albedo x0.8 must fail
    # the comparison below, or the comparison proves nothing
    biased = App(cfg)
    biased.load_scene()
    biased.geom = dataclasses.replace(biased.geom,
                                      albedo=biased.geom.albedo * 0.8)
    biased._select_backend()
    biased.solution, biased.cdfs = app.solution, app.cdfs
    rb = biased.renderer()
    rb.render(cfg.spp)
    mis_biased = film_mean(rb.film)
    check_film("mis albedo x0.8", mis_biased)

    # the guided film against two CPU renders of the same configuration
    # (same scene, camera and CDFs) at ref_width^2, other seeds
    cpu = jax.devices("cpu")[0]
    spp_cpu = 32
    cdfs = jax.device_put(app.cdfs, cpu)
    refs = []
    with jax.default_device(cpu):
        from pathtracer.render.renderer import RenderSettings
        from pathtracer.scene.builtin import cornell_box

        geom = cornell_box("quads").build()
        accel = dispatch.build_accel(
            geom, dispatch.select_backend("cpu", geom.num_tris)
        )
        settings = RenderSettings(
            width=ref_width, height=ref_width, max_depth=5,
            sampling_mode=r.settings.sampling_mode,
            spp_per_pass=spp_cpu, ray_chunk=1 << 16,
        )
        for s in (seed + 1, seed + 2):
            rc = ProgressiveRenderer(
                geom, app.camera_ctrl.build(), settings, cdfs=cdfs,
                mis_bsdf_fraction=cfg.mis_bsdf_fraction, seed=s,
                accel=accel,
            )
            t0 = time.perf_counter()
            rc.render(spp_cpu)
            print(f"  a.cpu reference {ref_width}^2 {spp_cpu} spp seed {s}: "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            refs.append(film_mean(rc.film))
    f = width // ref_width
    spp_ratio = cfg.spp * f * f / spp_cpu
    ok, z = stat_agree(block_mean(mis, f), *refs, spp_ratio=spp_ratio)
    ok_b, z_b = stat_agree(block_mean(mis_biased, f), *refs,
                           spp_ratio=spp_ratio)
    print(f"  a.stat guided GPU ({width}^2 -> {ref_width}^2) vs CPU in "
          f"16x16 tiles: z {z:.5f} (albedo x0.8: {z_b:.5f}; limit 1.5)",
          flush=True)
    if not ok:
        raise AssertionError("guided film disagrees with the CPU render")
    if ok_b:
        raise AssertionError("the comparison passed a film with albedo x0.8")


def phase_kernels(n: int = 65536, subdivisions=(0, 4)):
    import jax
    import jax.numpy as jnp

    from pathtracer.ops import intersect_triton as it
    from pathtracer.ops.intersect import closest_hit, occluded
    from pathtracer.render.camera import CameraController
    from pathtracer.scene.builtin import cornell_box
    from pathtracer.scene.mesh import subdivide

    cam = CameraController.default().build()
    for sub in subdivisions:
        geom = subdivide(cornell_box("quads"), sub).build()
        pack = it.pack_triangles(geom)
        u = jax.random.uniform(jax.random.key(sub), (2, n))
        k1, k2 = jax.random.split(jax.random.key(100 + sub))
        o_in = jax.random.uniform(k1, (n, 3), minval=-2.5, maxval=2.5)
        d_in = jax.random.normal(k2, (n, 3))
        batches = {
            "camera": cam.get_rays(u[0], u[1]),
            "incoherent": (
                o_in + jnp.array([0.0, 2.75, 0.0]),
                d_in / jnp.linalg.norm(d_in, axis=-1, keepdims=True),
            ),
        }
        kern_hit = jax.jit(lambda o, d: it.kernel_closest_hit(pack, o, d))
        ref_hit = jax.jit(lambda o, d: closest_hit(geom, o, d))
        kern_occ = jax.jit(
            lambda o, d, m, a, b: it.kernel_occluded(pack, o, d, m, a, b)
        )
        ref_occ = jax.jit(
            lambda o, d, m, a, b: occluded(geom, o, d, m, a, b)
        )
        for kind, (o, d) in batches.items():
            label = f"b.{geom.num_tris} tris {kind}"
            h = timed(label + " closest_hit kernel",
                      lambda: jax.block_until_ready(kern_hit(o, d)))
            with jax.default_matmul_precision("highest"):
                r = ref_hit(o, d)
            hv, rv = np.asarray(h.valid), np.asarray(r.valid)
            if (hv != rv).any():
                raise AssertionError(f"{label}: hit masks differ")
            ht, rt = np.asarray(h.t)[rv], np.asarray(r.t)[rv]
            rel = np.abs(ht - rt) / rt
            if rel.size and rel.max() > 1e-6:
                raise AssertionError(f"{label}: t rel diff {rel.max():g}")
            diff = np.asarray(h.prim)[rv] != np.asarray(r.prim)[rv]
            if (diff & (rel > 1e-6)).any():
                raise AssertionError(f"{label}: {diff.sum()} ids differ")
            for f in ("n", "albedo", "emission", "material"):
                a = np.asarray(getattr(h, f))[rv][~diff]
                b = np.asarray(getattr(r, f))[rv][~diff]
                if not np.array_equal(a, b):
                    raise AssertionError(f"{label}: {f} differs")
            ex = r.prim
            for scale in (0.999, 2.0):
                maxd = jnp.where(r.valid, r.t * scale, 10.0)
                kb = timed(
                    f"{label} any_hit kernel (max_dist x{scale})",
                    lambda: jax.block_until_ready(
                        kern_occ(o, d, maxd, ex, ex)),
                )
                with jax.default_matmul_precision("highest"):
                    rb = ref_occ(o, d, maxd, ex, ex)
                if not np.array_equal(np.asarray(kb), np.asarray(rb)):
                    raise AssertionError(f"{label}: any-hit flags differ")
            print(f"    {label}: {int(rv.sum())} hits, max t rel diff "
                  f"{float(rel.max()) if rel.size else 0.0:g}, "
                  f"{int(diff.sum())} id ties", flush=True)


def phase_large_scene(width: int = 512):
    from pathtracer.app import App
    from pathtracer.utils.config import Config

    for nee in (False, True):
        cfg = Config(scene="scenes/stress100k.pbrt", width=width,
                     height=width,
                     max_depth=4, spp=8, spp_per_pass=4, nee=nee)
        app = App(cfg)
        app.load_scene()
        if app.backend != "bvh":
            raise AssertionError(f"stress100k backend is {app.backend}")

        def passes():
            app._renderer = None
            r = app.renderer()
            r.render(cfg.spp)
            return r

        r = timed(f"c.stress100k ({app.geom.num_tris} tris) {width}^2 "
                  f"8 spp nee={nee}", passes)
        img = film_mean(r.film)
        check_film(f"stress100k nee={nee}", img)
        print(f"    {r.mrays_per_sec:.1f} Mrays/s wall, film mean "
              f"{img.mean():.5f}", flush=True)


def phase_solver(subdivision: int = 4):
    from pathtracer.app import App
    from pathtracer.utils.config import Config

    cfg = Config(scene="cbox_quads", subdivision=subdivision,
                 radiosity_solver="gather",
                 radiosity_iterations=10, mc_samples=16)
    app = App(cfg)
    app.load_scene()
    sol = timed(f"d.sub-{subdivision} gather solve ({app.geom.num_prims} prims, "
                f"{app.geom.num_tris} tris, backend {app.backend})",
                app.run_solver)
    rad = np.asarray(sol.radiosity)
    emis = np.asarray(app.geom.emission)
    grid = np.asarray(sol.rad_grid)
    if not (np.isfinite(rad).all() and np.isfinite(grid).all()):
        raise AssertionError("sub-4 solve is not finite")
    if (rad < emis - 1e-6).any() or not rad.mean() > emis.mean():
        raise AssertionError("sub-4 radiosity lost energy below emission")
    print(f"    mean B {rad.mean():.5f} (emission {emis.mean():.5f})",
          flush=True)


# ---------------------------------------------------------------------------
# Four cards
# ---------------------------------------------------------------------------


def _spread(arr, n_dev: int, label: str):
    """No array of the sharded path may land wholly on one device."""
    devs = {s.device for s in arr.addressable_shards}
    if len(devs) != n_dev:
        raise AssertionError(f"{label} lives on {len(devs)} device(s)")


def phase_tiled_4k(width: int = 3840, height: int = 2160):
    import jax

    from pathtracer.ops import dispatch
    from pathtracer.parallel.sharding import TiledRenderer
    from pathtracer.render.camera import CameraController
    from pathtracer.render.renderer import ProgressiveRenderer, RenderSettings
    from pathtracer.scene.builtin import cornell_box

    n_dev = len(jax.devices())
    geom = cornell_box("quads").build()
    cam = CameraController(
        lookfrom=np.array([0.5, 3.0, 8.5], np.float32),
        lookat=np.array([0.0, 2.5, 0.0], np.float32),
        vup=np.array([0.0, 1.0, 0.0], np.float32),
        vfov=40.0, aspect=width / height,
    ).build()
    accel = dispatch.build_accel(
        geom, dispatch.select_backend("gpu", geom.num_tris)
    )
    s = RenderSettings(width=width, height=height, max_depth=5,
                       spp_per_pass=4, ray_chunk=1 << 16)
    tiled = TiledRenderer(geom, cam, s, seed=11, n_tiles=n_dev, accel=accel)
    timed(f"four.tiled {width}x{height} 4 spp over {n_dev} cards",
          lambda: (tiled.step(), tiled.film)[1])
    _spread(tiled.film.accum, n_dev, "tiled film")
    single = ProgressiveRenderer(geom, cam, s, seed=11, accel=accel)
    single.step()
    single.step()
    a = np.asarray(tiled.gather_film().accum, np.float64)
    b = np.asarray(single.film.accum, np.float64)
    check_film("tiled 4K", a)
    same = float(np.mean(a == b))
    rel = float(np.abs(a - b).sum() / np.abs(b).sum())
    print(f"    tiled vs single card: {same * 100:.4f}% of values bitwise "
          f"equal, relative L1 difference {rel:.3g}", flush=True)
    if rel > 1e-4:
        raise AssertionError("tiled 4K render disagrees with one card")


def phase_sharded_shooting(subdivision: int = 5):
    import jax

    from pathtracer.core import rng
    from pathtracer.ops import dispatch
    from pathtracer.parallel.sharding import (
        make_mesh,
        solve_radiosity_shooting_sharded,
    )
    from pathtracer.render.radiosity import solve_radiosity_shooting
    from pathtracer.scene.builtin import cornell_box
    from pathtracer.scene.mesh import subdivide

    geom = subdivide(cornell_box("quads"), subdivision).build()
    accel = dispatch.build_accel(
        geom, dispatch.select_backend("gpu", geom.num_tris)
    )
    mesh = make_mesh()
    if mesh.devices.ndim != 1:
        raise AssertionError("make_mesh must stay a flat 1-D mesh")
    kw = dict(steps=8, shooters_per_step=128, mc_samples=4,
              check_every=0, accel=accel)
    key = rng.base_key(5)
    sharded = timed(
        f"four.sharded shooting sub-{subdivision} ({geom.num_prims} "
        "prims) 8 steps",
        lambda: jax.block_until_ready(
            solve_radiosity_shooting_sharded(geom, key, mesh=mesh, **kw)),
    )
    _spread(sharded.rad_grid, mesh.devices.size, "sharded rad_grid")
    single = timed(f"four.single-card shooting sub-{subdivision} 8 steps",
                   lambda: jax.block_until_ready(
                       solve_radiosity_shooting(geom, key, **kw)))
    a = np.asarray(sharded.radiosity, np.float64)
    b = np.asarray(single.radiosity, np.float64)
    rel = float(np.abs(a - b).sum() / np.abs(b).sum())
    print(f"    sharded vs single card: max |dB| "
          f"{float(np.abs(a - b).max()):.3g}, relative L1 {rel:.3g}",
          flush=True)
    if not np.isfinite(a).all() or rel > 1e-4:
        raise AssertionError("sharded shooting disagrees with one card")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the four-card path and its comparisons")
    args = p.parse_args(argv)

    # The CPU backend stays available beside the GPU: phase (a)'s
    # reference renders run on it.
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found '{devices[0].platform}')",
              file=sys.stderr)
        return 2
    want = 4 if args.four else 1
    if len(devices) < want:
        print(f"chip_smoke: needs {want} GPUs, found {len(devices)}",
              file=sys.stderr)
        return 2
    import pathtracer  # noqa: F401  (fails outside a checkout)

    print(card_line(), flush=True)
    print(f"jax {jax.__version__}: {len(devices)} x "
          f"{devices[0].device_kind}", flush=True)
    phases = Phases()
    if args.four:
        phases.run("four.tiled_4k", phase_tiled_4k)
        phases.run("four.sharded_shooting", phase_sharded_shooting)
    else:
        phases.run("a.app", phase_app)
        phases.run("b.kernels", phase_kernels)
        phases.run("c.large_scene", phase_large_scene)
        phases.run("d.solver", phase_solver)
    if phases.failed:
        print(f"chip_smoke: FAILED phases {phases.failed}", file=sys.stderr)
        return 1
    print(result_line(devices[0].platform, devices[0].device_kind,
                      len(devices)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
