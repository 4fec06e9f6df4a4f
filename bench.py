"""Benchmark: wavefront path-tracing throughput across the render configs.

Prints ONE JSON line: {"metric", "value", "unit", "device", "extra"}.
The headline is cbox 1024x1024, depth 5, BSDF sampling. "extra" carries
the other configs measured in the same run:
  cbox1024_mis      — guided MIS sampling, same scene
  cbox512_mirror    — 512x512 depth-8 mirror tall box
  stress100k        — 101k-tri pbrt scene through the BVH
  flops_util        — ray-triangle test FLOP/s of the headline over the
                      card's published FP32 peak (PEAKS below)
Every scene goes through ops/dispatch, the path the App takes.

Timing is pipelined: n passes issued back-to-back, one device sync at
the end.
"""

import json
import sys
import time

# --- physical-plausibility guard -----------------------------------------
# bench.py refuses to print a number the hardware cannot produce: a broken
# device barrier once inflated a headline ~1500x. The ceiling is the
# card's published FP32 rate, keyed by jax device_kind; a device that is
# not in the table is an error, not a default.
PEAKS = {
    # NVIDIA H100 SXM data sheet: 67 TFLOP/s FP32 (non-tensor),
    # 3.35 TB/s HBM3, at the 700 W power limit.
    "NVIDIA H100 80GB HBM3": {"fp32_flops": 67e12, "hbm_bytes": 3.35e12},
}
FLOPS_PER_TEST = 40.0   # affine t/u/v ray-triangle test + min/id reduce


class ImplausibleBenchmark(BaseException):
    """Deliberately BaseException-derived: every per-config block in
    main() degrades failures to an 'error: ...' extra field via
    `except Exception`, but an impossible number must abort the WHOLE
    bench (no JSON line printed) rather than be reported politely."""


def peaks(device_kind):
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ImplausibleBenchmark(
            f"no published peaks for device kind '{device_kind}'; add its "
            "data-sheet figures to bench.PEAKS"
        ) from None


def check_physical(name, mrays, device_kind, num_tris=None,
                   all_pairs=False):
    """Raise if a measured throughput exceeds what the card can do: every
    traced ray costs at least one ray-triangle test (num_tris of them
    for an all-pairs backend) at FLOPS_PER_TEST FP32 operations."""
    tests_per_ray = num_tris if all_pairs and num_tris else 1
    ceiling = peaks(device_kind)["fp32_flops"] / (
        FLOPS_PER_TEST * tests_per_ray
    ) / 1e6
    if mrays > ceiling:
        raise ImplausibleBenchmark(
            f"bench '{name}': {mrays:.1f} Mrays/s exceeds the "
            f"{ceiling:.0f} Mrays/s that {device_kind}'s published FP32 "
            f"peak allows at {tests_per_ray} test(s) per ray — the timing "
            "barrier did not drain the dispatch queue; refusing to report."
        )


def _bench_renderer(r, min_passes=3, min_seconds=6.0, max_passes=16):
    """Warmup one pass, then pipelined timed passes; returns Mrays/s."""
    r.step()  # compile + warmup
    r.reset_stats()
    t0 = time.time()
    passes = 0
    while passes < min_passes or (
        time.time() - t0 < min_seconds and passes < max_passes
    ):
        r.step(block=False)
        passes += 1
    r.sync()
    # wall seconds per sample-per-pixel, for cross-config cost ratios
    r.bench_wall_per_spp = r.render_seconds / (
        passes * r.settings.spp_per_pass
    )
    return r.mrays_per_sec


def main():
    import dataclasses

    import jax
    import numpy as np

    from pathtracer.ops import dispatch
    from pathtracer.render.camera import CameraController
    from pathtracer.render.renderer import (
        ProgressiveRenderer,
        RenderSettings,
    )
    from pathtracer.scene.builtin import cornell_box

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"bench.py measures the GPU; JAX found '{dev.platform}'"
        )
    kind = dev.device_kind
    peaks(kind)   # unknown device kinds stop here, before any work
    extra = {}

    def accel_for(geom):
        backend = dispatch.select_backend(dev.platform, geom.num_tris)
        return backend, dispatch.build_accel(geom, backend)

    def check(name, mrays, geom, backend):
        check_physical(name, mrays, kind, geom.num_tris,
                       all_pairs=backend != "bvh")

    # --- headline: cbox 1024^2 depth 5, BSDF ---
    geom = cornell_box("quads").build()
    cam = CameraController.default().build()
    backend, accel = accel_for(geom)
    extra["cbox_backend"] = backend
    settings = RenderSettings(
        width=1024, height=1024, max_depth=5, spp_per_pass=16,
        ray_chunk=1 << 16, wavefront=True,
    )
    r_head = ProgressiveRenderer(geom, cam, settings, accel=accel)
    mrays = _bench_renderer(r_head)
    check("headline", mrays, geom, backend)
    # Achieved ray-triangle test FLOP/s over the published FP32 peak:
    # every ray tests every scene triangle at ~FLOPS_PER_TEST flops.
    extra["flops_util_headline"] = round(
        mrays * 1e6 * geom.num_tris * FLOPS_PER_TEST
        / peaks(kind)["fp32_flops"], 4
    )

    # --- config #3: full progressive accumulation, 1024^2 @ 1024 spp ---
    # End-to-end wall seconds (compile excluded via a warmup pass whose
    # 16 spp count toward the total).
    try:
        r3 = ProgressiveRenderer(geom, cam, settings, accel=accel)
        r3.step()
        r3.sync()
        r3.reset_stats()
        t0 = time.time()
        r3.render(1024)
        wall3 = time.time() - t0
        extra["cbox1024_progressive_s"] = round(wall3, 2)
        extra["cbox1024_progressive"] = round(
            r3.total_rays / 1e6 / wall3, 1
        )
        check("cbox1024_progressive", extra["cbox1024_progressive"],
              geom, backend)
    except Exception as e:  # noqa: BLE001
        extra["cbox1024_progressive"] = f"error: {e}"

    # --- guided MIS on the same scene (needs radiosity + CDFs) ---
    try:
        from pathtracer.core.constants import SAMPLING_MIS
        from pathtracer.core.math_utils import luminance
        from pathtracer.ops.guiding import build_cdfs
        from pathtracer.render.radiosity import solve_radiosity

        sol = solve_radiosity(geom, jax.random.key(12345),
                              num_iterations=10, mc_samples=64,
                              accel=accel)
        cdfs = build_cdfs(luminance(sol.rad_grid))
        s_mis = dataclasses.replace(settings, sampling_mode=SAMPLING_MIS)
        r = ProgressiveRenderer(geom, cam, s_mis, cdfs=cdfs,
                                mis_bsdf_fraction=0.5, accel=accel)
        extra["cbox1024_mis"] = round(_bench_renderer(r), 2)
        check("cbox1024_mis", extra["cbox1024_mis"], geom, backend)
    except Exception as e:  # noqa: BLE001
        extra["cbox1024_mis"] = f"error: {e}"

    # --- config #2: 512^2, depth 8, mirror tall box ---
    try:
        geom_m = cornell_box("quads", mirror_tall_box=True).build()
        backend_m, accel_m = accel_for(geom_m)
        s2 = RenderSettings(
            width=512, height=512, max_depth=8, spp_per_pass=32,
            ray_chunk=1 << 16, wavefront=True,
        )
        extra["cbox512_mirror"] = round(
            _bench_renderer(ProgressiveRenderer(geom_m, cam, s2,
                                                accel=accel_m)),
            2,
        )
        check("cbox512_mirror", extra["cbox512_mirror"], geom_m,
              backend_m)
    except Exception as e:  # noqa: BLE001
        extra["cbox512_mirror"] = f"error: {e}"

    # --- next-event estimation cost: config #1 with nee=True ---
    # Shadow rays are counted in total_rays, so this Mrays/s is
    # work-honest; nee_wall_per_spp_ratio is the per-spp wall cost
    # multiplier vs the headline.
    try:
        s_nee = dataclasses.replace(settings, nee=True)
        r_nee = ProgressiveRenderer(geom, cam, s_nee, accel=accel)
        extra["cbox1024_nee"] = round(_bench_renderer(r_nee), 2)
        check("cbox1024_nee", extra["cbox1024_nee"], geom, backend)
        extra["nee_wall_per_spp_ratio"] = round(
            r_nee.bench_wall_per_spp / r_head.bench_wall_per_spp, 2
        )
    except Exception as e:  # noqa: BLE001
        extra["cbox1024_nee"] = f"error: {e}"

    # --- next-event estimation quality: RMSE gain at equal spp ---
    # cbox 128^2 depth-5, 16 spp, both estimators against a 1024-spp
    # NEE reference. Value = rmse_bsdf / rmse_nee (>=2x is the
    # test-enforced floor).
    try:
        def _film(nee, spp, seed):
            s_n = RenderSettings(
                width=128, height=128, max_depth=5, spp_per_pass=spp,
                ray_chunk=1 << 14, nee=nee,
            )
            r_n = ProgressiveRenderer(geom, cam, s_n, seed=seed,
                                      accel=accel)
            r_n.step()
            return np.asarray(r_n.film.accum, np.float64) / spp

        ref_f = _film(True, 1024, 1)
        rmse_b = np.sqrt(np.mean((_film(False, 16, 2) - ref_f) ** 2))
        rmse_n = np.sqrt(np.mean((_film(True, 16, 3) - ref_f) ** 2))
        extra["nee_rmse_gain_16spp"] = round(float(rmse_b / rmse_n), 2)
    except Exception as e:  # noqa: BLE001
        extra["nee_rmse_gain_16spp"] = f"error: {e}"

    # --- 4K cbox render on one card ---
    try:
        s4k = RenderSettings(
            width=4096, height=2160, max_depth=4, spp_per_pass=4,
            ray_chunk=1 << 16, wavefront=True,
        )
        r4k = ProgressiveRenderer(geom, cam, s4k, accel=accel)
        extra["cbox4k"] = round(
            _bench_renderer(r4k, min_passes=2, min_seconds=3.0,
                            max_passes=6), 2
        )
        check("cbox4k", extra["cbox4k"], geom, backend)
    except Exception as e:  # noqa: BLE001
        extra["cbox4k"] = f"error: {e}"

    # --- 101k-tri pbrt stress scene through the BVH ---
    try:
        from pathtracer.scene.pbrt_loader import parse_pbrt

        scene = parse_pbrt("scenes/stress100k.pbrt")
        geom_s = scene.prims.build()
        backend_s, accel_s = accel_for(geom_s)
        eye, tgt, up = scene.camera_lookat
        cam_s = CameraController(
            lookfrom=np.array(eye, np.float32),
            lookat=np.array(tgt, np.float32),
            vup=np.array(up, np.float32),
            vfov=scene.camera_fov or 40.0,
            aspect=1.0,
        ).build()
        s4 = RenderSettings(
            width=256, height=256, max_depth=4, spp_per_pass=8,
            ray_chunk=1 << 16, wavefront=True,
            balance_lanes=4,   # cost-balanced 4-pixel lane queues: the
                               # open scene parks miss lanes early; film
                               # is bitwise identical either way
        )
        r_s = ProgressiveRenderer(geom_s, cam_s, s4, accel=accel_s)
        extra["stress100k"] = round(
            _bench_renderer(r_s, min_seconds=3.0, max_passes=8), 2
        )
        check("stress100k", extra["stress100k"], geom_s, backend_s)
        r_sn = ProgressiveRenderer(
            geom_s, cam_s, dataclasses.replace(s4, nee=True),
            accel=accel_s,
        )
        extra["stress100k_nee"] = round(
            _bench_renderer(r_sn, min_seconds=3.0, max_passes=8), 2
        )
        extra["stress100k_nee_wall_per_spp_ratio"] = round(
            r_sn.bench_wall_per_spp / r_s.bench_wall_per_spp, 2
        )
    except Exception as e:  # noqa: BLE001
        extra["stress100k"] = f"error: {e}"

    print(
        json.dumps(
            {
                "metric": "pathtrace_throughput_cbox1024",
                "value": round(mrays, 2),
                "unit": "Mrays/sec",
                "device": {"platform": dev.platform, "kind": kind,
                           "count": len(jax.devices())},
                "extra": extra,
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
