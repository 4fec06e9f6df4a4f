"""Million-triangle scene: generate it and render it through the App's path.

The reference's BVH path is nominally bounded only by its 2M-triangle
PBRT proxy guard (pbrt_loader.h:205-272); this script builds the same
scale class: a procedurally displaced sphere at ~1.004M triangles (10x
the stress100k scene), or ~2.1M with --tag 2m, past the reference's
refusal point. The scene renders through ops/dispatch (the BVH at this
size), and the script reports parse and accelerator build times, the
first pass (compile + run), the warm rate, and writes a frame.

The PLY is generated on demand into out/ (listed in .gitignore).

Usage: python benchmarks/stress1m.py [--spp 8] [--res 256] [--tag 2m]
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.join(HERE, "..")
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--tag", default="1m")
    ap.add_argument("--n", type=int, default=0,
                    help="sphere tessellation (default: 709 for 1m, "
                         "1025 for 2m)")
    args = ap.parse_args()
    n_tess = args.n or {"1m": 709, "2m": 1025}.get(args.tag, 709)

    sys.path.insert(0, os.path.join(ROOT, "scenes"))
    from generate_stress import generate

    import numpy as np

    work = os.path.join(ROOT, "out", f"stress{args.tag}")
    os.makedirs(work, exist_ok=True)
    pbrt = os.path.join(work, f"stress{args.tag}.pbrt")
    if not os.path.exists(pbrt):
        pbrt = generate(work, tag=args.tag, n=n_tess)

    from pathtracer.ops import dispatch
    from pathtracer.render.camera import CameraController
    from pathtracer.render.renderer import (
        ProgressiveRenderer,
        RenderSettings,
    )
    from pathtracer.scene.pbrt_loader import parse_pbrt
    from pathtracer.utils.png import write_png_bottom_up

    t0 = time.time()
    # Lift the reference-parity 2M proxy guard (pbrt_loader.h:205) to
    # render past it for real.
    scene = parse_pbrt(pbrt, max_triangles=1 << 31)
    geom = scene.prims.build()
    parse_s = time.time() - t0
    print(f"parsed {geom.num_tris} tris in {parse_s:.1f} s")

    t0 = time.time()
    backend = dispatch.select_backend(dispatch.current_platform(),
                                      geom.num_tris)
    accel = dispatch.build_accel(geom, backend)
    build_s = time.time() - t0
    print(f"{backend} built in {build_s:.1f} s")

    eye, tgt, up = scene.camera_lookat
    cam = CameraController(
        lookfrom=np.array(eye, np.float32),
        lookat=np.array(tgt, np.float32),
        vup=np.array(up, np.float32),
        vfov=scene.camera_fov or 40.0,
        aspect=1.0,
    ).build()
    s = RenderSettings(
        width=args.res, height=args.res, max_depth=args.depth,
        spp_per_pass=args.spp, ray_chunk=1 << 16, wavefront=True,
        balance_lanes=4,
    )
    r = ProgressiveRenderer(geom, cam, s, accel=accel)
    t0 = time.time()
    r.step()   # compile + warmup
    first_s = time.time() - t0
    r.reset_stats()
    t0 = time.time()
    passes = 0
    while passes < 3 or (time.time() - t0 < 8.0 and passes < 12):
        r.step(block=False)
        passes += 1
    r.sync()
    rate = r.mrays_per_sec
    print(f"first pass {first_s:.1f} s; {passes} passes -> "
          f"{rate:.2f} Mrays/s")

    out = os.path.join(work, f"stress{args.tag}.png")
    write_png_bottom_up(out, np.asarray(r.film.to_srgb()))
    print(f"wrote {out}")
    print(json.dumps({
        "tris": int(geom.num_tris),
        "backend": backend,
        "parse_s": round(parse_s, 1),
        "accel_build_s": round(build_s, 1),
        "first_pass_s": round(first_s, 1),
        "mrays_per_sec": round(rate, 2),
        "settings": f"{args.res}^2@{args.spp}spp depth{args.depth}",
    }))


if __name__ == "__main__":
    main()
