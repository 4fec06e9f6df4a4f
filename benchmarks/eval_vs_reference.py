"""Cross-renderer accuracy: our renders vs the CUDA reference's own PNGs.

The reference repo publishes its renders (outputs/cbox_pt_23.png and the
radiosity sweep cbox_sub{N}_step{M}.png) produced from its default view
(camera (0.5,3,8.5) -> (0,2.5,0), fov 40, AppConfig at
application_state.h:282-292) of scenes/cbox_quads.obj at the GLFW
framebuffer size 1085x1026. This script loads that same scene file and
camera, re-renders each view with our renderer, and reports RMSE — the
"<=1% RMSE vs CUDA reference" check.

The radiosity sweep is near-deterministic (MC form factors average out at
64 samples/pair), so those views must match tightly. The path-traced view
is stochastic; for it we also render OUR OWN frame at the reference's
sample count and report its RMSE against our converged render — if the
cross-renderer residual matches that self-noise yardstick, the estimator
agrees and the difference is MC variance, not bias.

Usage (REFERENCE_DIR names the reference's checkout; it is required):
  python benchmarks/eval_vs_reference.py radiosity          # sub0..3, step5
  python benchmarks/eval_vs_reference.py radiosity4         # sub4 step0..10
  python benchmarks/eval_vs_reference.py pt [--spp 1024]
Results accumulate in benchmarks/eval_vs_reference_result.json; our
renders land in outputs/ref_compare/.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

HERE = os.path.dirname(os.path.abspath(__file__))
RESULT = os.path.join(HERE, "eval_vs_reference_result.json")
OUT_DIR = os.path.join(HERE, "..", "outputs", "ref_compare")
W, H = 1085, 1026  # reference framebuffer size (its saved PNGs)
# The reference's renderFrame() calls updateCameraOrbit() every frame
# (application.h:162), which REPLACES the configured camera_origin with
# a (yaw, pitch, radius) orbit around look_at (sensor.h:57-68) — and its
# published PNGs were captured from a hand-orbited view, not the yaw=90
# pitch=0 default. We recover that view by least-squares fitting
# (yaw, pitch, R, fov) to the projected pixel bounding boxes of two
# known scene features (the light quad and the room's front opening) in
# cbox_sub2_step5.png; the fit is sub-pixel (see _fit_cam derivation:
# yaw 87.8deg, pitch -3.8deg, R 8.36, fov 40.5 -> max bbox error <1.2px).
_YAW, _PITCH, _R, CAM_FOV = 87.8, -3.8, 8.36, 40.5
_yr, _pr = np.radians(_YAW), np.radians(_PITCH)
CAM_ORIGIN = tuple(
    np.array([0.0, 2.5, 0.0])
    + _R * np.array([np.cos(_pr) * np.cos(_yr), np.sin(_pr),
                     np.cos(_pr) * np.sin(_yr)])
)
CAM_LOOKAT = (0.0, 2.5, 0.0)


def reference_path(*parts: str) -> str:
    """A file of the CUDA reference's checkout (USharma002/CUDA-PathTracer),
    whose scene file and published PNGs are the ground truth compared
    against. Its location is given by REFERENCE_DIR; there is no default."""
    root = os.environ.get("REFERENCE_DIR")
    if not root:
        raise SystemExit(
            "eval_vs_reference: set REFERENCE_DIR to a checkout of "
            "USharma002/CUDA-PathTracer (it needs scenes/cbox_quads.obj "
            "and outputs/*.png)"
        )
    return os.path.join(root, *parts)


def load_ref_png(name: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(
        Image.open(reference_path("outputs", name)).convert("RGB"))


def edge_mask(img_u8: np.ndarray, dilate: int = 2) -> np.ndarray:
    """True at pixels near strong image gradients (prim silhouettes),
    where sub-pixel jitter differences dominate any estimator error."""
    g = img_u8.astype(np.int16)
    gx = np.zeros(img_u8.shape[:2], bool)
    gx[:, 1:] |= (np.abs(np.diff(g, axis=1)).max(-1) > 8)
    gx[1:, :] |= (np.abs(np.diff(g, axis=0)).max(-1) > 8)
    for _ in range(dilate):
        m = gx.copy()
        m[1:, :] |= gx[:-1, :]
        m[:-1, :] |= gx[1:, :]
        m[:, 1:] |= gx[:, :-1]
        m[:, :-1] |= gx[:, 1:]
        gx = m
    return gx


def compare(ours_u8: np.ndarray, ref_u8: np.ndarray) -> dict:
    assert ours_u8.shape == ref_u8.shape, (ours_u8.shape, ref_u8.shape)
    d = ours_u8.astype(np.float64) - ref_u8.astype(np.float64)
    rmse = float(np.sqrt((d ** 2).mean()))
    interior = ~edge_mask(ref_u8)
    di = d[interior]
    return {
        "rmse_8bit": round(rmse, 3),
        "rel_rmse": round(rmse / 255.0, 5),
        "interior_rmse_8bit": round(float(np.sqrt((di ** 2).mean())), 3),
        "interior_rel_rmse": round(float(np.sqrt((di ** 2).mean())) / 255.0, 5),
        "interior_frac": round(float(interior.mean()), 3),
    }


def build_geom(sub: int, convert_quads: bool = True):
    """Reproduce the reference's scene pipeline for its published sweep
    renders: the per-triangle shading structure in those PNGs shows they
    were produced with quad->triangle conversion ON
    (convertQuadsToTriangles, application_state.h:323-366) before
    subdivision."""
    from pathtracer.scene.mesh import (
        convert_quads_to_triangles,
        subdivide,
    )
    from pathtracer.scene.obj_loader import load_obj

    prims = load_obj(reference_path("scenes", "cbox_quads.obj"))
    if convert_quads:
        prims = convert_quads_to_triangles(prims)
    if sub:
        prims = subdivide(prims, sub)
    return prims.build()


def camera():
    from pathtracer.render.camera import CameraController

    return CameraController(
        lookfrom=np.array(CAM_ORIGIN, np.float32),
        lookat=np.array(CAM_LOOKAT, np.float32),
        vup=np.array([0.0, 1.0, 0.0], np.float32),
        vfov=CAM_FOV,
        aspect=W / H,
    ).build()


def save_result(key: str, value: dict) -> None:
    data = {}
    if os.path.exists(RESULT):
        with open(RESULT) as f:
            data = json.load(f)
    data[key] = value
    with open(RESULT, "w") as f:
        json.dump(data, f, indent=2)
    print(key, "->", json.dumps(value))


def save_png(name: str, img_u8: np.ndarray) -> None:
    from pathtracer.utils.png import write_png

    os.makedirs(OUT_DIR, exist_ok=True)
    write_png(os.path.join(OUT_DIR, name), img_u8)


def render_radiosity_view(geom, radiosity, spp: int,
                          accel=None) -> np.ndarray:
    import jax

    from pathtracer.render.renderer import (
        RenderSettings,
        render_radiosity_view as rrv,
    )

    s = RenderSettings(
        width=W, height=H, spp_per_pass=spp, ray_chunk=65536,
    )
    img = rrv(geom, radiosity, camera(), jax.random.key(7), s,
              accel=accel)
    return np.asarray(img)[::-1]  # row 0 = top, like the reference PNG


def run_radiosity(subs, steps, spp, yardstick=False):
    import jax

    from pathtracer.ops import dispatch
    from pathtracer.render.radiosity import solve_radiosity

    for sub in subs:
        geom = build_geom(sub)
        # FF visibility through the App's intersection path for this
        # platform and scene size (like App.run_solver)
        accel = dispatch.build_accel(geom, dispatch.select_backend(
            dispatch.current_platform(), geom.num_tris))
        n_iter = max(steps)
        sol = solve_radiosity(
            geom, jax.random.key(12345), num_iterations=n_iter,
            use_monte_carlo=True, mc_samples=64, accel=accel,
        )
        sol_b = None
        if yardstick:
            # a second solve with an independent MC sample stream: the
            # RMSE between our own two renders is the expected residual
            # from form-factor MC variance alone — if ours-vs-reference
            # matches it, the estimators agree and the difference is
            # noise, not bias.
            sol_b = solve_radiosity(
                geom, jax.random.key(99991), num_iterations=n_iter,
                use_monte_carlo=True, mc_samples=64, accel=accel,
            )
        for step in steps:
            if step == n_iter:
                rad = sol.radiosity
            else:
                # history_at(k) = k steps back from the latest entry
                # (which is B after n_iter-1 iterations)
                rad = sol.history_at(n_iter - 1 - step)
            ours = render_radiosity_view(geom, rad, spp, accel)
            name = f"cbox_sub{sub}_step{step}.png"
            ref = load_ref_png(name)
            save_png(name, ours)
            save_result(f"radiosity/{name}", compare(ours, ref))
            if sol_b is not None and step == n_iter:
                rad_b = sol_b.radiosity
                ours_b = render_radiosity_view(geom, rad_b, spp, accel)
                save_result(
                    f"radiosity/cbox_sub{sub}_selfnoise",
                    {**compare(ours, ours_b),
                     "note": "our render vs our render, independent "
                             "MC FF streams — expected noise floor"},
                )


def run_pt(spp: int, ref_spp: int, depth: int):
    import jax

    from pathtracer.render.camera import CameraController
    from pathtracer.render.renderer import (
        ProgressiveRenderer,
        RenderSettings,
    )

    geom = build_geom(0)
    ref = load_ref_png("cbox_pt_23.png")

    def render(total_spp, tag):
        s = RenderSettings(
            width=W, height=H, max_depth=depth,
            spp_per_pass=1, ray_chunk=65536,
        )
        r = ProgressiveRenderer(geom, camera(), s)
        r.render(total_spp)
        img = np.asarray(r.film.to_image())
        save_png(f"cbox_pt_{tag}.png", img)
        return img

    converged = render(spp, f"{spp}")
    ours_ref_spp = render(ref_spp, f"{ref_spp}")
    save_result("pt/converged_vs_reference",
                compare(converged, ref))
    save_result("pt/self_noise_yardstick",
                {**compare(ours_ref_spp, converged),
                 "note": f"our {ref_spp}spp frame vs our {spp}spp frame; "
                         "cross-renderer residual at or below this level "
                         "is MC variance, not estimator bias"})


def downsample(img_u8: np.ndarray, k: int = 8) -> np.ndarray:
    h, w, c = img_u8.shape
    h2, w2 = (h // k) * k, (w // k) * k
    x = img_u8[:h2, :w2].astype(np.float64)
    return x.reshape(h2 // k, k, w2 // k, k, c).mean((1, 3))


def run_pt_downsampled(k: int = 8):
    """Full-frame comparison at kx box-downsampled
    resolution, where MC noise averages out (~1/k per axis) and estimator
    BIAS survives. Uses the saved renders from `pt` (same camera/settings):
      cross = ref 23spp  vs our 256spp   (bias + both noises)
      yard  = our 23spp  vs our 256spp   (pure noise at the same spp)
    bias_bound = sqrt(max(cross^2 - yard^2, 0)) — the estimator-difference
    residual covering ~100% of the frame (no edge mask)."""
    ref = load_ref_png("cbox_pt_23.png").astype(np.float64)
    ours_conv = np.asarray(
        _open_ours("cbox_pt_256.png"), np.float64)
    ours_23 = np.asarray(_open_ours("cbox_pt_23.png"), np.float64)

    def rel_rmse(a, b):
        d = downsample(a.astype(np.uint8), k) - downsample(
            b.astype(np.uint8), k)
        return float(np.sqrt((d ** 2).mean())) / 255.0

    cross = rel_rmse(ref, ours_conv)
    yard = rel_rmse(ours_23, ours_conv)
    bias = float(np.sqrt(max(cross ** 2 - yard ** 2, 0.0)))
    save_result(f"pt/downsampled_{k}x", {
        "cross_rel_rmse": round(cross, 5),
        "noise_yardstick_rel_rmse": round(yard, 5),
        "bias_bound_rel_rmse": round(bias, 5),
        "frame_coverage": 1.0,
        "note": f"{k}x box-downsampled full-frame; cross = ref23 vs "
                f"our256, yardstick = our23 vs our256 (same-spp noise); "
                f"bias_bound = sqrt(cross^2 - yard^2)",
    })


def _open_ours(name: str):
    from PIL import Image

    return np.asarray(
        Image.open(os.path.join(OUT_DIR, name)).convert("RGB"))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("which", choices=["radiosity", "radiosity4", "pt",
                                     "pt_downsampled"])
    p.add_argument("--spp", type=int, default=0)
    p.add_argument("--ref-spp", type=int, default=23)
    p.add_argument("--depth", type=int, default=5)
    p.add_argument("--yardstick", action="store_true")
    args = p.parse_args()
    if args.which == "pt_downsampled":
        run_pt_downsampled()
    elif args.which == "radiosity":
        run_radiosity(subs=(0, 1, 2, 3), steps=(5,), spp=args.spp or 16,
                      yardstick=args.yardstick)
    elif args.which == "radiosity4":
        run_radiosity(subs=(4,), steps=tuple(range(11)),
                      spp=args.spp or 16, yardstick=args.yardstick)
    else:
        run_pt(args.spp or 1024, args.ref_spp, args.depth)


if __name__ == "__main__":
    main()
