"""Equal-spp RMSE evaluation: guided sampling vs BSDF sampling.

The accuracy metric is "<=1% RMSE vs the reference at equal spp at
convergence". The CUDA reference cannot execute in this environment, so
ground truth is this renderer's own converged accumulation (all estimators
here are unbiased for the same integral and statistically validated against
closed forms in tests/; at 1024+ spp the converged image is the common
fixed point). This harness:

  1. renders (or loads) a high-spp ground truth;
  2. renders each sampling mode at a low spp budget;
  3. reports per-mode RMSE relative to ground truth — demonstrating the
     radiosity-guided variance reduction that is the reference's research
     contribution.

Run: python benchmarks/eval_rmse.py [--res 256] [--gt-spp 4096]
     [--test-spp 64] [--out eval_rmse.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def render_mode(mode: str, spp: int, res: int, seed: int,
                subdivision: int = 1, mis_fraction: float = 0.5):
    from pathtracer.app import App
    from pathtracer.utils.config import Config

    nee = mode.endswith("+nee")
    if nee:
        mode = mode[: -len("+nee")]
    cfg = Config(
        scene="cbox_quads", width=res, height=res, spp=spp, max_depth=5,
        sampling_mode=mode, subdivision=subdivision, nee=nee,
        radiosity_iterations=10, mis_bsdf_fraction=mis_fraction,
        mc_samples=64, ray_chunk=1 << 16,
        spp_per_pass=min(32, spp), seed=seed,
    )
    app = App(cfg)
    r = app.renderer()
    r.render(spp)
    return np.asarray(r.film.mean_radiance())


def rel_rmse(img: np.ndarray, gt: np.ndarray) -> float:
    err = np.sqrt(np.mean((img - gt) ** 2))
    scale = max(float(np.sqrt(np.mean(gt**2))), 1e-9)
    return float(err / scale)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--res", type=int, default=256)
    p.add_argument("--gt-spp", type=int, default=4096)
    p.add_argument("--test-spp", type=int, default=64)
    p.add_argument("--subdivision", type=int, default=1)
    p.add_argument("--mis-fraction", type=float, default=0.5)
    p.add_argument("--out", type=str, default="")
    p.add_argument(
        "--nee-ladder", action="store_true",
        help="measure the NEE x guided composition: bsdf / mis with and "
             "without next-event estimation at the given subdivision",
    )
    args = p.parse_args(argv)

    # The NEE ladder probes estimators ~7x below BSDF noise, so its ground
    # truth is rendered WITH next-event estimation (same fixed point — all
    # modes are unbiased; tests enforce the furnace mean) to push the GT
    # noise floor well under the best candidate (~0.002 vs ~0.02).
    gt_mode = "bsdf+nee" if args.nee_ladder else "bsdf"
    gt_tag = "_nee" if args.nee_ladder else ""
    gt_path = os.path.join(
        os.path.dirname(__file__),
        f"gt_cbox_{args.res}_{args.gt_spp}{gt_tag}.npy",
    )
    if os.path.exists(gt_path):
        gt = np.load(gt_path)
        print(f"loaded ground truth {gt_path}")
    else:
        print(f"rendering ground truth ({gt_mode}, {args.gt_spp} spp)...")
        gt = render_mode(gt_mode, args.gt_spp, args.res, seed=999)
        np.save(gt_path, gt)

    modes = ("bsdf", "radiosity", "mis")
    if args.nee_ladder:
        modes = ("bsdf", "bsdf+nee", "radiosity", "radiosity+nee",
                 "mis", "mis+nee")
    results = {}
    for mode in modes:
        img = render_mode(mode, args.test_spp, args.res, seed=7,
                          subdivision=args.subdivision,
                          mis_fraction=args.mis_fraction)
        r = rel_rmse(img, gt)
        results[mode] = r
        print(f"{mode:<10} @ {args.test_spp} spp: rel RMSE {r:.4f}")

    if results["mis"] < results["bsdf"]:
        gain = results["bsdf"] / results["mis"]
        print(f"guided MIS reduces RMSE {gain:.2f}x vs BSDF at equal spp")
    if args.nee_ladder:
        for a, b in (("bsdf", "bsdf+nee"), ("mis", "mis+nee"),
                     ("radiosity", "radiosity+nee"),
                     ("bsdf", "mis+nee")):
            if results[b] < results[a]:
                print(f"{b} vs {a}: {results[a] / results[b]:.2f}x lower "
                      "RMSE at equal spp")
    out = {
        "resolution": args.res,
        "gt_spp": args.gt_spp,
        "test_spp": args.test_spp,
        "subdivision": args.subdivision,
        "mis_fraction": args.mis_fraction,
        "nee_ladder": bool(args.nee_ladder),
        "rel_rmse": results,
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
