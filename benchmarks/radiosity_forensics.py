"""Root-cause the radiosity sweep residual against the reference PNGs.

The reference's sweep PNGs (cbox_sub{N}_step{M}.png) are flat-shaded
per primitive: every interior pixel of prim i displays
sqrt(min(Le_i + B_i, 1)) (render_radiosity, integrator.h:460-504).
So we can invert the display transform and read the reference's actual
per-primitive B vector off its PNG — no camera-noise, no MC-noise, no
edge-mask arguments — and compare it against candidate solves:

  * mc64    — our solver, reference defaults (MC FF, 64 samples/pair)
  * mc64b   — same, independent RNG stream (noise yardstick)
  * analytic— our solver, point-to-point centroid FF kernel
             (calculate_form_factors_kernel, form_factors.h:354-404)

plus knob variants (no adaptive sampling, no FF clamp, per-sample
estimator) when --variants is set.

Per-prim extraction: render a primary-hit prim-id map at the reference
camera, erode it so only pixels >=2px inside a prim survive, take the
median reference color over each prim's pixels, invert gamma. Channels
at the u8 clamp (>=253) are excluded (the min(...,1) display clamp).

Usage:
  python benchmarks/radiosity_forensics.py --sub 0 [--cpu] [--variants]
Writes benchmarks/radiosity_forensics_result.json (accumulates by sub).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from eval_vs_reference import (  # noqa: E402
    W, H, build_geom, camera, load_ref_png,
)

HERE = os.path.dirname(os.path.abspath(__file__))
RESULT = os.path.join(HERE, "radiosity_forensics_result.json")


def prim_id_map(geom, accel=None) -> np.ndarray:
    """(H, W) int32 primary-hit prim id at pixel centers, -1 on miss;
    row 0 = top (matching the reference PNG orientation)."""
    import jax
    import jax.numpy as jnp

    from pathtracer.render.integrator import trace_primary

    cam = camera()
    ids = np.full((H * W,), -1, np.int32)
    # brute intersect materializes (chunk, T) intermediates — cap them
    # at ~64 MB
    chunk = min(1 << 16, max(2048, (1 << 24) // max(geom.num_tris, 1)))

    @jax.jit
    def run(lane):
        x = (lane % W).astype(jnp.float32)
        y = (lane // W).astype(jnp.float32)
        u = (x + 0.5) / W
        v = (y + 0.5) / H
        o, d = cam.get_rays(u, v)
        hit = trace_primary(geom, o, d, accel)
        return jnp.where(hit.valid, hit.prim, -1)

    # dispatch all chunks, fetch once
    outs = []
    for s in range(0, H * W, chunk):
        lane = jnp.arange(s, min(s + chunk, H * W), dtype=jnp.int32)
        pad = chunk - lane.shape[0]
        if pad:
            lane = jnp.concatenate([lane, jnp.zeros((pad,), jnp.int32)])
        outs.append((s, pad, run(lane)))
    for s, pad, out in outs:
        ids[s:s + chunk - pad] = np.asarray(out)[:chunk - pad]
    return ids.reshape(H, W)[::-1]  # flip to row0=top


def erode(mask: np.ndarray, it: int = 2) -> np.ndarray:
    m = mask.copy()
    for _ in range(it):
        e = m.copy()
        e[1:, :] &= m[:-1, :]
        e[:-1, :] &= m[1:, :]
        e[:, 1:] &= m[:, :-1]
        e[:, :-1] &= m[:, 1:]
        m = e
    return m


def extract_ref_med(ref_u8: np.ndarray, ids: np.ndarray, n: int):
    """Per-prim mean displayed u8 color over interior pixels (pixels whose
    2-px neighborhood shares one prim id), vectorized via bincount —
    O(image), usable at sub-4's 4096 prims.

    Returns (med (N,3) float, npix (N,)); NaN where a prim has fewer
    than 25 interior pixels."""
    interior = ids >= 0
    for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1),
                   (2, 0), (-2, 0), (0, 2), (0, -2),
                   (1, 1), (1, -1), (-1, 1), (-1, -1)):
        shifted = np.roll(np.roll(ids, dy, 0), dx, 1)
        interior &= shifted == ids
    flat_ids = ids[interior]
    npx = np.bincount(flat_ids, minlength=n).astype(np.int64)
    med = np.full((n, 3), np.nan, np.float64)
    for c in range(3):
        s = np.bincount(flat_ids, weights=ref_u8[interior][:, c],
                        minlength=n)
        med[:, c] = np.where(npx >= 25, s / np.maximum(npx, 1), np.nan)
    return med, npx


def summarize(tag, b_ours, b_ref, ok):
    sel = ok & np.isfinite(b_ref)
    d = (np.asarray(b_ours, np.float64) - b_ref)[sel]
    r = b_ref[sel]
    rel = float(np.sqrt((d ** 2).mean()) / max(np.sqrt((r ** 2).mean()),
                                               1e-12))
    return {
        "rel_rmse_B": round(rel, 5),
        "mean_signed": round(float(d.mean()), 6),
        "max_abs": round(float(np.abs(d).max()), 6),
        "channels": int(sel.sum()),
    }


def per_sample_ff(geom, key, n_samples, accel):
    """Unbiased double-area MC form factors (experiment):
    F_ij = A_j/pi * mean_s[vis * ci * cj / d^2], clamp [0,1], no
    adaptive sample counts. Same sampling/visibility machinery as
    mc_form_factors, different combiner."""
    import jax
    import jax.numpy as jnp

    from pathtracer.core.math_utils import PI, dot
    from pathtracer.ops import dispatch
    from pathtracer.render.radiosity import (
        _pair_culling,
        sample_uniform_on_prims,
    )

    n = geom.num_prims
    rc = min(16, n)

    @jax.jit
    def do_rows(rows):
        dn_c, dist_c, cos_i_c, cos_j_c, facing = _pair_culling(geom, rows)
        ni = geom.normal[rows][:, None, :]
        nj = geom.normal[None, :, :]
        rows_b = jnp.broadcast_to(rows[:, None], dist_c.shape)
        cols_b = jnp.broadcast_to(
            jnp.arange(n)[None, :], dist_c.shape)

        def one_sample(acc, s):
            skey = jax.random.fold_in(jax.random.fold_in(key, rows[0]), s)
            u = jax.random.uniform(skey, (4,) + dist_c.shape)
            p_i = sample_uniform_on_prims(geom, rows_b, u[0], u[1])
            p_j = sample_uniform_on_prims(geom, cols_b, u[2], u[3])
            seg = p_j - p_i
            r = jnp.linalg.norm(seg, axis=-1)
            sd = seg / jnp.maximum(r, 1e-20)[..., None]
            ct_i = dot(ni, sd)
            ct_j = -dot(nj, sd)
            active = (r >= 1e-6) & (ct_i > 0.0) & (ct_j > 0.0) & facing
            flat = lambda x: x.reshape(-1, *x.shape[2:])
            blocked = dispatch.occluded(
                geom, accel, flat(p_i + ni * 1e-4 * jnp.ones_like(sd)),
                flat(sd), flat(r - 2e-4), flat(rows_b), flat(cols_b),
            ).reshape(r.shape)
            ok = active & ~blocked
            est = jnp.where(
                ok, ct_i * ct_j / jnp.maximum(r * r, 1e-12), 0.0)
            return acc + est, None

        acc, _ = jax.lax.scan(
            one_sample, jnp.zeros(dist_c.shape, jnp.float32),
            jnp.arange(n_samples))
        ff = acc / n_samples * geom.area[None, :] / PI
        return jnp.clip(ff, 0.0, 1.0)

    import numpy as _np
    npad = ((n + rc - 1) // rc) * rc
    row_ids = _np.where(_np.arange(npad) < n, _np.arange(npad), 0)
    parts = [do_rows(jnp.asarray(row_ids[s:s + rc], jnp.int32))
             for s in range(0, npad, rc)]
    return jnp.concatenate(parts)[:n]


def _displays(emission):
    import numpy as _np

    def sqrt_leb(b):
        c = _np.minimum(b + emission, 1.0)
        return 255.99 * _np.sqrt(_np.maximum(c, 0.0))

    def rh22_b(b):
        c = _np.maximum(b, 0.0)
        return 255.99 * (c / (1.0 + c)) ** (1 / 2.2)

    def rh20_b(b):
        c = _np.maximum(b, 0.0)
        return 255.99 * _np.sqrt(c / (1.0 + c))

    def rh22_leb(b):
        c = _np.maximum(b + emission, 0.0)
        return 255.99 * (c / (1.0 + c)) ** (1 / 2.2)

    return {"sqrt_LeB": sqrt_leb, "rh22_B": rh22_b,
            "rh20_B": rh20_b, "rh22_LeB": rh22_leb}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sub", type=int, default=0)
    ap.add_argument("--steps", default="5",
                    help="comma list of refinement steps to compare")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--only", default=None,
                    help="comma list of estimators (mc64,mc64b,analytic,"
                         "per_sample) to compute; default all basic")
    ap.add_argument("--mc-samples", type=int, default=64)
    args = ap.parse_args()
    steps = [int(s) for s in args.steps.split(",")]
    only = set(args.only.split(",")) if args.only else None

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp  # noqa: F401

    from pathtracer.ops import dispatch
    from pathtracer.render.radiosity import (
        analytic_form_factors,
        mc_form_factors,
        radiosity_step,
        solve_radiosity,
    )

    geom = build_geom(args.sub)
    n = geom.num_prims
    # the App's intersection path for this platform and scene size
    accel = dispatch.build_accel(geom, dispatch.select_backend(
        dispatch.current_platform(), geom.num_tris))
    emission = np.asarray(geom.emission, np.float64)
    # id map cached on disk: at sub-4 it costs ~500 brute chunks
    idmap_cache = os.path.join(HERE, f"forensics_ids_sub{args.sub}.npy")
    if os.path.exists(idmap_cache):
        ids = np.load(idmap_cache)
    else:
        ids = prim_id_map(geom, accel)
        np.save(idmap_cache, ids)

    def solve_from_ff(ff, nsteps):
        rad = geom.emission
        unshot = geom.emission
        for _ in range(nsteps):
            rad, unshot = radiosity_step(geom, ff, rad, unshot)
        return np.asarray(rad)

    # FF matrices once per estimator; any step derives from them.
    def want(tag):
        return only is None or tag in only

    ffs = {}
    ff_cache = os.path.join(HERE, f"forensics_ff_sub{args.sub}.npz")
    cached = {}
    if os.path.exists(ff_cache):
        cached = dict(np.load(ff_cache))
    if want("mc64"):
        if "mc64" in cached:
            ffs["mc64"] = cached["mc64"]
        else:
            sol = solve_radiosity(geom, jax.random.key(12345),
                                  num_iterations=1,
                                  mc_samples=args.mc_samples,
                                  accel=accel)
            ffs["mc64"] = sol.form_factors
    if want("mc64b"):
        if "mc64b" in cached:
            ffs["mc64b"] = cached["mc64b"]
        else:
            sol_b = solve_radiosity(geom, jax.random.key(99991),
                                    num_iterations=1,
                                    mc_samples=args.mc_samples,
                                    accel=accel)
            ffs["mc64b"] = sol_b.form_factors
    if want("analytic"):
        ffs["analytic"] = cached.get("analytic")
        if ffs["analytic"] is None:
            ffs["analytic"] = analytic_form_factors(
                geom, accel=accel)
    if args.variants and want("per_sample"):
        # per-sample (unbiased double-area) estimator:
        # F = A_j/pi * mean_s[vis * ci * cj / d^2], clamped [0,1].
        # The current reference kernel uses ratio-of-averages
        # (form_factors.h:339-347), but its published PNGs may predate
        # it — for ADJACENT large patches the per-sample integrand is
        # ~1/d^2 singular and the clamp bites, making everything
        # brighter at low subdivision.
        if "per_sample" in cached:
            ffs["per_sample"] = cached["per_sample"]
        else:
            ffs["per_sample"] = per_sample_ff(
                geom, jax.random.key(12345), args.mc_samples, accel)
    cached.update({k: np.asarray(v) for k, v in ffs.items()})
    np.savez(ff_cache, **cached)

    data = {}
    if os.path.exists(RESULT):
        with open(RESULT) as f:
            data = json.load(f)

    disp = _displays(emission)
    for step in steps:
        try:
            ref = load_ref_png(f"cbox_sub{args.sub}_step{step}.png")
        except FileNotFoundError:
            continue
        ref_med, npx = extract_ref_med(ref, ids, n)
        sel = np.isfinite(ref_med).all(-1)
        out = {"n_prims": n, "extracted_prims": int((npx >= 25).sum())}

        candidates = {tag: solve_from_ff(ff, step)
                      for tag, ff in ffs.items()}
        # Compare every (candidate, display) pair against the
        # reference's per-prim u8 medians IN DISPLAY SPACE (u8 RMSE
        # over extracted prims) — no inversion instability at the clamp.
        grid = {}
        for tag, b in candidates.items():
            for dname, dfn in disp.items():
                pred = dfn(np.asarray(b, np.float64))
                dd = (pred - ref_med)[sel]
                grid[f"{tag}/{dname}"] = round(
                    float(np.sqrt((dd ** 2).mean())), 2)
        out["u8_rmse"] = dict(sorted(grid.items(), key=lambda kv: kv[1]))
        # Whole-image interior rel-RMSE via the id-map flat render —
        # immune to per-prim mask/median pathologies, comparable to the
        # eval_vs_reference numbers.
        from eval_vs_reference import compare as img_compare

        img_grid = {}
        for tag, b in candidates.items():
            for dname, dfn in disp.items():
                flat = np.where(
                    ids[..., None] >= 0,
                    dfn(np.asarray(b, np.float64))[np.maximum(ids, 0)],
                    0.0)
                img = np.clip(flat, 0, 255).astype(np.uint8)
                img_grid[f"{tag}/{dname}"] = img_compare(
                    img, ref)["interior_rel_rmse"]
        out["img_interior_rel_rmse"] = dict(
            sorted(img_grid.items(), key=lambda kv: kv[1]))
        if "mc64" in candidates and "mc64b" in candidates:
            best_disp = min(disp.items(),
                            key=lambda kv: grid[f"mc64/{kv[0]}"])
            dfn = best_disp[1]
            dd = (dfn(candidates["mc64"].astype(np.float64))
                  - dfn(candidates["mc64b"].astype(np.float64)))[sel]
            out["mc_self_noise_u8"] = round(
                float(np.sqrt((dd ** 2).mean())), 2)

        if n <= 64:
            tab = []
            for i in range(n):
                if npx[i] < 25:
                    continue
                row = {"prim": i,
                       "ref_u8": [round(float(x), 1) for x in ref_med[i]]}
                for tag in ("mc64", "analytic", "per_sample"):
                    if tag in candidates:
                        row[tag + "_B"] = [round(float(x), 4)
                                           for x in candidates[tag][i]]
                tab.append(row)
            out["per_prim"] = tab

        data[f"sub{args.sub}_step{step}"] = out
        print(f"--- sub{args.sub} step{step} ---")
        print(json.dumps({k: v for k, v in out.items()
                          if k != "per_prim"}, indent=1))

    with open(RESULT, "w") as f:
        json.dump(data, f, indent=1)


if __name__ == "__main__":
    main()
