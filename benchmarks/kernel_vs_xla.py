"""Fused hit kernels against XLA's brute force (and the BVH), end to end.

Times the same work through each intersection path on the GPU, from a
device trace (utils.kernel_profile.reduce_trace) and from the wall clock
of warm, unprofiled passes, in one process on one card:

  cbox      cbox 1024x1024, depth 5, 16 spp, BSDF sampling
  mis       the same with guided MIS (10 x 64-sample MC gather solve)
  ff        the sub-4 cbox (8,192 triangles) MC form-factor pass
  threshold App render passes (BSDF, NEE) and form-factor passes on the
            kernel and on the BVH, at 8k-33k triangles: where the BVH
            starts to win, by wall time
  det       a cbox pass run twice in this process: bitwise equal? Writes
            the film's digest so two processes can be compared.

    python benchmarks/kernel_vs_xla.py [--only cbox,mis,...] [--out DIR]

Prints one JSON object per measurement and writes them all to
DIR/kernel_vs_xla.json.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from pathtracer.ops import dispatch  # noqa: E402
from pathtracer.utils.kernel_profile import kernel_profile_traced  # noqa: E402


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()


def profile(step_fn) -> dict:
    """Device busy/idle and the top ops of one traced call of step_fn."""
    prof = kernel_profile_traced(step_fn)
    return {
        "device_busy_ms": prof["device_busy_s"] * 1e3,
        "device_window_ms": prof["device_window_s"] * 1e3,
        "idle_share": prof["idle_share"],
        "percent": prof["percent"],
        "top_ops": [
            {k: t[k] for k in ("name", "ms", "count")}
            for t in prof["top_ops"][:10]
        ],
    }


def wall(step_fn, n: int = 3) -> list:
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(step_fn())
        out.append(time.perf_counter() - t0)
    return out


def render_step(geom, backend, *, mode=0, cdfs=None, width=1024, spp=16):
    from pathtracer.render.camera import CameraController
    from pathtracer.render.renderer import ProgressiveRenderer, RenderSettings

    s = RenderSettings(width=width, height=width, max_depth=5,
                       spp_per_pass=spp, ray_chunk=1 << 16,
                       sampling_mode=mode)
    r = ProgressiveRenderer(geom, CameraController.default().build(), s,
                            cdfs=cdfs, accel=dispatch.build_accel(geom,
                                                                  backend))

    def step():
        r.step(block=False)
        return r.film.accum

    return step


def compare(name, steps: dict, reps: int = 2, trace: bool = True) -> dict:
    """steps: backend -> step_fn. Warm each, wall-time `reps` calls of
    each in the order A B B A, then trace one call of each."""
    res = {"config": name}
    for b, fn in steps.items():
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        res[f"{b}_first_s"] = time.perf_counter() - t0
    order = list(steps) + list(steps)[::-1]
    for b in order:
        res.setdefault(f"{b}_wall_s", []).extend(wall(steps[b], reps))
    if trace:
        for b, fn in steps.items():
            res[f"{b}_trace"] = profile(fn)
    return res


def run_cbox(mode_name="bsdf"):
    from pathtracer.core.constants import SAMPLING_BSDF, SAMPLING_MIS
    from pathtracer.core.math_utils import luminance
    from pathtracer.ops.guiding import build_cdfs
    from pathtracer.render.radiosity import solve_radiosity
    from pathtracer.scene.builtin import cornell_box

    geom = cornell_box("quads").build()
    cdfs, mode = None, SAMPLING_BSDF
    if mode_name == "mis":
        sol = solve_radiosity(geom, jax.random.key(12345),
                              num_iterations=10, mc_samples=64)
        cdfs, mode = build_cdfs(luminance(sol.rad_grid)), SAMPLING_MIS
    return compare(
        f"cbox1024_{mode_name}",
        {b: render_step(geom, b, mode=mode, cdfs=cdfs)
         for b in ("brute", "triton")},
    )


def run_ff(subdivision=4):
    from pathtracer.render.radiosity import mc_form_factors
    from pathtracer.scene.builtin import cornell_box
    from pathtracer.scene.mesh import subdivide

    geom = subdivide(cornell_box("quads"), subdivision).build()
    key = jax.random.key(1)

    def ff(backend):
        accel = dispatch.build_accel(geom, backend)
        return lambda: mc_form_factors(geom, key, n_samples=8, accel=accel)

    return compare(f"ff_sub{subdivision}_8samples",
                   {b: ff(b) for b in ("brute", "triton", "bvh")}, reps=1)


THRESHOLD_SCENES = (
    # (label, Config fields); stress{n} is scenes/generate_stress.py's
    # displaced sphere at n x n (2 (n - 1) n triangles) with its ground
    # plane and light
    ("cbox_sub4", {"scene": "cbox_quads", "subdivision": 4}),
    ("stress64", {"stress_n": 64}),
    ("stress91", {"stress_n": 91}),
    ("stress111", {"stress_n": 111}),
    ("cbox_sub5", {"scene": "cbox_quads", "subdivision": 5}),
    ("stress128", {"stress_n": 128}),
)


def run_threshold(scenes=THRESHOLD_SCENES, backends=("triton", "bvh"),
                  width=512, spp=4, ff_rows=128, ff_samples=8,
                  scene_dir="out/threshold_scenes"):
    """Where the BVH starts to beat the fused kernel, end to end through
    App at the sizes around the cut. Per scene and backend (App's
    `backend` option), wall seconds of warm calls of:
      render      one App render pass, width^2, depth 5, `spp` spp, BSDF
                  sampling (closest hit);
      render_nee  the same with NEE (closest hit + shadow any-hit);
      ff          the solver's form-factor visibility for `ff_rows`
                  receiver rows spread over the scene x every primitive x
                  `ff_samples` (mc_form_factors_rows with App's accel).
    Wall, not device-busy time: the BVH's walk reads its loop predicate
    back every step, and users wait for that too."""
    import dataclasses

    import jax.numpy as jnp

    from pathtracer.app import App
    from pathtracer.render.radiosity import mc_form_factors_rows
    from pathtracer.utils.config import Config

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "scenes"))
    import generate_stress

    os.makedirs(scene_dir, exist_ok=True)
    out = []
    for label, fields in scenes:
        fields = dict(fields)
        n_st = fields.pop("stress_n", None)
        if n_st is not None:
            fields["scene"] = generate_stress.generate(
                scene_dir, tag=str(n_st), n=n_st)
        base = Config(width=width, height=width, max_depth=5, spp=spp,
                      spp_per_pass=spp, **fields)
        apps = {}
        for b in backends:
            apps[b] = App(dataclasses.replace(base, backend=b))
            apps[b].load_scene()
        geom = apps[backends[0]].geom
        n = geom.num_prims
        rows = jnp.asarray(
            np.linspace(0, n - 1, ff_rows).astype(np.int32))
        key = jax.random.key(1)

        def render(app, nee):
            def step():
                app.config.nee = nee
                app._renderer = None
                r = app.renderer()
                r.render(app.config.spp)
                return r.film.accum
            return step

        def ff(app):
            return lambda: mc_form_factors_rows(
                app.geom, key, rows, n_samples=ff_samples, row_chunk=16,
                accel=app.accel)[0]

        row = {"scene": label, "tris": int(geom.num_tris), "prims": n}
        for what, make in (("render", lambda a: render(a, False)),
                           ("render_nee", lambda a: render(a, True)),
                           ("ff", ff)):
            res = compare(f"{label}_{what}",
                          {b: make(apps[b]) for b in backends}, trace=False)
            for b in backends:
                row[f"{what}_{b}_first_s"] = res[f"{b}_first_s"]
                row[f"{what}_{b}_wall_s"] = res[f"{b}_wall_s"]
                row[f"{what}_{b}_median_s"] = float(
                    np.median(res[f"{b}_wall_s"]))
        out.append(row)
        print(json.dumps(row), flush=True)
    return {"config": f"threshold_app_{width}px_{spp}spp_ff{ff_rows}rows",
            "rows": out}


def run_det():
    from pathtracer.scene.builtin import cornell_box

    geom = cornell_box("quads").build()
    res = {"config": "determinism_cbox1024"}
    for b in ("brute", "triton"):
        films = []
        for _ in range(2):
            step = render_step(geom, b)
            films.append(np.asarray(step()))
        res[f"{b}_in_process_bitwise"] = bool(
            np.array_equal(films[0], films[1])
        )
        res[f"{b}_digest"] = hashlib.sha256(films[0].tobytes()).hexdigest()
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--only", default="cbox,mis,ff,threshold,det")
    p.add_argument("--out", default="out")
    p.add_argument("--tag", default="", help="suffix of the output file")
    args = p.parse_args(argv)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"measures the GPU; JAX found '{dev.platform}'")
    head = {"card": card(), "device_kind": dev.device_kind}
    print(json.dumps(head), flush=True)
    runs = {
        "cbox": lambda: run_cbox("bsdf"),
        "mis": lambda: run_cbox("mis"),
        "ff": run_ff,
        "threshold": run_threshold,
        "det": run_det,
    }
    results = [head]
    for name in args.only.split(","):
        res = runs[name]()
        print(json.dumps(res), flush=True)
        results.append(res)
    os.makedirs(args.out, exist_ok=True)
    name = f"kernel_vs_xla{args.tag}.json"
    with open(os.path.join(args.out, name), "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
