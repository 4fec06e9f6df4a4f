"""Produce the reference-style output artifact set (outputs/ parity:
cbox_sub{S}_step{I}.png radiosity sweeps, path-traced renders, delta
images, mirror demo — SURVEY.md C32). Run on the GPU or the CPU:

    python scenes/make_outputs.py [--fast]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                   "outputs")


def main(fast: bool = False):
    from pathtracer.app import App
    from pathtracer.utils.config import Config

    os.makedirs(OUT, exist_ok=True)
    res = 256 if fast else 512
    spp = 32 if fast else 256

    # Radiosity sweeps: subdivision x iteration count
    for sub in (0, 1, 2, 3):
        for step in (1, 5, 10):
            cfg = Config(
                scene="cbox_quads", width=res, height=res, spp=4,
                subdivision=sub, integrator="radiosity",
                radiosity_iterations=step, mc_samples=32,
                ray_chunk=1 << 14,
            )
            t0 = time.time()
            app = App(cfg)
            app.save_png(
                os.path.join(OUT, f"cbox_sub{sub}_step{step}.png")
            )
            print(f"sub{sub}_step{step}: {time.time()-t0:.1f}s",
                  flush=True)

    # Path-traced renders: BSDF vs guided MIS at equal spp
    for mode in ("bsdf", "mis"):
        cfg = Config(
            scene="cbox_quads", width=res, height=res, spp=spp,
            max_depth=5, sampling_mode=mode, subdivision=1,
            radiosity_iterations=10, mc_samples=64,
            ray_chunk=1 << 16, spp_per_pass=16,
        )
        t0 = time.time()
        app = App(cfg)
        app.save_png(os.path.join(OUT, f"cbox_pt_{mode}_{spp}spp.png"))
        print(f"pt_{mode}: {time.time()-t0:.1f}s", flush=True)

    # Mirror tall box (the additive mirror lobe)
    cfg = Config(
        scene="cbox_quads", width=res, height=res, spp=spp,
        max_depth=8, sampling_mode="bsdf", mirror_tall_box=True,
        ray_chunk=1 << 16, spp_per_pass=16,
    )
    app = App(cfg)
    app.save_png(os.path.join(OUT, f"cbox_mirror_{spp}spp.png"))
    print("mirror done", flush=True)

    # Radiosity history delta
    cfg = Config(
        scene="cbox_quads", width=res, height=res, spp=4,
        subdivision=2, radiosity_iterations=8, mc_samples=32,
        ray_chunk=1 << 14,
    )
    app = App(cfg)
    img = app.render_history_delta(0, 3, boost=8.0)
    app.save_png(os.path.join(OUT, "delta_0_3_boosted.png"), img)
    print("delta done", flush=True)


if __name__ == "__main__":
    main(fast="--fast" in sys.argv)
