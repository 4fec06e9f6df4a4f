"""Golden-image regression harness (SURVEY.md §4c / §7.12).

The reference's only regression mechanism is eyeballing PNG sweeps in
outputs/ (SURVEY.md §4); here goldens are exact float32 radiance images at
fixed seeds. The renderer is bitwise deterministic per platform
(counter-based threefry + f32 intersection), so CPU goldens must match
later CPU renders exactly; the RMSE gate additionally guards against
intentional-but-small estimator changes.

Usage:
    python benchmarks/goldens.py generate   # (re)write goldens/
    python benchmarks/goldens.py check      # verify current renderer
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# Goldens are defined on the CPU brute-force backend (what tests/ use);
# generation and verification must run on the same platform, so this
# tool pins the CPU.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "..", "goldens")

# name -> Config kwargs (all tiny, CPU-friendly, fixed seeds)
CONFIGS = {
    "cbox_bsdf": dict(
        scene="cbox_quads", width=64, height=64, spp=32, max_depth=4,
        sampling_mode="bsdf", ray_chunk=4096, spp_per_pass=32, seed=2023,
    ),
    "cbox_mis": dict(
        scene="cbox_quads", width=64, height=64, spp=16, max_depth=4,
        sampling_mode="mis", ray_chunk=4096, spp_per_pass=16, seed=2023,
        radiosity_iterations=5, mc_samples=16,
    ),
    "cbox_mirror": dict(
        scene="cbox_quads", width=64, height=64, spp=16, max_depth=6,
        sampling_mode="bsdf", ray_chunk=4096, spp_per_pass=16, seed=7,
        mirror_tall_box=True,
    ),
    # NEE exercises the trickiest estimator machinery (last-depth
    # gating + complementary MIS hit weights, integrator.py:203-307);
    # it is also the biggest measured quality lever (2.7-6.9x RMSE),
    # so it gets the same bitwise net as the other paths.
    "cbox_nee": dict(
        scene="cbox_quads", width=64, height=64, spp=16, max_depth=4,
        sampling_mode="bsdf", nee=True, ray_chunk=4096,
        spp_per_pass=16, seed=2023,
    ),
    "cbox_radiosity_view": dict(
        scene="cbox_quads", width=64, height=64, spp=4, subdivision=1,
        integrator="radiosity", ray_chunk=4096, seed=2023,
        radiosity_iterations=8, mc_samples=16,
    ),
}


def render(name: str) -> np.ndarray:
    """Render a config to linear mean radiance (or u8 for radiosity view)."""
    from pathtracer.app import App
    from pathtracer.utils.config import Config

    cfg = Config(**CONFIGS[name])
    app = App(cfg)
    if cfg.integrator == "radiosity":
        return app.render().astype(np.float32)
    r = app.renderer()
    r.render(cfg.spp)
    return np.asarray(r.film.mean_radiance())


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.sqrt(np.mean((a - b) ** 2)))


def generate(only: str | None = None) -> None:
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    for name in CONFIGS if only is None else [only]:
        img = render(name)
        np.savez_compressed(
            os.path.join(GOLDEN_DIR, f"{name}.npz"), image=img
        )
        print(f"golden '{name}': shape {img.shape}, mean {img.mean():.5f}")


def check(rtol_rmse: float = 0.01) -> int:
    failures = 0
    for name in CONFIGS:
        path = os.path.join(GOLDEN_DIR, f"{name}.npz")
        if not os.path.exists(path):
            print(f"MISSING golden {name}")
            failures += 1
            continue
        want = np.load(path)["image"]
        got = render(name)
        e = rmse(got, want)
        scale = max(float(np.sqrt(np.mean(want**2))), 1e-6)
        rel = e / scale
        exact = np.array_equal(got, want)
        status = "OK " if rel <= rtol_rmse else "FAIL"
        if rel > rtol_rmse:
            failures += 1
        print(
            f"{status} {name}: rmse {e:.6f} (rel {rel:.5f}), "
            f"bitwise={'yes' if exact else 'no'}"
        )
    return failures


if __name__ == "__main__":
    cmd = sys.argv[1] if len(sys.argv) > 1 else "check"
    if cmd == "generate":
        generate(sys.argv[2] if len(sys.argv) > 2 else None)
    else:
        sys.exit(1 if check() else 0)
