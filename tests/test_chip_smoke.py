"""chip_smoke.py's pieces that run without a card: the statistical film
comparison, the result line, and the refusal to run without a GPU. Also
where the package keeps its compile cache."""

import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (repo-root module)


def _films(rng, sigma=0.5, size=256, fine=4):
    """Truth, two references with per-pixel noise sigma (heavy-tailed,
    like fireflies), and a test film box-averaged from a `fine`x finer
    film with the same per-pixel noise (fine^2 x the samples)."""
    truth = rng.uniform(0.1, 0.5, (size, size, 3))

    def noise(shape):
        return sigma * rng.standard_t(4, shape) / np.sqrt(2.0)

    ref_a = truth + noise(truth.shape)
    ref_b = truth + noise(truth.shape)
    big = np.repeat(np.repeat(truth, fine, 0), fine, 1)
    test = chip_smoke.block_mean(big + noise(big.shape), fine)
    return truth, ref_a, ref_b, test


def test_stat_agree_block_mean_and_result_line():
    rng = np.random.default_rng(0)
    truth, ref_a, ref_b, test = _films(rng)
    assert test.shape == truth.shape
    ok, z = chip_smoke.stat_agree(test, ref_a, ref_b, spp_ratio=16)
    assert ok and 0.8 < z < 1.2, z
    # a 20% bias over the whole film, and a quarter of it at half
    # brightness, are both caught
    ok, z = chip_smoke.stat_agree(test * 0.8, ref_a, ref_b, spp_ratio=16)
    assert not ok, z
    dark = test.copy()
    dark[:128, :128] *= 0.5
    ok, z = chip_smoke.stat_agree(dark, ref_a, ref_b, spp_ratio=16)
    assert not ok, z
    line = chip_smoke.result_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 1},
    }
    assert "\n" not in line


def test_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert "no GPU" in p.stderr


def _cache_dir(env_value):
    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    out = subprocess.run(
        [sys.executable, "-c",
         "import pathtracer, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300,
        check=True,
    )
    return out.stdout.strip().splitlines()[-1]


def test_compile_cache_follows_env(tmp_path):
    want = str(tmp_path / "xla_cache")
    assert _cache_dir(want) == want


def test_compile_cache_default_inside_checkout():
    import pathtracer

    got = _cache_dir(None)
    assert got == pathtracer.DEFAULT_CACHE_DIR
    root = os.path.realpath(ROOT)
    assert os.path.realpath(got).startswith(root + os.sep)
    rel = os.path.relpath(os.path.realpath(got), root)
    with open(os.path.join(ROOT, ".gitignore")) as fh:
        assert rel + "/" in fh.read().split()
