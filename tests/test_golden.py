"""Golden-image regression tests: fixed-seed renders must match the stored
goldens bitwise (the renderer is deterministic per platform; the goldens
are CPU renders)."""

import os

import numpy as np
import pytest

from benchmarks.goldens import CONFIGS, GOLDEN_DIR, render, rmse


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_matches_golden(name):
    path = os.path.join(GOLDEN_DIR, f"{name}.npz")
    assert os.path.exists(path), f"golden {name} missing — run " \
        "python benchmarks/goldens.py generate"
    want = np.load(path)["image"]
    got = render(name)
    assert got.shape == want.shape
    scale = max(float(np.sqrt(np.mean(want.astype(np.float64) ** 2))), 1e-6)
    rel = rmse(got.astype(np.float64), want.astype(np.float64)) / scale
    assert rel < 0.01, f"{name}: relative RMSE {rel}"
    np.testing.assert_array_equal(got, want)
