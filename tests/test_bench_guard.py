"""bench.py must refuse physically impossible throughput numbers.

Regression net for a broken device barrier that once inflated a headline
~1500x: bench.check_physical aborts the whole bench on any number above
what the card's published FP32 peak (bench.PEAKS, keyed by device_kind)
allows, and on a device kind it has no peaks for.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import bench  # noqa: E402  (repo-root module; imports no heavy deps)

H100 = "NVIDIA H100 80GB HBM3"


def test_sane_numbers_pass():
    # all-pairs on the 32-triangle cbox, and a BVH rate on 101k tris
    bench.check_physical("headline", 3000.0, H100, 32, all_pairs=True)
    bench.check_physical("stress100k", 50.0, H100, 101704)
    # the all-pairs ceiling itself (67e12 / (40 * 32) = 52,343 Mrays/s)
    bench.check_physical("ceiling", 52000.0, H100, 32, all_pairs=True)


def test_b9ee9de_magnitude_rejected():
    # a ~1500x-inflated headline
    with pytest.raises(bench.ImplausibleBenchmark):
        bench.check_physical("headline", 3000.0 * 1500, H100, 32,
                             all_pairs=True)


def test_issue_plateau_rejected_for_all_pairs():
    # 60,000 Mrays/s x 32 tris x 40 flops = 7.7e13 > 6.7e13 FP32 peak,
    # yet far below the one-test-per-ray ceiling — only the all-pairs
    # law trips
    with pytest.raises(bench.ImplausibleBenchmark):
        bench.check_physical("headline", 60000.0, H100, 32, all_pairs=True)
    bench.check_physical("bvh", 60000.0, H100, 32)


def test_absolute_ceiling_rejected_for_any_backend():
    # one test per ray: 67e12 / 40 = 1.675e6 Mrays/s on any backend
    with pytest.raises(bench.ImplausibleBenchmark):
        bench.check_physical("stress100k", 2.0e6, H100, 101704)


def test_unknown_device_kind_raises():
    with pytest.raises(bench.ImplausibleBenchmark, match="no published"):
        bench.check_physical("headline", 1.0, "Example Accelerator X1", 32)
    with pytest.raises(bench.ImplausibleBenchmark):
        bench.peaks("cpu")


def test_guard_escapes_except_exception():
    # main()'s per-config blocks catch Exception; the guard must not be
    # swallowed into an "error: ..." extra field
    assert not issubclass(bench.ImplausibleBenchmark, Exception)
