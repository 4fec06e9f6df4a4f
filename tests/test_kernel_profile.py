"""Trace-based kernel profile: classifier + parser unit coverage. The
GPU reduction is checked on a trimmed trace recorded on the card
(tests/fixtures/gpu_trace_cbox256.json.gz: one cbox 256x256 render pass
through the fused hit kernel, NVIDIA H100 80GB HBM3 at a 700 W limit)."""

import gzip
import json
import os

import pytest

from pathtracer.utils.kernel_profile import (
    _bucket_exclusive,
    classify_op,
    device_op_events,
    reduce_trace,
)

GPU_FIXTURE = os.path.join(
    os.path.dirname(__file__), "fixtures", "gpu_trace_cbox256.json.gz"
)


def _gpu_events():
    with gzip.open(GPU_FIXTURE, "rt") as fh:
        return json.load(fh)["traceEvents"]


def test_classifier_buckets():
    assert classify_op("closest_hit", "") == "intersection"
    assert classify_op("any_hit", "") == "intersection"
    assert classify_op("fusion.1", "threefry2x32 ...") == "rng"
    assert classify_op("sort.3", "") == "sort"
    assert classify_op("fusion.9", "add mul select") == "shading/other"


def test_exclusive_subtracts_nested_children():
    # a 100us `while` containing two 30us hit-kernel calls and a 20us
    # shading fusion: the while's exclusive share is only the 20us of
    # loop glue, and nothing is double-counted.
    raw = [
        (0, 0, 0.0, 100.0, "while.1", ""),
        (0, 0, 5.0, 30.0, "closest_hit.1", ""),
        (0, 0, 40.0, 30.0, "closest_hit.1", ""),
        (0, 0, 75.0, 20.0, "fusion.2", "add mul select"),
    ]
    seconds, per_op, n_ops = _bucket_exclusive(raw)
    assert n_ops == 4
    assert abs(sum(seconds.values()) * 1e6 - 100.0) < 1e-6
    assert abs(seconds["intersection"] * 1e6 - 60.0) < 1e-6
    assert abs(seconds["shading/other"] * 1e6 - 40.0) < 1e-6
    assert abs(per_op["while.1"][0] * 1e6 - 20.0) < 1e-6
    assert per_op["closest_hit.1"][1] == 2


def test_exclusive_grandchildren_direct_only():
    # while > fusion > kernel: the kernel grandchild is subtracted from
    # the fusion (its direct parent), not twice from the while.
    raw = [
        (0, 0, 0.0, 100.0, "while.1", ""),
        (0, 0, 10.0, 80.0, "fusion.1", "add mul"),
        (0, 0, 20.0, 50.0, "closest_hit.2", ""),
    ]
    seconds, per_op, _ = _bucket_exclusive(raw)
    assert abs(sum(seconds.values()) * 1e6 - 100.0) < 1e-6
    assert abs(per_op["while.1"][0] * 1e6 - 20.0) < 1e-6
    assert abs(per_op["fusion.1"][0] * 1e6 - 30.0) < 1e-6
    assert abs(seconds["intersection"] * 1e6 - 50.0) < 1e-6


def test_exclusive_separate_threads_not_nested():
    # equal timestamps on DIFFERENT tids must not nest
    raw = [
        (0, 0, 0.0, 50.0, "fusion.1", "add"),
        (0, 1, 0.0, 50.0, "fusion.2", "mul"),
    ]
    seconds, _, _ = _bucket_exclusive(raw)
    assert abs(sum(seconds.values()) * 1e6 - 100.0) < 1e-6


def test_cpu_trace_fallback_finds_ops(tmp_path):
    """XLA:CPU traces carry per-op events in the PjRt client thread pool
    (args.hlo_op) instead of a 'device:' process with an 'XLA Ops'
    track; kernel_profile_traced must fall back to them so the viewer's
    kernel panel works on CPU-only hosts."""
    import jax
    import jax.numpy as jnp

    from pathtracer.utils.kernel_profile import kernel_profile_traced

    @jax.jit
    def f(x):
        return jnp.sort(jnp.sin(x) @ x, axis=-1)

    x = jnp.ones((128, 128))
    prof = kernel_profile_traced(f, x, log_dir=str(tmp_path))
    assert prof["ops"] > 0
    assert prof["device_total"] > 0
    # the sort must land in its phase bucket via the fallback events
    assert "sort" in prof["percent"]


def test_gpu_trace_reduction():
    """The card's stream track is read, host events are not, and the
    fused hit kernel lands in the intersection bucket once per
    wavefront iteration."""
    events = _gpu_events()
    raw = device_op_events(events, "gpu")
    assert len(raw) == 464
    assert {r[0] for r in raw} == {1}          # the /device:GPU:0 pid
    prof = reduce_trace(events, "gpu")
    top = {t["name"]: t for t in prof["top_ops"]}
    assert top["closest_hit"]["count"] == 20
    assert prof["top_ops"][0]["name"] == "closest_hit"
    assert prof["seconds"]["intersection"] == pytest.approx(
        top["closest_hit"]["ms"] / 1e3, rel=1e-3
    )
    # one stream, no nesting: busy time is the sum of op time
    assert prof["device_busy_s"] == pytest.approx(prof["device_total"])
    assert 0.0 < prof["idle_share"] < 1.0


def test_gpu_trace_without_device_ops_raises():
    """Host events are never read as device time: a GPU trace whose
    device process holds no kernels raises instead."""
    events = [
        e for e in _gpu_events()
        if e.get("ph") == "M" or e.get("pid") != 1
    ]
    with pytest.raises(RuntimeError, match="no GPU device ops"):
        reduce_trace(events, "gpu")
    # a CPU-style trace (op events on host threads) is not a GPU trace
    cpu_like = [{"ph": "X", "pid": 7, "tid": 1, "ts": 0.0, "dur": 5.0,
                 "name": "fusion.1", "args": {"hlo_op": "fusion.1"}}]
    with pytest.raises(RuntimeError):
        device_op_events(cpu_like, "gpu")


def test_cpu_branch_only_on_cpu():
    events = [
        {"ph": "X", "pid": 7, "tid": 1, "ts": 0.0, "dur": 5.0,
         "name": "sort.3", "args": {"hlo_op": "sort.3",
                                    "hlo_module": "jit_f"}},
        {"ph": "X", "pid": 7, "tid": 1, "ts": 6.0, "dur": 1.0,
         "name": "end: sort.3", "args": {"hlo_op": "sort.3"}},
    ]
    raw = device_op_events(events, "cpu")
    assert len(raw) == 1
    assert raw[0][5] == "sort.3"               # the op, not the module
    with pytest.raises(ValueError):
        device_op_events(events, "rocm")


def test_busy_seconds_union_across_streams():
    """Device busy time is the union of op intervals: two streams that
    overlap count their shared span once; the window spans first start
    to last end."""
    from pathtracer.utils.kernel_profile import busy_seconds

    raw = [
        (1, 13, 0.0, 10.0, "a", ""),
        (1, 14, 5.0, 10.0, "b", ""),      # overlaps a by 5 us
        (1, 13, 30.0, 5.0, "c", ""),      # after a 15 us gap
    ]
    busy, window = busy_seconds(raw)
    assert busy * 1e6 == pytest.approx(20.0)
    assert window * 1e6 == pytest.approx(35.0)
