"""Per-phase kernel timing breakdown.

Parity with the reference's in-kernel cycle accounting
(`ENABLE_KERNEL_PROFILING`, KernelProfileData: intersection / grid-init /
sampling / shading cycles via clock64+atomics, render_config.h:61-77 and
the Profiler-window percentage breakdown, ui_windows.h:487-550). A fused
XLA program has no cycle counters to read, so the breakdown comes either
from timing phase-isolated jitted programs over a representative ray
batch (kernel_profile) or from a profiler trace of one real step
(kernel_profile_traced).
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp

from ..core.constants import SAMPLING_BSDF
from ..core.math_utils import cosine_sample_hemisphere
from ..ops.guiding import sample_grid
from ..ops import dispatch


def _time(fn, *args, iters=10) -> float:
    r = fn(*args)
    jax.block_until_ready(r)
    t0 = time.perf_counter()
    for _ in range(iters):
        r = fn(*args)
    jax.block_until_ready(r)
    return (time.perf_counter() - t0) / iters


def kernel_profile(
    geom,
    o,
    d,
    *,
    mode: int = SAMPLING_BSDF,
    cdfs=None,
    accel=None,
    iters: int = 10,
) -> dict:
    """Measure the bounce phases for a ray batch (o, d).

    Returns {phase: seconds} plus percentage shares — the KernelProfileData
    equivalent (intersection / grid sampling / bsdf sampling / rng).
    """
    b = o.shape[0]
    key = jax.random.key(0)

    @jax.jit
    def p_intersect(o, d):
        h = dispatch.closest_hit(geom, accel, o, d)
        return h.t.sum() + h.emission.sum()

    @jax.jit
    def p_rng(k):
        return jax.random.uniform(k, (b, 6)).sum()

    @jax.jit
    def p_bsdf_sample(n, u):
        dd, pdf = cosine_sample_hemisphere(n, u[:, 0], u[:, 1])
        return dd.sum() + pdf.sum()

    results = {}
    results["intersection"] = _time(p_intersect, o, d, iters=iters)
    results["rng"] = _time(p_rng, key, iters=iters)
    n = jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0]), (b, 3))
    u = jax.random.uniform(key, (b, 2))
    results["bsdf_sampling"] = _time(p_bsdf_sample, n, u, iters=iters)

    if cdfs is not None:
        prim = jnp.zeros((b,), jnp.int32)
        u4 = jax.random.uniform(key, (4, b))

        @jax.jit
        def p_grid(n, u4):
            dd, pdf = sample_grid(cdfs, prim, n, u4[0], u4[1], u4[2], u4[3])
            return dd.sum() + pdf.sum()

        results["grid_sampling"] = _time(p_grid, n, u4, iters=iters)

    total = sum(results.values())
    return {
        "seconds": results,
        "percent": {
            k: 100.0 * v / total for k, v in results.items()
        },
        "rays": b,
    }


def format_profile(prof: dict) -> str:
    lines = [f"{'phase':<16} {'ms':>8} {'%':>6}"]
    for k, v in prof["seconds"].items():
        lines.append(
            f"{k:<16} {v * 1e3:>8.3f} {prof['percent'][k]:>6.1f}"
        )
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# In-situ breakdown from a REAL device trace of the fused step
# ---------------------------------------------------------------------------

# Phase classifier over XLA op names + HLO long names (which carry the
# jax op_name metadata paths of everything fused into each kernel).
_PHASE_PATTERNS = (
    ("intersection", ("closest", "any_hit", "intersect", "occluded",
                      "bvh")),
    ("rng", ("threefry", "random_bits", "random_wrap")),
    ("grid_sampling", ("sample_grid", "searchsorted", "cdf", "guiding")),
    ("sort", ("sort",)),
    ("dma/copy", ("memcpy", "copy", "transpose", "bitcast")),
)


def classify_op(name: str, long_name: str) -> str:
    text = (name + " " + long_name).lower()
    for phase, keys in _PHASE_PATTERNS:
        if any(k in text for k in keys):
            return phase
    return "shading/other"


def _bucket_exclusive(raw):
    """Bucket trace events by phase using EXCLUSIVE durations.

    `raw`: iterable of (pid, tid, ts_us, dur_us, name, long_name).

    Container ops (`while`, call wrappers) can appear on a track as one
    event spanning their whole body, with every body op emitted again as
    a nested event; summing raw durations would double-count loop
    bodies. A per-thread stack sweep subtracts each event's DIRECT
    children, so every device-busy microsecond is counted exactly once.

    Returns (seconds: {phase: s}, per_op: {name: [excl_s, count,
    [excl_call_s...<=32], long_name]}, n_ops).
    """
    seconds: dict = {}
    per_op: dict = {}
    n_ops = 0
    by_tid: dict = {}
    for pid, tid, ts, dur, name, long_name in raw:
        by_tid.setdefault((pid, tid), []).append(
            (ts, dur, name, long_name)
        )

    deferred = []          # (name, phase, dur, stack_cell)
    for evs in by_tid.values():
        # parents sort before their children: earlier start first,
        # longer duration first at equal starts
        evs.sort(key=lambda r: (r[0], -r[1]))
        stack: list = []   # [ts_end, child_sum] per open ancestor
        for ts, dur, name, long_name in evs:
            while stack and stack[-1][0] <= ts + 1e-9:
                stack.pop()
            if stack:
                stack[-1][1] += dur      # direct child of stack[-1]
            cell = [ts + dur, 0.0]
            stack.append(cell)
            ent = per_op.get(name)
            if ent is None:
                per_op[name] = ent = [0.0, 0, [], long_name[:160]]
            ent[1] += 1
            n_ops += 1
            # child_sum keeps mutating while descendants are swept —
            # resolve the exclusive duration after the sweep
            deferred.append((name, classify_op(name, long_name),
                             dur, cell))

    for name, phase, dur, cell in deferred:
        excl = max(0.0, dur - cell[1]) / 1e6
        seconds[phase] = seconds.get(phase, 0.0) + excl
        ent = per_op[name]
        ent[0] += excl
        if len(ent[2]) < 32:
            ent[2].append(excl)
    return seconds, per_op, n_ops


def _process_names(events) -> dict:
    return {
        e.get("pid"): str(e["args"].get("name", ""))
        for e in events
        if e.get("ph") == "M" and e.get("name") == "process_name"
    }


def _gpu_op_events(events) -> list:
    """Kernel events of the GPU device processes ("/device:GPU:N", one
    thread per CUDA stream). Kernels inside a CUDA graph carry
    hlo_op="command_buffer" and no op path; the kernel name (fusion
    name, or a Pallas kernel's own name) is what classifies them."""
    gpu = {
        pid for pid, name in _process_names(events).items()
        if name.startswith("/device:GPU:")
    }
    raw = []
    for e in events:
        if e.get("ph") != "X" or e.get("pid") not in gpu:
            continue
        a = e.get("args") or {}
        long_name = " ".join(
            str(a[k]) for k in ("long_name", "hlo_op", "tf_op")
            if a.get(k) and a[k] not in ("command_buffer", "XlaModule:")
        )
        raw.append((
            e.get("pid"), e.get("tid"),
            float(e.get("ts", 0.0)), float(e.get("dur", 0.0)),
            str(e.get("name", "")), long_name,
        ))
    return raw


def _cpu_op_events(events) -> list:
    """XLA:CPU has no device process: per-op events live in the PjRt CPU
    client thread pool with the HLO op in args.hlo_op ("end: <op>"
    markers and thunk bookkeeping events carry none)."""
    raw = []
    for e in events:
        a = e.get("args") or {}
        name = str(e.get("name", ""))
        if (e.get("ph") != "X" or "hlo_op" not in a
                or name.startswith("end:")):
            continue
        raw.append((
            e.get("pid"), e.get("tid"),
            float(e.get("ts", 0.0)), float(e.get("dur", 0.0)),
            name, str(a["hlo_op"]),
        ))
    return raw


def device_op_events(events, platform: str) -> list:
    """(pid, tid, ts_us, dur_us, name, long_name) for every op the device
    of `platform` ran in a Chrome-format trace. Raises when a GPU trace
    holds no device ops: host events are never read as device time."""
    if platform == "cpu":
        return _cpu_op_events(events)
    if platform != "gpu":
        raise ValueError(f"no trace reduction for platform '{platform}'")
    raw = _gpu_op_events(events)
    if not raw:
        raise RuntimeError(
            "the trace holds no GPU device ops (no '/device:GPU:N' "
            "process with kernel events)"
        )
    return raw


def busy_seconds(raw) -> tuple[float, float]:
    """(busy, window) seconds: busy is the union of the op intervals,
    window runs from the first op's start to the last op's end."""
    iv = sorted((ts, ts + dur) for _, _, ts, dur, _, _ in raw)
    if not iv:
        return 0.0, 0.0
    busy, cur_s, cur_e = 0.0, iv[0][0], iv[0][1]
    for s, e in iv[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy / 1e6, (max(e for _, e in iv) - iv[0][0]) / 1e6


def reduce_trace(events, platform: str) -> dict:
    """Phase split, device busy/idle and top ops of one recorded step."""
    raw = device_op_events(events, platform)
    seconds, per_op, n_ops = _bucket_exclusive(raw)
    total = sum(seconds.values()) or 1.0
    busy, window = busy_seconds(raw)
    top = sorted(per_op.items(), key=lambda kv: -kv[1][0])[:15]
    return {
        "platform": platform,
        "seconds": seconds,
        "percent": {k: 100.0 * v / total for k, v in seconds.items()},
        "ops": n_ops,
        "device_total": total,
        "device_busy_s": busy,
        "device_window_s": window,
        "idle_share": 1.0 - busy / window if window > 0 else 0.0,
        "top_ops": [
            {
                "name": k,
                "ms": round(v[0] * 1e3, 3),
                "count": v[1],
                # per-call ms when the op repeats (e.g. one hit kernel
                # per wavefront iteration) — shows cost vs bounce depth
                "calls_ms": [round(x * 1e3, 3) for x in v[2][:32]]
                if v[1] > 1 else None,
                "long_name": v[3],
            }
            for k, v in top
        ],
    }


def kernel_profile_traced(step_fn, *args, log_dir=None) -> dict:
    """Phase breakdown measured INSIDE one real fused device program.

    Runs step_fn once under jax.profiler.trace and reduces the device's
    op events (reduce_trace): the GPU's stream tracks on the GPU, the
    XLA:CPU op events on the CPU. This is the counterpart of the
    reference's clock64()-based in-kernel cycle accounting
    (integrator.h:286-368, render_config.h:61-77): it sees the true
    fused schedule, unlike timing phase-isolated programs.

    Returns {"seconds": {phase: s}, "percent": {...}, "ops": count,
    "device_total": s, "device_busy_s", "device_window_s",
    "idle_share", "top_ops": [...]}.
    """
    import glob
    import gzip
    import json as _json
    import tempfile

    from ..ops.dispatch import current_platform

    jax.block_until_ready(step_fn(*args))   # compile outside the trace
    td = log_dir or tempfile.mkdtemp(prefix="tpt_trace_")
    with jax.profiler.trace(td):
        jax.block_until_ready(step_fn(*args))

    traces = sorted(glob.glob(td + "/**/*.trace.json.gz", recursive=True))
    if not traces:
        raise RuntimeError(f"no trace written under {td}")
    data = _json.loads(gzip.open(traces[-1]).read())
    return reduce_trace(data.get("traceEvents", []), current_platform())
