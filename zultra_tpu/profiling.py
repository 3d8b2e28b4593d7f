"""Tracing, profiling and metrics.

The reference's only instrumentation is CLI wall-clock timing
(tool/zultra.c:62-93); this framework adds:

* stage timing: ``stage_timer`` contexts aggregating per-stage wall time
  (the native engine's internal breakdown is exposed via ZN_PROFILE=1);
* device tracing: ``trace`` wraps jax.profiler for device timelines;
* stream metrics: Stream.total_in/total_out plus ``stream_stats``.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

_STAGE_TOTALS: dict[str, float] = defaultdict(float)
_STAGE_COUNTS: dict[str, int] = defaultdict(int)


@contextlib.contextmanager
def stage_timer(name: str):
    """Accumulate wall time under a stage name."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        elapsed = time.perf_counter() - t0
        _STAGE_TOTALS[name] += elapsed
        _STAGE_COUNTS[name] += 1


def stage_report(reset: bool = False):
    """{stage: {total_s, calls, mean_ms}} for everything timed so far."""
    report = {
        name: {
            "total_s": total,
            "calls": _STAGE_COUNTS[name],
            "mean_ms": total * 1000.0 / max(_STAGE_COUNTS[name], 1),
        }
        for name, total in sorted(_STAGE_TOTALS.items())
    }
    if reset:
        _STAGE_TOTALS.clear()
        _STAGE_COUNTS.clear()
    return report


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/zultra_tpu_trace"):
    """JAX profiler trace around device work (view with TensorBoard or
    xprof). No-op fallback if the profiler is unavailable."""
    try:
        import jax

        jax.profiler.start_trace(log_dir)
        started = True
    except Exception:
        started = False
    try:
        yield
    finally:
        if started:
            try:
                import jax

                jax.profiler.stop_trace()
            except Exception:
                pass


def stream_stats(stream) -> dict:
    """Counters for a zultra_tpu.Stream."""
    return {
        "total_in": stream.total_in,
        "total_out": stream.total_out,
        "ratio_pct": 100.0 * stream.total_out / max(stream.total_in, 1),
        "engine": stream.engine.name,
        "pending_windows": len(stream._pending),
        "max_block_size": stream.max_block_size,
    }
