"""Tracing / profiling utilities.

The reference's only instrumentation is commented-out clock_t prints around
Ceres solves (`ba_project/src/ba/Optimizer.cpp:116-125`, SURVEY.md §5).
Here: a per-phase wall-clock accumulator threaded through the pipeline, and
a context wrapper around the JAX device profiler.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class PhaseTimer:
    """Accumulates wall time + call counts per named phase."""

    def __init__(self):
        self.total = defaultdict(float)
        self.count = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.total[name] += time.perf_counter() - t0
            self.count[name] += 1

    def report(self):
        """{phase: {"total_s", "count", "mean_ms"}} sorted by total."""
        out = {}
        for name in sorted(self.total, key=lambda n: -self.total[n]):
            t, c = self.total[name], self.count[name]
            out[name] = {
                "total_s": round(t, 4),
                "count": c,
                "mean_ms": round(1000.0 * t / max(c, 1), 3),
            }
        return out

    def merge(self, other):
        for k, v in other.total.items():
            self.total[k] += v
        for k, v in other.count.items():
            self.count[k] += v


@contextlib.contextmanager
def device_trace(log_dir):
    """JAX profiler trace (TensorBoard format) around a code region."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
