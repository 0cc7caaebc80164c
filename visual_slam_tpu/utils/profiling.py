"""Lightweight metrics/observability: stage timers and rate counters.

The reference's observability is bare prints + the live viewer (SURVEY.md
§5). Here every pipeline stage can be timed and summarized (frames/s,
BA iterations/s — the report metrics), and jax.profiler
tracing can wrap any region for XLA-level inspection.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class StageTimers:
    """Accumulates wall time + call counts per named stage."""

    def __init__(self):
        self.total = defaultdict(float)
        self.count = defaultdict(int)

    @contextlib.contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.total[name] += time.perf_counter() - t0
            self.count[name] += 1

    def summary(self) -> dict:
        return {
            name: {
                "total_s": round(self.total[name], 4),
                "calls": self.count[name],
                "ms_per_call": round(1000 * self.total[name] / max(self.count[name], 1), 3),
            }
            for name in sorted(self.total)
        }

    def rate(self, name: str, units: int) -> float:
        """units per second spent in `name` (e.g. BA iterations/s)."""
        t = self.total.get(name, 0.0)
        return units / t if t > 0 else 0.0


def device_slope_ms(body, carry0, n1: int = 16, n2: int = 128,
                    reps: int = 3) -> float:
    """Per-iteration DEVICE time of `body` (carry -> carry), measured as
    the wall-time slope between two in-program lax.scan lengths.

    Per-dispatch wall timing of a sub-millisecond stage mostly measures
    dispatch overhead; the slope between two scan lengths of the SAME
    program cancels dispatch, transfer, and fetch costs. `body` must thread its
    carry through the computation (a real data dependence), or XLA
    dead-code-eliminates the loop body and the slope measures nothing.
    """
    import jax

    def run(n):
        f = jax.jit(
            lambda c: jax.lax.scan(
                lambda c, _: (body(c), None), c, None, length=n
            )[0]
        )
        out = f(carry0)
        jax.block_until_ready(out)  # compile + warm
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = f(carry0)
            jax.block_until_ready(out)
            ts.append(time.perf_counter() - t0)
        return min(ts)

    return max((run(n2) - run(n1)) / (n2 - n1) * 1e3, 0.0)


@contextlib.contextmanager
def xla_trace(log_dir: str):
    """jax.profiler trace region (open in TensorBoard / xprof)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
