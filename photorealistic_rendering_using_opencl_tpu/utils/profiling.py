"""Profiling & metrics: wall-time scopes, rays/sec counters, XLA traces.

The reference's profiling is printf wall-timing (BVH build ``src/BVH/
bvh.cpp:45-66``, kernel time ``src/main.cpp:243-271``; SURVEY §5).  Here:
structured counters + optional ``jax.profiler`` traces viewable in
TensorBoard/XProf or Perfetto.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field


@dataclass
class Metrics:
    """Accumulates named wall-time spans and throughput counters."""

    spans: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            total, count = self.spans.get(name, (0.0, 0))
            self.spans[name] = (total + dt, count + 1)

    def count(self, name: str, n: float) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + n

    def rate(self, counter: str, span: str) -> float:
        total, _ = self.spans.get(span, (0.0, 0))
        return self.counters.get(counter, 0.0) / max(total, 1e-12)

    def report(self) -> str:
        lines = []
        for name, (total, count) in sorted(self.spans.items()):
            lines.append(f"{name}: {total:.3f}s over {count} calls "
                         f"({total / max(count, 1) * 1e3:.1f} ms/call)")
        for name, v in sorted(self.counters.items()):
            lines.append(f"{name}: {v:,.0f}")
        return "\n".join(lines)


@contextlib.contextmanager
def xla_trace(logdir: str | None):
    """jax.profiler trace scope; no-op when logdir is None."""
    if logdir is None:
        yield
        return
    import jax.profiler
    with jax.profiler.trace(logdir):
        yield


def samples_per_sec(width: int, height: int, spp: int, seconds: float
                    ) -> float:
    return width * height * spp / max(seconds, 1e-12)
