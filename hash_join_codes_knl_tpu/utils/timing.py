"""Phase timing and structured metrics (tracing subsystem, SURVEY.md sec 5).

The reference stamps per-thread phase boundaries into times[8] / timelog[]
arrays (hj.h:39,69-70; npj.cpp:878-915) and prints min/max/avg across
threads.  Here a phase is a jit-compiled stage: the timer runs the stage,
blocks on its outputs, and records wall time; `timeline` keeps the TIMELOG
analog (monotonic stamps per phase boundary).  Metrics are emitted as one
JSON object (tuples/s, per-stage seconds, bytes moved) instead of printf.
"""

from __future__ import annotations

import json
import time

import jax


class PhaseTimer:
    def __init__(self):
        self.phases: dict[str, float] = {}
        self.timeline: list[tuple[str, float]] = []
        self._t0 = time.perf_counter()

    def run(self, name: str, fn, *args, **kw):
        """Run fn, block until its outputs are ready, record the phase."""
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args, **kw))
        dt = time.perf_counter() - t0
        self.phases[name] = self.phases.get(name, 0.0) + dt
        self.timeline.append((name, time.perf_counter() - self._t0))
        return out

    @property
    def total(self) -> float:
        return sum(self.phases.values())

    def metrics(self, **extra) -> dict:
        out = {f"{k}_s": round(v, 6) for k, v in self.phases.items()}
        out["total_s"] = round(self.total, 6)
        out.update(extra)
        return out

    def report(self, **extra) -> str:
        return json.dumps(self.metrics(**extra))
