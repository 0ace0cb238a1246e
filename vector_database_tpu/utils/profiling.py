"""Tracing / profiling / observability utilities.

The reference's observability is Stopwatch spans and throttled console
progress (SURVEY.md §5; IndexBuilder.cs:43-53, Program.cs:36-52). The
equivalents here:

- ``BuildStats`` — per-level build telemetry collected through the host
  builder's progress hook (level, live ranges, active points, wall time);
- ``ProgressLogger`` — the reference's throttled progress print;
- ``trace`` — a ``jax.profiler`` trace context (device timeline);
- ``selectivity_report`` — candidates-examined-per-match statistics, the
  generalization of the reference tests' predicate-call counters
  (MemoryVectorIndexTests.cs:191-196).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import List

import numpy as np


@dataclass
class LevelStat:
    level: int
    live_ranges: int
    active_points: int
    seconds: float


@dataclass
class BuildStats:
    """Collects per-level timings via ``build_index(progress=stats)``.

    The builder fires ``progress(level, ...)`` AFTER level ``level``'s
    device pass, so the window since the previous callback is that
    level's own duration and is recorded on the stat being appended.
    Level 0's window starts at construction — create the instance
    immediately before the build or its row absorbs the setup time."""

    levels: List[LevelStat] = field(default_factory=list)
    _t0: float = field(default_factory=time.time)

    def __call__(self, level: int, live: int, active: int) -> None:
        now = time.time()
        self.levels.append(LevelStat(level, live, active, now - self._t0))
        self._t0 = now

    @property
    def total_seconds(self) -> float:
        return sum(s.seconds for s in self.levels)

    def report(self) -> str:
        lines = ["level  ranges    active     seconds"]
        for s in self.levels:
            lines.append(
                f"{s.level:>5}  {s.live_ranges:>7}  {s.active_points:>9}"
                f"  {s.seconds:>9.4f}"
            )
        return "\n".join(lines)


class ProgressLogger:
    """Throttled build progress print (IndexBuilder.cs:43-53)."""

    def __init__(self, every: int = 1):
        self.every = every

    def __call__(self, level: int, live: int, active: int) -> None:
        if level % self.every == 0:
            print(f"Process level {level}: {live} ranges, "
                  f"{active} active points")


@contextlib.contextmanager
def trace(log_dir: str):
    """``jax.profiler`` device trace of the block, written to ``log_dir``.
    A profiler that fails to start or stop raises."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def selectivity_report(result, n: int) -> dict:
    """Candidates-per-match statistics for a ``SearchResult`` over an
    ``n``-vector index."""
    cand = np.asarray(result.candidates, dtype=np.float64)
    matches = np.asarray(result.count, dtype=np.float64)
    per_match = cand / np.maximum(matches, 1)
    return {
        "queries": int(cand.shape[0]),
        "mean_candidates": float(cand.mean()),
        "candidate_fraction": float(cand.mean() / n),
        "mean_matches": float(matches.mean()),
        "candidates_per_match": float(per_match.mean()),
        "overflowed": int(np.asarray(result.overflow).sum()),
    }
