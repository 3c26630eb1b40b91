"""Tracing & profiling utilities (SURVEY.md §5).

Reference counterpart: per-iteration ``time.time()`` prints and
``cudnn.benchmark=True`` [R: train.py :: train] — no real profiler. Here the
JAX equivalents:

- :func:`trace`: context manager around ``jax.profiler`` producing a
  Perfetto/XPlane trace directory (view with tensorboard or ui.perfetto.dev).
- :func:`annotate`: named region inside a trace (shows up on the host
  timeline around dispatches).
- :class:`StepTimer`: host-side per-step wall-time stats (mean/p50/p95).
  NOTE: JAX dispatch is async — without a device sync this measures host
  dispatch + input-pipeline time, which is exactly what you want for
  spotting data stalls; device time lives in the profiler trace.
- :func:`nan_guard`: context manager flipping ``jax_debug_nans`` (the
  functional analogue of the reference having no sanitizers at all).
"""
from __future__ import annotations

import contextlib
import time
from typing import Iterator, List, Optional

import jax
import numpy as np


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[None]:
    """Capture a profiler trace into ``logdir`` (no-op when None)."""
    if not logdir:
        yield
        return
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named trace region: ``with annotate('augment'): ...``."""
    return jax.profiler.TraceAnnotation(name)


@contextlib.contextmanager
def nan_guard(enable: bool = True) -> Iterator[None]:
    """Raise on NaN-producing ops inside the context (debug runs only —
    disables some fusions)."""
    if not enable:
        yield
        return
    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)


class StepTimer:
    """Host-side step timing: ``with timer.step(): ...`` then ``.summary()``."""

    def __init__(self):
        self._durations: List[float] = []

    @contextlib.contextmanager
    def step(self) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._durations.append(time.perf_counter() - t0)

    def __len__(self):
        return len(self._durations)

    def reset(self):
        self._durations.clear()

    def summary(self) -> Optional[dict]:
        if not self._durations:
            return None
        d = np.asarray(self._durations) * 1e3
        return {"steps": int(d.size),
                "mean_ms": float(d.mean()),
                "p50_ms": float(np.percentile(d, 50)),
                "p95_ms": float(np.percentile(d, 95)),
                "max_ms": float(d.max())}
