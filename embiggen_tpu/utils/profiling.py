"""Tracing / profiling hooks (SURVEY §5.1).

The reference has only coarse wall-clock phase timing recorded into the
evaluation report (ref `abstract_classifier_model.py:2431-2508,2904-2915`);
this package adds real JAX profiler integration on top of the same
phase-timing surface:

- `trace(log_dir)` — capture an XLA device profile (TensorBoard format) around
  any block; safe no-op fallback when the profiler backend is unavailable.
- `annotate(name)` — named host-side trace annotation that shows up inside
  a captured profile (wraps `jax.profiler.TraceAnnotation`).
- `PhaseTimer` — accumulates named wall-clock phases; `as_dict()` feeds the
  `required_*_time` style columns of the evaluation report.
- `device_memory_stats()` — per-device HBM usage snapshot.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, Optional


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a JAX profiler trace into `log_dir` (view with TensorBoard).

    Falls back to a no-op if the profiler cannot start (e.g. another trace
    is already active, or the backend lacks profiler support).
    """
    import jax

    started = False
    try:
        jax.profiler.start_trace(log_dir)
        started = True
    except Exception:
        pass
    try:
        yield
    finally:
        if started:
            try:
                jax.profiler.stop_trace()
            except Exception:
                pass


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region visible in a captured profile's host timeline."""
    import jax

    try:
        ctx = jax.profiler.TraceAnnotation(name)
    except Exception:
        yield
        return
    with ctx:
        yield


class PhaseTimer:
    """Accumulates named wall-clock phases.

    >>> t = PhaseTimer()
    >>> with t.phase("fit"): ...
    >>> t.as_dict()  # {"fit_time": ...}
    """

    def __init__(self) -> None:
        self._elapsed: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._elapsed[name] = (
                self._elapsed.get(name, 0.0) + time.perf_counter() - t0
            )

    def as_dict(self, suffix: str = "_time") -> Dict[str, float]:
        return {f"{k}{suffix}": v for k, v in self._elapsed.items()}


def device_memory_stats(device=None) -> Optional[Dict[str, int]]:
    """HBM usage snapshot for one device, or None when the backend does not
    expose memory stats (CPU)."""
    import jax

    dev = device if device is not None else jax.devices()[0]
    try:
        stats = dev.memory_stats()
    except Exception:
        return None
    if not stats:
        return None
    return {k: int(v) for k, v in stats.items()}
