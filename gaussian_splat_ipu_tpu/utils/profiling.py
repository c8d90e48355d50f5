"""Tracing, profiling and throughput instrumentation.

Parity with the reference's PVTI tracepoints + per-frame throughput logging
(SURVEY.md §5: pvti::Tracepoint scopes around UI/render/build,
src/main/splat.cpp:69,210-224,251-258; "Splat time / points/sec" prints,
splat.cpp:267-272,318):

  * Tracepoint — named scope that shows up in JAX/XLA profiler traces
    (jax.named_scope) and accumulates host wall-clock per channel.
  * trace() — context manager around jax.profiler (Perfetto/TensorBoard
    trace directory), the PVTI-capture analogue.
  * FrameMeter — rolling frames/s + Msplats/s, logged every N seconds like
    the reference's ~3s cadence.
  * two_point_time — per-iteration device time of a fused program: time a
    K1-iteration and a K2-iteration run and difference them, so fixed
    dispatch and transfer costs cancel.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import time
from typing import Callable, Dict

import jax

log = logging.getLogger("gsplat")

_channel_totals: Dict[str, float] = collections.defaultdict(float)
_channel_counts: Dict[str, int] = collections.defaultdict(int)


@contextlib.contextmanager
def Tracepoint(channel: str):
    """Scoped tracepoint: names the XLA region + accumulates host time."""
    t0 = time.perf_counter()
    with jax.named_scope(channel):
        yield
    dt = time.perf_counter() - t0
    _channel_totals[channel] += dt
    _channel_counts[channel] += 1


def tracepoint_summary() -> Dict[str, Dict[str, float]]:
    return {ch: {"total_s": _channel_totals[ch],
                 "count": _channel_counts[ch]}
            for ch in _channel_totals}


def reset_tracepoints() -> None:
    _channel_totals.clear()
    _channel_counts.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a device profile (view with TensorBoard / Perfetto)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class FrameMeter:
    """Rolling throughput logger (reference splat.cpp:267-272 cadence)."""

    def __init__(self, num_primitives: int, log_every_s: float = 3.0):
        self.n = num_primitives
        self.log_every_s = log_every_s
        self._count = 0
        self._t_last = time.perf_counter()
        self._frames_last = 0

    def tick(self) -> None:
        self._count += 1
        now = time.perf_counter()
        dt = now - self._t_last
        if dt >= self.log_every_s:
            frames = self._count - self._frames_last
            fps = frames / dt
            log.info("%.2f fps, %.2f Msplats/s (%d frames)", fps,
                     fps * self.n / 1e6, self._count)
            self._t_last = now
            self._frames_last = self._count


def two_point_time(run_k: Callable[[int], None], k1: int = 1,
                   k2: int = 16) -> float:
    """Seconds per iteration via the two-point method.

    run_k(k) must execute a SINGLE fused program doing k iterations and
    block on a small result (e.g. fetch a scalar reduction). Both sizes are
    run once to warm the compile cache, then timed; the difference cancels
    fixed dispatch + transfer latency.
    """
    run_k(k1)
    run_k(k2)
    t0 = time.perf_counter()
    run_k(k1)
    t1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_k(k2)
    t2 = time.perf_counter() - t0
    return max((t2 - t1) / (k2 - k1), 1e-12)
