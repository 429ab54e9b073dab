"""Profiling helpers: realtime-factor metering and jax.profiler traces.

The reference's only perf affordance is "monitor CPU usage" advice
(README.md:98); here the realtime factor (audio-seconds processed per
wall-second per chip — bench.py's headline metric) is a first-class utility.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import jax


def time_fn(fn, *args, warmup: int = 1, iters: int = 5):
    """Median wall time of fn(*args) with block_until_ready semantics."""
    for _ in range(warmup):
        _block(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _block(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def _block(out):
    for leaf in jax.tree_util.tree_leaves(out):
        if hasattr(leaf, "block_until_ready"):
            leaf.block_until_ready()
    return out


@dataclass
class RealtimeMeter:
    """Accumulates audio-seconds vs wall-seconds → realtime factor."""

    sr: float
    audio_samples: int = 0
    wall_s: float = 0.0
    _t0: float = field(default=0.0, repr=False)

    @contextlib.contextmanager
    def measure(self, n_samples: int):
        t0 = time.perf_counter()
        yield
        self.wall_s += time.perf_counter() - t0
        self.audio_samples += n_samples

    @property
    def audio_s(self) -> float:
        return self.audio_samples / self.sr

    @property
    def realtime_factor(self) -> float:
        return self.audio_s / self.wall_s if self.wall_s > 0 else float("inf")


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace contextmanager (view with tensorboard/xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
