"""Observability utilities: realtime meter, timing, jax.profiler traces."""

import os
import time

import numpy as np
import pytest

from upmix.utils.profiling import RealtimeMeter, time_fn, trace


def test_realtime_meter():
    m = RealtimeMeter(sr=1000.0)
    with m.measure(500):
        time.sleep(0.01)
    assert m.audio_s == 0.5
    assert 0 < m.realtime_factor < 100


def test_time_fn():
    import jax.numpy as jnp

    dt = time_fn(lambda x: x * 2, jnp.ones(16), warmup=1, iters=3)
    assert dt > 0


def test_trace_writes_profile(tmp_path):
    import jax
    import jax.numpy as jnp

    try:
        with trace(str(tmp_path)):
            jax.block_until_ready(jax.jit(lambda x: x * 2)(jnp.ones(128)))
    except Exception as e:  # pragma: no cover - profiler optional on CPU
        pytest.skip(f"profiler unavailable: {e}")
    found = []
    for root, _dirs, files in os.walk(tmp_path):
        found.extend(files)
    assert found, "trace produced no files"


def test_package_lazy_exports():
    import upmix

    assert callable(upmix.Upmixer)
    assert callable(upmix.StreamingUpmixer)
    assert callable(upmix.BatchUpmixer)
    assert callable(upmix.ShardedUpmixer)
    assert callable(upmix.run_offline)
    assert callable(upmix.run_streaming)
    with pytest.raises(AttributeError):
        upmix.no_such_thing
