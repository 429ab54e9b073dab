"""GPU measurements behind PERF.md: matmul precision, the transform
choice per bucket, compile time, and the serving pool's block rate.

Run on a GPU host, one process at a time (each process claims the card):

  python scripts/measure_gpu.py compile   # flagship compile time; cold
                                          # or warm by the state of the
                                          # compilation cache directory
  python scripts/measure_gpu.py           # precision, buckets, pool

Every line printed is one JSON record; each carries the card's name and
power limit (nvidia-smi) so numbers from different cards never mix.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("BENCH_LOOPS", "5")

N = 2**21  # the flagship input length (bench.py)
EDGES = (0.0, 30.0, 120.0, 480.0, 1920.0, 7680.0)
INNER = 10  # applications chained per dispatch
LOOPS = 5  # min over this many timed dispatches


def emit(kind: str, **fields) -> None:
    import bench

    print(json.dumps({"measure": kind, **fields, **bench.device_info()}),
          flush=True)


def chained_seconds(fn, *args) -> float:
    """Min over LOOPS of one dispatch running INNER dependency-chained
    applications of fn (first array argument perturbed by the previous
    output), per application."""
    import jax
    import jax.numpy as jnp

    def step(seed, *a):
        for _ in range(INNER):
            out = fn(a[0] + seed, *a[1:])
            seed = jax.tree.leaves(out)[0].reshape(-1)[0] * 1e-6
        return seed

    run = jax.jit(step)
    seed = jnp.zeros((), jnp.float32)
    float(run(seed, *args))  # compile + warm
    times = []
    for _ in range(LOOPS):
        t0 = time.perf_counter()
        float(run(seed, *args))
        times.append((time.perf_counter() - t0) / INNER)
    return min(times)


def flagship_config():
    from upmix.config import UpmixConfig

    return UpmixConfig.make(list(EDGES), sr=44100.0, max_block_size=65536)


def measure_compile() -> None:
    import jax
    import jax.numpy as jnp

    from upmix.models.offline import build_offline_fn
    from upmix.utils.cache import enable_compilation_cache

    cache = enable_compilation_cache()
    files = sum(len(f) for _, _, f in os.walk(cache)) if cache else 0
    t0 = time.perf_counter()
    x = jnp.zeros((N,), jnp.float32)
    lowered = jax.jit(build_offline_fn(flagship_config(), N)).lower(x, x)
    t1 = time.perf_counter()
    compiled = lowered.compile()
    t2 = time.perf_counter()
    jax.block_until_ready(compiled(x, x))
    t3 = time.perf_counter()
    emit("compile", cache_files_before=files, trace_lower_s=t1 - t0,
         compile_s=t2 - t1, first_run_s=t3 - t2,
         memory=str(compiled.memory_analysis()))


def measure_precision() -> None:
    import jax

    import bench
    from upmix.ops import fftmm

    for name in ("HIGHEST", "HIGH"):
        fftmm.PRECISION = getattr(jax.lax.Precision, name)
        rec = bench.measure()
        emit("precision", precision=name, realtime_factor=rec["value"],
             median_realtime_factor=rec["median_value"],
             worst_probe_snr_db=rec["snr_db"])
    fftmm.PRECISION = jax.lax.Precision.HIGHEST


def measure_buckets() -> None:
    import jax.numpy as jnp

    from upmix.models.offline import (
        _bucket_fold_mm,
        _bucket_lcr,
        _plan_buckets,
        build_offline_fn,
    )
    from upmix.ops.fftmm import _split

    cfg = flagship_config()
    rng = np.random.default_rng(0)
    L = jnp.asarray(rng.standard_normal(N), jnp.float32)
    R = jnp.asarray(rng.standard_normal(N), jnp.float32)
    for p in _plan_buckets(cfg, N):
        B, H = p.block_size, p.hop_size
        F = N // H
        T = N + B - H
        nz = np.nonzero(p.gains.max(axis=0))[0]
        kept = int(nz[-1] - nz[0] + 1)
        n1, n2 = _split(B)
        direct = kept <= n1 + n2 and B * 2 * kept * 4 <= (8 << 20)
        x_ext = jnp.pad(jnp.stack([L, R]), ((0, 0), (0, T - N)))
        t_mm = chained_seconds(
            lambda x, p=p, F=F: _bucket_fold_mm(p, x, F), x_ext
        )
        t_xla = chained_seconds(
            lambda a, b, p=p: _bucket_lcr(p, a, b, N), L, R
        )
        emit("bucket", block=B, hop=H, bands=int(p.gains.shape[0]),
             kept_bins=kept, mm_body="direct" if direct else "2-stage",
             mm_ms=t_mm * 1e3, xla_cufft_ms=t_xla * 1e3,
             samples=N)
    for kernel in ("mm", "xla"):
        fn = build_offline_fn(cfg, N, kernel=kernel)
        t = chained_seconds(lambda a, b, fn=fn: fn(a, b), L, R)
        emit("pipeline", kernel=kernel, ms=t * 1e3,
             realtime_factor=N / 44100.0 / t, samples=N)


def measure_pool() -> None:
    from upmix.config import UpmixConfig
    from upmix.tune import tune_pool

    cfg = UpmixConfig.streaming([0.0, 500.0, 2000.0, 8000.0], sr=48000.0,
                                hw_block_size=2048)
    for protocol in ("dispatch", "scan"):
        report = tune_pool(cfg, 2048, batch_sizes=(64, 256, 1024),
                           blocks=32, visits=3, protocol=protocol,
                           verbose=False)
        for r in report["results"]:
            emit("pool", protocol=protocol, streams=r["batch"],
                 ok=r["ok"], error=r["error"],
                 ms_per_block=(r["seconds_per_block"] or 0) * 1e3,
                 blocks_per_s=(1.0 / r["seconds_per_block"]
                               if r["ok"] else None),
                 realtime_streams=r["streams_per_chip"],
                 transport_floor_ms=report["protocol"]
                 ["transport_floor_seconds"] * 1e3)


def main(argv) -> int:
    import jax

    if jax.devices()[0].platform != "gpu":
        print("measure_gpu: needs a GPU", file=sys.stderr)
        return 2
    if argv[1:] == ["compile"]:
        measure_compile()
        return 0
    if argv[1:]:
        print(__doc__, file=sys.stderr)
        return 2
    measure_precision()
    measure_buckets()
    measure_pool()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
