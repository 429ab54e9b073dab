"""Per-config-class offline throughput on the GPU.

The headline bench covers the reference's default 6-band 44.1 kHz
config; this sweep records the realtime factor for the other config
classes users actually run, proving the perf story generalizes.

Protocol: INTERLEAVED min-of-visits — every class is visited VISITS
times round-robin, so a burst of host noise degrades one visit of every
class instead of every visit of one class.  INNER applications are
chained per dispatch to amortize the per-dispatch host cost, matching
bench.py.

    python scripts/bench_config_classes.py
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N = int(os.environ.get("BENCH_SAMPLES", 2**21))
ITERS = int(os.environ.get("BENCH_ITERS", 3))
INNER = max(1, int(os.environ.get("BENCH_INNER", 10)))
VISITS = int(os.environ.get("BENCH_VISITS", 5))


def classes():
    from upmix.config import UpmixConfig

    default = [0.0, 30.0, 120.0, 480.0, 1920.0, 7680.0]
    yield "default-6band-44k", UpmixConfig.make(default, sr=44100.0), 44100.0
    yield (
        "streaming-class-4band-48k",
        UpmixConfig.streaming([0.0, 500.0, 2000.0, 8000.0], sr=48000.0,
                              hw_block_size=2048),
        48000.0,
    )
    yield (
        "8band-44k",
        UpmixConfig.make(
            [0.0, 60.0, 150.0, 400.0, 1000.0, 2500.0, 6000.0, 12000.0],
            sr=44100.0,
        ),
        44100.0,
    )
    yield (
        "overlap50-44k",
        UpmixConfig.make(default, sr=44100.0, overlap=0.5),
        44100.0,
    )
    yield (
        "hardzero-44k",
        UpmixConfig.make(default, sr=44100.0, xover_mode="hard_zero"),
        44100.0,
    )


def main():
    import jax
    import jax.numpy as jnp

    from upmix.models.offline import build_offline_fn
    from upmix.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    rng = np.random.default_rng(0)
    L = jnp.asarray(rng.standard_normal(N), jnp.float32)
    R = jnp.asarray(rng.standard_normal(N), jnp.float32)
    L, R = jax.device_put((L, R))

    entries = []
    for name, cfg, sr in classes():
        base_fn = build_offline_fn(cfg, N)

        def step(L, R, seed, base_fn=base_fn):
            for _ in range(INNER):
                c, ls, rs = base_fn(L + seed, R - seed)
                seed = c[0] * 1e-6
            return c, ls, rs, seed

        fn = jax.jit(step)

        def run(iters, fn=fn):
            seed = jnp.zeros((), jnp.float32)
            out = None
            for _ in range(iters):
                out = fn(L, R, seed)
                seed = out[3]
            return float(np.asarray(out[0][0]))

        t0 = time.perf_counter()
        run(1)
        compile_s = time.perf_counter() - t0
        entries.append({"name": name, "sr": sr, "run": run,
                        "compile_s": compile_s, "times": []})

    for v in range(VISITS):
        for e in entries:
            t0 = time.perf_counter()
            e["run"](ITERS)
            e["times"].append((time.perf_counter() - t0) / (ITERS * INNER))
        time.sleep(1.0)

    for e in entries:
        ms = min(e["times"]) * 1e3
        rt = (N / e["sr"]) / min(e["times"])
        allv = " ".join(f"{t*1e3:.2f}" for t in e["times"])
        print(
            f"{e['name']:28s} {ms:7.2f} ms/iter  {rt:8.1f}x realtime "
            f"(compile+warm {e['compile_s']:.1f}s; visits [{allv}])"
        )


if __name__ == "__main__":
    main()
