"""Native C++ engine throughput: serial vs band-pool, host CPU only.

    python scripts/bench_native.py

Measures the reference's shipped 4-band 48 kHz / 2048-block config.
NOTE: this dev box exposes a single core (nproc=1), where the pool can
only measure neutral; the ~n_bands-way speedup needs a multi-core host.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from upmix import native  # noqa: E402

SR, HW = 48000.0, 2048
EDGES = [0.0, 500.0, 2000.0, 8000.0]
N_BLOCKS = int(os.environ.get("BENCH_BLOCKS", 256))


def main():
    if not native.is_available():
        raise SystemExit("native lib not built (make -C native)")
    n = N_BLOCKS * HW
    rng = np.random.default_rng(0)
    L = (rng.standard_normal(n) * 0.3).astype(np.float32)
    R = (rng.standard_normal(n) * 0.3).astype(np.float32)
    print(f"cores visible: {os.cpu_count()}")
    for prec in ("double", "float"):
        for nt in (1, 0, 2, 4):
            eng = native.NativeStreamingUpmixer(
                EDGES, sr=SR, hw_block_size=HW, n_threads=nt, precision=prec
            )
            eng.process_signal(L[: 8 * HW], R[: 8 * HW])  # warm
            eng.reset()
            best = float("inf")
            for _ in range(3):
                eng.reset()
                t0 = time.perf_counter()
                eng.process_signal(L, R, mix="stereo_sum")
                best = min(best, time.perf_counter() - t0)
            dt = best
            print(
                f"{prec:6s} n_threads={nt}: {n / SR / dt:7.1f}x realtime"
                f"  ({dt * 1e3 / N_BLOCKS:.3f} ms/block,"
                f" deadline {HW / SR * 1e3:.1f} ms)"
            )


if __name__ == "__main__":
    main()
