"""Stream-server stack overhead: full socket path vs bare pool dispatch.

Runs an in-process StreamServer (lockstep) with S loopback clients all
streaming N_BLOCKS as fast as they can, and times the same number of
pool blocks dispatched directly — the delta is the host-side server
stack (sockets, queues, per-slot mixing) per block.  Both numbers
include the per-dispatch host cost, so the per-block delta is the
server stack's own figure.

    BENCH_S=32 python scripts/bench_serve_stream.py
"""

import os
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SR, HW = 48000.0, 2048
EDGES = [0.0, 500.0, 2000.0, 8000.0]
S = int(os.environ.get("BENCH_S", 32))
N_BLOCKS = int(os.environ.get("BENCH_BLOCKS", 50))


def main():
    from upmix.config import UpmixConfig
    from upmix.models import make_stream_pool
    from upmix.serve_stream import StreamServer, stream_client
    from upmix.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    cfg = UpmixConfig.streaming(EDGES, sr=SR, hw_block_size=HW)
    t0 = time.time()
    pool = make_stream_pool(cfg, HW, n_streams=S)
    print(f"pool: {type(pool).__name__} S={S}", flush=True)

    # Bare-pool reference: N_BLOCKS dispatches, one at a time (the
    # serving pattern — no scan chaining), warm first.
    rng = np.random.default_rng(0)
    xl = (rng.standard_normal((S, HW)) * 0.3).astype(np.float32)
    xr = (rng.standard_normal((S, HW)) * 0.3).astype(np.float32)
    for _ in range(3):
        out = pool.push_blocks(xl, xr)
    _ = np.asarray(out[0])
    t1 = time.perf_counter()
    for _ in range(N_BLOCKS):
        out = pool.push_blocks(xl, xr)
    _ = np.asarray(out[0])
    bare = (time.perf_counter() - t1) / N_BLOCKS
    print(
        f"bare pool dispatch: {bare * 1e3:7.2f} ms/block "
        f"({S * 23.4 * min(1.0, (1 / 23.4) / bare):5.0f} realtime streams "
        f"sustainable at this rate)",
        flush=True,
    )

    pool.reset()
    n = N_BLOCKS * HW
    sigs = [
        tuple(
            (np.random.default_rng(100 + i + c).standard_normal(n) * 0.3)
            .astype(np.float32)
            for c in range(2)
        )
        for i in range(S)
    ]
    results = [None] * S
    with StreamServer(pool, lockstep=True) as srv:

        def go(i):
            results[i] = stream_client(
                *srv.address, *sigs[i], timeout=600.0
            )

        threads = [
            threading.Thread(target=go, args=(i,)) for i in range(S)
        ]
        t2 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t2
    assert all(r is not None for r in results)
    # Drain adds warmup-1 extra pool blocks; count what actually ran.
    blocks_run = srv.stats["blocks"]
    per_block = wall / blocks_run
    audio_s = S * n / SR
    print(
        f"server stack:       {per_block * 1e3:7.2f} ms/block over "
        f"{blocks_run} blocks ({S} clients, {wall:.1f}s wall, "
        f"{audio_s / wall:5.1f}x aggregate realtime)",
        flush=True,
    )
    print(
        f"stack overhead:     {(per_block - bare) * 1e3:7.2f} ms/block "
        f"(sockets + queues + per-slot mixing on this host)",
        flush=True,
    )
    print(f"total {time.time() - t0:.0f}s", flush=True)


if __name__ == "__main__":
    main()
