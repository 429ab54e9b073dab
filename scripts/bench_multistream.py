"""Multi-stream streaming throughput on the real chip.

How many concurrent REAL-TIME sessions can one chip serve?  Scans the
vmapped stream step over a window of hardware blocks for several batch
widths and reports sustained time per block per stream vs the real-time
deadline (hw/sr).

    python scripts/bench_multistream.py
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SR, HW = 48000.0, 2048
EDGES = [0.0, 500.0, 2000.0, 8000.0]
N_BLOCKS = int(os.environ.get("BENCH_BLOCKS", 64))


def main():
    import jax
    import jax.numpy as jnp

    from upmix.config import UpmixConfig
    from upmix.models.streaming import build_stream_step, init_stream_state
    from upmix.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    cfg = UpmixConfig.streaming(EDGES, sr=SR, hw_block_size=HW)
    step = build_stream_step(cfg, HW)
    deadline_ms = HW / SR * 1e3

    for B in (1, 8, 32, 128):
        vstep = jax.vmap(step) if B > 1 else step

        @jax.jit
        def scan_blocks(state, blocks):
            return jax.lax.scan(vstep if B > 1 else step, state, blocks)

        one = init_stream_state(cfg, HW)
        state = (
            jax.tree.map(lambda a: jnp.zeros((B,) + a.shape, a.dtype), one)
            if B > 1
            else one
        )
        rng = np.random.default_rng(0)
        shape = (N_BLOCKS, B, 2, HW) if B > 1 else (N_BLOCKS, 2, HW)
        blocks = jnp.asarray(rng.standard_normal(shape), jnp.float32) * 0.3
        state = jax.device_put(state)
        blocks = jax.device_put(blocks)

        # Warm (compile), then time with a dependency chain + tiny fetch.
        # (Fetch ONLY a scalar: outs is ~192 MB at B=128.)
        st, outs = scan_blocks(state, blocks)
        _ = float(np.asarray(outs.ravel()[0]))
        times = []
        for _i in range(3):
            t0 = time.perf_counter()
            st2, outs = scan_blocks(state, blocks)
            _ = float(np.asarray(outs.ravel()[0]))
            times.append((time.perf_counter() - t0) / N_BLOCKS)
        times.sort()
        per_block_ms = times[0] * 1e3  # min: host noise only adds time
        per_stream_us = per_block_ms * 1e3 / B
        streams_rt = B * deadline_ms / per_block_ms
        print(
            f"B={B:4d}: {per_block_ms:7.3f} ms/block batch "
            f"({per_stream_us:7.1f} us/block/stream) -> "
            f"{streams_rt:7.0f} realtime streams/chip "
            f"(deadline {deadline_ms:.1f} ms)"
        )


if __name__ == "__main__":
    main()
