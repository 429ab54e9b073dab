"""Headline benchmark: stereo→LCR offline upmix realtime factor on one chip.

Runs the flagship offline pipeline (default 44.1 kHz 6-band config,
band_edges [0,30,120,480,1920,7680] — reference main.py:62-73) over
synthetic stereo audio and reports audio-seconds processed per wall-clock
second per chip.  The reference publishes no numbers (SURVEY.md §6);
`vs_baseline` is normalized against a fixed 1000× realtime per chip.

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N}
plus "snr_db"/"snr_ok": worst-slice parity of the benched program vs
the float64 NumPy oracle (exit 1 below the 60 dB bar, so a numerics
regression cannot ship a fast wrong number — BENCH_SNR=0 skips), the
device it ran on (platform, device_kind, device_count; on a GPU also
nvidia-smi's name and power limit) and the matmul precision.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

TARGET_REALTIME = 1000.0  # vs_baseline normalization: 1000x realtime/chip

SR = float(os.environ.get("BENCH_SR", 44100.0))
BAND_EDGES = tuple(
    float(e)
    for e in os.environ.get("BENCH_EDGES", "0,30,120,480,1920,7680").split(",")
)
MAX_BLOCK = int(os.environ.get("BENCH_MAX_BLOCK", 65536))
N_SAMPLES = int(os.environ.get("BENCH_SAMPLES", 2**21))  # ~47.6 s of audio
ITERS = max(1, int(os.environ.get("BENCH_ITERS", 3)))
WARMUP = int(os.environ.get("BENCH_WARMUP", 1))
LOOPS = max(1, int(os.environ.get("BENCH_LOOPS", 7)))
# Pipeline applications chained INSIDE one jitted call, so the fixed
# per-dispatch host cost is amortized and the number is the sustained
# on-device throughput.
INNER = max(1, int(os.environ.get("BENCH_INNER", 10)))  # 1 = single-dispatch timing
# Numerics gate (a silent kernel regression must not ship a fast wrong
# number): after timing, ONE extra dispatch returns
# small slices of the first chained application's output (probes ride
# the same compiled program — no second compile, ~0.6 MB fetched), and
# they are held to the float64 NumPy oracle.  BENCH_SNR=0 skips.
SNR_CHECK = os.environ.get("BENCH_SNR", "1") != "0"
SNR_BAR_DB = 60.0  # correctness bar vs the float64 oracle
PROBE_W = min(16384, N_SAMPLES // 4)
PROBE_STARTS = tuple(
    sorted({0, N_SAMPLES // 2, N_SAMPLES - PROBE_W})
)  # head (onset transient included), middle, tail


def device_info() -> dict:
    """Where the number was taken: JAX's view of the device and, on a
    GPU, nvidia-smi's card name and power limit."""
    import subprocess

    import jax

    dev = jax.devices()[0]
    info = {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
    }
    if dev.platform == "gpu":
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        )
        info["gpu"] = out.stdout.strip().splitlines()[0]
    return info


def measure() -> dict:
    """Time the flagship program and gate its numerics; returns the
    record main() prints."""
    import jax
    import jax.numpy as jnp

    from upmix.config import UpmixConfig
    from upmix.models.offline import build_offline_fn
    from upmix.utils.cache import enable_compilation_cache

    enable_compilation_cache()  # fresh processes reuse compiled programs

    config = UpmixConfig.make(list(BAND_EDGES), sr=SR, max_block_size=MAX_BLOCK)
    base_fn = build_offline_fn(config, N_SAMPLES)

    # Each iteration's input depends on the previous iteration's output
    # (true serialization on the device stream), and the clock stops only
    # after fetching real result bytes of the final iteration.
    def step(L, R, seed):
        # INNER chained applications per dispatch (see INNER above); each
        # feeds a tiny function of its output into the next input, so the
        # device cannot skip or overlap them incorrectly.
        probes = None
        for i in range(INNER):
            c, ls, rs = base_fn(L + seed, R - seed)
            if i == 0:
                # Parity probes of the FIRST application: with seed=0 it
                # runs on exactly (L, R), so one post-timing dispatch at
                # seed=0 yields oracle-comparable slices.  [3, 3, W] is
                # ~0.6 MB — negligible next to the [3, N] outputs the
                # program already materializes.
                probes = jnp.stack(
                    [
                        jnp.stack([ch[s:s + PROBE_W] for s in PROBE_STARTS])
                        for ch in (c, ls, rs)
                    ]
                )
            seed = c[0] * 1e-6
        return c, ls, rs, seed, probes

    fn = jax.jit(step)

    rng = np.random.default_rng(0)
    L = jnp.asarray(rng.standard_normal(N_SAMPLES), jnp.float32)
    R = jnp.asarray(rng.standard_normal(N_SAMPLES), jnp.float32)
    L, R = jax.device_put((L, R))

    def run(iters):
        if iters < 1:
            return 0.0
        seed = jnp.zeros((), jnp.float32)
        out = None
        for _ in range(iters):
            out = fn(L, R, seed)
            seed = out[3]  # tiny data dependency chains the dispatches
        return float(np.asarray(out[0][0]))  # fetch forces completion

    run(WARMUP)
    # MIN of 7 timed loops, spaced ~3 s apart: host and scheduler noise
    # arrives in bursts, so a median can land entirely inside one; each
    # loop is ~30 chained device applications, the spacing samples
    # distinct noise windows, and noise only ever ADDS time.
    times = []
    for k in range(LOOPS):
        if k:
            time.sleep(3.0 if LOOPS >= 7 else 0.0)
        t0 = time.perf_counter()
        run(ITERS)
        times.append((time.perf_counter() - t0) / (ITERS * INNER))
    sec_per_iter = min(times)
    audio_sec = N_SAMPLES / SR
    realtime_factor = audio_sec / sec_per_iter
    median_factor = audio_sec / sorted(times)[len(times) // 2]

    snr_db = None
    if SNR_CHECK:
        from upmix.oracle import oracle_multiband

        # One more dispatch at seed=0: its first chained application runs
        # on exactly (L, R), and the fetched probes are its output slices.
        out = fn(L, R, jnp.zeros((), jnp.float32))
        probes = np.asarray(out[4], np.float64)  # [3 ch, 3 slices, W]
        ref = np.stack(
            oracle_multiband(
                np.asarray(L, np.float32), np.asarray(R, np.float32), config
            )
        )
        snr_db = float("inf")
        for ci in range(3):
            for si, s in enumerate(PROBE_STARTS):
                r = ref[ci, s:s + PROBE_W].astype(np.float64)
                e = probes[ci, si] - r
                snr = 10.0 * np.log10(
                    max((r**2).sum(), 1e-30) / max((e**2).sum(), 1e-30)
                )
                snr_db = min(snr_db, float(snr))

    # value = min-of-7 (the calm-window estimate; noise only ever ADDS
    # time).  median_* records the same run's median loop.
    from upmix.ops import fftmm

    record = {
        "metric": "offline_upmix_realtime_factor",
        "value": round(realtime_factor, 2),
        "unit": "audio_sec/sec/chip",
        "vs_baseline": round(realtime_factor / TARGET_REALTIME, 4),
        "estimator": f"min_of_{LOOPS}_loops",
        "median_value": round(median_factor, 2),
        **device_info(),
        "matmul_precision": str(fftmm.PRECISION).rsplit(".", 1)[-1],
    }
    if snr_db is not None:
        # Worst-slice SNR of the benched program class vs the float64
        # oracle (head incl. onset / middle / tail probes).
        record["snr_db"] = round(snr_db, 1)
        record["snr_ok"] = bool(snr_db >= SNR_BAR_DB)
    return record


def main():
    record = measure()
    print(json.dumps(record))
    snr_db = record.get("snr_db")
    if snr_db is not None and snr_db < SNR_BAR_DB:
        print(
            f"BENCH NUMERICS GATE FAILED: worst probe SNR {snr_db:.1f} dB "
            f"< {SNR_BAR_DB} dB bar — the speed number above is not valid",
            file=sys.stderr,
        )
        sys.exit(1)


if __name__ == "__main__":
    main()
