"""Long-run StreamServer soak: leak/growth behavior under sustained churn.

The hours-scale variant of tests/test_serve_soak.py — one server lives
for the whole run while client traffic churns through it (full sessions,
abrupt half-close aborts, periodic checkpoints).  Periodic status lines
report RSS, gauges, counters, and dispatch latency quantiles; the final
JSON summary records RSS growth from the post-warmup baseline.

    python scripts/soak_serve_stream.py --seconds 600
    python scripts/soak_serve_stream.py --seconds 14400 \
        --json soak.json          # 4-hour soak

Runs on the CPU backend by default (the soak targets host-side serving
structures); pass --device to run on JAX's default device (the GPU),
as the only JAX process on that card.
"""

import argparse
import gc
import json
import os
import sys
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def rss_kb() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1])
    return -1


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=120.0)
    ap.add_argument("--streams", type=int, default=4)
    ap.add_argument("--hw", type=int, default=256)
    ap.add_argument("--sr", type=float, default=8000.0)
    ap.add_argument("--edges", default="0,400,1600")
    ap.add_argument("--checkpoint-every", type=float, default=30.0,
                    help="seconds between save_checkpoint calls")
    ap.add_argument("--status-every", type=float, default=15.0)
    ap.add_argument("--blocks-min", type=int, default=4)
    ap.add_argument("--blocks-max", type=int, default=12)
    ap.add_argument("--lockstep", action="store_true", default=True)
    ap.add_argument("--realtime", dest="lockstep", action="store_false",
                    help="lockstep=False wall-clock tick mode")
    ap.add_argument("--tick-sr-mult", type=float, default=16.0,
                    help="realtime mode: tick at sr*mult (faster than real)")
    ap.add_argument("--device", action="store_true",
                    help="run on JAX's default device instead of the CPU")
    ap.add_argument("--json", default=None, help="write summary JSON here")
    args = ap.parse_args()

    import jax

    if not args.device:
        jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from upmix.config import UpmixConfig
    from upmix.models.streaming import BatchStreamingUpmixer
    from upmix.serve_stream import StreamServer, StreamSession, stream_client

    HW = args.hw
    SR = args.sr
    edges = [float(e) for e in args.edges.split(",")]
    cfg = UpmixConfig.streaming(edges, sr=SR, hw_block_size=HW)
    pool = BatchStreamingUpmixer(cfg, HW, n_streams=args.streams)

    ckpt = os.path.join("/tmp", f"soak_sessions_{os.getpid()}.npz")
    rng = np.random.default_rng(0)
    stats = {"sessions": 0, "aborts": 0, "client_errors": 0}
    stats_lock = threading.Lock()

    def full_client(addr, seed, n_blocks):
        t = np.arange(n_blocks * HW) / SR
        L = (0.4 * np.sin(2 * np.pi * 220.0 * t)).astype(np.float32)
        R = (0.4 * np.sin(2 * np.pi * 333.0 * t + seed)).astype(np.float32)
        try:
            got = stream_client(*addr, L, R, timeout=300.0)
            ok = all(np.isfinite(np.asarray(g)).all() for g in got)
            with stats_lock:
                stats["sessions"] += 1
                if not ok:
                    stats["client_errors"] += 1
        except Exception:
            with stats_lock:
                stats["client_errors"] += 1

    def abrupt_client(addr, n_blocks=2):
        z = np.zeros(HW, np.float32)
        try:
            sess = StreamSession(*addr)
            for _ in range(n_blocks):
                sess.send_block(z, z)
            sess.close()
            with stats_lock:
                stats["aborts"] += 1
        except Exception:
            with stats_lock:
                stats["client_errors"] += 1

    kw = {"lockstep": True} if args.lockstep else {
        "lockstep": False, "sr": SR * args.tick_sr_mult}
    srv = StreamServer(pool, **kw).start()
    addr = srv.address
    print(f"soak: server on {addr}, lockstep={args.lockstep}, "
          f"streams={args.streams}", flush=True)

    # Warm phase: stabilize compile caches/allocator before the baseline.
    for i in range(3):
        full_client(addr, i, args.blocks_min)
    gc.collect()
    rss0 = rss_kb()
    t0 = time.monotonic()
    next_status = t0 + args.status_every
    next_ckpt = t0 + args.checkpoint_every
    rounds = 0
    rss_series = []

    try:
        while time.monotonic() - t0 < args.seconds:
            n1 = int(rng.integers(args.blocks_min, args.blocks_max + 1))
            n2 = int(rng.integers(args.blocks_min, args.blocks_max + 1))
            threads = [
                threading.Thread(target=full_client, args=(addr, rounds, n1)),
                threading.Thread(target=full_client,
                                 args=(addr, 10_000 + rounds, n2)),
                threading.Thread(target=abrupt_client, args=(addr,)),
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            rounds += 1
            now = time.monotonic()
            if now >= next_ckpt:
                srv.save_checkpoint(ckpt)
                next_ckpt = now + args.checkpoint_every
            if now >= next_status:
                gc.collect()
                snap = srv.metrics_snapshot()
                rss = rss_kb()
                rss_series.append([round(now - t0, 1), rss])
                d = snap["dispatch_seconds"]
                print(json.dumps({
                    "t": round(now - t0, 1), "rounds": rounds,
                    "rss_mb": round(rss / 1024, 1),
                    "rss_growth_mb": round((rss - rss0) / 1024, 2),
                    "gauges": snap["gauges"],
                    "counters": snap["counters"],
                    "dispatch_p50_ms": round(d["p50"] * 1e3, 3),
                    "dispatch_p95_ms": round(d["p95"] * 1e3, 3),
                    **stats,
                }), flush=True)
                next_status = now + args.status_every
    finally:
        # quiesce, final accounting, then tear down
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            g = srv.metrics_snapshot()["gauges"]
            if g["slots_active"] == g["slots_draining"] == 0 and (
                    g["queued_input_blocks"] == 0):
                break
            time.sleep(0.1)
        gc.collect()
        rss1 = rss_kb()
        snap = srv.metrics_snapshot()
        srv.close()
        try:
            os.unlink(ckpt)
        except OSError:
            pass

    growth_kb = rss1 - rss0
    summary = {
        "seconds": round(time.monotonic() - t0, 1),
        "rounds": rounds,
        "rss0_mb": round(rss0 / 1024, 1),
        "rss1_mb": round(rss1 / 1024, 1),
        "rss_growth_mb": round(growth_kb / 1024, 2),
        "rss_growth_kb_per_session": (
            round(growth_kb / max(stats["sessions"], 1), 2)),
        "rss_series": rss_series,
        "final_gauges": snap["gauges"],
        "final_counters": snap["counters"],
        "dispatch_p50_ms": round(snap["dispatch_seconds"]["p50"] * 1e3, 3),
        "dispatch_p95_ms": round(snap["dispatch_seconds"]["p95"] * 1e3, 3),
        "cycle_p50_ms": round(snap["cycle_seconds"]["p50"] * 1e3, 3),
        **stats,
    }
    print("SOAK_SUMMARY " + json.dumps(summary), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=1)
    # Exit nonzero on obvious failure modes so CI can gate on the script.
    ok = (stats["client_errors"] == 0
          and snap["counters"]["dispatcher_failures"] == 0
          and snap["gauges"]["queued_input_blocks"] == 0)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
