#!/usr/bin/env python3
"""Smoke test of upmix on a GPU: the main paths once, at full width.

Every phase drives the entry points a user calls and holds what comes
out to the float64 NumPy oracle (upmix.oracle) at >= 60 dB:

  1. device   JAX must report a GPU; the card's name and power limit are
              printed as nvidia-smi gives them.
  2. offline  the benchmark configuration (44.1 kHz, band edges
              0/30/120/480/1920/7680 Hz, max block 65536): a seeded
              2^21-sample stereo WAV through the CLI (upmix.cli.main,
              in process), and 2^22 + 12345 samples through
              Upmixer.process_np — several scan segments, and a length
              that is not a multiple of the chunk.  Head, middle and tail
              probes of every channel are checked.
  3. serving  the reference's Bela configuration (48 kHz, edges
              0/500/2000/8000 Hz, hardware block 2048): a 64-slot
              make_stream_pool pool behind run_stream_server (what
              --serve-stream starts), 8 concurrent sessions of 40 blocks
              from stream_client threads.

With --four, only the multi-device paths run, on 4 GPUs: a seq=4 mesh
through ShardedUpmixer at the benchmark configuration (2^22 samples, a
49,152-sample halo exchanged by ppermute), a data=2,seq=2 batch of 2,
and a data=4-sharded 64-slot serving pool.  Each is compared with the
oracle and with the one-device result, and its output must sit on 4
distinct devices.

The last line of stdout is one JSON object,
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}};
a failed check raises, so the script exits non-zero without it.  One
process drives every card; clients are threads.

  python chip_smoke.py           # one GPU
  python chip_smoke.py --four    # four GPUs
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile
import threading

import numpy as np

SNR_BAR_DB = 60.0
PROBE_W = 16384
OFFLINE_SR = 44100.0
OFFLINE_EDGES = (0.0, 30.0, 120.0, 480.0, 1920.0, 7680.0)
OFFLINE_MAX_BLOCK = 65536
SERVE_SR = 48000.0
SERVE_EDGES = (0.0, 500.0, 2000.0, 8000.0)
SERVE_HW = 2048


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def snr_db(ref, test) -> float:
    ref = np.asarray(ref, np.float64)
    err = np.sum((ref - np.asarray(test, np.float64)) ** 2)
    return float(10.0 * np.log10(max(np.sum(ref**2), 1e-30) / max(err, 1e-30)))


def stereo(n: int, sr: float, seed: int):
    """Seeded stereo test signal: a shared center tone plus decorrelated
    sides and noise, so every band carries energy."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    center = 0.3 * np.sin(2 * np.pi * 220.0 * t) + 0.1 * rng.standard_normal(n)
    side_l = 0.2 * np.sin(2 * np.pi * 555.0 * t) + 0.1 * rng.standard_normal(n)
    side_r = 0.2 * np.sin(2 * np.pi * 3300.0 * t) + 0.1 * rng.standard_normal(n)
    return (center + side_l).astype(np.float32), (center + side_r).astype(np.float32)


def check_probes(label: str, ref, got, bar: float = SNR_BAR_DB) -> float:
    """Hold head, middle and tail probes of every (C, Ls, Rs) channel to
    the bar; returns the worst probe SNR."""
    n = len(ref[0])
    w = min(PROBE_W, n)
    worst = float("inf")
    for name, r, g in zip(("C", "Ls", "Rs"), ref, got):
        assert np.asarray(g).shape == (n,), f"{label} {name}: shape {np.shape(g)}"
        assert np.isfinite(g).all(), f"{label} {name}: non-finite output"
        for start in sorted({0, n // 2, n - w}):
            s = snr_db(r[start:start + w], np.asarray(g)[start:start + w])
            assert s >= bar, f"{label} {name} @ {start}: {s:.1f} dB < {bar}"
            worst = min(worst, s)
    log(f"{label}: worst probe SNR {worst:.1f} dB (bar {bar:.0f} dB)")
    return worst


def offline_config():
    from upmix.config import UpmixConfig

    return UpmixConfig.make(
        list(OFFLINE_EDGES), sr=OFFLINE_SR, max_block_size=OFFLINE_MAX_BLOCK
    )


def phase_offline(workdir: str, n_cli: int = 2**21,
                  n_lib: int = 2**22 + 12345) -> None:
    from upmix import cli
    from upmix.io import read_wav, write_wav
    from upmix.models import Upmixer
    from upmix.oracle import oracle_multiband

    cfg = offline_config()

    # The CLI on a seeded WAV; split export writes C, Ls, Rs scaled by one
    # shared factor (input peak / output peak, reference main.py).
    L, R = stereo(n_cli, OFFLINE_SR, seed=1)
    src = os.path.join(workdir, "smoke.wav")
    out_dir = os.path.join(workdir, "out")
    write_wav(src, np.column_stack([L, R]), int(OFFLINE_SR))
    rc = cli.main([src, "--out-dir", out_dir, "--export-mode", "split"])
    assert rc == 0, f"cli exit {rc}"
    got = []
    for tag, col in (("C", 0), ("Ls", 0), ("Rs", 1)):
        (path,) = glob.glob(os.path.join(out_dir, f"smoke_{tag}_*.wav"))
        data, sr = read_wav(path)
        assert sr == int(OFFLINE_SR) and data.shape == (n_cli, 2), path
        got.append(data[:, col])
    ref = oracle_multiband(L, R, cfg)
    peak_in = float(np.max(np.abs(np.column_stack([L, R]))))
    scale = peak_in / max(float(np.max(np.abs(r))) for r in ref)
    check_probes(f"offline cli {n_cli} samples",
                 [r * scale for r in ref], got)

    # The library entry point on a multi-segment, ragged length.
    L, R = stereo(n_lib, OFFLINE_SR, seed=2)
    got = Upmixer(cfg).process_np(L, R)
    check_probes(f"offline Upmixer {n_lib} samples",
                 oracle_multiband(L, R, cfg), got)


def serving_config():
    from upmix.config import UpmixConfig

    return UpmixConfig.streaming(
        list(SERVE_EDGES), sr=SERVE_SR, hw_block_size=SERVE_HW
    )


def aligned_stream_oracle(L, R, cfg, hw: int):
    """What a warmup-aligned client receives: the streaming oracle over
    the signal plus drain blocks, leading warmup silence dropped."""
    from upmix.models.streaming import stream_warmup_blocks
    from upmix.oracle import oracle_stream_multiband

    n = len(L)
    skip = (stream_warmup_blocks(cfg) - 1) * hw
    m = -(-(n + skip) // hw) * hw
    xl = np.zeros(m, np.float32)
    xr = np.zeros(m, np.float32)
    xl[:n], xr[:n] = L, R
    ol, orr = oracle_stream_multiband(xl, xr, cfg, hw)
    return ol[skip:skip + n], orr[skip:skip + n]


def phase_serving(n_slots: int = 64, n_sessions: int = 8,
                  n_blocks: int = 40, mesh=None, label: str = "serving"):
    """Serve n_sessions concurrent clients; returns their outputs."""
    from upmix.serve_stream import run_stream_server, stream_client

    cfg = serving_config()
    server = run_stream_server(
        0, sr=SERVE_SR, n_streams=n_slots, hw_block_size=SERVE_HW,
        band_edges=SERVE_EDGES, lockstep=True, mesh=mesh,
    )
    signals = [stereo(n_blocks * SERVE_HW, SERVE_SR, seed=100 + i)
               for i in range(n_sessions)]
    results: list = [None] * n_sessions

    def client(i):
        try:
            results[i] = stream_client(*server.address, *signals[i],
                                       timeout=600.0)
        except Exception as exc:  # re-raised below, on the main thread
            results[i] = exc

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_sessions)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        assert not any(t.is_alive() for t in threads), "client hung"
        worst = float("inf")
        for i, ((L, R), got) in enumerate(zip(signals, results)):
            if isinstance(got, Exception):
                raise got
            for name, r, g in zip(("L", "R"),
                                  aligned_stream_oracle(L, R, cfg, SERVE_HW),
                                  got):
                assert np.isfinite(g).all(), f"session {i} {name}: non-finite"
                s = snr_db(r, g)
                assert s >= SNR_BAR_DB, f"session {i} {name}: {s:.1f} dB"
                worst = min(worst, s)
        counters = server.metrics.counters
        assert counters["dispatcher_failures"] == 0
        log(f"{label}: {n_sessions} sessions x {n_blocks} blocks on "
            f"{n_slots} slots, worst SNR {worst:.1f} dB, "
            f"{counters['blocks']} pool dispatches")
        return server, results
    finally:
        server.close()


def on_devices(arr, n: int, label: str) -> None:
    devices = {s.device for s in arr.addressable_shards}
    assert len(devices) == n, f"{label}: output on {len(devices)} devices"
    log(f"{label}: output shards on {len(devices)} distinct devices")


def phase_four(n_seq: int = 2**22, n_batch: int = 2**21,
               n_slots: int = 64) -> None:
    import jax

    from upmix.cli import build_mesh
    from upmix.models import Upmixer
    from upmix.oracle import oracle_multiband
    from upmix.parallel import ShardedUpmixer

    cfg = offline_config()
    single = Upmixer(cfg)

    # seq=4: one long file split over the sample axis, halos by ppermute.
    L, R = stereo(n_seq, OFFLINE_SR, seed=3)
    y = ShardedUpmixer(cfg, build_mesh("seq=4")).process_batch(
        np.stack([L, R])[None]
    )
    on_devices(y, 4, "mesh seq=4")
    y = np.asarray(y)[0]
    check_probes(f"mesh seq=4 {n_seq} samples vs oracle",
                 oracle_multiband(L, R, cfg), y)
    check_probes("mesh seq=4 vs one device", single.process_np(L, R), y)

    # data=2,seq=2: a batch of two files, each split over two devices.
    x = np.stack([np.stack(stereo(n_batch, OFFLINE_SR, seed=4 + b))
                  for b in range(2)])
    y = ShardedUpmixer(cfg, build_mesh("data=2,seq=2")).process_batch(x)
    on_devices(y, 4, "mesh data=2,seq=2")
    y = np.asarray(y)
    for b in range(2):
        check_probes(f"mesh data=2,seq=2 file {b} vs oracle",
                     oracle_multiband(x[b, 0], x[b, 1], cfg), y[b])
        check_probes(f"mesh data=2,seq=2 file {b} vs one device",
                     single.process_np(x[b, 0], x[b, 1]), y[b])

    # data=4 serving pool: session slots split over the four devices.
    mesh = build_mesh("data=4", allowed=("data",), flag="--pool-mesh")
    server, sharded = phase_serving(n_slots=n_slots, mesh=mesh,
                                    label="pool-mesh data=4")
    on_devices(server.pool.state["history"], 4, "pool-mesh data=4 state")
    _, plain = phase_serving(n_slots=n_slots, label="one-device pool")
    for i, (a, b) in enumerate(zip(sharded, plain)):
        for ch, (ga, gb) in enumerate(zip(a, b)):
            s = snr_db(gb, ga)
            assert s >= SNR_BAR_DB, f"session {i} ch {ch}: {s:.1f} dB vs one device"
    log("pool-mesh data=4 vs one device: every session >= 60 dB")
    jax.block_until_ready(y)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the multi-device paths, on 4 GPUs")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX reports {devices[0].platform!r}",
              file=sys.stderr)
        return 2
    if args.four and len(devices) < 4:
        print(f"chip_smoke: --four needs 4 GPUs, JAX sees {len(devices)}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from upmix.ops import fftmm

    log(f"gpu: {gpu_name_and_power_limit()}")
    log(f"jax {jax.__version__}: {len(devices)} x {devices[0].device_kind}")
    log(f"matmul precision: {fftmm.PRECISION}")
    if args.four:
        phase_four()
    else:
        with tempfile.TemporaryDirectory(
            prefix=".chip_smoke_", dir=os.path.dirname(os.path.abspath(__file__))
        ) as workdir:
            phase_offline(workdir)
        phase_serving()
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
