"""Serving soak + leak gate (SURVEY §5 serving contract).

A StreamServer lives for the whole soak while traffic churns through it:
full sessions, abrupt half-close/RST aborts, periodic checkpoints, a
crash/resume cycle, and a lockstep=False wall-clock phase.  At the end
the process must show bounded RSS growth, quiesced queue depths, and
self-consistent counters/histograms — the designed-right claims (fixed
slot array, LRU-bounded caches, fixed-bucket histograms) proven under
sustained load.  scripts/soak_serve_stream.py is the hours-scale
variant of the same loop.
"""

import gc
import os
import threading
import time

import numpy as np
import pytest

from upmix.config import UpmixConfig
from upmix.models.streaming import BatchStreamingUpmixer
from upmix.serve_stream import StreamServer, StreamSession, stream_client

from helpers import make_stereo

HW = 256
SR = 8000.0
EDGES = [0.0, 400.0, 1600.0]


def _cfg():
    return UpmixConfig.streaming(EDGES, sr=SR, hw_block_size=HW)


def _pool():
    return BatchStreamingUpmixer(_cfg(), HW, n_streams=4)


def rss_kb() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1])
    raise RuntimeError("no VmRSS")  # pragma: no cover


def _full_client(addr, seed, n_blocks):
    L, R = make_stereo(n_blocks * HW, SR, seed=seed)
    got = stream_client(*addr, L.astype(np.float32), R.astype(np.float32))
    assert all(len(g) == n_blocks * HW for g in got)
    assert all(np.isfinite(np.asarray(g)).all() for g in got)


def _abrupt_client(addr, seed, n_blocks=2):
    """Connect, send a couple of blocks, vanish without finish/drain —
    the RST/half-close churn the slot lifecycle must absorb."""
    L, R = make_stereo(n_blocks * HW, SR, seed=seed)
    L, R = L.astype(np.float32), R.astype(np.float32)
    sess = StreamSession(*addr)
    for b in range(n_blocks):
        sess.send_block(L[b * HW : (b + 1) * HW], R[b * HW : (b + 1) * HW])
    sess.close()  # no finish(): server sees EOF mid-stream


def _soak_round(addr, rnd):
    threads = [
        threading.Thread(target=_full_client, args=(addr, 1000 + rnd, 4)),
        threading.Thread(target=_full_client, args=(addr, 2000 + rnd, 5)),
        threading.Thread(target=_abrupt_client, args=(addr, 3000 + rnd)),
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive(), f"round {rnd}: client thread hung"


def _quiesce(srv, timeout=30.0):
    """Wait until every slot is free and no input is queued."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        g = srv.metrics_snapshot()["gauges"]
        if g["slots_active"] == g["slots_draining"] == 0 and (
            g["queued_input_blocks"] == 0
        ):
            return g
        time.sleep(0.05)
    raise AssertionError(f"server never quiesced: {srv.metrics_snapshot()['gauges']}")


ROUNDS = int(os.environ.get("SOAK_ROUNDS", "18"))
WARM_ROUNDS = 3
# Bound on steady-state RSS drift over the soak.  Observed drift on this
# box is ~0-6 MB (allocator/GC noise); a real per-session leak of even
# 100 KB would blow through this at 3 sessions/round.
RSS_BOUND_KB = 40 * 1024


def test_serve_soak_leak_gate(tmp_path):
    ckpt = str(tmp_path / "soak_sessions.npz")
    with StreamServer(_pool(), lockstep=True) as srv:
        addr = srv.address
        for rnd in range(WARM_ROUNDS):  # warm compile caches + allocator
            _soak_round(addr, rnd)
        _quiesce(srv)
        gc.collect()
        rss0 = rss_kb()
        snap0 = srv.metrics_snapshot()

        for rnd in range(WARM_ROUNDS, WARM_ROUNDS + ROUNDS):
            _soak_round(addr, rnd)
            if rnd % 5 == 0:
                srv.save_checkpoint(ckpt)

        gauges = _quiesce(srv)
        gc.collect()
        rss1 = rss_kb()
        snap1 = srv.metrics_snapshot()

    # -- leak gate ---------------------------------------------------------
    growth = rss1 - rss0
    assert growth < RSS_BOUND_KB, (
        f"RSS grew {growth/1024:.1f} MB over {ROUNDS} soak rounds "
        f"({ROUNDS * 3} sessions) — bound {RSS_BOUND_KB/1024:.0f} MB"
    )

    # -- queue depths / slot lifecycle --------------------------------------
    assert gauges["queued_input_blocks"] == 0
    assert gauges["slots_active"] == 0 and gauges["slots_draining"] == 0
    assert gauges["slots_parked"] + gauges["slots_free"] == snap1["config"]["n_slots"]

    # -- counter/histogram sanity -------------------------------------------
    c0, c1 = snap0["counters"], snap1["counters"]
    sessions = ROUNDS * 3
    assert c1["accepted"] - c0["accepted"] == sessions
    assert c1["rejected"] == c0["rejected"]  # 4 slots, ≤3 concurrent
    assert c1["checkpoints"] - c0["checkpoints"] >= ROUNDS // 5
    assert c1["blocks"] > c0["blocks"] and c1["frames"] > c0["frames"]
    assert c1["dispatcher_failures"] == 0
    for k, v in c1.items():
        assert v >= c0[k], f"counter {k} went backwards"
    for hist in ("dispatch_seconds", "cycle_seconds"):
        h0, h1 = snap0[hist], snap1[hist]
        # fixed bucket layout: growth in counts, never in structure
        assert len(h1["buckets"]) == len(h0["buckets"])
        assert h1["count"] >= h0["count"]
        cums = [c for _b, c in h1["buckets"]]
        assert cums == sorted(cums), "cumulative bucket counts not monotone"
        assert cums[-1] <= h1["count"]  # overflow rides count, not a bucket
    assert snap1["cycle_seconds"]["count"] == c1["blocks"]


def test_soak_resume_cycle(tmp_path):
    # Crash/resume churn: a session checkpointed mid-stream continues on
    # a fresh server with correct frame accounting, while the old
    # server's abrupt death mid-session leaks nothing into the new one.
    path = str(tmp_path / "sessions.npz")
    n_blocks = 8
    L, R = make_stereo(n_blocks * HW, SR, seed=7)
    L, R = L.astype(np.float32), R.astype(np.float32)

    srv_a = StreamServer(_pool(), lockstep=True).start()
    sess = StreamSession(*srv_a.address)
    for b in range(4):
        sess.send_block(L[b * HW : (b + 1) * HW], R[b * HW : (b + 1) * HW])
    time.sleep(0.2)  # let the reader thread enqueue server-side
    assert srv_a.save_checkpoint(path) == 1
    token = sess.token
    sess.close()
    srv_a.close()

    srv_b = StreamServer(_pool(), lockstep=True, checkpoint=path).start()
    try:
        snap = srv_b.metrics_snapshot()
        assert snap["gauges"]["slots_parked"] == 1
        sess2 = StreamSession(*srv_b.address, token=token)
        assert sess2.server_in_frames == 4 * HW
        for b in range(4, n_blocks):
            sess2.send_block(L[b * HW : (b + 1) * HW], R[b * HW : (b + 1) * HW])
        sess2.finish()
        out = sess2.recv_frames(n_blocks * HW - sess2.server_out_frames)
        assert np.isfinite(out).all()
        sess2.close()
        snap = srv_b.metrics_snapshot()
        assert snap["counters"]["resumed"] == 1
        assert snap["counters"]["accepted"] == 1
    finally:
        srv_b.close()


def test_soak_script_smoke(tmp_path):
    # The hours-scale script variant must stay runnable; 3 seconds of
    # traffic, JSON summary, clean exit.
    import json
    import subprocess
    import sys

    from helpers import cpu_child_env

    root = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    out = str(tmp_path / "soak.json")
    r = subprocess.run(
        [sys.executable, os.path.join(root, "scripts", "soak_serve_stream.py"),
         "--seconds", "3", "--status-every", "2", "--json", out],
        capture_output=True, text=True, env=cpu_child_env(), cwd=root,
        timeout=300,
    )
    assert r.returncode == 0, r.stdout[-800:] + r.stderr[-1200:]
    summary = json.load(open(out))
    assert summary["sessions"] > 0 and summary["client_errors"] == 0
    assert summary["final_counters"]["dispatcher_failures"] == 0


def test_soak_realtime_tick_phase():
    # lockstep=False: wall-clock ticks, slow/absent clients get zeros
    # injected (late_zero_blocks) and the pool never stalls.
    pool = BatchStreamingUpmixer(_cfg(), HW, n_streams=2)
    with StreamServer(pool, lockstep=False, sr=SR * 16) as srv:
        for rnd in range(4):
            _full_client(srv.address, 4000 + rnd, 4)
        snap = srv.metrics_snapshot()
        assert snap["counters"]["accepted"] == 4
        assert snap["counters"]["dispatcher_failures"] == 0
        _quiesce(srv)


def _open_fds() -> int:
    return len(os.listdir("/proc/self/fd"))


def test_server_churn_leaks_no_fds_or_threads():
    # Whole-SERVER churn (vs the whole-session churn above): create a
    # server, serve one full + one abrupt client, close it — many times
    # in one process — and the process-level resources must stay flat.
    # This is the gate that catches the blocked-accept class of bug
    # directly: a close() that leaves its accept thread wedged (or its
    # connection threads parked in writer.join) leaks one thread and
    # one socket fd per server generation.
    for rnd in range(2):  # warm lazily-created fds (jax, caches)
        with StreamServer(_pool(), lockstep=True) as srv:
            _full_client(srv.address, 5000 + rnd, 3)
    gc.collect()
    fds0, thr0 = _open_fds(), threading.active_count()
    n = 12
    for rnd in range(n):
        with StreamServer(_pool(), lockstep=True) as srv:
            _full_client(srv.address, 6000 + rnd, 3)
            _abrupt_client(srv.address, 7000 + rnd)
            time.sleep(0.05)  # let the abrupt session reach DRAINING
    gc.collect()
    time.sleep(0.3)  # conn threads finish teardown after close()
    fds1, thr1 = _open_fds(), threading.active_count()
    assert fds1 - fds0 <= 4, f"fd leak: {fds0} -> {fds1} over {n} servers"
    assert thr1 - thr0 <= 2, (
        f"thread leak: {thr0} -> {thr1} over {n} servers"
    )
