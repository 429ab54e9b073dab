"""Seeded protocol-interleaving fuzz of the stream server.

test_serve_stream.py pins CHOSEN interleavings; this sweep drives
RANDOM ones against randomly-built servers (donation, mesh, pipeline
drawn per seed): concurrent full sessions with random lengths and mix
modes, mid-stream aborts (plain close and RST, output never read),
malformed hellos, unknown resume tokens, metrics queries, and
checkpoints fired at random instants while traffic flows.  A second
sweep randomizes the checkpoint/restart/resume SPLIT POINT and the
queued-block depth riding the checkpoint (the fixed-cut version lives
in test_serve_stream.py).

Contract per seed:
- every well-behaved client receives its exact single-engine
  warmup-aligned output (the same bar as test_serve_stream._check);
- every misbehaving actor observes a clean protocol error or EOF —
  never a hang, never a poisoned neighbour;
- the server quiesces afterwards: all slots freed, zero dispatcher
  failures, counters exactly accounting every actor the fuzz ran.

The schedule is deterministic by seed; thread interleavings still vary
run to run — that variation is the point, the assertions must hold for
all of them.  Reference surface: the reference serves exactly one
stream with no protocol at all (bela/upmix.cpp:516-553) — this is the
adversarial-traffic insurance for the serving layer built on top.
"""

import socket
import struct
import threading
import time

import numpy as np
import pytest

from upmix.models.streaming import BatchStreamingUpmixer
from upmix.serve_stream import (
    MAGIC_HELLO,
    MAGIC_REPLY,
    StreamServer,
    StreamSession,
    _ST_FREE,
    fetch_metrics,
    stream_client,
)

from helpers import make_stereo
from test_serve_stream import HW, SR, _aligned_reference, _cfg, _check

BASE_SEED = 20260821


def _make_server(rng):
    """Random lockstep server geometry: the pool (pipeline 1 or 2),
    optionally without state donation or mesh-sharded over 2 virtual
    devices.  Returns (server, n_slots)."""
    kind = int(rng.integers(5))
    if kind == 3:
        pool = BatchStreamingUpmixer(_cfg(), HW, n_streams=8, donate=False)
        pipeline = int(rng.choice([1, 2]))
    elif kind == 4:
        import jax

        mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("data",))
        pool = BatchStreamingUpmixer(_cfg(), HW, n_streams=4, mesh=mesh)
        pipeline = int(rng.choice([1, 2]))
    else:
        pool = BatchStreamingUpmixer(_cfg(), HW, n_streams=4)
        pipeline = 2 if kind == 2 else 1
    srv = StreamServer(pool, lockstep=True, pipeline=pipeline)
    return srv.start(), pool.n_streams


def _recv_exact(sock, n):
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            break
        buf.extend(chunk)
    return bytes(buf)


def _full_client(srv, seed, out, i):
    """Well-behaved session: random length (ragged tail), random mix;
    records (got, L, R, mix) for the orchestrator to verify."""
    try:
        rng = np.random.default_rng(seed)
        n = int(rng.integers(3, 13)) * HW + int(rng.integers(0, HW))
        mix = "lcr" if rng.random() < 0.3 else "stereo_sum"
        L, R = make_stereo(n, SR, seed=seed)
        L, R = L.astype(np.float32), R.astype(np.float32)
        got = stream_client(*srv.address, L, R, mix=mix)
        out[i] = (got, L, R, mix)
    except Exception as e:  # surfaced by the orchestrator's assert
        out[i] = e


def _aborter(srv, seed, out, i):
    """Sends 0-4 blocks then vanishes without reading output — half the
    time via RST (SO_LINGER 0), half via plain close."""
    try:
        rng = np.random.default_rng(seed)
        k = int(rng.integers(0, 5))
        sess = StreamSession(*srv.address)
        if k:
            L, R = make_stereo(k * HW, SR, seed=seed)
            L, R = L.astype(np.float32), R.astype(np.float32)
            for b in range(k):
                sess.send_block(L[b * HW:(b + 1) * HW],
                                R[b * HW:(b + 1) * HW])
        if rng.random() < 0.5:
            sess.sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                                 struct.pack("ii", 1, 0))
        sess.close()
        out[i] = "aborted"
    except Exception as e:
        out[i] = e


def _bad_hello(srv, rng):
    """Malformed handshake: the server must reply status 2 (or just see
    the close) and never allocate a slot."""
    variant = int(rng.integers(4))
    with socket.create_connection(srv.address, timeout=30) as s:
        if variant == 0:
            s.sendall(b"NOPE" + struct.pack("<II", 1, 0))
        elif variant == 1:
            s.sendall(MAGIC_HELLO + struct.pack("<II", 99, 0))  # bad version
        elif variant == 2:
            s.sendall(MAGIC_HELLO + struct.pack("<II", 1, 7))  # bad mix
        else:
            s.sendall(MAGIC_HELLO[:2])  # truncated hello, then close
            return
        reply = _recv_exact(s, 20)
        assert reply[:4] == MAGIC_REPLY
        assert struct.unpack("<I", reply[4:8])[0] == 2  # bad-hello status


def _bad_token(srv, rng):
    token = bytes(rng.integers(1, 256, 16, dtype=np.uint8))
    with pytest.raises(ConnectionError, match="unknown or expired"):
        StreamSession(*srv.address, token=token)


def _quiesce(srv, timeout=90.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with srv._lock:
            if all(s.state == _ST_FREE for s in srv._slots):
                return
        time.sleep(0.02)
    with srv._lock:
        states = [s.state for s in srv._slots]
    raise AssertionError(f"server did not quiesce: slot states {states}")


@pytest.mark.parametrize("seed", range(BASE_SEED, BASE_SEED + 6))
def test_fuzz_serve_interleavings(seed, tmp_path):
    rng = np.random.default_rng(seed)
    srv, n_slots = _make_server(rng)
    n_accepted = n_rejected = n_checkpoints = 0
    try:
        for rnd in range(3):
            # 1-3 full clients + at most one aborter: never exceeds the
            # smallest pool (4 slots), so pool-full cannot occur and
            # every accept/reject is accounted exactly.
            n_full = int(rng.integers(1, 4))
            results = [None] * (n_full + 1)
            threads = [
                threading.Thread(
                    target=_full_client,
                    args=(srv, seed * 100 + rnd * 10 + i, results, i),
                )
                for i in range(n_full)
            ]
            with_abort = rng.random() < 0.5
            if with_abort:
                threads.append(
                    threading.Thread(
                        target=_aborter,
                        args=(srv, seed * 100 + rnd * 10 + 9, results,
                              n_full),
                    )
                )
            for t in threads:
                t.start()
            n_accepted += n_full + int(with_abort)
            # Non-slot actors + a mid-traffic checkpoint, interleaved
            # while the sessions stream.
            if rng.random() < 0.6:
                _bad_hello(srv, rng)
            if rng.random() < 0.5:
                _bad_token(srv, rng)
                n_rejected += 1
            if rng.random() < 0.5:
                time.sleep(float(rng.uniform(0.0, 0.05)))
                srv.save_checkpoint(str(tmp_path / f"ck{rnd}.npz"))
                n_checkpoints += 1
            if rng.random() < 0.5:
                snap = fetch_metrics(*srv.address)
                assert snap["counters"]["dispatcher_failures"] == 0
            for t in threads:
                t.join(timeout=180)
                assert not t.is_alive(), "fuzz actor hung"
            for i in range(n_full):
                assert not isinstance(results[i], Exception), (
                    f"round {rnd} client {i}: {results[i]!r}"
                )
                got, L, R, mix = results[i]
                _check(got, _aligned_reference(L, R, mix=mix))
            if with_abort:
                assert results[n_full] == "aborted", (
                    f"round {rnd} aborter: {results[n_full]!r}"
                )
            _quiesce(srv)

        stats = srv.stats
        assert stats["dispatcher_failures"] == 0
        assert stats["accepted"] == n_accepted
        assert stats["rejected"] == n_rejected  # bad tokens only
        assert stats["checkpoints"] == n_checkpoints
        assert stats["late_zero_blocks"] == 0  # lockstep never injects
        snap = srv.metrics_snapshot()
        assert snap["gauges"]["slots_active"] == 0
        assert snap["gauges"]["slots_draining"] == 0
        assert snap["gauges"]["queued_input_blocks"] == 0
    finally:
        srv.close()


@pytest.mark.parametrize("seed", range(BASE_SEED + 100, BASE_SEED + 103))
def test_fuzz_realtime_mode_interleavings(seed, tmp_path):
    # lockstep=False (wall-clock ticks, sped up 4x): random concurrent
    # full sessions + aborts + bad actors while the tick runs free.
    # Output EXACTNESS is deliberately not asserted — a starved client
    # thread on a loaded box legitimately receives late-zero blocks
    # (the designed realtime degradation) — but every client must
    # COMPLETE with the right shape and finite values, the server must
    # quiesce, and the counters must account every actor.
    rng = np.random.default_rng(seed)
    pool = BatchStreamingUpmixer(_cfg(), HW, n_streams=4)
    srv = StreamServer(pool, lockstep=False, sr=SR * 4).start()
    n_accepted = 0
    try:
        for rnd in range(2):
            n_full = int(rng.integers(1, 4))
            results = [None] * (n_full + 1)
            threads = [
                threading.Thread(
                    target=_full_client,
                    args=(srv, seed * 100 + rnd * 10 + i, results, i),
                )
                for i in range(n_full)
            ]
            with_abort = rng.random() < 0.5
            if with_abort:
                threads.append(
                    threading.Thread(
                        target=_aborter,
                        args=(srv, seed * 100 + rnd * 10 + 9, results,
                              n_full),
                    )
                )
            for t in threads:
                t.start()
            n_accepted += n_full + int(with_abort)
            if rng.random() < 0.5:
                _bad_hello(srv, rng)
            if rng.random() < 0.4:
                srv.save_checkpoint(str(tmp_path / f"rt{rnd}.npz"))
            for t in threads:
                t.join(timeout=180)
                assert not t.is_alive(), "realtime fuzz actor hung"
            for i in range(n_full):
                assert not isinstance(results[i], Exception), (
                    f"round {rnd} client {i}: {results[i]!r}"
                )
                got, L, R, mix = results[i]
                want_ch = 3 if mix == "lcr" else 2
                assert len(got) == want_ch
                for g in got:
                    assert len(g) == len(L)
                    assert np.all(np.isfinite(np.asarray(g)))
            if with_abort:
                assert results[n_full] == "aborted"
            _quiesce(srv)
        assert srv.stats["dispatcher_failures"] == 0
        assert srv.stats["accepted"] == n_accepted
    finally:
        srv.close()


def _warmup_skip():
    from upmix.models.streaming import stream_warmup_blocks

    return (stream_warmup_blocks(_cfg()) - 1) * HW


@pytest.mark.parametrize("seed", range(BASE_SEED + 50, BASE_SEED + 53))
def test_fuzz_checkpoint_restart_resume_random_split(seed, tmp_path):
    """Random cut point + random queued-block depth through the full
    kill/restore/resume cycle, two sessions (the second gates lockstep
    so the queued blocks provably ride the checkpoint undispatched)."""
    rng = np.random.default_rng(seed)
    n_blocks = int(rng.integers(8, 14))
    cut = int(rng.integers(1, n_blocks - 3))
    queued = int(rng.integers(0, min(4, n_blocks - cut)))
    mix_x = "lcr" if rng.random() < 0.5 else "stereo_sum"

    def pool_factory():
        return BatchStreamingUpmixer(_cfg(), HW, n_streams=4)

    def mesh_pool_factory():
        import jax

        mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("data",))
        return BatchStreamingUpmixer(_cfg(), HW, n_streams=4, mesh=mesh)

    # Randomly restore across mesh topologies: the checkpoint codec is
    # topology-free, so a plain-pool checkpoint must resume exactly on
    # a mesh-sharded replacement server and vice versa.
    src_factory = mesh_pool_factory if rng.random() < 0.25 else pool_factory
    dst_factory = mesh_pool_factory if rng.random() < 0.25 else pool_factory

    Lx, Rx = make_stereo(n_blocks * HW, SR, seed=seed)
    Ly, Ry = make_stereo(n_blocks * HW, SR, seed=seed + 7919)
    Lx, Rx, Ly, Ry = (a.astype(np.float32) for a in (Lx, Rx, Ly, Ry))
    with StreamServer(pool_factory(), lockstep=True) as ref_srv:
        ref_x = stream_client(*ref_srv.address, Lx, Rx, mix=mix_x)
    with StreamServer(pool_factory(), lockstep=True) as ref_srv:
        ref_y = stream_client(*ref_srv.address, Ly, Ry)

    path = str(tmp_path / "sessions.npz")
    srv_a = StreamServer(src_factory(), lockstep=True).start()
    sx = StreamSession(*srv_a.address, mix=mix_x)
    sy = StreamSession(*srv_a.address)
    for b in range(cut):
        sx.send_block(Lx[b * HW:(b + 1) * HW], Rx[b * HW:(b + 1) * HW])
        sy.send_block(Ly[b * HW:(b + 1) * HW], Ry[b * HW:(b + 1) * HW])
    due = max(0, cut * HW - _warmup_skip())
    px = sx.recv_frames(due) if due else np.zeros((0, sx.out_channels), "<f4")
    py = sy.recv_frames(due) if due else np.zeros((0, sy.out_channels), "<f4")
    # X runs ahead; lockstep holds these queued (Y sends nothing more),
    # so they must ride the checkpoint as captured-but-unprocessed input.
    for b in range(cut, cut + queued):
        sx.send_block(Lx[b * HW:(b + 1) * HW], Rx[b * HW:(b + 1) * HW])
    time.sleep(0.3)  # let the reader thread enqueue them server-side
    assert srv_a.save_checkpoint(path) == 2
    sx.close(), sy.close()
    srv_a.close()

    srv_b = StreamServer(dst_factory(), lockstep=True,
                         checkpoint=path).start()
    try:
        sx2 = StreamSession(*srv_b.address, token=sx.token, mix=mix_x)
        sy2 = StreamSession(*srv_b.address, token=sy.token)
        assert sx2.server_in_frames == (cut + queued) * HW
        assert sy2.server_in_frames == cut * HW
        assert sx2.server_out_frames == len(px)
        assert sy2.server_out_frames == len(py)
        for b in range(cut + queued, n_blocks):
            sx2.send_block(Lx[b * HW:(b + 1) * HW], Rx[b * HW:(b + 1) * HW])
        for b in range(cut, n_blocks):
            sy2.send_block(Ly[b * HW:(b + 1) * HW], Ry[b * HW:(b + 1) * HW])
        sx2.finish(), sy2.finish()
        gx = np.concatenate([px, sx2.recv_frames(n_blocks * HW - len(px))])
        gy = np.concatenate([py, sy2.recv_frames(n_blocks * HW - len(py))])
        sx2.close(), sy2.close()
    finally:
        srv_b.close()
    np.testing.assert_array_equal(gx, np.column_stack(ref_x))
    np.testing.assert_array_equal(gy, np.column_stack(ref_y))
