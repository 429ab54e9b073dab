"""Multi-client stream-server tests (upmix/serve_stream.py): the
socket surface must hand each client exactly the warmup-aligned output
its signal would get from the single-stream engine — concurrently, with
slot churn and pool-full rejection (SURVEY.md §5 failure handling; the
serving counterpart of the run_pipe tests)."""

import threading

import numpy as np
import pytest

from upmix.config import UpmixConfig
from upmix.models.streaming import BatchStreamingUpmixer, StreamingUpmixer
from upmix.serve_stream import StreamServer, stream_client

from helpers import make_stereo, snr_db

HW = 256
SR = 8000.0
EDGES = [0.0, 400.0, 1600.0]


def _cfg():
    return UpmixConfig.streaming(EDGES, sr=SR, hw_block_size=HW)


@pytest.fixture(scope="module")
def server():
    pool = BatchStreamingUpmixer(_cfg(), HW, n_streams=4)
    with StreamServer(pool, lockstep=True) as srv:
        yield srv


def _aligned_reference(L, R, mix="stereo_sum"):
    """What a warmup-aligned client must receive: run the single-stream
    engine over the (padded) signal plus zero drain blocks, drop the
    leading warmup silence, trim to the input length."""
    from upmix.models.streaming import stream_warmup_blocks

    eng = StreamingUpmixer(_cfg(), HW)
    n = len(L)
    pad = (-n) % HW
    xl = np.concatenate([L, np.zeros(pad, np.float32)])
    xr = np.concatenate([R, np.zeros(pad, np.float32)])
    skip = (stream_warmup_blocks(_cfg()) - 1) * HW
    outs = []
    zeros = np.zeros(HW, np.float32)
    total = len(xl)
    blocks = [
        (xl[i : i + HW], xr[i : i + HW]) for i in range(0, total, HW)
    ]
    emitted = 0
    bi = 0
    while emitted < total:
        bl, br = blocks[bi] if bi < len(blocks) else (zeros, zeros)
        bi += 1
        c, ls, rs = (np.asarray(o) for o in eng.push_block(bl, br))
        if mix == "lcr":
            out = np.column_stack([c, ls, rs])
        else:
            out = np.column_stack([ls + 0.5 * c, rs + 0.5 * c])
        if skip:
            k = min(skip, len(out))
            out = out[k:]
            skip -= k
        out = out[: total - emitted]
        if len(out):
            outs.append(out)
            emitted += len(out)
    ref = np.concatenate(outs)[:n]
    return tuple(np.ascontiguousarray(ref[:, ch]) for ch in range(ref.shape[1]))


def _check(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        g, r = np.asarray(g), np.asarray(r)
        assert g.shape == r.shape
        if np.abs(r).max() > 0:
            assert snr_db(r, g) > 80.0
        else:
            np.testing.assert_allclose(g, r, atol=1e-6)


def test_single_client_round_trip(server):
    # Includes a short final block (client pads, output trimmed to n).
    L, R = make_stereo(10 * HW + 100, SR, seed=60)
    L, R = L.astype(np.float32), R.astype(np.float32)
    got = stream_client(*server.address, L, R)
    _check(got, _aligned_reference(L, R))


def test_lcr_mix(server):
    L, R = make_stereo(6 * HW, SR, seed=61)
    L, R = L.astype(np.float32), R.astype(np.float32)
    got = stream_client(*server.address, L, R, mix="lcr")
    assert len(got) == 3
    _check(got, _aligned_reference(L, R, mix="lcr"))


def test_concurrent_clients_are_isolated(server):
    # Three different signals at once: each client gets exactly its own
    # stream's result, as if it were alone on a dedicated engine.
    sigs = []
    for seed in (62, 63, 64):
        L, R = make_stereo(8 * HW, SR, seed=seed)
        sigs.append((L.astype(np.float32), R.astype(np.float32)))
    results = [None] * len(sigs)

    def go(i):
        results[i] = stream_client(*server.address, *sigs[i])

    threads = [threading.Thread(target=go, args=(i,)) for i in range(len(sigs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for i, (L, R) in enumerate(sigs):
        assert results[i] is not None, f"client {i} did not finish"
        _check(results[i], _aligned_reference(L, R))


def test_slot_reuse_after_churn(server):
    # Sequential sessions reuse slots; a re-warmed slot must behave like
    # a fresh engine (no state leakage from the previous occupant).
    for seed in (65, 66):
        L, R = make_stereo(5 * HW, SR, seed=seed)
        L, R = L.astype(np.float32), R.astype(np.float32)
        got = stream_client(*server.address, L, R)
        _check(got, _aligned_reference(L, R))


def test_pool_full_rejection():
    # A server with a 1-slot pool serves one client and rejects a
    # second while the first is live; the slot frees afterwards.
    pool = BatchStreamingUpmixer(_cfg(), HW, n_streams=1)
    with StreamServer(pool, lockstep=True) as srv:
        import socket
        import struct

        from upmix.serve_stream import MAGIC_HELLO, MAGIC_REPLY, _read_exact

        hold = socket.create_connection(srv.address, timeout=10)
        hold.sendall(MAGIC_HELLO + struct.pack("<II", 1, 0))
        reply = _read_exact(hold, 20)
        assert reply[:4] == MAGIC_REPLY
        assert struct.unpack("<I", reply[4:8])[0] == 0  # accepted

        with pytest.raises(ConnectionError, match="full"):
            L, R = make_stereo(2 * HW, SR, seed=67)
            stream_client(
                *srv.address, L.astype(np.float32), R.astype(np.float32)
            )
        hold.close()
        # The abandoned slot drains out and frees; a new session works.
        deadline = 50
        last = None
        for _ in range(deadline):
            try:
                L, R = make_stereo(2 * HW, SR, seed=68)
                last = stream_client(
                    *srv.address, L.astype(np.float32), R.astype(np.float32)
                )
                break
            except ConnectionError:
                import time

                time.sleep(0.1)
        assert last is not None, "slot never freed after client abort"


def test_realtime_tick_mode_completes():
    # lockstep=False ticks on the wall clock and never stalls on a slow
    # client; a prompt client still gets a complete stream back.
    pool = BatchStreamingUpmixer(_cfg(), HW, n_streams=2)
    with StreamServer(pool, lockstep=False, sr=SR * 8) as srv:
        L, R = make_stereo(4 * HW, SR, seed=69)
        got = stream_client(
            *srv.address, L.astype(np.float32), R.astype(np.float32)
        )
        assert len(got) == 2
        assert all(np.isfinite(np.asarray(g)).all() for g in got)
        assert all(len(g) == 4 * HW for g in got)


def test_cli_serve_stream_round_trip(tmp_path):
    # The `upmix - --serve-stream` surface end-to-end: spawn the CLI
    # server as a subprocess (CPU env), connect with stream_client, and
    # check the aligned round trip against the single-stream engine.
    import re
    import subprocess
    import sys
    import time

    from helpers import cpu_child_env

    proc = subprocess.Popen(
        [
            sys.executable, "-m", "upmix.cli", "-",
            "--serve-stream", "0", "--sr", str(SR), "--hw-block", str(HW),
            "--band-edges", ",".join(str(e) for e in EDGES),
            "--streams", "2", "--lockstep",
        ],
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        text=True,
        env=cpu_child_env(),
    )
    try:
        addr = None
        deadline = time.time() + 120
        while time.time() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            m = re.search(r"stream server on ([\d.]+):(\d+)", line)
            if m:
                addr = (m.group(1), int(m.group(2)))
                break
        assert addr is not None, "server never announced its address"
        L, R = make_stereo(6 * HW, SR, seed=70)
        L, R = L.astype(np.float32), R.astype(np.float32)
        got = stream_client(*addr, L, R, timeout=120.0)
        _check(got, _aligned_reference(L, R))
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def test_rst_abort_frees_slot_and_pool_keeps_serving():
    # A client that dies with a TCP RST mid-stream (no clean half-close)
    # must not leak its slot or stall the lockstep dispatcher: the
    # server transitions the slot to draining on ANY reader exit path.
    import socket
    import struct

    from upmix.serve_stream import MAGIC_HELLO, _read_exact

    pool = BatchStreamingUpmixer(_cfg(), HW, n_streams=1)
    with StreamServer(pool, lockstep=True) as srv:
        rude = socket.create_connection(srv.address, timeout=10)
        rude.sendall(MAGIC_HELLO + struct.pack("<II", 1, 0))
        assert len(_read_exact(rude, 20)) == 20  # accepted
        # Send 1.5 blocks then abort with RST (SO_LINGER zero).
        junk = np.zeros(int(1.5 * HW * 2), np.float32).tobytes()
        rude.sendall(junk)
        rude.setsockopt(
            socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0)
        )
        rude.close()

        # The single slot must free and the next client must complete.
        import time

        L, R = make_stereo(3 * HW, SR, seed=71)
        L, R = L.astype(np.float32), R.astype(np.float32)
        got = None
        for _ in range(100):
            try:
                got = stream_client(*srv.address, L, R, timeout=30.0)
                break
            except ConnectionError:
                time.sleep(0.1)
        assert got is not None, "slot leaked after RST abort"
        _check(got, _aligned_reference(L, R))


def test_non_donating_pool_serves_clients():
    # A pool built without state donation composes with the socket stack
    # like the default one: a client's warmup-aligned output matches the
    # single-stream engine.
    pool = BatchStreamingUpmixer(_cfg(), HW, n_streams=8, donate=False)
    with StreamServer(pool, lockstep=True) as srv:
        L, R = make_stereo(8 * HW, SR, seed=67)
        L, R = L.astype(np.float32), R.astype(np.float32)
        got = stream_client(*srv.address, L, R)
        _check(got, _aligned_reference(L, R))


def test_run_stream_server_pool_options():
    # The CLI entry (run_stream_server) forwards its explicit pool
    # options — a lockstep pool built through the factory path, not a
    # hand-built pool — and a typo'd keyword raises at the call site
    # instead of inside pool construction.
    from upmix.serve_stream import run_stream_server

    srv = run_stream_server(
        0, sr=SR, n_streams=8, hw_block_size=HW, band_edges=EDGES,
        lockstep=True, engine="xla", verbose=False,
    )
    try:
        assert isinstance(srv.pool, BatchStreamingUpmixer)
        assert srv.pool.n_streams == 8
        L, R = make_stereo(6 * HW, SR, seed=91)
        got = stream_client(*srv.address, L.astype(np.float32),
                            R.astype(np.float32))
        _check(got, _aligned_reference(L.astype(np.float32),
                                       R.astype(np.float32)))
    finally:
        srv.close()

    with pytest.raises(TypeError):
        run_stream_server(0, sr=SR, lockstp=True)
    with pytest.raises(ValueError, match="unknown engine"):
        run_stream_server(0, sr=SR, engine="pallas", verbose=False)


# -- checkpoint / resume (protocol v2) ---------------------------------------


def _warmup_skip():
    from upmix.models.streaming import stream_warmup_blocks

    return (stream_warmup_blocks(_cfg()) - 1) * HW


def _one_shot(pool_factory, L, R, mix="stereo_sum"):
    """Uninterrupted run of the same signal on a fresh server: the exact
    reference for a checkpointed-and-resumed session."""
    with StreamServer(pool_factory(), lockstep=True) as srv:
        return stream_client(*srv.address, L, R, mix=mix)


def _send_and_read(sess, xl, xr, start_blk, n_blocks, already_read):
    """Send blocks [start_blk, start_blk + n_blocks) and read every output
    frame due after the corresponding dispatches (lockstep: one dispatch
    per block when this is the only stalled sender)."""
    for b in range(start_blk, start_blk + n_blocks):
        sess.send_block(xl[b * HW : (b + 1) * HW], xr[b * HW : (b + 1) * HW])
    due = max(0, (start_blk + n_blocks) * HW - _warmup_skip()) - already_read
    return sess.recv_frames(due) if due > 0 else np.zeros((0, sess.out_channels), "<f4")


@pytest.mark.parametrize("pool_kind", ["xla", "mesh"])
def test_checkpoint_resume_continues_exactly(tmp_path, pool_kind):
    # A session checkpointed mid-stream and resumed on a NEW server (new
    # pool, state injected from the checkpoint) must produce the exact
    # continuation of an uninterrupted run — the serving product's
    # failure-recovery contract (SURVEY.md §5 checkpoint/resume).
    from upmix.serve_stream import StreamSession

    def pool_factory():
        mesh = None
        if pool_kind == "mesh":
            import jax

            mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("data",))
        return BatchStreamingUpmixer(_cfg(), HW, n_streams=8, mesh=mesh)

    n_blocks = 12
    L, R = make_stereo(n_blocks * HW, SR, seed=101)
    L, R = L.astype(np.float32), R.astype(np.float32)
    ref = _one_shot(pool_factory, L, R)

    path = str(tmp_path / "sessions.npz")
    cut = 5  # blocks sent before the restart

    srv_a = StreamServer(pool_factory(), lockstep=True).start()
    sess = StreamSession(*srv_a.address)
    assert sess.server_in_frames == 0 and len(sess.token) == 16
    part1 = _send_and_read(sess, L, R, 0, cut, 0)
    n_saved = srv_a.save_checkpoint(path)
    assert n_saved == 1
    sess.close()  # connection dies with the "crashed" server
    srv_a.close()

    srv_b = StreamServer(pool_factory(), lockstep=True,
                         checkpoint=path).start()
    try:
        sess2 = StreamSession(*srv_b.address, token=sess.token)
        assert sess2.server_in_frames == cut * HW
        assert sess2.server_out_frames == len(part1)
        for b in range(cut, n_blocks):
            sess2.send_block(L[b * HW : (b + 1) * HW],
                             R[b * HW : (b + 1) * HW])
        sess2.finish()  # drain the tail
        part2 = sess2.recv_frames(n_blocks * HW - len(part1))
        sess2.close()
    finally:
        srv_b.close()

    got = np.concatenate([part1, part2])
    want = np.column_stack(ref)
    np.testing.assert_array_equal(got, want)


def test_checkpoint_captures_queued_blocks(tmp_path):
    # Blocks a client sent but the server had not yet dispatched (held
    # back by lockstep on another slot) ride the checkpoint and are
    # processed first after resume — no input is lost or re-requested.
    from upmix.serve_stream import StreamSession

    def pool_factory():
        return BatchStreamingUpmixer(_cfg(), HW, n_streams=4)

    n_blocks = 10
    Lx, Rx = make_stereo(n_blocks * HW, SR, seed=103)
    Ly, Ry = make_stereo(n_blocks * HW, SR, seed=104)
    arrs = [a.astype(np.float32) for a in (Lx, Rx, Ly, Ry)]
    Lx, Rx, Ly, Ry = arrs
    ref_x = _one_shot(pool_factory, Lx, Rx)
    ref_y = _one_shot(pool_factory, Ly, Ry)

    path = str(tmp_path / "sessions.npz")
    srv_a = StreamServer(pool_factory(), lockstep=True).start()
    sx = StreamSession(*srv_a.address)
    sy = StreamSession(*srv_a.address)
    # Interleaved sends: lockstep dispatches once BOTH slots have a
    # block, so neither client can run ahead before reading.
    for b in range(5):
        sx.send_block(Lx[b * HW : (b + 1) * HW], Rx[b * HW : (b + 1) * HW])
        sy.send_block(Ly[b * HW : (b + 1) * HW], Ry[b * HW : (b + 1) * HW])
    due = 5 * HW - _warmup_skip()
    px = sx.recv_frames(due)
    py = sy.recv_frames(due)
    # Two more blocks from X only: lockstep holds them queued (Y's 6th
    # block never arrives before the checkpoint).
    sx.send_block(Lx[5 * HW : 6 * HW], Rx[5 * HW : 6 * HW])
    sx.send_block(Lx[6 * HW : 7 * HW], Rx[6 * HW : 7 * HW])
    import time

    time.sleep(0.2)  # let the reader thread enqueue them server-side
    assert srv_a.save_checkpoint(path) == 2
    sx.close(), sy.close()
    srv_a.close()

    srv_b = StreamServer(pool_factory(), lockstep=True,
                         checkpoint=path).start()
    try:
        sx2 = StreamSession(*srv_b.address, token=sx.token)
        sy2 = StreamSession(*srv_b.address, token=sy.token)
        assert sx2.server_in_frames == 7 * HW  # the queued blocks count
        assert sy2.server_in_frames == 5 * HW
        for b in range(7, n_blocks):
            sx2.send_block(Lx[b * HW : (b + 1) * HW],
                           Rx[b * HW : (b + 1) * HW])
        for b in range(5, n_blocks):
            sy2.send_block(Ly[b * HW : (b + 1) * HW],
                           Ry[b * HW : (b + 1) * HW])
        sx2.finish(), sy2.finish()
        gx = np.concatenate([px, sx2.recv_frames(n_blocks * HW - len(px))])
        gy = np.concatenate([py, sy2.recv_frames(n_blocks * HW - len(py))])
        sx2.close(), sy2.close()
    finally:
        srv_b.close()
    np.testing.assert_array_equal(gx, np.column_stack(ref_x))
    np.testing.assert_array_equal(gy, np.column_stack(ref_y))


def test_resume_token_rejection_and_identity_guard(tmp_path):
    from upmix.serve_stream import StreamSession

    pool = BatchStreamingUpmixer(_cfg(), HW, n_streams=4)
    with StreamServer(pool, lockstep=True) as srv:
        with pytest.raises(ConnectionError, match="unknown or expired"):
            StreamSession(*srv.address, token=b"\x01" * 16)
        # New v2 sessions coexist with v1 clients on the same server.
        L, R = make_stereo(4 * HW, SR, seed=105)
        got = stream_client(*srv.address, L.astype(np.float32),
                            R.astype(np.float32))
        _check(got, _aligned_reference(L.astype(np.float32),
                                       R.astype(np.float32)))
        path = str(tmp_path / "ck.npz")
        srv.save_checkpoint(path)

    # A checkpoint only restores into a matching pool geometry.
    other = BatchStreamingUpmixer(_cfg(), HW, n_streams=8)
    with pytest.raises(ValueError, match="does not match"):
        StreamServer(other, lockstep=True, checkpoint=path)


def test_resume_ttl_reclaims_parked_slots(tmp_path):
    # A restored-but-never-resumed session reserves its slot FOREVER by
    # default; with resume_ttl the ghost's slot is reclaimed lazily
    # when an allocation would otherwise fail, and the late resume then
    # gets the unknown-token status.
    import time as _t

    from upmix.serve_stream import StreamSession

    def pool_factory():
        return BatchStreamingUpmixer(_cfg(), HW, n_streams=1)

    path = str(tmp_path / "ck.npz")
    srv_a = StreamServer(pool_factory(), lockstep=True).start()
    sess = StreamSession(*srv_a.address)
    L, R = make_stereo(2 * HW, SR, seed=110)
    L, R = L.astype(np.float32), R.astype(np.float32)
    _send_and_read(sess, L, R, 0, 2, 0)
    assert srv_a.save_checkpoint(path) == 1
    sess.close()
    srv_a.close()

    # Default (no ttl): the parked ghost holds the only slot.
    srv_b = StreamServer(pool_factory(), lockstep=True,
                         checkpoint=path).start()
    try:
        with pytest.raises(ConnectionError, match="full"):
            StreamSession(*srv_b.address)
    finally:
        srv_b.close()

    # With a ttl: the new client reclaims the expired parked slot and
    # the ghost's token is forgotten.
    srv_c = StreamServer(pool_factory(), lockstep=True, checkpoint=path,
                         resume_ttl=0.05).start()
    try:
        _t.sleep(0.1)
        s2 = StreamSession(*srv_c.address)
        assert srv_c.stats["parked_expired"] == 1
        with pytest.raises(ConnectionError, match="unknown or expired"):
            StreamSession(*srv_c.address, token=sess.token)
        s2.close()
    finally:
        srv_c.close()


def test_run_stream_server_snapshot_path(tmp_path):
    # The CLI entry restores parked sessions from --snapshot-path when
    # the file exists (and the CLI writes it back on shutdown).
    from upmix.serve_stream import StreamSession, run_stream_server

    path = str(tmp_path / "live.npz")
    kw = dict(sr=SR, n_streams=4, hw_block_size=HW, band_edges=EDGES,
              lockstep=True, engine="xla", verbose=False,
              snapshot_path=path)
    srv = run_stream_server(0, **kw)
    try:
        assert srv.snapshot_path == path
        L, R = make_stereo(6 * HW, SR, seed=107)
        L, R = L.astype(np.float32), R.astype(np.float32)
        sess = StreamSession(*srv.address)
        part1 = _send_and_read(sess, L, R, 0, 4, 0)
        assert len(part1) > 0  # output read => the 4 blocks were consumed
        srv.save_checkpoint(path)
        sess.close()
    finally:
        srv.close()

    srv2 = run_stream_server(0, **kw)  # restores from the same path
    try:
        sess2 = StreamSession(*srv2.address, token=sess.token)
        # The REAL client resume algorithm: resend everything from the
        # server's acked input position (in-flight TCP data at
        # checkpoint time is intentionally NOT in the checkpoint).
        resume_blk = sess2.server_in_frames // HW
        assert resume_blk == 4  # deterministic here: part1 forced sync
        for b in range(resume_blk, 6):
            sess2.send_block(L[b * HW : (b + 1) * HW],
                             R[b * HW : (b + 1) * HW])
        sess2.finish()
        part2 = sess2.recv_frames(6 * HW - len(part1))
        sess2.close()
    finally:
        srv2.close()
    ref = _aligned_reference(L, R)
    got = np.concatenate([part1, part2])
    _check(tuple(got[:, i] for i in range(got.shape[1])), ref)


def test_periodic_checkpoint_and_output_dedupe(tmp_path):
    # A NON-destructive mid-serving checkpoint: the session keeps
    # streaming after the save; on resume the client resends from the
    # checkpoint's acked input position and DISCARDS the output frames
    # it already received past the checkpoint's out_frames (the server
    # regenerates them) — the full at-least-once contract, both
    # directions.  Also exercises the periodic saver thread.
    import os
    import time

    from upmix.serve_stream import StreamServer, StreamSession

    def pool_factory():
        return BatchStreamingUpmixer(_cfg(), HW, n_streams=4)

    n_blocks = 10
    L, R = make_stereo(n_blocks * HW, SR, seed=109)
    L, R = L.astype(np.float32), R.astype(np.float32)
    ref = _one_shot(pool_factory, L, R)

    path = str(tmp_path / "mid.npz")
    srv_a = StreamServer(pool_factory(), lockstep=True,
                         snapshot_every=0.2).start()
    srv_a.snapshot_path = path
    try:
        sess = StreamSession(*srv_a.address)
        got_a = _send_and_read(sess, L, R, 0, 5, 0)
        srv_a.save_checkpoint(path)  # point-in-time: 5 blocks acked
        # Keep serving PAST the checkpoint: two more blocks in and out.
        more = _send_and_read(sess, L, R, 5, 2, len(got_a))
        got_a = np.concatenate([got_a, more])
        # The periodic thread keeps rewriting the file; wait for one
        # overwrite to prove the loop runs (mtime advances).
        m0 = os.stat(path).st_mtime_ns
        deadline = time.time() + 10
        while os.stat(path).st_mtime_ns == m0 and time.time() < deadline:
            time.sleep(0.05)
        periodic_ran = os.stat(path).st_mtime_ns != m0
        sess.close()
    finally:
        srv_a.close()
    assert periodic_ran
    # The last periodic write captured the final quiesced state (7
    # blocks acked, all outputs emitted) OR an earlier one; either is a
    # consistent point — resume must work from whatever is on disk.
    srv_b = StreamServer(pool_factory(), lockstep=True,
                         checkpoint=path).start()
    try:
        sess2 = StreamSession(*srv_b.address, token=sess.token)
        resume_blk = sess2.server_in_frames // HW
        assert 5 <= resume_blk <= 7
        dup = len(got_a) - sess2.server_out_frames  # frames to discard
        assert dup >= 0
        for b in range(resume_blk, n_blocks):
            sess2.send_block(L[b * HW : (b + 1) * HW],
                             R[b * HW : (b + 1) * HW])
        sess2.finish()
        regen = sess2.recv_frames(dup + n_blocks * HW - len(got_a))
        got = np.concatenate([got_a, regen[dup:]])
        sess2.close()
    finally:
        srv_b.close()
    np.testing.assert_array_equal(got, np.column_stack(ref))


def test_cli_connect_client_mode(tmp_path):
    # `upmix in.wav --connect HOST:PORT`: the network-client mode
    # streams files through a running server (no local JAX work) and
    # writes the returned mix; a sample-rate mismatch is refused before
    # any audio is sent.
    from upmix.cli import main
    from upmix.io import read_wav, write_wav

    pool = BatchStreamingUpmixer(_cfg(), HW, n_streams=4)
    with StreamServer(pool, lockstep=True) as srv:
        host, port = srv.address
        L, R = make_stereo(5 * HW + 77, SR, seed=111)
        L, R = L.astype(np.float32), R.astype(np.float32)
        in_path = str(tmp_path / "song.wav")
        write_wav(in_path, np.column_stack([L, R]), int(SR))
        out_dir = str(tmp_path / "out")
        rc = main(
            [in_path, "--connect", f"{host}:{port}", "--out-dir", out_dir]
        )
        assert rc == 0
        out_path = tmp_path / "out" / "song_net_stereo_sum.wav"
        assert out_path.exists()
        got, sr2 = read_wav(str(out_path))
        assert sr2 == int(SR) and got.shape == (len(L), 2)
        ref = _aligned_reference(L, R)
        _check((got[:, 0], got[:, 1]), ref)

        # sr mismatch: refused with a clear error, nothing written.
        bad = str(tmp_path / "bad.wav")
        write_wav(bad, np.column_stack([L, R]), int(SR * 2))
        with pytest.raises(SystemExit, match="Hz"):
            main([bad, "--connect", f"{host}:{port}", "--out-dir", out_dir])

    with pytest.raises(SystemExit, match="HOST:PORT"):
        main([in_path, "--connect", "nonsense"])
    with pytest.raises(SystemExit, match="input WAV"):
        main(["-", "--connect", "127.0.0.1:1"])


def test_pipeline_server_round_trip():
    # Pipelined dispatch (pipeline=2): the dispatcher parks each cycle's
    # device outputs and delivers them while the NEXT cycle computes.  A
    # strictly-lockstep client (send one block, read the due output)
    # must still complete: with no new cycle ready, the dispatcher
    # flushes the in-flight outputs instead of holding them hostage to
    # the next input's arrival.  Output must be bit-identical to the
    # synchronous server (same push sequence, deferred fetch only).
    pool = BatchStreamingUpmixer(_cfg(), HW, n_streams=4)
    L, R = make_stereo(9 * HW + 50, SR, seed=75)
    L, R = L.astype(np.float32), R.astype(np.float32)
    ref = _one_shot(lambda: BatchStreamingUpmixer(_cfg(), HW, n_streams=4),
                    L, R)
    with StreamServer(pool, lockstep=True, pipeline=2) as srv:
        assert srv.metrics_snapshot()["config"]["pipeline"] == 2
        got = stream_client(*srv.address, L, R)
        np.testing.assert_array_equal(np.column_stack(got),
                                      np.column_stack(ref))


def test_pipeline_concurrent_clients_with_drain():
    # Two different-length clients under pipeline=2: the shorter one
    # drains (its final in-flight outputs must be flushed even while
    # the longer one keeps feeding cycles); both get exact results.
    pool = BatchStreamingUpmixer(_cfg(), HW, n_streams=4)
    sigs = []
    for seed, n in ((76, 5 * HW), (77, 11 * HW + 30)):
        L, R = make_stereo(n, SR, seed=seed)
        sigs.append((L.astype(np.float32), R.astype(np.float32)))
    with StreamServer(pool, lockstep=True, pipeline=2) as srv:
        results = [None] * len(sigs)

        def go(i):
            results[i] = stream_client(*srv.address, *sigs[i])

        threads = [
            threading.Thread(target=go, args=(i,)) for i in range(len(sigs))
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        for i, (L, R) in enumerate(sigs):
            assert results[i] is not None, f"client {i} did not finish"
            _check(results[i], _aligned_reference(L, R))


def test_pipeline_construction_guard():
    pool = BatchStreamingUpmixer(_cfg(), HW, n_streams=4)
    for bad in (0, 3, -1):
        with pytest.raises(ValueError, match="pipeline"):
            StreamServer(pool, lockstep=True, pipeline=bad)


def test_pipeline_checkpoint_flushes_in_flight(tmp_path):
    # Checkpoint consistency under pipeline=2: the pool state already
    # includes the in-flight cycle (its inputs were consumed), so
    # save_checkpoint must deliver those outputs to the slots' counters
    # BEFORE the capture — they are never re-generated, and a resumed
    # client would stall waiting for them otherwise.  Burst-send without
    # reading to keep a cycle in flight at save time, then resume on a
    # fresh server with the at-least-once dedupe protocol.
    import time

    from upmix.serve_stream import StreamSession

    def pool_factory():
        return BatchStreamingUpmixer(_cfg(), HW, n_streams=4)

    n_blocks = 10
    L, R = make_stereo(n_blocks * HW, SR, seed=79)
    L, R = L.astype(np.float32), R.astype(np.float32)
    ref = _one_shot(pool_factory, L, R)

    path = str(tmp_path / "pipe.npz")
    srv_a = StreamServer(pool_factory(), lockstep=True, pipeline=2).start()
    try:
        sess = StreamSession(*srv_a.address)
        for b in range(6):  # burst: no reads between sends
            sess.send_block(L[b * HW : (b + 1) * HW],
                            R[b * HW : (b + 1) * HW])
        time.sleep(0.1)  # let the dispatcher pick some cycles up
        assert srv_a.save_checkpoint(path) == 1
        # Whatever the checkpoint captured, every CONSUMED input's
        # outputs must already be counted (queued blocks ride the file
        # and are re-pushed; consumed ones are not) — no in-flight
        # outputs lost.
        import json as _json

        saved = np.load(path, allow_pickle=False)
        meta = _json.loads(saved["__meta__"].tobytes().decode("utf-8"))
        s0 = meta["sessions"][0]
        queued = saved["s0.blocks"].shape[0]
        consumed = s0["in_frames"] - queued * HW
        assert s0["out_frames"] == max(0, consumed - _warmup_skip())
        got_a = sess.recv_frames(max(0, 6 * HW - _warmup_skip()))
        sess.close()
    finally:
        srv_a.close()

    srv_b = StreamServer(pool_factory(), lockstep=True,
                         checkpoint=path).start()
    try:
        sess2 = StreamSession(*srv_b.address, token=sess.token)
        resume_blk = sess2.server_in_frames // HW
        dup = len(got_a) - sess2.server_out_frames
        assert dup >= 0
        for b in range(resume_blk, n_blocks):
            sess2.send_block(L[b * HW : (b + 1) * HW],
                             R[b * HW : (b + 1) * HW])
        sess2.finish()
        regen = sess2.recv_frames(dup + n_blocks * HW - len(got_a))
        got = np.concatenate([got_a, regen[dup:]])
        sess2.close()
    finally:
        srv_b.close()
    np.testing.assert_array_equal(got, np.column_stack(ref))


@pytest.mark.parametrize("pipeline", [1, 2])
def test_checkpoint_resume_under_pipeline(tmp_path, pipeline):
    # The sample-exact-continuation contract must hold when both servers
    # run synchronous or pipelined dispatch (pipeline=2), with the
    # checkpoint's frame/skip accounting exact at the cut.
    import json as _json

    from upmix.serve_stream import StreamSession

    def pool_factory():
        return BatchStreamingUpmixer(_cfg(), HW, n_streams=8)

    srv_kw = dict(lockstep=True, pipeline=pipeline)
    n_blocks, cut = 12, 5
    L, R = make_stereo(n_blocks * HW, SR, seed=310 + pipeline)
    L, R = L.astype(np.float32), R.astype(np.float32)
    with StreamServer(pool_factory(), **srv_kw) as srv_ref:
        ref = stream_client(*srv_ref.address, L, R)

    dispatched = cut  # every block a lockstep cycle of its own
    queued = 0
    skip = _warmup_skip()
    path = str(tmp_path / "hp.npz")

    srv_a = StreamServer(pool_factory(), **srv_kw).start()
    sess = StreamSession(*srv_a.address)
    for b in range(cut):
        sess.send_block(L[b * HW : (b + 1) * HW], R[b * HW : (b + 1) * HW])
    # Reading the frames due after the dispatched cycles also forces
    # the pipeline=2 in-flight outputs out.
    due = max(0, dispatched * HW - skip)
    part1 = (sess.recv_frames(due) if due
             else np.zeros((0, sess.out_channels), "<f4"))
    # Wait for the reader thread to ack every sent block so the
    # checkpoint deterministically captures the counters asserted on.
    import time as _time

    deadline = _time.time() + 10.0
    while (srv_a._slots[0].in_frames < cut * HW
           and _time.time() < deadline):
        _time.sleep(0.01)
    assert srv_a.save_checkpoint(path) == 1
    sess.close()
    srv_a.close()

    # The checkpoint recorded the queue depth and the frame/skip
    # accounting.
    saved = np.load(path, allow_pickle=False)
    meta = _json.loads(saved["__meta__"].tobytes().decode("utf-8"))
    s0 = meta["sessions"][0]
    assert saved[f"s{s0['slot']}.blocks"].shape[0] == queued
    assert s0["in_frames"] == cut * HW
    assert s0["out_frames"] == max(0, dispatched * HW - skip) == len(part1)
    assert s0["skip"] == max(0, skip - dispatched * HW)

    srv_b = StreamServer(pool_factory(), checkpoint=path, **srv_kw).start()
    try:
        sess2 = StreamSession(*srv_b.address, token=sess.token)
        assert sess2.server_in_frames == cut * HW
        assert sess2.server_out_frames == len(part1)
        for b in range(cut, n_blocks):
            sess2.send_block(L[b * HW : (b + 1) * HW],
                             R[b * HW : (b + 1) * HW])
        sess2.finish()
        part2 = sess2.recv_frames(n_blocks * HW - len(part1))
        sess2.close()
    finally:
        srv_b.close()

    got = np.concatenate([part1, part2])
    np.testing.assert_array_equal(got, np.column_stack(ref))


def test_close_releases_port_with_live_clients():
    # close() must sweep end-of-stream sentinels: without them each
    # connection's writer thread blocks in outq.get(), _serve_conn
    # blocks in writer.join() holding the accepted socket, and a server
    # restarted on the SAME port gets EADDRINUSE (found by the native
    # client's resume-across-restart test).
    import socket as _socket
    import time as _time

    from upmix.serve_stream import StreamSession

    srv_a = StreamServer(
        BatchStreamingUpmixer(_cfg(), HW, n_streams=4), lockstep=True
    ).start()
    host, port = srv_a.address
    # Two live sessions mid-stream (one with queued blocks, one idle).
    s1 = StreamSession(host, port)
    s2 = StreamSession(host, port)
    z = np.zeros(HW, np.float32)
    s1.send_block(z, z)
    _time.sleep(0.1)
    srv_a.close()
    # The clients observe a clean shutdown (EOF), not a hang.
    for s in (s1, s2):
        s.sock.settimeout(10.0)
        try:
            s.sock.recv(1 << 16)  # data or b"" (EOF) — both fine
        except TimeoutError:  # pragma: no cover
            raise AssertionError("client hung on server shutdown")
        except OSError:
            pass  # connection reset is fine too
        s.close()
    # Rebinding the same port must succeed promptly.
    deadline = _time.monotonic() + 10.0
    last = None
    while _time.monotonic() < deadline:
        try:
            srv_b = StreamServer(
                BatchStreamingUpmixer(_cfg(), HW, n_streams=4),
                lockstep=True, host=host, port=port,
            ).start()
            break
        except OSError as e:  # pragma: no cover
            last = e
            _time.sleep(0.1)
    else:  # pragma: no cover
        raise AssertionError(f"could not rebind {host}:{port}: {last}")
    try:
        L, R = make_stereo(4 * HW, SR, seed=95)
        got = stream_client(*srv_b.address, L.astype(np.float32),
                            R.astype(np.float32))
        _check(got, _aligned_reference(L.astype(np.float32),
                                       R.astype(np.float32)))
    finally:
        srv_b.close()


def test_dispatcher_death_fails_sessions_fast():
    # A dispatcher crash must not hang clients: the guard logs, counts
    # dispatcher_failures, ends every live session (socket close) and
    # stops the server.
    pool = BatchStreamingUpmixer(_cfg(), HW, n_streams=4)
    with StreamServer(pool, lockstep=True) as srv:

        def boom(*a, **k):
            raise RuntimeError("injected pool failure")

        srv.pool.push_blocks = boom
        L, R = make_stereo(6 * HW, SR, seed=80)
        errs = []

        def go():
            try:
                stream_client(
                    *srv.address, L.astype(np.float32), R.astype(np.float32)
                )
            except Exception as exc:
                errs.append(exc)

        t = threading.Thread(target=go)
        t.start()
        t.join(timeout=60)
        assert not t.is_alive(), "client hung on a dead dispatcher"
        assert errs, "client must observe the failed session, not succeed"
        # The client can observe the socket shutdown (outq sentinel)
        # before the dispatcher thread reaches _stop.set(): wait for the
        # dispatcher to exit before asserting the guard's end state.
        import time

        deadline = time.monotonic() + 30
        while (
            not srv._stop.is_set() or srv._sock.fileno() != -1
        ) and time.monotonic() < deadline:
            time.sleep(0.01)
        assert srv.stats["dispatcher_failures"] == 1
        assert srv._stop.is_set()
        assert srv._sock.fileno() == -1, "failure guard must close the listener"
        # Post-failure clients must be rejected, not admitted as new
        # victims: the guard also closes the listener (ADVICE r4).
        with pytest.raises(Exception):
            stream_client(
                *srv.address, L.astype(np.float32), R.astype(np.float32)
            )


def test_stopping_server_refuses_admission_mid_handshake():
    # The mid-handshake race (round-5 review): a connection accepted
    # BEFORE _stop but allocating AFTER the failure guard's sentinel
    # sweep must be refused by _alloc_slot's under-lock _stop check —
    # otherwise it gets a slot nothing will ever drain and hangs.
    # Simulated directly: _stop set while the listener is still open.
    from upmix.serve_stream import StreamSession

    pool = BatchStreamingUpmixer(_cfg(), HW, n_streams=4)
    srv = StreamServer(pool, lockstep=True).start()
    try:
        srv._stop.set()  # stopping, but listener not yet closed
        with pytest.raises(ConnectionError, match="pool is full"):
            StreamSession(*srv.address)
        # The reply reaches the client BEFORE the counter bumps: poll.
        import time

        deadline = time.monotonic() + 10
        while srv.stats["rejected"] < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert srv.stats["rejected"] >= 1
        with srv._lock:
            assert all(s.state == 0 for s in srv._slots), "no slot leaked"
    finally:
        srv.close()


def test_mesh_sharded_pool_server():
    # run_stream_server(mesh=...) shards the serving pool over the
    # virtual mesh's 'data' axis; a session's output must still match
    # the single-stream engine exactly as on an unsharded pool.
    import jax

    from upmix.parallel import make_mesh
    from upmix.serve_stream import run_stream_server

    if len(jax.devices()) < 2:
        pytest.skip("needs >= 2 devices")
    mesh = make_mesh({"data": 2})
    srv = run_stream_server(
        0, sr=SR, n_streams=4, hw_block_size=HW, band_edges=EDGES,
        lockstep=True, verbose=False, mesh=mesh,
    )
    try:
        L, R = make_stereo(8 * HW, SR, seed=77)
        L, R = L.astype(np.float32), R.astype(np.float32)
        got = stream_client(*srv.address, L, R)
        _check(got, _aligned_reference(L, R))
    finally:
        srv.close()


def test_checkpoint_restores_across_mesh_topologies(tmp_path):
    # A checkpoint taken on an UNSHARDED pool server restores into a
    # mesh-sharded pool server and vice versa — the realistic restore
    # scenario where the replacement host has a different device count.
    # The resumed session must be the exact continuation either way.
    import jax

    from upmix.serve_stream import StreamSession

    if len(jax.devices()) < 2:
        pytest.skip("needs >= 2 devices")
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("data",))

    def plain_factory():
        return BatchStreamingUpmixer(_cfg(), HW, n_streams=4)

    def mesh_factory():
        return BatchStreamingUpmixer(_cfg(), HW, n_streams=4, mesh=mesh)

    n_blocks = 12
    cut = 5
    path = str(tmp_path / "sessions.npz")
    for src_factory, dst_factory in (
        (plain_factory, mesh_factory),
        (mesh_factory, plain_factory),
    ):
        L, R = make_stereo(n_blocks * HW, SR, seed=105)
        L, R = L.astype(np.float32), R.astype(np.float32)
        ref = _one_shot(plain_factory, L, R)

        srv_a = StreamServer(src_factory(), lockstep=True).start()
        sess = StreamSession(*srv_a.address)
        part1 = _send_and_read(sess, L, R, 0, cut, 0)
        assert srv_a.save_checkpoint(path) == 1
        sess.close()
        srv_a.close()

        srv_b = StreamServer(dst_factory(), lockstep=True,
                             checkpoint=path).start()
        try:
            sess2 = StreamSession(*srv_b.address, token=sess.token)
            assert sess2.server_in_frames == cut * HW
            for b in range(cut, n_blocks):
                sess2.send_block(L[b * HW : (b + 1) * HW],
                                 R[b * HW : (b + 1) * HW])
            sess2.finish()
            part2 = sess2.recv_frames(n_blocks * HW - len(part1))
            sess2.close()
        finally:
            srv_b.close()

        got = np.concatenate([part1, part2])
        want = np.column_stack(ref)
        np.testing.assert_array_equal(got, want)
