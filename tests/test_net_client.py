"""Native network client (native/upmix_net_client.cpp): raw-PCM stdin ->
one StreamServer session -> raw-PCM stdout, no Python/JAX in-process —
the embedded-host shell for the pooled serving path (the reference's
Bela runtime is a single stream of hardware blocks exactly like this,
bela/upmix.cpp:516-553).  Built on demand like the other native
binaries; its output must be bit-identical to the Python stream_client
against the same server."""

import os
import subprocess

import numpy as np
import pytest

from upmix.models.streaming import BatchStreamingUpmixer
from upmix.serve_stream import StreamServer, stream_client

from helpers import make_stereo
from test_serve_stream import HW, SR, _cfg

NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "native")
BIN = os.path.join(NATIVE_DIR, "upmix_net_client")


@pytest.fixture(scope="module")
def net_bin():
    if not os.path.exists(BIN):
        mk = subprocess.run(
            ["make", "-C", NATIVE_DIR, "net"], capture_output=True
        )
        if not os.path.exists(BIN):  # pragma: no cover
            pytest.skip(f"net client build failed: {mk.stderr.decode()[-300:]}")
    return BIN


@pytest.fixture(scope="module")
def server():
    pool = BatchStreamingUpmixer(_cfg(), HW, n_streams=4)
    with StreamServer(pool, lockstep=True) as srv:
        yield srv


def _run(net_bin, srv, raw, mix=None, extra=(), timeout=180):
    cmd = [net_bin, "--host", srv.address[0], "--port", str(srv.address[1])]
    if mix:
        cmd += ["--mix", mix]
    cmd += list(extra)
    return subprocess.run(cmd, input=raw, capture_output=True, timeout=timeout)


def _interleave(L, R):
    return np.column_stack([L, R]).astype("<f4").tobytes()


@pytest.mark.parametrize("mix,out_ch", [("stereo_sum", 2), ("lcr", 3)])
def test_net_client_matches_python_client(net_bin, server, mix, out_ch):
    # Ragged tail: the binary zero-pads the final block on the wire and
    # trims the surplus output frames, exactly like stream_client.
    n = 7 * HW + 123
    L, R = make_stereo(n, SR, seed=80)
    L, R = L.astype(np.float32), R.astype(np.float32)
    ref = stream_client(*server.address, L, R, mix=mix)

    proc = _run(net_bin, server, _interleave(L, R), mix=mix)
    assert proc.returncode == 0, proc.stderr.decode()
    got = np.frombuffer(proc.stdout, "<f4").reshape(-1, out_ch)
    assert got.shape == (n, out_ch)
    # Same server, sequential sessions, re-warmed slot: bit-identical.
    np.testing.assert_array_equal(got, np.column_stack(ref))


def test_net_client_block_multiple_input(net_bin, server):
    n = 5 * HW  # EOF exactly on a block boundary: no pad block at all
    L, R = make_stereo(n, SR, seed=81)
    L, R = L.astype(np.float32), R.astype(np.float32)
    ref = stream_client(*server.address, L, R)
    proc = _run(net_bin, server, _interleave(L, R))
    assert proc.returncode == 0, proc.stderr.decode()
    got = np.frombuffer(proc.stdout, "<f4").reshape(-1, 2)
    np.testing.assert_array_equal(got, np.column_stack(ref))


def test_net_client_empty_input(net_bin, server):
    proc = _run(net_bin, server, b"")
    assert proc.returncode == 0, proc.stderr.decode()
    assert proc.stdout == b""


def test_net_client_sr_validation(net_bin, server):
    # --sr pins the deployment's expected rate BEFORE any audio is sent.
    L, R = make_stereo(2 * HW, SR, seed=82)
    ok = _run(net_bin, server, _interleave(L, R), extra=["--sr", str(SR)])
    assert ok.returncode == 0, ok.stderr.decode()
    bad = _run(net_bin, server, _interleave(L, R),
               extra=["--sr", str(SR * 2)])
    assert bad.returncode == 1
    assert b"Hz" in bad.stderr


def test_net_client_file_resume_across_server_restart(net_bin, tmp_path):
    # The native client rides the checkpoint/resume contract end to end:
    # server A checkpoints mid-stream and "crashes"; server B restores on
    # the SAME port; the client (file mode) reconnects with its token,
    # reseeks to the server's acked input position, discards regenerated
    # output, and the stitched stdout is bit-identical to an
    # uninterrupted run.
    import threading
    import time

    from upmix.serve_stream import StreamSession

    def pool_factory():
        return BatchStreamingUpmixer(_cfg(), HW, n_streams=4)

    n_blocks = 60
    L, R = make_stereo(n_blocks * HW, SR, seed=90)
    L, R = L.astype(np.float32), R.astype(np.float32)
    with StreamServer(pool_factory(), lockstep=True) as srv0:
        ref = stream_client(*srv0.address, L, R)

    f32 = tmp_path / "in.f32"
    f32.write_bytes(_interleave(L, R))
    ck = str(tmp_path / "ck.npz")
    tok = str(tmp_path / "token.bin")

    srv_a = StreamServer(pool_factory(), lockstep=True).start()
    host, port = srv_a.address
    # A second, silent session gates the lockstep dispatcher: cycles run
    # only when we feed it, so the kill point is deterministic.
    gate = StreamSession(host, port)
    zeros = np.zeros(HW, np.float32)

    proc = subprocess.Popen(
        [net_bin, "--host", host, "--port", str(port), "--in", str(f32),
         "--retries", "40", "--retry-delay", "0.25", "--token-file", tok],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
    )
    chunks = []

    def drain():
        while True:
            b = proc.stdout.read(65536)
            if not b:
                break
            chunks.append(b)

    reader = threading.Thread(target=drain)
    reader.start()
    try:
        cut = 20
        for _ in range(cut):
            gate.send_block(zeros, zeros)
        deadline = time.time() + 60
        while srv_a.stats["blocks"] < cut and time.time() < deadline:
            time.sleep(0.02)
        assert srv_a.stats["blocks"] >= cut
        time.sleep(0.5)  # let delivered output reach the client's stdout
        assert srv_a.save_checkpoint(ck) == 2  # client + gate sessions
        gate.close()
        srv_a.close()

        # Old per-connection sockets on A's port can linger briefly
        # after close(); retry the rebind (the client is retrying too).
        deadline = time.time() + 20
        while True:
            try:
                srv_b = StreamServer(pool_factory(), lockstep=True,
                                     checkpoint=ck, host=host,
                                     port=port).start()
                break
            except OSError:
                if time.time() > deadline:
                    raise
                time.sleep(0.2)
        try:
            rc = proc.wait(timeout=120)
            reader.join(timeout=30)
            err = proc.stderr.read().decode()
            assert rc == 0, err
            assert "reconnecting" in err
        finally:
            srv_b.close()
    finally:
        if proc.poll() is None:  # pragma: no cover
            proc.kill()
    got = np.frombuffer(b"".join(chunks), "<f4").reshape(-1, 2)
    np.testing.assert_array_equal(got, np.column_stack(ref))
    assert len(open(tok, "rb").read()) == 16


def test_net_client_retries_require_seekable_input(net_bin):
    p = subprocess.run([net_bin, "--port", "9", "--retries", "2"],
                       input=b"", capture_output=True, timeout=60)
    assert p.returncode == 2
    assert b"--in" in p.stderr


def test_net_client_rejects_fifo_as_in_file(net_bin, server, tmp_path):
    # --in needs the real size upfront (the output cap and the resume
    # seek both depend on it); a FIFO must be refused loudly, not
    # silently produce empty output with exit 0.
    fifo = str(tmp_path / "in.fifo")
    os.mkfifo(fifo)
    import threading

    def feed():
        try:
            with open(fifo, "wb") as f:
                f.write(b"\x00" * (HW * 2 * 4))
        except OSError:  # pragma: no cover
            pass

    t = threading.Thread(target=feed, daemon=True)
    t.start()
    p = subprocess.run(
        [net_bin, "--host", server.address[0],
         "--port", str(server.address[1]), "--in", fifo],
        capture_output=True, timeout=60,
    )
    assert p.returncode == 2
    assert b"seekable" in p.stderr
    assert p.stdout == b""


def test_net_client_resume_after_padded_tail_acked(net_bin, tmp_path):
    # A ragged-tail file whose zero-PADDED final block was already
    # enqueued (acked) when the checkpoint ran: the server's in_frames
    # legitimately exceeds the file's frame count, and the resumed
    # client must send NOTHING and just drain — not reject the resume.
    import threading
    import time

    from upmix.serve_stream import StreamSession

    def pool_factory():
        return BatchStreamingUpmixer(_cfg(), HW, n_streams=4)

    n = 6 * HW + 100  # ragged tail -> 7 padded blocks on the wire
    L, R = make_stereo(n, SR, seed=91)
    L, R = L.astype(np.float32), R.astype(np.float32)
    with StreamServer(pool_factory(), lockstep=True) as srv0:
        ref = stream_client(*srv0.address, L, R)
    f32 = tmp_path / "in.f32"
    f32.write_bytes(_interleave(L, R))
    ck = str(tmp_path / "ck.npz")

    srv_a = StreamServer(pool_factory(), lockstep=True).start()
    host, port = srv_a.address
    gate = StreamSession(host, port)  # holds lockstep: nothing dispatches
    proc = subprocess.Popen(
        [net_bin, "--host", host, "--port", str(port), "--in", str(f32),
         "--retries", "40", "--retry-delay", "0.25"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
    )
    chunks = []

    def drain():
        while True:
            b = proc.stdout.read(65536)
            if not b:
                break
            chunks.append(b)

    reader = threading.Thread(target=drain)
    reader.start()
    try:
        # All 7 padded blocks fit in the slot queue (bound 32) with the
        # gate holding dispatch, so in_frames reaches 7*HW > n.
        padded = 7 * HW
        deadline = time.time() + 30
        while time.time() < deadline:
            with srv_a._lock:
                if max(s.in_frames for s in srv_a._slots) >= padded:
                    break
            time.sleep(0.02)
        with srv_a._lock:
            assert max(s.in_frames for s in srv_a._slots) == padded
        assert srv_a.save_checkpoint(ck) == 2
        gate.close()
        srv_a.close()
        deadline = time.time() + 20
        while True:
            try:
                srv_b = StreamServer(pool_factory(), lockstep=True,
                                     checkpoint=ck, host=host,
                                     port=port).start()
                break
            except OSError:  # pragma: no cover
                if time.time() > deadline:
                    raise
                time.sleep(0.2)
        try:
            rc = proc.wait(timeout=120)
            reader.join(timeout=30)
            err = proc.stderr.read().decode()
            assert rc == 0, err
            assert "reconnecting" in err
        finally:
            srv_b.close()
    finally:
        if proc.poll() is None:  # pragma: no cover
            proc.kill()
    got = np.frombuffer(b"".join(chunks), "<f4").reshape(-1, 2)
    np.testing.assert_array_equal(got, np.column_stack(ref))


def test_net_client_errors(net_bin, server):
    # Unknown flag / missing port: usage error, exit 2.
    p = subprocess.run([net_bin, "--bogus"], capture_output=True, timeout=60)
    assert p.returncode == 2
    p = subprocess.run([net_bin], capture_output=True, timeout=60)
    assert p.returncode == 2
    # Unreachable server: clean connect error, exit 1.
    p = subprocess.run(
        [net_bin, "--host", "127.0.0.1", "--port", "1"],
        input=b"", capture_output=True, timeout=60,
    )
    assert p.returncode == 1
    assert b"connect" in p.stderr or b"resolve" in p.stderr
