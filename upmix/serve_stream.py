"""Multi-client live-stream server on the serving pool.

The serving triangle's third surface (DESIGN.md §6): `run_jobs` serves
offline files, `run_pipe` serves ONE live stream on stdin/stdout, and
this module serves MANY concurrent live streams over a socket — each
client connection claims one slot of a `make_stream_pool` pool, and one
pool dispatch per hardware block processes every live session together
(reference analog: bela/upmix.cpp:537-547 serves exactly one stream on
the audio callback).

Wire protocol (little-endian, fixed-size frames after the handshake):

  client hello:  b"UPMX" | u32 version (1) | u32 mix (0=stereo_sum, 1=lcr)
  server reply:  b"UPMR" | u32 status (0 ok, 1 pool full, 2 bad hello)
                 | u32 slot | u32 hw_block | u32 out_channels
  v2 hello adds | 16-byte resume token (zeros = new session)
  v2 reply adds | 16-byte session token | u64 in_frames | u64 out_frames
                 | f64 sample_rate   (status 3 = unknown resume token)
  then, repeatedly:
    client -> server: hw_block * 2 float32 (interleaved stereo)
    server -> client: hw_block * out_channels float32 (interleaved)

Metrics query (observability, any protocol version): a client may
instead open a connection and send b"UPMQ" | u32 format | u32 0 —
the server replies u32 payload length + the metrics payload (format
0 = JSON `metrics_snapshot()`, 1 = Prometheus text) and closes.  The
same snapshot is served over HTTP (GET /metrics, /metrics.json) when
the server is built with `metrics_http_port` — the endpoint a
Prometheus scraper points at.  See upmix/metrics.py.

Clients half-close (shutdown(SHUT_WR)) at end of stream; the server
drains the engine with zero blocks and closes when the output has
caught up with the input.  Output is warmup-ALIGNED per connection
(run_pipe's align=True semantics): the slot's leading warmup silence is
dropped and the tail is drained, so output frame i corresponds to input
frame i and every client gets back exactly as many frames as it sent.
Short final blocks must be zero-padded to hw_block by the client (and
trimmed client-side); `stream_client` below does both.

Tick modes:
  lockstep=True  (default) — a pool block is dispatched once EVERY
    active slot has one input block queued (idle slots contribute
    zeros).  Deterministic; the mode for file-fed clients and tests.
  lockstep=False — dispatch every hw/sr seconds of wall clock; slots
    whose block has not arrived get zeros (the degraded late-callback
    semantics of a real-time audio host).  Missing input is zeros, not
    a stall: one slow client cannot hold back the pool.

Checkpoint/resume (protocol v2): `save_checkpoint(path)` freezes every
live session — per-slot engine state rows (BatchStreamingUpmixer
`extract_streams`), frame counters, warmup skip,
queued-but-unprocessed input blocks, and a per-session resume token —
into one .npz file.  A server started with `checkpoint=path` PARKS
those sessions: their slots are reserved and their engine rows live
host-side (a parked row must NOT ride the pool — every dispatch would
advance its OLA state).  A client reconnecting with its token gets the
same slot back, its rows injected (`load_streams`), and the server's
`in_frames` position in the reply tells it where to resume sending —
in lockstep mode the continued output is sample-exact with an
uninterrupted run.  Input still in TCP flight at checkpoint time is
intentionally NOT captured: `in_frames` is the server's acked input
position, and the resume contract is "resend everything from there"
(at-least-once from the last ack, the standard resumable-upload
shape).  Symmetrically on the OUTPUT side, the resume reply's
`out_frames` is the server's output position AT the checkpoint: a
client that kept serving between a periodic checkpoint and the crash
may have received frames past it, and must discard the first
(received − out_frames) frames after resume (the server regenerates
them).  v1 clients keep working unchanged.
"""

from __future__ import annotations

import json
import os
import queue
import socket
import struct
import threading
import time

import numpy as np

from upmix.metrics import ServerMetrics, prometheus_text

MAGIC_HELLO = b"UPMX"
MAGIC_REPLY = b"UPMR"
MAGIC_METRICS = b"UPMQ"
VERSION = 1
VERSION2 = 2
MIX_MODES = ("stereo_sum", "lcr")
_TOKEN_LEN = 16
_ZERO_TOKEN = b"\x00" * _TOKEN_LEN
# _flush_pending default: "pop and deliver self._pending" (None must stay
# distinct — an explicit None argument means "nothing to deliver").
_FLUSH_SELF_PENDING = object()

_ST_FREE, _ST_ACTIVE, _ST_DRAINING, _ST_PARKED = 0, 1, 2, 3


# -- pytree <-> npz codec (checkpoint format) -------------------------------

def _tree_encode(tree, arrays: dict, prefix: str):
    """Structure descriptor (JSON-safe) + flat array dict for a pytree of
    dicts/tuples/lists of ndarrays (the pool snapshot shapes)."""
    if isinstance(tree, dict):
        return {
            "t": "d",
            "k": {
                str(k): _tree_encode(v, arrays, f"{prefix}.{k}")
                for k, v in tree.items()
            },
        }
    if isinstance(tree, (tuple, list)):
        return {
            "t": "t" if isinstance(tree, tuple) else "l",
            "c": [
                _tree_encode(v, arrays, f"{prefix}.{i}")
                for i, v in enumerate(tree)
            ],
        }
    arrays[prefix] = np.asarray(tree)
    return {"t": "a", "key": prefix}


def _tree_decode(desc, arrays):
    if desc["t"] == "d":
        return {k: _tree_decode(v, arrays) for k, v in desc["k"].items()}
    if desc["t"] in ("t", "l"):
        vals = [_tree_decode(c, arrays) for c in desc["c"]]
        return tuple(vals) if desc["t"] == "t" else list(vals)
    return arrays[desc["key"]]


def _read_exact(sock, n):
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            break
        buf.extend(chunk)
    return bytes(buf)


class _Slot:
    __slots__ = (
        "state", "mix", "inq", "outq", "in_frames", "out_frames",
        "skip", "gen", "token", "parked", "parked_at",
    )

    def __init__(self):
        self.state = _ST_FREE
        self.mix = 0
        self.inq = None
        self.outq = None
        self.in_frames = 0
        self.out_frames = 0
        self.skip = 0
        self.gen = 0  # bumped per allocation; stale threads detect reuse
        self.token = _ZERO_TOKEN  # per-session resume key (v2 protocol)
        self.parked = None  # checkpointed session record awaiting resume
        self.parked_at = 0.0  # monotonic restore time (resume_ttl clock)


class StreamServer:
    """Serve a pool of live upmix sessions over TCP.

    `pool` is a make_stream_pool pool (optionally mesh-sharded); the
    server owns its state (do not push blocks into it from outside
    while serving).

    ``pipeline=2`` overlaps the host with the device: the dispatcher
    pushes cycle N (async jax dispatch), then fetches and delivers
    cycle N-1's outputs while the device computes N.  One cycle of
    in-flight work hides the round-trip latency that the synchronous
    (pipeline=1) cycle pays serially, at ONE cycle of output latency.
    With pipeline=2 the dispatch histogram
    records the blocking fetch wait (the time the host actually spent
    on the previous cycle's outputs) and the cycle histogram records
    each cycle's dispatch→delivery latency, which spans the overlapped
    next cycle — throughput is `stats["blocks"] / wall`, not
    1/cycle_p50.
    """

    def __init__(
        self,
        pool,
        host: str = "127.0.0.1",
        port: int = 0,
        lockstep: bool = True,
        sr: float | None = None,
        max_buffered_blocks: int = 32,
        checkpoint: "str | dict | None" = None,
        snapshot_every: float | None = None,
        metrics_http_port: int | None = None,
        pipeline: int = 1,
        resume_ttl: float | None = None,
    ):
        self.pool = pool
        self.hw = int(pool.hw_block_size)
        self.n_slots = int(pool.n_streams)
        self.lockstep = bool(lockstep)
        if not lockstep and not sr:
            raise ValueError("realtime mode needs sr for the tick period")
        # Pipelined dispatch: depth 2 keeps ONE cycle in flight (see
        # class docstring).  Deeper pipelines would add output latency
        # for no further overlap — the host fetch and the device compute
        # are the only two stages to overlap.
        self.pipeline = int(pipeline)
        if self.pipeline not in (1, 2):
            raise ValueError(
                f"pipeline must be 1 (synchronous) or 2 (one cycle in "
                f"flight), got {pipeline}"
            )
        # In-flight cycle: (device outputs (c, ls, rs), live slot list,
        # cycle start time).  Written only under _pool_lock.
        self._pending = None
        # The tick covers one hardware block of every stream's time.
        self.tick_period = (self.hw / float(sr)) if sr else None
        # Parked-session time-to-live: a restored session's slot is
        # reserved until its client resumes; without a bound a client
        # that never returns reserves it FOREVER and a full pool starts
        # rejecting new work for ghosts.  With resume_ttl set, expired
        # parked slots are reclaimed LAZILY when an allocation would
        # otherwise fail (no background timer; an idle pool holds
        # sessions indefinitely).  None = hold forever (default);
        # ttl <= 0 = reclaim immediately when a slot is needed.
        self.resume_ttl = (
            float(resume_ttl) if resume_ttl is not None else None
        )
        self.max_buffered_blocks = int(max_buffered_blocks)
        self._slots = [_Slot() for _ in range(self.n_slots)]
        if checkpoint is not None:
            self._load_checkpoint(checkpoint)
        self._lock = threading.Lock()
        # Serializes every touch of the pool's state: the dispatcher's
        # push_blocks vs. connection threads' slot re-warm
        # (reset_streams) — an interleaved read-modify-write would drop
        # one side's state update (and with a donate=True pool could
        # consume a donated buffer mid-step).
        self._pool_lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._threads = []
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, int(port)))
        self._sock.listen()
        self.address = self._sock.getsockname()
        self.metrics = ServerMetrics()
        # Back-compat alias: the pre-metrics public counter surface.
        # Same dict object, so either name observes every increment.
        self.stats = self.metrics.counters
        self._t0 = time.monotonic()
        self._metrics_http_port = metrics_http_port
        self._http = None
        self.metrics_http_address = None
        self.snapshot_path = None  # set by run_stream_server (CLI saves here)
        # Periodic checkpointing (needs snapshot_path): save_checkpoint
        # is non-destructive and point-in-time consistent, but its
        # capture pauses dispatch while the pool state copies to host —
        # pick an interval accordingly.
        self.snapshot_every = (
            float(snapshot_every) if snapshot_every else None
        )

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        loops = [self._accept_loop, self._dispatch_loop]
        if self.snapshot_every:
            loops.append(self._snapshot_loop)
        for fn in loops:
            t = threading.Thread(target=fn, daemon=True)
            t.start()
            self._threads.append(t)
        if self._metrics_http_port is not None:
            self._start_metrics_http(self._metrics_http_port)
        return self

    # -- observability -------------------------------------------------------

    def metrics_snapshot(self) -> dict:
        """Point-in-time metrics: counters + latency histograms (from
        `self.metrics`) plus state gauges and static config info."""
        with self._lock:
            states = [s.state for s in self._slots]
            queued = sum(
                s.inq.qsize() for s in self._slots if s.inq is not None
            )
        snap = self.metrics.snapshot()
        snap["gauges"] = {
            "slots_active": states.count(_ST_ACTIVE),
            "slots_draining": states.count(_ST_DRAINING),
            "slots_parked": states.count(_ST_PARKED),
            "slots_free": states.count(_ST_FREE),
            "queued_input_blocks": queued,
            "uptime_seconds": time.monotonic() - self._t0,
        }
        snap["config"] = {
            "engine": type(self.pool).__name__,
            "hw_block": self.hw,
            "n_slots": self.n_slots,
            "sr": float(self.pool.config.sr),
            "lockstep": self.lockstep,
            "pipeline": self.pipeline,
        }
        return snap

    def _start_metrics_http(self, port: int):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        server = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path in ("/metrics", "/metrics.json"):
                    snap = server.metrics_snapshot()
                    if self.path == "/metrics":
                        body = prometheus_text(snap).encode()
                        ctype = "text/plain; version=0.0.4"
                    else:
                        body = json.dumps(snap).encode()
                        ctype = "application/json"
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_error(404)

            def log_message(self, *args):
                pass  # no per-scrape stderr noise

        self._http = ThreadingHTTPServer(
            (self.address[0], int(port)), _Handler
        )
        self.metrics_http_address = self._http.server_address
        t = threading.Thread(target=self._http.serve_forever, daemon=True)
        t.start()
        self._threads.append(t)

    def _snapshot_loop(self):
        while not self._stop.wait(self.snapshot_every):
            if self.snapshot_path is None:
                continue
            try:
                self.save_checkpoint(self.snapshot_path)
            except Exception:
                import logging

                logging.getLogger(__name__).exception(
                    "periodic session checkpoint failed"
                )

    def close(self):
        self._stop.set()
        self._wake.set()
        # End-of-stream sentinels for every live session (same sweep as
        # the dispatcher-failure path): without them each connection's
        # writer thread blocks forever in outq.get(), its _serve_conn
        # parent blocks in writer.join() holding the accepted socket,
        # and a server restarted on the SAME port gets EADDRINUSE from
        # those lingering sockets (found by the native client's
        # resume-across-restart test).
        with self._lock:
            for s in self._slots:
                if s.state not in (_ST_FREE, _ST_PARKED) and (
                    s.outq is not None
                ):
                    s.outq.put(None)
        # shutdown() BEFORE close(): closing an fd does NOT wake a
        # thread blocked in accept() on Linux — the blocked syscall
        # keeps the listening socket alive (a process-less LISTEN in
        # `ss`) and the port stays EADDRINUSE for a restarted server
        # until some client's connect happens to unwedge the accept.
        # shutdown() wakes it deterministically.
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        if self._http is not None:
            self._http.shutdown()
            self._http.server_close()
        for t in self._threads:
            t.join(timeout=5.0)

    # -- checkpoint / resume -------------------------------------------------

    def _pool_identity(self) -> dict:
        """What must match for a checkpoint to restore into this server.
        JSON-canonicalized (tuples become lists) so the live identity
        compares equal to one round-tripped through the .npz metadata."""
        from upmix.aot import config_to_dict

        ident = {
            "engine": type(self.pool).__name__,
            "hw": self.hw,
            "n_streams": self.n_slots,
            "config": config_to_dict(self.pool.config),
        }
        return json.loads(json.dumps(ident))

    def save_checkpoint(self, path: str) -> int:
        """Freeze every live session to `path` (.npz); returns how many.

        NON-destructive and safe at any time, not just shutdown: the
        capture runs under _pool_lock+_lock (a consistent point in time
        — the dispatcher cycle is atomic under the same locks), queued
        input blocks are COPIED, not drained, and the file write
        happens outside the locks so serving resumes immediately.
        DRAINING sessions are checkpointed too: a client that already
        half-closed (its whole file sent) still has its warmup-tail
        output undelivered, and excluding it would make every file-fed
        stream unresumable during exactly its drain window — a resumed
        drain client reconnects with its token, sends nothing, and
        half-closes again to finish.  Still-PARKED sessions are
        carried forward as-is.  NOTE: the capture itself copies the full pool
        state to the host — seconds for multi-thousand-stream pools on
        a slow transport — during which dispatch is paused.
        """
        arrays: dict = {}
        sessions = []
        # Lock order everywhere both are held: _pool_lock OUTER, _lock
        # inner.  Holding both makes the checkpoint atomic against a
        # dispatcher cycle (which holds _pool_lock for its whole
        # pop+push+account step) and against slot alloc/resume.
        with self._pool_lock:
            # pipeline=2: the pool state already includes the in-flight
            # cycle, so its outputs must reach the slots' out_frames
            # BEFORE the capture — they are never re-generated, and a
            # resumed client would stall waiting for them otherwise.
            # (Takes _lock per slot, so it runs before the block below.)
            self._flush_pending()
            with self._lock:
                snap = self.pool.snapshot()
                for i, s in enumerate(self._slots):
                    if s.state in (_ST_ACTIVE, _ST_DRAINING):
                        # Peek, don't drain: all queue mutations happen
                        # under self._lock (reader enqueue, dispatcher
                        # pop), so reading the backing deque here is
                        # race-free and the server keeps processing
                        # these blocks after the checkpoint.
                        blocks = list(s.inq.queue)
                        rec = {
                            "rows": self.pool.extract_streams(
                                [i], snap=snap
                            ),
                            "blocks": np.stack(blocks)
                            if blocks
                            else np.zeros((0, self.hw, 2), np.float32),
                            "in_frames": s.in_frames,
                            "out_frames": s.out_frames,
                            "skip": s.skip,
                            "token": s.token,
                        }
                    elif s.state == _ST_PARKED:
                        rec = s.parked
                    else:
                        continue
                    key = f"s{i}"
                    desc = _tree_encode(rec["rows"], arrays, f"{key}.rows")
                    arrays[f"{key}.blocks"] = rec["blocks"]
                    sessions.append(
                        {
                            "slot": i,
                            "rows": desc,
                            "in_frames": int(rec["in_frames"]),
                            "out_frames": int(rec["out_frames"]),
                            "skip": int(rec["skip"]),
                            "token": rec["token"].hex(),
                        }
                    )
        meta = {
            "format": 1,
            "identity": self._pool_identity(),
            "sessions": sessions,
        }
        tmp = f"{path}.tmp"
        with open(tmp, "wb") as f:
            np.savez(
                f,
                __meta__=np.frombuffer(
                    json.dumps(meta).encode("utf-8"), dtype=np.uint8
                ),
                **arrays,
            )
        os.replace(tmp, path)
        self.stats["checkpoints"] += 1
        return len(sessions)

    def _load_checkpoint(self, checkpoint):
        if isinstance(checkpoint, (str, os.PathLike)):
            with np.load(checkpoint) as z:
                data = {k: z[k] for k in z.files}
        else:
            data = dict(checkpoint)
        meta = json.loads(bytes(data.pop("__meta__").tobytes()).decode("utf-8"))
        if meta.get("format") != 1:
            raise ValueError(
                f"unsupported stream-server checkpoint format "
                f"{meta.get('format')!r}"
            )
        want = self._pool_identity()
        have = meta["identity"]
        if have != want:
            diff = [k for k in want if have.get(k) != want[k]]
            raise ValueError(
                "checkpoint does not match this server's pool "
                f"(mismatched: {diff})"
            )
        for sess in meta["sessions"]:
            i = int(sess["slot"])
            key = f"s{i}"
            s = self._slots[i]
            s.state = _ST_PARKED
            s.parked_at = time.monotonic()
            s.token = bytes.fromhex(sess["token"])
            s.parked = {
                "rows": _tree_decode(sess["rows"], data),
                "blocks": data[f"{key}.blocks"],
                "in_frames": int(sess["in_frames"]),
                "out_frames": int(sess["out_frames"]),
                "skip": int(sess["skip"]),
                "token": bytes.fromhex(sess["token"]),
            }

    def _resume_slot(self, token: bytes, mix: int):
        """Claim a PARKED session by token: inject its engine rows into
        the pool and rebuild the live slot around its counters.

        The row injection and the slot's ACTIVE publication are ONE
        atomic step under _pool_lock+_lock (lock order: pool outer):
        if the slot went ACTIVE first, the dispatcher could process its
        queued blocks against the fresh pool's zero row before the
        injection landed — silently corrupting the resumed stream."""
        with self._pool_lock, self._lock:
            if self._stop.is_set():
                return None, None  # stopping: see _alloc_slot
            slot = None
            for i, s in enumerate(self._slots):
                if s.state == _ST_PARKED and s.token == token:
                    slot, idx = s, i
                    break
            if slot is None:
                return None, None
            rec = slot.parked
            self.pool.load_streams([idx], rec["rows"])
            slot.state = _ST_ACTIVE
            slot.parked = None
            slot.mix = mix
            slot.inq = queue.Queue(
                maxsize=max(self.max_buffered_blocks, len(rec["blocks"]) + 1)
            )
            slot.outq = queue.Queue()
            slot.in_frames = rec["in_frames"]
            slot.out_frames = rec["out_frames"]
            slot.skip = rec["skip"]
            slot.gen += 1
            for blk in rec["blocks"]:
                slot.inq.put_nowait(np.asarray(blk, np.float32))
            # Session counters are incremented under _lock (dict += is
            # a non-atomic read-modify-write; concurrent handshakes
            # would lose increments).
            self.stats["resumed"] += 1
            self.stats["accepted"] += 1
        self._wake.set()
        return idx, slot

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()

    # -- connection handling ----------------------------------------------

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return  # socket closed
            threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True
            ).start()

    def _alloc_slot(self, mix):
        with self._lock:
            if self._stop.is_set():
                # Server stopping (close() or dispatcher failure): an
                # accepted-but-unallocated connection must not become a
                # new victim blocked on an output queue nothing fills.
                return None, None
            if self.resume_ttl is not None and not any(
                s.state == _ST_FREE for s in self._slots
            ):
                # Lazy reclaim: only when the allocation would fail.
                now = time.monotonic()
                for s in self._slots:
                    if s.state == _ST_PARKED and (
                        now - s.parked_at > self.resume_ttl
                    ):
                        s.state = _ST_FREE
                        s.parked = None
                        s.token = _ZERO_TOKEN  # late resume -> status 3
                        self.stats["parked_expired"] += 1
            for i, s in enumerate(self._slots):
                if s.state == _ST_FREE:
                    s.state = _ST_ACTIVE
                    s.mix = mix
                    # Bounded: a file-fed client cannot buffer its whole
                    # signal server-side — the reader blocks and TCP
                    # backpressure stalls the client instead.
                    s.inq = queue.Queue(maxsize=self.max_buffered_blocks)
                    s.outq = queue.Queue()
                    s.in_frames = s.out_frames = 0
                    s.skip = (self.pool.warmup_blocks - 1) * self.hw
                    s.gen += 1
                    s.token = os.urandom(_TOKEN_LEN)
                    self.stats["accepted"] += 1
                    return i, s
        return None, None

    def _release_slot(self, s):
        with self._lock:
            s.state = _ST_FREE
            s.inq = s.outq = None
        self._wake.set()

    def _reply(self, conn, version, status, idx=0, out_ch=0, slot=None):
        head = MAGIC_REPLY + struct.pack(
            "<IIII", status, idx, self.hw if status == 0 else 0, out_ch
        )
        if version >= VERSION2:
            token = slot.token if slot is not None else _ZERO_TOKEN
            in_f = slot.in_frames if slot is not None else 0
            out_f = slot.out_frames if slot is not None else 0
            sr = float(self.pool.config.sr)
            head += token + struct.pack("<QQd", in_f, out_f, sr)
        conn.sendall(head)

    def _serve_conn(self, conn):
        slot = None
        writer = None
        try:
            hello = _read_exact(conn, 12)
            if len(hello) == 12 and hello[:4] == MAGIC_METRICS:
                fmt = struct.unpack("<I", hello[4:8])[0]
                snap = self.metrics_snapshot()
                payload = (
                    prometheus_text(snap).encode()
                    if fmt == 1
                    else json.dumps(snap).encode()
                )
                conn.sendall(struct.pack("<I", len(payload)) + payload)
                return
            version = (
                struct.unpack("<I", hello[4:8])[0] if len(hello) == 12 else 0
            )
            ok = (
                len(hello) == 12
                and hello[:4] == MAGIC_HELLO
                and version in (VERSION, VERSION2)
                and struct.unpack("<I", hello[8:12])[0] < len(MIX_MODES)
            )
            token = _ZERO_TOKEN
            if ok and version >= VERSION2:
                token = _read_exact(conn, _TOKEN_LEN)
                ok = len(token) == _TOKEN_LEN
            if not ok:
                self._reply(conn, max(version, VERSION), 2)
                return
            mix = struct.unpack("<I", hello[8:12])[0]
            if version >= VERSION2 and token != _ZERO_TOKEN:
                # Resume a parked (checkpointed) session: same slot, its
                # engine rows injected back into the pool, counters
                # restored; the reply's in_frames tells the client where
                # to resume sending.
                idx, slot = self._resume_slot(token, mix)
                if slot is None:
                    self._reply(conn, version, 3)
                    with self._lock:
                        self.stats["rejected"] += 1
                    return
            else:
                # Slot claim + pool-row zeroing are ONE atomic step
                # under _pool_lock: a checkpoint interleaving between
                # them would extract the PREVIOUS session's audio
                # history under the new session's token (cross-session
                # leak).
                with self._pool_lock:
                    idx, slot = self._alloc_slot(mix)
                    if slot is not None:
                        # The slot re-warms in place: its engine rows
                        # restart from silence without touching the
                        # other live sessions.
                        self.pool.reset_streams([idx])
                if slot is None:
                    self._reply(conn, version, 1)
                    with self._lock:
                        self.stats["rejected"] += 1
                    return
            out_ch = 3 if MIX_MODES[mix] == "lcr" else 2
            self._reply(conn, version, 0, idx, out_ch, slot)

            writer = threading.Thread(
                target=self._writer_loop, args=(conn, slot.outq),
                daemon=True,
            )
            writer.start()
            gen = slot.gen
            block_bytes = self.hw * 2 * 4
            while True:
                raw = _read_exact(conn, block_bytes)
                if len(raw) < block_bytes:
                    break  # EOF (half-close) or dead connection
                x = np.frombuffer(raw, dtype="<f4").reshape(self.hw, 2)
                # The enqueue and the in_frames ack are ONE atomic step
                # under _lock: a checkpoint between them would either
                # ack a block it never captured (permanent gap + drain
                # hang) or capture a block it never acked (duplicate on
                # resume).  The bounded queue's backpressure is handled
                # by retrying OUTSIDE the lock (a blocking put under
                # the lock would deadlock against the dispatcher).
                enqueued = False
                while not enqueued:
                    with self._lock:
                        if slot.gen != gen or slot.state != _ST_ACTIVE:
                            break  # slot torn down underneath us
                        try:
                            slot.inq.put_nowait(x)
                            slot.in_frames += self.hw
                            enqueued = True
                        except queue.Full:
                            pass
                    if not enqueued:
                        if self._stop.is_set():
                            break
                        # Backpressure: retry shortly; meanwhile we stop
                        # reading and TCP stalls the client's send.
                        self._stop.wait(0.01)
                if not enqueued:
                    break
                self._wake.set()
        except (OSError, ValueError):
            pass  # client gone mid-stream; drain below frees the slot
        finally:
            # EVERY exit path (clean EOF, RST abort, failed sendall)
            # must move an allocated slot to DRAINING, or the slot
            # leaks and a lockstep dispatcher stalls the whole pool
            # waiting for its next block.
            if slot is not None:
                with self._lock:
                    if slot.state == _ST_ACTIVE:
                        slot.state = _ST_DRAINING
                self._wake.set()
                if writer is not None:
                    writer.join()
            try:
                conn.close()
            except OSError:
                pass

    def _writer_loop(self, conn, outq):
        # The queue object is captured here, not re-read from the slot:
        # the dispatcher nulls slot.outq when it frees the slot.
        while True:
            item = outq.get()
            if item is None:
                try:
                    conn.shutdown(socket.SHUT_WR)
                except OSError:
                    pass
                return
            try:
                conn.sendall(item)
            except OSError:
                # Client vanished mid-stream: stop writing; the reader
                # side sees EOF and the slot drains out and frees.
                return

    # -- the pool dispatcher ----------------------------------------------

    def _ready(self):
        """Lockstep tick rule: every ACTIVE slot has an input block
        queued and at least one slot needs processing."""
        any_live = False
        for s in self._slots:
            if s.state == _ST_ACTIVE:
                any_live = True
                if s.inq.empty():
                    return False
            elif s.state == _ST_DRAINING:
                any_live = True
        return any_live

    def _flush_pending(self, cycle=_FLUSH_SELF_PENDING, t0=None):
        """Fetch and deliver one cycle's outputs: the in-flight cycle
        (no argument — pipeline=2's parked work) or an explicit
        ``((c, ls, rs), live, t_cycle)`` tuple.  The ONLY delivery path
        — both dispatcher branches and every drain site route through
        here so fetch timing + accounting cannot diverge.

        ``t0`` sets the dispatch-histogram baseline: the synchronous
        (pipeline=1) path passes its pre-dispatch timestamp so the
        histogram records dispatch+fetch; without it the histogram
        records only the blocking fetch wait (the host time a
        pipelined cycle's outputs actually cost — the chip computed
        them while the next cycle was dispatching).

        Caller must hold _pool_lock (and NOT _lock — accounting takes
        _lock per slot)."""
        import time as _time

        if cycle is _FLUSH_SELF_PENDING:
            cycle, self._pending = self._pending, None
        if cycle is None:
            return
        (c, ls, rs), live, t_cycle = cycle
        t_fetch = _time.monotonic() if t0 is None else t0
        c, ls, rs = np.asarray(c), np.asarray(ls), np.asarray(rs)
        self.metrics.dispatch_seconds.record(_time.monotonic() - t_fetch)
        self._account_cycle(c, ls, rs, live, t_cycle)

    def _account_cycle(self, c, ls, rs, live, t_cycle):
        """Deliver one cycle's fetched outputs to the live slots.
        Caller holds _pool_lock; takes _lock per slot internally."""
        import time as _time

        # Mix once, vectorized over the whole pool; the per-slot loop
        # below only slices and frames (matters on a busy host: the
        # dispatcher is one thread serving every session).
        half_c = 0.5 * c
        mix_l, mix_r = ls + half_c, rs + half_c
        for i, s, gen in live:
            with self._lock:
                if s.gen != gen or s.state == _ST_FREE:
                    continue
                if MIX_MODES[s.mix] == "lcr":
                    out = np.column_stack([c[i], ls[i], rs[i]])
                else:
                    out = np.column_stack([mix_l[i], mix_r[i]])
                if s.skip:
                    k = min(s.skip, len(out))
                    out = out[k:]
                    s.skip -= k
                room = s.in_frames - s.out_frames
                out = out[: max(0, room)]
                if len(out):
                    s.out_frames += len(out)
                    self.stats["frames"] += len(out)
                    s.outq.put(
                        np.ascontiguousarray(out)
                        .astype("<f4")
                        .tobytes()
                    )
                done = (
                    s.state == _ST_DRAINING
                    and s.inq.empty()
                    and s.out_frames >= s.in_frames
                )
            if done:
                s.outq.put(None)
                self._release_slot(s)
        self.metrics.cycle_seconds.record(_time.monotonic() - t_cycle)

    def _dispatch_loop(self):
        """Thread body: run cycles until stop; on an unexpected failure
        fail FAST instead of hanging — the dispatcher is the only thread
        that moves blocks through the pool, so a silent death would
        leave every connected client blocked forever on an output queue
        that nothing will ever fill (stats['blocks'] frozen, accept loop
        still admitting new victims)."""
        try:
            self._dispatch_cycles()
        except Exception:
            import logging

            logging.getLogger(__name__).exception(
                "stream dispatcher died; failing all live sessions"
            )
            self.stats["dispatcher_failures"] += 1
            # _stop BEFORE the sentinel sweep: _alloc_slot/_resume_slot
            # check it under _lock, so any admission that wins the lock
            # after this sweep is refused — without this ordering a
            # mid-handshake connection could allocate between the sweep
            # and a later _stop.set() and hang as a fresh victim.
            self._stop.set()
            with self._lock:
                for s in self._slots:
                    if s.state not in (_ST_FREE, _ST_PARKED) and (
                        s.outq is not None
                    ):
                        # End-of-stream sentinel: the writer thread
                        # drains and closes the socket, so the client
                        # observes a short read instead of a hang.
                        s.outq.put(None)
            self._wake.set()
            # Unblock _accept_loop too: it only re-checks _stop between
            # accepts, so without closing the listener post-failure
            # clients would still be admitted, get slots, and hang on
            # output queues nothing fills.  shutdown() first — close()
            # alone does not wake a blocked accept() (see close()).
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._sock.close()
            except OSError:
                pass

    def _dispatch_cycles(self):
        import time as _time

        zeros = np.zeros(self.hw, np.float32)  # one all-silent block row
        next_tick = None
        while not self._stop.is_set():
            if self.lockstep:
                with self._lock:
                    ready = self._ready()
                if not ready:
                    # No new cycle to build: deliver any in-flight
                    # outputs first (pipeline=2) — a DRAINING tail or a
                    # paused client must not hold the previous cycle's
                    # outputs hostage to the NEXT input's arrival.
                    if self._pending is not None:
                        with self._pool_lock:
                            self._flush_pending()
                        continue
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
                    continue
            else:
                # Deadline-based tick: the period is measured deadline to
                # deadline, so dispatch time does not stretch the block
                # rate (sleep-then-work would run period + work_time per
                # block and fall behind real time without bound).
                now = _time.monotonic()
                if next_tick is None:
                    next_tick = now + self.tick_period
                elif next_tick > now:
                    self._stop.wait(next_tick - now)
                    next_tick += self.tick_period
                else:  # fell behind (e.g. a compile): don't burst-spin
                    next_tick = now + self.tick_period
                with self._lock:
                    # PARKED counts as idle: a restarted server whose
                    # checkpointed clients have not reconnected yet must
                    # sleep, not dispatch all-zero pool blocks forever.
                    idle = not any(
                        s.state not in (_ST_FREE, _ST_PARKED)
                        for s in self._slots
                    )
                if idle:
                    if self._pending is not None:
                        with self._pool_lock:
                            self._flush_pending()
                    next_tick = None  # re-anchor the clock on next client
                    self._wake.wait(timeout=self.tick_period)
                    self._wake.clear()
                    continue
            # The WHOLE cycle — pop queued blocks, push the pool, account
            # the outputs — runs under _pool_lock, so a checkpoint (which
            # takes _pool_lock then _lock) can only observe quiesced
            # boundaries: never a block that left its queue but has not
            # reached the pool, nor pool state whose output frames were
            # not yet counted.  Lock order: _pool_lock OUTER, _lock inner.
            with self._pool_lock:
                t_cycle = _time.monotonic()
                in_l = [zeros] * self.n_slots
                in_r = [zeros] * self.n_slots
                live = []
                with self._lock:
                    # Re-check readiness under the cycle's locks: a slot
                    # can go ACTIVE between the unlocked _ready() poll
                    # and here (e.g. a session RESUMING with an empty
                    # queue), and the "late client: zeros" fallback
                    # below would inject a silent block into the middle
                    # of its stream (measured: full output corruption
                    # from that block's window onward).
                    if self.lockstep and not self._ready():
                        continue
                    for i, s in enumerate(self._slots):
                        if s.state in (_ST_FREE, _ST_PARKED):
                            # Parked sessions' engine rows live host-side
                            # in their checkpoint record; the pool row is
                            # dead until resume injects them.
                            continue
                        live.append((i, s, s.gen))
                        # In lockstep every ACTIVE queue holds a block
                        # (the under-lock _ready re-check above); an
                        # empty queue is a late realtime client or a
                        # DRAINING tail — both get silence.
                        try:
                            x = s.inq.get_nowait()
                        except queue.Empty:
                            if s.state == _ST_ACTIVE:
                                # Late client: zeros this tick (only
                                # reachable in realtime mode).
                                self.stats["late_zero_blocks"] += 1
                            continue  # row stays the all-silent block
                        in_l[i] = np.ascontiguousarray(x[:, 0])
                        in_r[i] = np.ascontiguousarray(x[:, 1])
                t_dispatch = _time.monotonic()
                c, ls, rs = self.pool.push_blocks(
                    np.stack(in_l), np.stack(in_r)
                )
                self.stats["blocks"] += 1
                cycle = ((c, ls, rs), live, t_cycle)
                if self.pipeline > 1:
                    # Async dispatch: jax returns device futures — hand
                    # the PREVIOUS cycle's outputs to the sockets while
                    # the chip computes this one, then park this cycle
                    # as the new in-flight work.
                    prev, self._pending = self._pending, cycle
                    self._flush_pending(prev)
                else:
                    # Synchronous: the histogram covers dispatch+fetch.
                    self._flush_pending(cycle, t0=t_dispatch)
        # Shutdown: deliver anything still in flight so a gracefully
        # closing client's tail is not dropped with the pipeline.
        with self._pool_lock:
            self._flush_pending()


class StreamSession:
    """Protocol-v2 client session: block-level streaming with a resume
    token.  Connect fresh (token=None) or resume a checkpointed session
    (token=<bytes from a previous session>); after a resume,
    ``server_in_frames`` says how many input frames the server already
    holds — resend your signal from that offset and skip reading the
    output frames you already received.

    Minimal surface for host shells and tests; `stream_client` below
    remains the one-shot whole-signal convenience (protocol v1).
    """

    def __init__(self, host, port, mix="stereo_sum", token=None,
                 timeout=60.0):
        if mix not in MIX_MODES:
            raise ValueError(f"mix must be one of {MIX_MODES}, got {mix!r}")
        self.sock = socket.create_connection((host, port), timeout=timeout)
        try:
            tok = token if token is not None else _ZERO_TOKEN
            if len(tok) != _TOKEN_LEN:
                raise ValueError(f"token must be {_TOKEN_LEN} bytes")
            self.sock.sendall(
                MAGIC_HELLO
                + struct.pack("<II", VERSION2, MIX_MODES.index(mix))
                + tok
            )
            reply = _read_exact(self.sock, 20 + _TOKEN_LEN + 24)
            if len(reply) < 20 + _TOKEN_LEN + 24 or reply[:4] != MAGIC_REPLY:
                raise ConnectionError("bad server reply")
            status, self.slot, self.hw, self.out_channels = struct.unpack(
                "<IIII", reply[4:20]
            )
            self.token = reply[20 : 20 + _TOKEN_LEN]
            (
                self.server_in_frames,
                self.server_out_frames,
                self.server_sr,
            ) = struct.unpack(
                "<QQd", reply[20 + _TOKEN_LEN : 44 + _TOKEN_LEN]
            )
            if status == 1:
                raise ConnectionError("server pool is full")
            if status == 3:
                raise ConnectionError("unknown or expired resume token")
            if status != 0:
                raise ConnectionError(
                    f"server rejected hello (status {status})"
                )
        except Exception:
            self.sock.close()
            raise

    def send_block(self, in_l, in_r):
        """One hw block (each channel length hw, zero-pad short tails)."""
        frame = np.column_stack(
            [np.asarray(in_l, "<f4"), np.asarray(in_r, "<f4")]
        )
        if frame.shape != (self.hw, 2):
            raise ValueError(
                f"send_block expects two length-{self.hw} channels"
            )
        self.sock.sendall(frame.tobytes())

    def recv_frames(self, n):
        """Read exactly n output frames -> [n, out_channels] float32."""
        raw = _read_exact(self.sock, n * self.out_channels * 4)
        if len(raw) < n * self.out_channels * 4:
            raise ConnectionError(
                f"short stream: got {len(raw) // (self.out_channels * 4)} "
                f"of {n} frames"
            )
        return np.frombuffer(raw, "<f4").reshape(n, self.out_channels)

    def finish(self):
        """Half-close: no more input; the server drains and closes."""
        try:
            self.sock.shutdown(socket.SHUT_WR)
        except OSError:
            pass

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def stream_client(
    host, port, in_l, in_r, mix="stereo_sum", timeout=60.0, expect_sr=None
):
    """Reference client: stream a whole stereo signal through a
    StreamServer and return the processed channels, trimmed to the
    input length.  Sends and receives concurrently (the server replies
    block-for-block), zero-padding the final short block.

    Speaks protocol v2 (as a fresh session); `expect_sr` validates the
    server's sample rate against the signal's before sending a byte
    (a mismatched rate would silently pitch-shift the audio).
    """
    if mix not in MIX_MODES:
        raise ValueError(f"mix must be one of {MIX_MODES}, got {mix!r}")
    in_l = np.asarray(in_l, np.float32)
    in_r = np.asarray(in_r, np.float32)
    n = len(in_l)
    sock = socket.create_connection((host, port), timeout=timeout)
    try:
        sock.sendall(
            MAGIC_HELLO
            + struct.pack("<II", VERSION2, MIX_MODES.index(mix))
            + _ZERO_TOKEN
        )
        reply = _read_exact(sock, 20 + _TOKEN_LEN + 24)
        if len(reply) < 20 + _TOKEN_LEN + 24 or reply[:4] != MAGIC_REPLY:
            raise ConnectionError("bad server reply")
        status, _slot, hw, out_ch = struct.unpack("<IIII", reply[4:20])
        (server_sr,) = struct.unpack(
            "<d", reply[36 + _TOKEN_LEN : 44 + _TOKEN_LEN]
        )
        if status == 1:
            raise ConnectionError("server pool is full")
        if status != 0:
            raise ConnectionError(f"server rejected hello (status {status})")
        if expect_sr is not None and abs(server_sr - float(expect_sr)) > 1e-6:
            raise ValueError(
                f"server runs at {server_sr:g} Hz but the signal is "
                f"{float(expect_sr):g} Hz — resample or use a matching "
                "server"
            )

        pad = (-n) % hw
        xl = np.concatenate([in_l, np.zeros(pad, np.float32)])
        xr = np.concatenate([in_r, np.zeros(pad, np.float32)])
        frames = np.column_stack([xl, xr]).astype("<f4")
        total = len(xl)

        def send():
            try:
                for i in range(0, total, hw):
                    sock.sendall(frames[i : i + hw].tobytes())
                sock.shutdown(socket.SHUT_WR)
            except OSError:
                pass

        tx = threading.Thread(target=send, daemon=True)
        tx.start()
        out = bytearray()
        want = total * out_ch * 4
        while len(out) < want:
            chunk = sock.recv(min(1 << 16, want - len(out)))
            if not chunk:
                break
            out.extend(chunk)
        tx.join()
        got = np.frombuffer(bytes(out), dtype="<f4").reshape(-1, out_ch)
        if len(got) < total:
            raise ConnectionError(
                f"short stream: got {len(got)} of {total} frames"
            )
        return tuple(np.ascontiguousarray(got[:n, ch]) for ch in range(out_ch))
    finally:
        sock.close()


def fetch_metrics(host: str, port: int, fmt: str = "json"):
    """Query a running StreamServer's metrics over its own port.

    fmt="json" returns the parsed `metrics_snapshot()` dict;
    fmt="prometheus" returns the text exposition as a str.
    """
    fmt_code = {"json": 0, "prometheus": 1}[fmt]
    with socket.create_connection((host, int(port))) as sock:
        sock.sendall(MAGIC_METRICS + struct.pack("<II", fmt_code, 0))
        head = _read_exact(sock, 4)
        if len(head) < 4:
            raise ConnectionError("metrics query: short reply")
        (n,) = struct.unpack("<I", head)
        payload = _read_exact(sock, n)
    if len(payload) < n:
        raise ConnectionError("metrics query: truncated payload")
    if fmt == "json":
        return json.loads(payload.decode("utf-8"))
    return payload.decode("utf-8")


def run_stream_server(
    port: int,
    sr: float,
    n_streams: int = 16,
    hw_block_size: int = 2048,
    band_edges=(0, 500, 2000, 8000),
    host: str = "127.0.0.1",
    lockstep: bool = False,
    window: str = "blackman_harris",
    xover_mode: str = "raised_cosine",
    threshold_factor: float = 32.0,
    synthesis: str = "analysis",
    bin_rounding: str = "cpp",
    verbose: bool = True,
    engine: str = "auto",
    mesh=None,
    snapshot_path: str | None = None,
    snapshot_every: float | None = None,
    metrics_http_port: int | None = None,
    pipeline: int = 1,
    resume_ttl: float | None = None,
) -> "StreamServer":
    """CLI entry: build the pool (auto engine) and serve until ^C.

    Defaults mirror run_pipe's streaming config (the reference Bela
    setup, bela/upmix.cpp:525-528).  lockstep defaults to False here:
    a network server ticks on the wall clock like an audio callback.
    engine/mesh configure make_stream_pool (explicit keywords, not a
    **kwargs pass-through, so a misspelled server kwarg raises here
    instead of deep in pool construction).  A mesh
    with a 'data' axis shards the serving pool across chips — sessions
    split over devices, zero collectives per block.

    snapshot_path: if the file exists, restore the checkpointed
    sessions from it (they park until their clients reconnect with
    their resume tokens); the CLI saves back to it on shutdown.
    """
    from upmix.config import UpmixConfig
    from upmix.models import make_stream_pool

    config = UpmixConfig.streaming(
        list(band_edges),
        sr=float(sr),
        hw_block_size=int(hw_block_size),
        window=window,
        xover_mode=xover_mode,
        threshold_factor=threshold_factor,
        synthesis=synthesis,
        bin_rounding=bin_rounding,
    )
    pool = make_stream_pool(
        config, int(hw_block_size), int(n_streams),
        engine=engine, mesh=mesh,
    )
    checkpoint = None
    if snapshot_path is not None and os.path.exists(snapshot_path):
        checkpoint = snapshot_path
    server = StreamServer(
        pool, host=host, port=port, lockstep=lockstep, sr=float(sr),
        checkpoint=checkpoint, snapshot_every=snapshot_every,
        metrics_http_port=metrics_http_port,
        pipeline=pipeline, resume_ttl=resume_ttl,
    )
    server.snapshot_path = snapshot_path
    server.start()
    if verbose:
        parked = sum(1 for s in server._slots if s.state == _ST_PARKED)
        resumed = f", {parked} parked sessions" if parked else ""
        http_note = ""
        if server.metrics_http_address is not None:
            http_note = (
                f", metrics http://{server.metrics_http_address[0]}:"
                f"{server.metrics_http_address[1]}/metrics"
            )
        print(
            f"upmix stream server on {server.address[0]}:"
            f"{server.address[1]} — {n_streams} slots, hw {hw_block_size}, "
            f"engine {type(pool).__name__}{resumed}{http_note}",
            flush=True,
        )
    return server
