"""Production serving surfaces: the job server and the multi-stream pool.

Two ways this framework serves at scale beyond one-shot CLI runs:

1. `run_jobs` — the persistent batch job server behind
   `upmix - --serve`: JSON jobs in, JSON results out, compiled
   programs reused across jobs (driven here through plain StringIO, no
   subprocess needed).
2. `make_stream_pool` — many concurrent live streams through ONE
   dispatch per hardware block (the stream step vmapped over session
   slots), with per-slot session churn.
3. `StreamServer` — the network front end for that pool (behind
   `upmix - --serve-stream PORT`): each TCP connection claims a
   slot and streams fixed-size float32 blocks; the client gets its
   warmup-aligned result back, frame for frame.

    python examples/04_serving.py [workdir]
"""

import io
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from upmix.app import run_jobs
from upmix.config import UpmixConfig
from upmix.io import write_wav
from upmix.models import make_stream_pool

workdir = sys.argv[1] if len(sys.argv) > 1 else "."
os.makedirs(workdir, exist_ok=True)

# --- 1. job server ------------------------------------------------------
sr = 8000
rng = np.random.default_rng(0)
paths = []
for i in range(3):
    x = (rng.standard_normal((sr, 2)) * 0.3).astype(np.float32)
    p = os.path.join(workdir, f"job_{i}.wav")
    write_wav(p, x, sr)
    paths.append(p)

jobs = "\n".join(
    [json.dumps({"cmd": "ping"})]
    + [json.dumps({"in": p, "out_dir": os.path.join(workdir, "served")}) for p in paths]
)
dst = io.StringIO()
n_ok, n_fail = run_jobs(
    io.StringIO(jobs), dst, band_edges=[0.0, 400.0, 1600.0], max_block_size=512
)
assert (n_ok, n_fail) == (3, 0)
for line in dst.getvalue().splitlines():
    r = json.loads(line)
    print("job:", {k: r[k] for k in r if k != "outputs"})
print("job server: 3/3 ok (first job compiled; the rest ran warm)\n")

# --- 2. multi-stream pool ----------------------------------------------
HW, B = 256, 4
cfg = UpmixConfig.streaming([0.0, 400.0, 1600.0], sr=float(sr), hw_block_size=HW)
pool = make_stream_pool(cfg, HW, n_streams=B)  # engine='auto'
common = rng.standard_normal((8, B, HW)).astype(np.float32) * 0.3
side = rng.standard_normal((8, B, HW)).astype(np.float32) * 0.1
for t in range(8):
    C, Ls, Rs = pool.push_blocks(common[t] + side[t], common[t] - side[t])
    if t == 5:
        pool.reset_streams([2])  # session on slot 2 ended; slot re-warms
print(f"pool: {B} streams, last block C peak per stream:",
      [round(float(np.abs(np.asarray(C[b])).max()), 4) for b in range(B)])
assert np.abs(np.asarray(C[2])).max() == 0.0  # slot 2 still in warmup
assert np.abs(np.asarray(C[0])).max() > 0.0
print("multi-stream pool: slot churn verified (slot 2 re-warming)\n")

# --- 3. live-stream server ---------------------------------------------
from upmix.models.streaming import BatchStreamingUpmixer
from upmix.serve_stream import StreamServer, stream_client

server_pool = BatchStreamingUpmixer(cfg, HW, n_streams=B)
with StreamServer(server_pool, lockstep=True) as srv:
    n = 5 * HW
    L = (rng.standard_normal(n) * 0.3).astype(np.float32)
    R = (rng.standard_normal(n) * 0.3).astype(np.float32)
    out_l, out_r = stream_client(*srv.address, L, R)
    assert len(out_l) == n and np.isfinite(out_l).all()
    print(f"stream server on {srv.address[0]}:{srv.address[1]}: "
          f"{n} frames round-tripped, peak {np.abs(out_l).max():.3f}")

    # Observability: every server answers a metrics query on its own
    # port (and serves Prometheus text over HTTP with
    # metrics_http_port=...; CLI: --metrics-http PORT).
    from upmix.serve_stream import fetch_metrics

    m = fetch_metrics(*srv.address)
    print(f"metrics: {m['counters']['accepted']} sessions, "
          f"{m['counters']['blocks']} pool blocks, dispatch p95 "
          f"{m['dispatch_seconds']['p95'] * 1e3:.2f} ms")

# --- 4. session checkpoint/resume across a server restart ----------------
# Live sessions survive a server restart: save_checkpoint freezes every
# session (engine rows, counters, queued blocks, resume tokens) to one
# file; a new server parks them until their clients reconnect with
# StreamSession(token=...) and resend from the acked input position.
from upmix.serve_stream import StreamSession

ck = os.path.join(workdir, "sessions.npz")
srv_a = StreamServer(
    BatchStreamingUpmixer(cfg, HW, n_streams=B), lockstep=True
).start()
n_blocks = 8
L = (rng.standard_normal(n_blocks * HW) * 0.3).astype(np.float32)
R = (rng.standard_normal(n_blocks * HW) * 0.3).astype(np.float32)
sess = StreamSession(*srv_a.address)
for b in range(4):
    sess.send_block(L[b * HW : (b + 1) * HW], R[b * HW : (b + 1) * HW])
part1 = sess.recv_frames(4 * HW - (pool.warmup_blocks - 1) * HW)
srv_a.save_checkpoint(ck)
sess.close()
srv_a.close()  # "crash"

srv_b = StreamServer(
    BatchStreamingUpmixer(cfg, HW, n_streams=B), lockstep=True, checkpoint=ck
).start()
try:
    sess2 = StreamSession(*srv_b.address, token=sess.token)  # same session
    resume_blk = sess2.server_in_frames // HW  # resend from the acked pos
    for b in range(resume_blk, n_blocks):
        sess2.send_block(L[b * HW : (b + 1) * HW], R[b * HW : (b + 1) * HW])
    sess2.finish()
    part2 = sess2.recv_frames(n_blocks * HW - len(part1))
    full = np.concatenate([part1, part2])
    assert len(full) == n_blocks * HW and np.isfinite(full).all()
    print(f"checkpoint/resume: session resumed at block {resume_blk}, "
          f"{len(full)} frames total across the restart")
finally:
    sess2.close()
    srv_b.close()
