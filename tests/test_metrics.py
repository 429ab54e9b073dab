"""Serving observability tests (upmix/metrics.py + the stream
server's UPMQ query / HTTP endpoint): counters must agree with the
server's own accounting, histograms must see one sample per pool
dispatch, and the Prometheus text exposition must be well-formed.
The reference has no observability surface; this is framework-grade
serving machinery (SURVEY.md §5 metrics/logging)."""

import json
import struct
import urllib.request

import numpy as np
import pytest

from upmix.config import UpmixConfig
from upmix.metrics import LatencyHistogram, ServerMetrics, prometheus_text
from upmix.models.streaming import BatchStreamingUpmixer
from upmix.serve_stream import StreamServer, fetch_metrics, stream_client

from helpers import make_stereo

HW = 256
SR = 8000.0
EDGES = [0.0, 400.0, 1600.0]


def _cfg():
    return UpmixConfig.streaming(EDGES, sr=SR, hw_block_size=HW)


# -- histogram unit behavior -------------------------------------------------

def test_histogram_records_and_quantiles():
    h = LatencyHistogram()
    for ms in (1, 1, 1, 1, 1, 1, 1, 1, 1, 100):
        h.record(ms * 1e-3)
    snap = h.snapshot()
    assert snap["count"] == 10
    assert snap["sum"] == pytest.approx(0.109, rel=1e-6)
    assert snap["max"] == pytest.approx(0.1)
    # p50 lands in the bucket holding the 1 ms samples; p99 must reach
    # the outlier's bucket (upper-bound estimator: >= the sample).
    assert 1e-3 <= snap["p50"] <= 2e-3
    assert snap["p99"] >= 0.1
    # Cumulative bucket counts are monotone and end at count.
    cum = [c for _, c in snap["buckets"]]
    assert cum == sorted(cum)
    assert cum[-1] == 10


def test_histogram_empty_and_overflow():
    h = LatencyHistogram(bounds=(1e-3, 1e-2))
    assert h.quantile(0.5) == 0.0
    h.record(5.0)  # beyond every bound -> +Inf bucket
    snap = h.snapshot()
    assert snap["count"] == 1
    assert snap["buckets"][-1][1] == 0  # nothing under the finite bounds
    assert h.quantile(0.5) == pytest.approx(5.0)  # falls back to max


def test_prometheus_text_shape():
    m = ServerMetrics()
    m.counters["blocks"] += 3
    m.dispatch_seconds.record(2e-3)
    snap = m.snapshot()
    snap["gauges"] = {"slots_active": 2}
    snap["config"] = {"engine": "X", "hw_block": HW}
    text = prometheus_text(snap)
    assert 'upmix_blocks_total 3.0' in text
    assert 'upmix_slots_active 2.0' in text
    assert 'upmix_dispatch_seconds_bucket{le="+Inf"} 1.0' in text
    assert "upmix_dispatch_seconds_count 1.0" in text
    assert 'upmix_server_info{engine="X",hw_block="%d"} 1.0' % HW in text
    # Every non-comment line is "name[{labels}] value".
    for line in text.strip().splitlines():
        if line.startswith("#"):
            continue
        name, _, value = line.rpartition(" ")
        assert name and float(value) is not None


# -- live server integration -------------------------------------------------

@pytest.fixture(scope="module")
def server():
    pool = BatchStreamingUpmixer(_cfg(), HW, n_streams=4)
    with StreamServer(pool, lockstep=True, metrics_http_port=0) as srv:
        yield srv


def test_server_metrics_counters_and_histograms(server):
    L, R = make_stereo(4 * HW, SR, seed=11)
    before = server.metrics_snapshot()
    out_l, out_r = stream_client(server.address[0], server.address[1], L, R)
    assert out_l.shape == out_r.shape == (len(L),)
    after = server.metrics_snapshot()
    d_acc = after["counters"]["accepted"] - before["counters"]["accepted"]
    d_blocks = after["counters"]["blocks"] - before["counters"]["blocks"]
    d_frames = after["counters"]["frames"] - before["counters"]["frames"]
    assert d_acc == 1
    assert d_frames == len(L)
    # Lockstep: never a zero-injected late block.
    assert after["counters"]["late_zero_blocks"] == 0
    # One dispatch + one cycle histogram sample per pool block.
    d_disp = (after["dispatch_seconds"]["count"]
              - before["dispatch_seconds"]["count"])
    d_cyc = (after["cycle_seconds"]["count"]
             - before["cycle_seconds"]["count"])
    assert d_disp == d_blocks == d_cyc
    assert d_blocks > 0
    # Cycle time includes the dispatch it wraps.
    assert after["cycle_seconds"]["sum"] >= after["dispatch_seconds"]["sum"]
    # Gauges: idle again after the client drained; slots all free.
    assert after["gauges"]["slots_active"] == 0
    assert after["gauges"]["slots_free"] == server.n_slots
    assert after["gauges"]["uptime_seconds"] > 0
    assert after["config"]["hw_block"] == HW
    # stats alias still observes the same counters (back-compat).
    assert server.stats["blocks"] == after["counters"]["blocks"]


def test_wire_metrics_query_matches_snapshot(server):
    snap = fetch_metrics(server.address[0], server.address[1])
    assert snap["config"]["n_slots"] == server.n_slots
    assert set(snap["counters"]) == set(server.metrics.counters)
    text = fetch_metrics(server.address[0], server.address[1],
                         fmt="prometheus")
    assert text.startswith("# HELP upmix_")
    assert "upmix_server_info" in text
    # The query itself must not count as an accepted/rejected session.
    snap2 = fetch_metrics(server.address[0], server.address[1])
    assert snap2["counters"]["accepted"] == snap["counters"]["accepted"]
    assert snap2["counters"]["rejected"] == snap["counters"]["rejected"]


def test_http_endpoint(server):
    host, port = server.metrics_http_address
    with urllib.request.urlopen(f"http://{host}:{port}/metrics.json") as r:
        assert r.headers["Content-Type"] == "application/json"
        snap = json.loads(r.read().decode())
    assert snap["config"]["engine"] == "BatchStreamingUpmixer"
    with urllib.request.urlopen(f"http://{host}:{port}/metrics") as r:
        assert r.headers["Content-Type"].startswith("text/plain")
        text = r.read().decode()
    assert "upmix_blocks_total" in text
    with pytest.raises(urllib.error.HTTPError):
        urllib.request.urlopen(f"http://{host}:{port}/nope")


def test_bad_metrics_magic_still_rejected(server):
    # An unknown magic must get the bad-hello reply, not a metrics dump.
    import socket as _socket

    with _socket.create_connection(server.address) as sock:
        sock.sendall(b"XXXX" + struct.pack("<II", 0, 0))
        head = sock.recv(4)
    assert head == b"UPMR" or head == b""  # status-2 reply path


def test_checkpoint_and_resume_counters(tmp_path):
    pool = BatchStreamingUpmixer(_cfg(), HW, n_streams=2)
    path = str(tmp_path / "sess.npz")
    with StreamServer(pool, lockstep=True) as srv:
        srv.save_checkpoint(path)
        assert srv.stats["checkpoints"] == 1
        snap = srv.metrics_snapshot()
        assert snap["counters"]["checkpoints"] == 1
        assert snap["counters"]["resumed"] == 0
