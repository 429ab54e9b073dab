"""Autotuner tests (upmix/tune.py): the pool sweep must measure
every feasible batch-size candidate with the interleaved
min-of-visits protocol, record infeasible ones with their error, and
pick the capacity-best feasible candidate.  Run tiny on the CPU
backend; the protocol is identical on hardware."""

import numpy as np
import pytest

from upmix.config import UpmixConfig
from upmix.tune import tune_pool

HW = 256
SR = 8000.0
EDGES = [0.0, 400.0, 1600.0]


def _cfg():
    return UpmixConfig.streaming(EDGES, sr=SR, hw_block_size=HW)


def test_tune_xla_sweep_picks_best():
    report = tune_pool(
        _cfg(), HW, batch_sizes=(2, 4), blocks=2, visits=2, verbose=False,
    )
    ok = [r for r in report["results"] if r["ok"]]
    assert len(ok) == 2  # one candidate per batch
    best = report["best"]
    assert best is not None and best in report["results"]
    for r in ok:
        assert r["seconds_per_block"] > 0
        assert r["streams_per_chip"] == pytest.approx(
            r["batch"] * (HW / SR) / r["seconds_per_block"]
        )
        assert r["us_per_block_stream"] == pytest.approx(
            r["seconds_per_block"] / r["batch"] * 1e6
        )
    assert best["streams_per_chip"] == max(r["streams_per_chip"] for r in ok)
    assert report["protocol"]["estimator"].startswith("min-of-visits")
    assert report["protocol"]["transport_floor_seconds"] > 0


def test_tune_records_failures_without_raising():
    # A pool that cannot be built (0 streams) is recorded with its
    # error; the feasible candidate still measures and wins.
    report = tune_pool(
        _cfg(), HW, batch_sizes=(0, 2), blocks=1, visits=1, verbose=False,
    )
    bad, good = report["results"]
    assert bad["ok"] is False
    assert "ValueError" in bad["error"]
    assert good["ok"] and report["best"] is good


def test_tune_cli_json(capsys):
    import json

    from upmix.tune import main

    rc = main([
        "--sr", str(SR), "--hw-block", str(HW),
        "--edges", "0,400,1600", "--batches", "2",
        "--blocks", "1", "--visits", "1", "--json",
    ])
    assert rc == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    report = json.loads(line)
    assert report["best"]["batch"] == 2


def test_tune_xla_one_candidate_per_batch():
    report = tune_pool(
        _cfg(), HW, batch_sizes=(2,), blocks=1, visits=1, verbose=False,
    )
    (rec,) = report["results"]
    assert rec["ok"] and rec["label"] == "B2" and rec["pipeline"] == 1


def test_tune_cli_json_exit_code_on_total_failure(capsys):
    import json

    from upmix.tune import main

    # No buildable candidate at all: the scripted (--json) path must
    # exit nonzero like the human path.
    rc = main([
        "--sr", str(SR), "--hw-block", str(HW),
        "--edges", "0,400,1600", "--batches", "0",
        "--blocks", "1", "--visits", "1", "--json",
    ])
    assert rc == 1
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line)["best"] is None


def test_tune_scan_protocol_xla():
    # scan protocol: one-dispatch chained steps per visit (device-side
    # capacity); must resolve a best candidate and label the protocol.
    report = tune_pool(
        _cfg(), HW, batch_sizes=(2, 4), blocks=4, visits=2,
        protocol="scan", unroll=2, verbose=False,
    )
    ok = [r for r in report["results"] if r["ok"]]
    assert len(ok) == 2
    assert report["best"] is not None
    assert report["protocol"]["name"] == "scan"
    assert report["protocol"]["unroll"] == 2
    for r in ok:
        assert r["seconds_per_block"] > 0


def test_tune_rejects_unknown_protocol():
    with pytest.raises(ValueError):
        tune_pool(_cfg(), HW, protocol="bogus")


@pytest.mark.parametrize("protocol", ["dispatch", "scan", "lockstep"])
def test_tune_report_shape_per_protocol(protocol):
    # Every protocol reports the same per-candidate fields and its own
    # protocol block; unroll is a scan-only field.
    report = tune_pool(
        _cfg(), HW, batch_sizes=(2,), blocks=2, visits=1,
        protocol=protocol, verbose=False,
    )
    (rec,) = report["results"]
    assert rec["ok"] and rec["error"] is None
    assert set(rec) >= {"batch", "pipeline", "label", "seconds_per_block",
                        "us_per_block_stream", "streams_per_chip"}
    assert "visits" not in rec
    proto = report["protocol"]
    assert proto["name"] == protocol and proto["blocks"] == 2
    assert (proto["unroll"] is None) == (protocol != "scan")


def test_tune_lockstep_protocol_xla():
    # lockstep protocol: host inputs + full 3-output host fetch per
    # cycle (the stream server's dispatcher cost model,
    # serve_stream.py) — the transfers belong in the timed region.
    report = tune_pool(
        _cfg(), HW, batch_sizes=(2, 4), blocks=2, visits=2,
        protocol="lockstep", verbose=False,
    )
    ok = [r for r in report["results"] if r["ok"]]
    assert len(ok) == 2
    assert report["protocol"]["name"] == "lockstep"
    assert report["best"] is not None
    for r in ok:
        assert r["seconds_per_block"] > 0


def test_tune_lockstep_pipeline_sweep_shares_pool(monkeypatch):
    # pipeline=2 candidates time the SAME pool with the pipelined fetch
    # schedule (park cycle N's outputs, fetch after dispatching N+1) —
    # the build is shared, both depths are measured, labels carry /P2.
    import upmix.models.streaming as streaming

    builds = []
    real = streaming.make_stream_pool

    def counting(*a, **k):
        builds.append(a)
        return real(*a, **k)

    monkeypatch.setattr(streaming, "make_stream_pool", counting)
    report = tune_pool(
        _cfg(), HW, batch_sizes=(4,), blocks=4, visits=2,
        protocol="lockstep", pipelines=(1, 2), verbose=False,
    )
    assert len(builds) == 1
    ok = [r for r in report["results"] if r["ok"]]
    assert {r["pipeline"] for r in ok} == {1, 2}
    (p2,) = [r for r in ok if r["pipeline"] == 2]
    assert p2["label"].endswith("/P2")
    assert report["protocol"]["pipelines"] == [1, 2]
    for r in ok:
        assert r["seconds_per_block"] > 0


def test_tune_pipeline_rejected_off_lockstep():
    # pipelines is a lockstep-only knob: the scan/dispatch protocols
    # are already async-pipelined by jax dispatch, so a depth sweep
    # there would silently measure nothing.
    with pytest.raises(ValueError, match="lockstep"):
        tune_pool(_cfg(), HW, batch_sizes=(4,),
                  protocol="dispatch", pipelines=(1, 2), verbose=False)
    with pytest.raises(ValueError, match="1 or 2"):
        tune_pool(_cfg(), HW, batch_sizes=(4,),
                  protocol="lockstep", pipelines=(3,), verbose=False)


def test_tune_offline_sweep():
    from upmix.tune import tune_offline

    report = tune_offline(
        sr=8000.0, band_edges=(0.0, 400.0, 1600.0), max_block_size=512,
        n_samples=4096, chunks=(2048, 4096, 0), kernel="mm", inner=2,
        visits=2, verbose=False,
    )
    ok = [r for r in report["results"] if r["ok"]]
    assert len(ok) == 3  # all feasible at this tiny geometry
    best = report["best"]
    assert best is not None and best in report["results"]
    for r in ok:
        assert r["seconds_per_application"] > 0
        assert r["realtime_factor"] == pytest.approx(
            (4096 / 8000.0) / r["seconds_per_application"]
        )
    assert best["realtime_factor"] == max(r["realtime_factor"] for r in ok)
    assert report["protocol"]["name"] == "offline"


def test_tune_offline_chunk_rounds_to_frame_grid():
    from upmix.tune import tune_offline

    # A chunk below the frame-grid unit is rounded up by the builder
    # (models/offline.py), not rejected: still a feasible candidate.
    report = tune_offline(
        sr=8000.0, band_edges=(0.0, 400.0, 1600.0), max_block_size=512,
        n_samples=4096, chunks=(7, 4096), kernel="mm", inner=1, visits=1,
        verbose=False,
    )
    assert all(r["ok"] for r in report["results"])
    assert report["protocol"]["chunk_active"]


def test_tune_offline_records_infeasible():
    from upmix.tune import tune_offline

    # Every candidate failing (unknown kernel) is recorded with its
    # error, not raised, and best is None.
    report = tune_offline(
        sr=8000.0, band_edges=(0.0, 400.0, 1600.0), max_block_size=512,
        n_samples=4096, chunks=(4096,), kernel="nope", inner=1, visits=1,
        verbose=False,
    )
    bad = [r for r in report["results"] if not r["ok"]]
    assert len(bad) == 1 and "error" in bad[0]
    assert report["best"] is None


def test_tune_offline_cli_json(capsys):
    from upmix.tune import main

    rc = main([
        "--offline", "--sr", "8000", "--edges", "0,400,1600",
        "--max-block-size", "512", "--samples", "4096",
        "--chunks", "4096", "--inner", "1", "--visits", "1", "--json",
    ])
    assert rc == 0
    import json

    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["best"]["ok"]


def test_tune_offline_inactive_chunking_dedupes():
    # kernel=xla has no chunked scan: every candidate is the identical
    # whole-file program, so only one builds and the rest are recorded
    # as duplicates (review finding: ranking noise between copies of one
    # program is not a sweep).
    from upmix.tune import tune_offline

    report = tune_offline(
        sr=8000.0, band_edges=(0.0, 400.0, 1600.0), max_block_size=512,
        n_samples=4096, chunks=(2048, 4096), kernel="xla", inner=1,
        visits=1, verbose=False,
    )
    ok = [r for r in report["results"] if r["ok"]]
    dup = [r for r in report["results"]
           if r.get("error") and "identical program" in r["error"]]
    assert len(ok) == 1 and len(dup) == 1
    assert report["protocol"]["chunk_active"] is False


def test_tune_offline_clamped_chunks_deduped():
    # Chunks >= the input length all clamp to "whole input, one scan
    # step": only the first is distinct, later ones are duplicates.
    from upmix.tune import tune_offline

    report = tune_offline(
        sr=8000.0, band_edges=(0.0, 400.0, 1600.0), max_block_size=512,
        n_samples=4096, chunks=(2048, 4096, 8192), kernel="mm", inner=1,
        visits=1, verbose=False,
    )
    ok = [r for r in report["results"] if r["ok"]]
    dup = [r for r in report["results"]
           if r.get("error") and "duplicate" in r["error"]]
    assert len(ok) == 2  # 2048 (2-step scan) + 4096 (clamped whole)
    assert len(dup) == 1 and dup[0]["chunk"] == 8192
