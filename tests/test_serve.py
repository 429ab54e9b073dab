"""Job-server mode (--serve): line-delimited JSON jobs over stdin/stdout,
warm compile cache across jobs, per-job failure isolation."""

import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from upmix.app import run_jobs
from upmix.io import read_wav, write_wav

from helpers import cpu_child_env, make_stereo

SR = 8000


def _wav(path, n=4096, seed=0):
    L, R = make_stereo(n, SR, seed=seed)
    write_wav(path, np.stack([L, R], 1).astype(np.float32), SR)
    return str(path)


def test_run_jobs_end_to_end(tmp_path):
    a = _wav(tmp_path / "a.wav", seed=1)
    b = _wav(tmp_path / "b.wav", seed=2)
    out1, out2 = str(tmp_path / "o1"), str(tmp_path / "o2")
    jobs = "\n".join(
        [
            json.dumps({"cmd": "ping"}),
            json.dumps({"cmd": "stats"}),
            json.dumps({"in": a, "out_dir": out1}),
            json.dumps({"in": str(tmp_path / "missing.wav")}),  # fails, isolated
            json.dumps({"in": b, "out_dir": out2, "export_mode": "split"}),
            json.dumps({"in": a, "bogus_field": 1}),  # rejected, isolated
            "",  # blank lines ignored
            "not json",  # parse error, isolated
        ]
    )
    dst = io.StringIO()
    n_ok, n_fail = run_jobs(
        io.StringIO(jobs),
        dst,
        out_dir=str(tmp_path / "default_out"),
        band_edges=[0.0, 400.0, 1600.0],
        max_block_size=512,
    )
    assert n_ok == 2 and n_fail == 3
    resps = [json.loads(line) for line in dst.getvalue().splitlines()]
    assert resps[0] == {"ok": True, "pong": True}
    assert resps[1]["ok"] and resps[1]["configs_cached"] == 0
    assert resps[2]["ok"] and resps[2]["in"] == a
    assert not resps[3]["ok"] and "missing" in resps[3]["error"]
    assert resps[4]["ok"] and len(resps[4]["outputs"]) == 3  # split mode
    assert not resps[5]["ok"] and "bogus_field" in resps[5]["error"]
    assert not resps[6]["ok"]
    assert len(resps) == 7
    # The outputs really exist and decode.
    for p in resps[2]["outputs"] + resps[4]["outputs"]:
        y, sr = read_wav(p, always_2d=True)
        assert sr == SR and len(y) > 0
    assert resps[2]["audio_seconds"] == pytest.approx(4096 / SR, abs=1e-3)


def test_run_jobs_cache_bounded_under_failing_jobs(tmp_path):
    # run_offline inserts the Upmixer into the warm cache BEFORE
    # processing; a stream of jobs that all fail (after insertion) at
    # distinct sample rates must still leave the cache within its
    # documented 8-config bound (the eviction runs in a finally block).
    import numpy as np

    from upmix.io import write_wav

    jobs = []
    for i, sr in enumerate([8000, 11025, 16000, 22050, 24000, 32000,
                            44100, 48000, 88200, 96000]):
        p = tmp_path / f"in_{i}.wav"
        write_wav(str(p), np.zeros((512, 2), np.float32), sr)
        # out_dir is an existing FILE -> export fails after the Upmixer
        # (and its config cache entry) was created.
        blocker = tmp_path / f"blocker_{i}"
        blocker.write_text("not a directory")
        jobs.append(json.dumps({"in": str(p), "out_dir": str(blocker)}))

    # Wrap run_jobs to observe its internal cache via the stats command.
    jobs.append(json.dumps({"cmd": "stats"}))
    dst = io.StringIO()
    n_ok, n_fail = run_jobs(
        io.StringIO("\n".join(jobs)),
        dst,
        band_edges=[0.0, 1000.0],
        max_block_size=256,
    )
    resps = [json.loads(line) for line in dst.getvalue().splitlines()]
    stats = resps[-1]
    assert n_ok == 0 and n_fail == 10
    assert stats["ok"] and stats["configs_cached"] <= 8, stats


def test_serve_cli_roundtrip(tmp_path):
    # Keep the subprocess's program TINY (one band, 2048 samples, pad
    # bucketing overridden): the test drives the stdin/stdout protocol,
    # and a fresh CPU subprocess pays jax import + an uncached compile —
    # on a loaded single-core box that dominated the old timeout.
    a = _wav(tmp_path / "in.wav", n=2048, seed=3)
    out = str(tmp_path / "srv_out")
    jobs = (
        json.dumps({"cmd": "ping"})
        + "\n"
        + json.dumps({"in": a, "out_dir": out})
        + "\n"
    )
    env = cpu_child_env()
    proc = subprocess.run(
        [
            sys.executable, "-m", "upmix.cli", "-", "--serve",
            "--band-edges", "0,400", "--max-block-size", "256",
            "--pad-granularity", "2048",
        ],
        input=jobs,
        capture_output=True,
        text=True,
        timeout=900,
        env=env,
        cwd=os.path.join(os.path.dirname(__file__), ".."),
    )
    assert proc.returncode == 0, proc.stderr[-1200:]
    lines = [json.loads(x) for x in proc.stdout.splitlines() if x.strip()]
    assert lines[0]["pong"] is True
    assert lines[1]["ok"] and os.path.exists(lines[1]["outputs"][0])


def test_serve_exit_code_all_failed(tmp_path):
    # A stream whose every job failed exits 1 so supervisors can tell;
    # a healthy or empty stream exits 0 (the other tests cover that).
    env = cpu_child_env()
    proc = subprocess.run(
        [sys.executable, "-m", "upmix.cli", "-", "--serve"],
        input='{"in": "/nonexistent/x.wav"}\n',
        capture_output=True,
        text=True,
        timeout=120,
        env=env,
        cwd=os.path.join(os.path.dirname(__file__), ".."),
    )
    assert proc.returncode == 1
    assert not json.loads(proc.stdout.splitlines()[0])["ok"]


def test_serve_requires_dash_input(tmp_path):
    a = _wav(tmp_path / "x.wav")
    env = cpu_child_env()
    proc = subprocess.run(
        [sys.executable, "-m", "upmix.cli", a, "--serve"],
        capture_output=True,
        text=True,
        timeout=120,
        env=env,
        cwd=os.path.join(os.path.dirname(__file__), ".."),
    )
    assert proc.returncode != 0
    assert "stdin" in proc.stderr


def test_run_jobs_stats_latency_histogram(tmp_path):
    # {"cmd": "stats"} after completed jobs must report their wall-time
    # distribution (count matches n_ok; failures are not recorded).
    a = _wav(tmp_path / "h.wav", seed=3)
    jobs = "\n".join(
        [
            json.dumps({"in": a, "out_dir": str(tmp_path / "o")}),
            json.dumps({"in": str(tmp_path / "nope.wav")}),  # fails
            json.dumps({"in": a, "out_dir": str(tmp_path / "o")}),
            json.dumps({"cmd": "stats"}),
        ]
    )
    dst = io.StringIO()
    n_ok, n_fail = run_jobs(
        io.StringIO(jobs), dst,
        band_edges=[0.0, 400.0, 1600.0], max_block_size=512,
    )
    assert n_ok == 2 and n_fail == 1
    stats = json.loads(dst.getvalue().splitlines()[-1])
    hs = stats["job_seconds"]
    assert hs["count"] == 2
    assert hs["sum"] > 0 and hs["max"] > 0
    assert hs["p50"] <= hs["p95"] <= hs["p99"]
