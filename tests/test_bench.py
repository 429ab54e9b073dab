"""bench.py driver contract: ONE JSON line with the required keys plus
the numerics gate (worst-slice probe SNR vs the float64 oracle — the
benched program must not ship a fast wrong number).  Runs bench.py as a
CPU-backend subprocess at a tiny geometry so the suite stays fast; the
GPU run uses the same code path at the production geometry.
"""

import json
import os
import subprocess
import sys

from helpers import cpu_child_env

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_bench(extra_env):
    env = cpu_child_env()
    env.update(
        BENCH_SR="8000",
        BENCH_EDGES="0,400,1600",
        BENCH_MAX_BLOCK="512",
        BENCH_SAMPLES="8192",
        BENCH_ITERS="1",
        BENCH_INNER="2",
        BENCH_WARMUP="1",
        BENCH_LOOPS="2",
    )
    env.update(extra_env)
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "bench.py")],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=600,
    )
    line = proc.stdout.strip().splitlines()[-1]
    return proc, json.loads(line)


def test_bench_json_contract_and_snr_gate():
    proc, rec = _run_bench({})
    assert proc.returncode == 0, proc.stderr
    # Driver-required keys.
    assert rec["metric"] == "offline_upmix_realtime_factor"
    assert rec["unit"] == "audio_sec/sec/chip"
    assert rec["value"] > 0
    assert rec["vs_baseline"] == rec["value"] / 1000.0 or rec["vs_baseline"] > 0
    # Numerics gate: probes vs the float64 oracle, on by default.
    assert rec["snr_ok"] is True
    assert rec["snr_db"] > 60.0
    # Where the number was taken, and at which matmul precision.
    assert rec["platform"] == "cpu" and rec["device_kind"] == "cpu"
    assert rec["device_count"] >= 1 and "gpu" not in rec
    assert rec["matmul_precision"] == "HIGHEST"


def test_bench_snr_opt_out():
    proc, rec = _run_bench({"BENCH_SNR": "0"})
    assert proc.returncode == 0, proc.stderr
    assert "snr_db" not in rec and "snr_ok" not in rec
