"""Multi-PROCESS distributed runtime tests.

Everything else in the suite runs single-process over 8 virtual devices;
these tests spawn REAL OS processes that bring up `jax.distributed`
(coordinator on localhost, gloo TCP collectives on the CPU backend) and
run the pod verification harness (`upmix.parallel.pod_check`):
cross-process psum, the global-mesh sequence-sharded pipeline with halo
ppermutes crossing the process boundary, and `local_file_shard` offline
jobs — every output gated >60 dB vs the float64 oracle.

The reference's only parallel join is a per-band ThreadPoolExecutor
(center_extraction.py:499-511); multi-host clusters are this framework's
replacement for "more cores", held to the same oracle contract.
"""

import json
import re
import socket
import subprocess
import sys

import numpy as np

from helpers import cpu_child_env, make_stereo


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child_env(n_local_devices: int) -> dict:
    """CPU-only child env with its OWN virtual device count (the parent's
    XLA_FLAGS pins 8; each process gets n_local_devices instead)."""
    env = cpu_child_env()
    flags = env.get("XLA_FLAGS", "")
    flags = re.sub(r"--xla_force_host_platform_device_count=\d+", "", flags)
    env["XLA_FLAGS"] = (
        flags + f" --xla_force_host_platform_device_count={n_local_devices}"
    ).strip()
    return env


def test_pod_check_two_processes(tmp_path):
    # 2 processes x 4 local devices -> one 8-device GLOBAL mesh.  This is
    # the real jax.distributed bring-up (coordinator handshake, gloo
    # collectives, non-fully-addressable global arrays), not a simulation.
    from upmix.io.wav import write_wav

    n_proc, n_local = 2, 4
    files = []
    for i in range(3):  # 3 files over 2 processes: uneven round-robin
        L, R = make_stereo(4000, 8000.0, seed=20 + i)
        path = tmp_path / f"in{i}.wav"
        write_wav(path, np.column_stack([L, R]).astype(np.float32), 8000)
        files.append(str(path))

    port = _free_port()
    env = _child_env(n_local)
    procs, reports = [], []
    for pid in range(n_proc):
        report = tmp_path / f"pod{pid}.json"
        reports.append(report)
        procs.append(
            subprocess.Popen(
                [
                    sys.executable, "-m", "upmix.parallel.pod_check",
                    "--coordinator", f"127.0.0.1:{port}",
                    "--num-processes", str(n_proc),
                    "--process-id", str(pid),
                    "--files", *files,
                    "--report", str(report),
                ],
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                text=True,
                env=env,
            )
        )
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=420))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"rc={p.returncode}\n{out}\n{err}"
        assert "POD_CHECK_OK" in out, out + err

    loaded = [json.loads(r.read_text()) for r in reports]
    paths_seen = []
    for pid, rep in enumerate(loaded):
        assert rep["ok"] is True
        topo = rep["topology"]
        assert topo["process_index"] == pid
        assert topo["process_count"] == n_proc
        assert topo["local_devices"] == n_local
        assert topo["global_devices"] == n_proc * n_local
        # Cross-process collective produced the true global sum.
        assert abs(rep["collective"]["got"] - rep["collective"]["want"]) < 1e-3
        # Each process verified exactly its own 4 output shards of the
        # 8-way global seq-sharded run, all >60 dB vs the oracle.
        shards = rep["seq_sharded"]["shards"]
        assert len(shards) == n_local
        for s in shards:
            assert s["snr_db"] > 60.0, rep["seq_sharded"]
        # Shard sample ranges are the process's contiguous half.
        chunk = rep["seq_sharded"]["chunk"]
        starts = sorted(s["start"] for s in shards)
        assert starts == [
            (pid * n_local + k) * chunk for k in range(n_local)
        ]
        # File jobs: round-robin shard, each gated vs the oracle.
        want_files = files[pid::n_proc]
        assert [j["path"] for j in rep["file_jobs"]] == want_files
        for j in rep["file_jobs"]:
            assert min(j["snr_db"]) > 60.0, j
            paths_seen.append(j["path"])
    # The two processes together covered every file exactly once.
    assert sorted(paths_seen) == sorted(files)
