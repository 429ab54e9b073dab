"""Multi-process (multi-host) bring-up verification.

``parallel/distributed.py`` wraps the JAX distributed runtime; this module
is the proof harness that the wrapper — and the framework's two multi-host
conventions — actually work on a live cluster.  Run ONE copy per process:

    python -m upmix.parallel.pod_check \
        --coordinator HOST:PORT --num-processes N --process-id I \
        [--files a.wav b.wav ...] [--report out.json]

Each process performs, in order:

1. ``init_distributed()`` — brings up the runtime; after it,
   ``jax.devices()`` is the cluster-global device list.
2. A cross-process COLLECTIVE sanity check: a ``psum`` over a global
   1-D mesh spanning every device must reproduce the global sum (on CPU
   clusters this rides the gloo TCP collectives; on GPUs, NCCL).
3. The GLOBAL-MESH sharded offline pipeline
   (``build_sharded_offline_fn`` over all devices on the ``seq`` axis):
   the halo ``ppermute``s cross the process boundary, and every
   process verifies ITS OWN addressable output shards against the
   float64 NumPy oracle (>60 dB) — no process ever materializes the
   global output.
4. The MULTI-HOST OFFLINE convention: ``local_file_shard`` splits a
   shared file list; this process runs the single-device pipeline over
   its shard and gates each result against the oracle (>60 dB).

The reference's only parallel join is a per-band ThreadPoolExecutor
(center_extraction.py:499-511); multi-host meshes are this framework's
replacement for "more cores", so the proof is held to the same oracle
contract as every other engine (SURVEY.md §2.3/§5 distributed rows).

Exits 0 and prints ``POD_CHECK_OK`` only if every step passes; the
optional ``--report`` JSON carries the measured numbers for CI.
"""

from __future__ import annotations

import argparse
import json
import math
import sys


def _test_stereo(n: int, sr: float, seed: int = 0):
    """Deterministic band-rich stereo pair, identical on every process
    (a shared center component plus decorrelated sides)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    center = 0.4 * np.sin(2 * np.pi * 220.0 * t) + 0.1 * rng.standard_normal(n)
    L = center + 0.3 * np.sin(2 * np.pi * 555.0 * t + 0.3) + 0.1 * rng.standard_normal(n)
    R = center + 0.3 * np.sin(2 * np.pi * 812.0 * t + 1.1) + 0.1 * rng.standard_normal(n)
    return L.astype(np.float32), R.astype(np.float32)


def _snr_db(ref, test) -> float:
    import numpy as np

    ref = np.asarray(ref, np.float64)
    err = np.sum((ref - np.asarray(test, np.float64)) ** 2)
    sig = np.sum(ref**2)
    if err == 0.0:
        return math.inf
    return 10.0 * math.log10(sig / max(err, 1e-300))


def run_pod_check(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    files: list[str] | None = None,
    edges: tuple[float, ...] = (0.0, 400.0, 1600.0),
    sr: float = 8000.0,
    max_block_size: int = 512,
    seq_samples: int = 6000,
    snr_floor_db: float = 60.0,
) -> dict:
    """Run the four-step multi-process verification (see module docstring).

    Returns the report dict; raises AssertionError on any failed gate so
    launchers see a non-zero exit.  Must be called before any other JAX
    API touches a device (jax.distributed requirement).
    """
    import jax

    # CPU clusters need a cross-process collective implementation; gloo
    # (TCP) is bundled with jaxlib.  Must be configured BEFORE backend
    # initialization, so key off the requested platform setting rather
    # than jax.default_backend() (which would initialize it).
    platforms = jax.config.jax_platforms or ""
    if "cpu" in platforms:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")

    from upmix.parallel.distributed import init_distributed, local_file_shard

    info = init_distributed(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    report: dict = {"topology": info}
    if num_processes is not None:
        assert info["process_count"] == num_processes, info
    assert info["global_devices"] >= info["local_devices"] >= 1, info

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from upmix.config import UpmixConfig
    from upmix.oracle import oracle_multiband
    from upmix.parallel.sharded import (
        build_sharded_offline_fn,
        make_mesh,
        sequence_plan,
    )

    n_glob = info["global_devices"]
    mesh = make_mesh({"seq": n_glob})

    # -- 2. cross-process collective sanity -----------------------------
    base = np.arange(n_glob * 8, dtype=np.float32).reshape(n_glob, 8)
    gx = jax.device_put(base, NamedSharding(mesh, P("seq", None)))

    def _global_sum(x_loc):
        return jax.lax.psum(jnp.sum(x_loc), "seq")[None]

    got = jax.jit(
        jax.shard_map(
            _global_sum, mesh=mesh, in_specs=P("seq", None), out_specs=P("seq")
        )
    )(gx)
    local_sum = float(np.asarray(got.addressable_shards[0].data)[0])
    want_sum = float(base.sum())
    report["collective"] = {"got": local_sum, "want": want_sum}
    assert abs(local_sum - want_sum) <= 1e-3 * abs(want_sum), report["collective"]

    # -- 3. global-mesh sequence-sharded pipeline ------------------------
    cfg = UpmixConfig.make(list(edges), sr=sr, max_block_size=max_block_size)
    plan = sequence_plan(cfg, seq_samples, n_glob)
    n = plan.n_padded  # full-length signal: every shard carries signal
    L, R = _test_stereo(n, sr, seed=11)
    ref = np.stack(oracle_multiband(L, R, cfg))  # [3, n] float64-accurate

    fn, _ = build_sharded_offline_fn(cfg, n, mesh, data_axis=None, kernel="xla")
    x = jax.device_put(
        np.stack([L, R])[None], NamedSharding(mesh, P(None, None, "seq"))
    )
    y = fn(x)  # [1, 3, n] sharded over seq — NOT fully addressable
    shard_snrs = []
    for s in y.addressable_shards:
        sl = s.index[-1]
        got_loc = np.asarray(s.data)[0]  # [3, chunk]
        shard_snrs.append(
            {
                "start": int(sl.start or 0),
                "stop": int(sl.stop if sl.stop is not None else n),
                "snr_db": _snr_db(ref[:, sl], got_loc),
            }
        )
    report["seq_sharded"] = {
        "chunk": plan.chunk,
        "halo": plan.halo,
        "n_padded": plan.n_padded,
        "shards": shard_snrs,
    }
    assert shard_snrs, "no addressable output shards on this process"
    for s in shard_snrs:
        assert s["snr_db"] > snr_floor_db, report["seq_sharded"]

    # -- 4. multi-host offline convention: per-process file shards -------
    jobs = []
    if files:
        from upmix.io.wav import read_wav
        from upmix.models.offline import upmix_offline

        for path in local_file_shard(files):
            data, fsr = read_wav(path, always_2d=True)
            Lf = np.asarray(data[:, 0], np.float32)
            Rf = np.asarray(data[:, min(1, data.shape[1] - 1)], np.float32)
            fcfg = UpmixConfig.make(
                list(edges), sr=float(fsr), max_block_size=max_block_size
            )
            fref = oracle_multiband(Lf, Rf, fcfg)
            got3 = upmix_offline(Lf, Rf, fcfg, kernel="xla")
            snrs = [_snr_db(r, np.asarray(g)) for r, g in zip(fref, got3)]
            jobs.append({"path": path, "snr_db": snrs})
            for s in snrs:
                assert s > snr_floor_db, jobs[-1]
    report["file_jobs"] = jobs
    report["ok"] = True
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m upmix.parallel.pod_check",
        description="Verify multi-process bring-up: distributed init, "
        "cross-process collectives, the global-mesh sharded pipeline, and "
        "per-process file sharding — all gated vs the NumPy oracle.",
    )
    ap.add_argument("--coordinator", default=None, help="HOST:PORT of process 0")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--files", nargs="*", default=None,
                    help="shared WAV list; THIS process takes paths[i::n]")
    ap.add_argument("--report", default=None, help="write the JSON report here")
    ap.add_argument("--sr", type=float, default=8000.0)
    ap.add_argument("--edges", type=float, nargs="+", default=[0.0, 400.0, 1600.0])
    ap.add_argument("--max-block", type=int, default=512)
    ap.add_argument("--seq-samples", type=int, default=6000)
    args = ap.parse_args(argv)

    try:
        report = run_pod_check(
            coordinator=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
            files=args.files,
            edges=tuple(args.edges),
            sr=args.sr,
            max_block_size=args.max_block,
            seq_samples=args.seq_samples,
        )
    except Exception as e:  # report the failure, exit non-zero
        report = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        if args.report:
            with open(args.report, "w") as f:
                json.dump(report, f, indent=2)
        print(f"POD_CHECK_FAIL {report['error']}", file=sys.stderr)
        return 1

    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=2)
    t = report["topology"]
    print(
        f"POD_CHECK_OK process {t['process_index']}/{t['process_count']} "
        f"devices local={t['local_devices']} global={t['global_devices']} "
        f"shards={len(report['seq_sharded']['shards'])} "
        f"files={len(report['file_jobs'])}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
