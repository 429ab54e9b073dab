"""Command-line interface.

The reference's config surface is edit-the-source constants
(main.py:29-30,62-73; bela/upmix.cpp:24-29,525).  This CLI exposes the same
knobs as real flags, with defaults exactly replicating main.py, plus batch
multi-file processing that reuses compiled programs across files.

Usage:
  python -m upmix.cli song.wav [more.wav ...] --export-mode stereo_sum
"""

from __future__ import annotations

import argparse
import sys

from upmix.app import EXPORT_MODES, run_offline
from upmix.utils.logging import get_logger

log = get_logger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="upmix",
        description="multi-band stereo→LCR upmixer (JAX)",
    )
    try:
        from importlib.metadata import version as _pkg_version

        _version = _pkg_version("upmix")
    except Exception:
        # Uninstalled tree: read the single source of truth instead of a
        # hardcoded string that would drift from pyproject.toml.
        from upmix import __version__ as _pkg_fallback

        _version = f"{_pkg_fallback} (uninstalled tree)"
    p.add_argument("--version", action="version", version=f"upmix {_version}")
    p.add_argument("inputs", nargs="+", help="input WAV file(s)")
    p.add_argument("--out-dir", default="out", help="output directory (default: out)")
    p.add_argument(
        "--export-mode",
        default="stereo_sum",
        choices=EXPORT_MODES,
        help="AB (upmix-vs-original), split (3 stereo files), stereo_sum "
        "(Ls+C/2 | Rs+C/2); default stereo_sum as in the reference main.py. "
        "With --streaming: stereo_sum or split",
    )
    p.add_argument(
        "--band-edges",
        default="0,30,120,480,1920,7680",
        help="comma-separated crossover edges in Hz (reference default)",
    )
    p.add_argument("--overlap", type=float, default=0.75, help="STFT overlap (default 0.75)")
    p.add_argument(
        "--window",
        default="blackman_harris",
        help="analysis window: blackman_harris, sqrt_hann, hann, "
        "blackman, hamming, rect, or a name registered via "
        "upmix.ops.windows.register_window (default blackman_harris)",
    )
    p.add_argument(
        "--window-file",
        default=None,
        metavar="FILE",
        help="load a custom analysis-window VECTOR (.npy, or whitespace-"
        "separated text) and use it instead of --window; it is linearly "
        "resampled to each band's block size (reference parity: "
        "main.py:65 accepts any window_func callable)",
    )
    p.add_argument(
        "--xover-mode",
        default="raised_cosine",
        choices=["raised_cosine", "hard_zero"],
        help="band-edge treatment (default raised_cosine)",
    )
    p.add_argument(
        "--max-block-size",
        type=int,
        default=2**16,
        help="cap on per-band STFT size (default 65536)",
    )
    p.add_argument(
        "--threshold-factor",
        type=float,
        default=32.0,
        help="dynamic-resolution threshold multiplier (default 32)",
    )
    p.add_argument(
        "--synthesis",
        default=None,
        choices=["wola", "analysis"],
        help="synthesis window: WOLA-designed (Python parity) or plain "
        "analysis window (C++ parity); default wola offline, analysis "
        "streaming (matching each reference implementation)",
    )
    p.add_argument(
        "--bin-rounding",
        default=None,
        choices=["python", "cpp"],
        help="freq->bin rounding semantics; default python offline, cpp "
        "streaming (matching each reference implementation)",
    )
    p.add_argument(
        "--subtype",
        default="FLOAT",
        choices=["FLOAT", "DOUBLE", "PCM_16", "PCM_24", "PCM_32"],
        help="output WAV sample format (default 32-bit float)",
    )
    p.add_argument(
        "--kernel",
        default="auto",
        choices=["auto", "mm", "xla"],
        help="transform kernel: mm (matmul transforms, GPU default) or "
        "xla (jnp.fft, CPU default)",
    )
    p.add_argument(
        "--chunk",
        type=int,
        default=None,
        help="offline scan chunk size in samples (default 2097152; 0 = one "
        "whole-file program).  Applies to the 'mm' scan "
        "kernel (the GPU default) — --kernel xla and "
        "non-power-of-two band geometries run whole-file regardless.  "
        "Derive for new hardware with `python -m upmix.tune "
        "--offline`",
    )
    p.add_argument(
        "--mesh",
        default=None,
        metavar="SPEC",
        help="run the offline pipeline mesh-sharded over the available "
        "devices: 'seq=N' splits the sample axis across N chips with "
        "halo exchange (long files); 'data=D,seq=N' adds file-batch "
        "data parallelism — with multiple input files the whole batch "
        "rides the data axis in one sharded call per sample rate.  The "
        "axis product must not exceed len(jax.devices()).  Offline "
        "mode only",
    )
    p.add_argument(
        "--pad-granularity",
        type=int,
        default=None,
        help="round input lengths up to a multiple of this to share compiled "
        "programs across a batch of files (default 1 = exact lengths; "
        "--serve defaults to 65536 so jobs of similar length run warm)",
    )
    p.add_argument(
        "--streaming",
        action="store_true",
        help="run the block-based streaming engine instead of the offline "
        "pipeline (stereo_sum or split output, C++-reference defaults)",
    )
    p.add_argument(
        "--hw-block",
        type=int,
        default=2048,
        help="streaming hardware block size in samples (default 2048, the "
        "reference Bela config)",
    )
    p.add_argument(
        "--engine",
        default="jax",
        choices=["jax", "native"],
        help="streaming engine: jax (scan-based, on the JAX device) or "
        "native (C++ host shell; requires `make -C native`)",
    )
    p.add_argument(
        "--serve",
        action="store_true",
        help="job-server mode: one JSON job per stdin line "
        '({"in": path, "out_dir"?, "export_mode"?} or {"cmd": "ping"}), '
        "one JSON result per stdout line; the process stays warm so "
        "compiled programs are reused across jobs (input must be '-')",
    )
    p.add_argument(
        "--serve-stream",
        type=int,
        default=None,
        metavar="PORT",
        help="multi-client live-stream server: each TCP connection claims "
        "one slot of a shared serving pool, ONE pool dispatch per hardware "
        "block serves every live session (requires --sr; port 0 picks an "
        "ephemeral port; input must be '-')",
    )
    p.add_argument(
        "--streams",
        type=int,
        default=16,
        help="stream-server pool size (concurrent sessions; default 16)",
    )
    p.add_argument(
        "--serve-host",
        default="127.0.0.1",
        help="stream-server bind address (default 127.0.0.1)",
    )
    p.add_argument(
        "--lockstep",
        action="store_true",
        help="stream-server dispatches when every live session has a block "
        "queued (deterministic, for file-fed clients) instead of on the "
        "wall clock",
    )
    p.add_argument(
        "--serve-pipeline",
        type=int,
        default=1,
        choices=(1, 2),
        metavar="D",
        help="stream-server dispatch pipelining: 2 keeps one pool cycle "
        "in flight, fetching+delivering cycle N-1's outputs while the "
        "device computes cycle N — hides the device round-trip at one "
        "cycle of added output latency",
    )
    p.add_argument(
        "--snapshot-path",
        default=None,
        metavar="PATH",
        help="stream-server session checkpoint file: restored on start "
        "(existing sessions park until their clients reconnect with "
        "their v2 resume tokens) and written on shutdown",
    )
    p.add_argument(
        "--snapshot-every",
        type=float,
        default=None,
        metavar="SECS",
        help="with --snapshot-path: ALSO checkpoint live sessions "
        "periodically every SECS seconds (non-destructive, "
        "point-in-time consistent; the capture pauses dispatch while "
        "the pool state copies to host)",
    )
    p.add_argument(
        "--resume-ttl",
        type=float,
        default=None,
        metavar="SECS",
        help="stream-server parked-session time-to-live: a restored "
        "session whose client has not resumed within SECS seconds may "
        "have its slot reclaimed when the pool is otherwise full "
        "(late resumes then get the unknown-token status).  Default: "
        "hold parked sessions forever",
    )
    p.add_argument(
        "--metrics-http",
        type=int,
        default=None,
        metavar="PORT",
        help="with --serve-stream: serve observability metrics over "
        "HTTP on PORT (GET /metrics = Prometheus text exposition, "
        "/metrics.json = the full snapshot; 0 picks an ephemeral "
        "port).  The same snapshot is always queryable on the stream "
        "port itself via upmix.serve_stream.fetch_metrics",
    )
    p.add_argument(
        "--pool-mesh",
        default=None,
        metavar="SPEC",
        help="with --serve-stream: shard the serving pool across devices "
        "— 'data=D' splits the session slots over D devices (zero "
        "collectives per block; --streams must be a multiple of D)",
    )
    p.add_argument(
        "--save-aot",
        default=None,
        metavar="PATH",
        help="build an AOT deployment artifact (jax.export StableHLO) for "
        "the active config and exit: the offline pipeline frozen at "
        "--aot-samples, or the streaming step with --aot-stream (requires "
        "--sr; input must be '-'; load with upmix.aot.load)",
    )
    p.add_argument(
        "--aot-samples",
        type=int,
        default=2**21,
        help="input length the offline AOT artifact is frozen at "
        "(default 2097152 ≈ 47.6 s at 44.1 kHz; shorter inputs zero-pad)",
    )
    p.add_argument(
        "--aot-stream",
        action="store_true",
        help="with --save-aot: export the real-time streaming step "
        "(C++-parity defaults, --hw-block sized) instead of the offline "
        "pipeline",
    )
    p.add_argument(
        "--aot-platforms",
        default=None,
        help="comma-separated lowering platforms for --save-aot (e.g. "
        "'cuda' or 'cuda,cpu'; default: the current backend)",
    )
    p.add_argument(
        "--pipe",
        action="store_true",
        help="raw-PCM filter mode: interleaved float32 stereo on stdin -> "
        "processed float32 on stdout (streaming engine; requires --sr; "
        "input argument must be '-'). stereo_sum emits 2 channels, "
        "--pipe-mix lcr emits C/Ls/Rs as 3 interleaved channels",
    )
    p.add_argument(
        "--sr",
        type=float,
        default=None,
        help="sample rate of the raw stdin stream (required with --pipe)",
    )
    p.add_argument(
        "--pipe-mix",
        default="stereo_sum",
        choices=["stereo_sum", "lcr"],
        help="pipe output layout (default stereo_sum)",
    )
    p.add_argument(
        "--pipe-raw",
        action="store_true",
        help="emit the raw real-time stream (output delayed by the engine "
        "warmup, tail not drained) instead of the default latency-aligned "
        "file-filter semantics",
    )
    p.add_argument(
        "--connect",
        default=None,
        metavar="HOST:PORT",
        help="network-client mode: stream the input WAV file(s) through a "
        "running `--serve-stream` server instead of processing locally "
        "(no JAX work in this process); --pipe-mix picks the "
        "returned layout, outputs land in --out-dir.  The file's sample "
        "rate must match the server's",
    )
    p.add_argument(
        "--fetch-metrics",
        default=None,
        metavar="HOST:PORT",
        help="print a running `--serve-stream` server's metrics snapshot "
        "and exit (no JAX work; JSON by default, Prometheus text "
        "with --prometheus)",
    )
    p.add_argument(
        "--prometheus",
        action="store_true",
        help="with --fetch-metrics: print the Prometheus text exposition "
        "instead of JSON",
    )
    p.add_argument(
        "--meter",
        action="store_true",
        help="print the realtime factor (audio-sec per wall-sec) after each file",
    )
    p.add_argument(
        "--no-compile-cache",
        action="store_true",
        help="disable the persistent JAX compilation cache (enabled by "
        "default: $JAX_COMPILATION_CACHE_DIR if set, else .jax_cache in "
        "the source checkout)",
    )
    p.add_argument("--verbose", action="store_true", help="print per-band config table")
    return p


def parse_edges(text: str):
    try:
        edges = [float(x) for x in text.split(",") if x.strip() != ""]
    except ValueError:
        raise SystemExit(f"error: --band-edges must be comma-separated numbers, got {text!r}")
    if not edges:
        raise SystemExit("error: --band-edges is empty")
    if any(b <= a for a, b in zip(edges, edges[1:])):
        raise SystemExit("error: --band-edges must be ascending")
    if edges[0] < 0:
        raise SystemExit("error: --band-edges must be non-negative")
    return edges


def parse_mesh_spec(text: str):
    """Parse 'axis=N[,axis=N...]' into an ordered axis dict."""
    axes = {}
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        name, eq, num = part.partition("=")
        name = name.strip()
        try:
            n = int(num)
        except ValueError:
            n = 0
        if not eq or not name or n < 1:
            raise SystemExit(
                f"error: mesh spec must be 'axis=N[,axis=N]' with N >= 1, "
                f"got {text!r}"
            )
        if name in axes:
            raise SystemExit(f"error: duplicate mesh axis {name!r} in {text!r}")
        axes[name] = n
    if not axes:
        raise SystemExit("error: empty mesh spec")
    return axes


def build_mesh(text: str, allowed=("data", "seq"), flag="--mesh"):
    """Build a jax Mesh from a CLI spec, with CLI-friendly errors."""
    axes = parse_mesh_spec(text)
    bad = [a for a in axes if a not in allowed]
    if bad:
        raise SystemExit(
            f"error: {flag} axis must be one of {'/'.join(allowed)}, "
            f"got {bad[0]!r}"
        )
    from upmix.parallel import make_mesh

    try:
        return make_mesh(axes)
    except ValueError as e:
        raise SystemExit(f"error: {flag} {text!r}: {e}")


def load_window_file(path: str) -> str:
    """Load a window vector from FILE (.npy or text) and register it
    under a content-derived name; returns the name.  Content-derived so
    two runs with the same file hit the same jit cache entry and a
    changed file cannot silently reuse a stale compiled program."""
    import hashlib

    import numpy as np

    from upmix.ops.windows import is_known_window, register_window_vector

    if path.endswith(".npy"):
        vec = np.load(path)
    else:
        vec = np.loadtxt(path, dtype=np.float64)
    vec = np.asarray(vec, np.float32).ravel()
    name = f"file:{hashlib.sha1(vec.tobytes()).hexdigest()[:10]}"
    if not is_known_window(name):
        register_window_vector(name, vec)
    return name


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.window_file is not None:
        args.window = load_window_file(args.window_file)
    else:
        # --window lost its argparse choices= when custom registrations
        # were allowed; validate upfront (after --window-file had its
        # chance to register) so a typo is a clean exit, not a
        # ValueError traceback out of BandSpec.__post_init__.
        from upmix.ops.windows import is_known_window, window_names

        if not is_known_window(args.window):
            raise SystemExit(
                f"error: unknown --window {args.window!r}; one of "
                f"{', '.join(sorted(window_names()))} (or register one "
                "via --window-file / upmix.ops.windows.register_window)"
            )
    edges = parse_edges(args.band_edges)
    if args.mesh is not None and (
        args.pipe or args.streaming or args.serve
        or args.serve_stream is not None or args.save_aot is not None
        or args.connect is not None
    ):
        raise SystemExit(
            "error: --mesh applies to the offline pipeline only "
            "(use --pool-mesh with --serve-stream)"
        )
    if args.pool_mesh is not None and args.serve_stream is None:
        raise SystemExit("error: --pool-mesh requires --serve-stream")
    if args.chunk is not None and args.chunk < 0:
        raise SystemExit("error: --chunk must be >= 0 (0 = whole-file)")
    if args.chunk is not None and args.mesh is not None:
        raise SystemExit(
            "error: --chunk does not apply to --mesh runs (the sharded "
            "pipeline manages its own chunking)"
        )
    if args.pad_granularity is not None and args.pad_granularity < 1:
        raise SystemExit("error: --pad-granularity must be >= 1")

    if not args.no_compile_cache:
        from upmix.utils.cache import enable_compilation_cache

        enable_compilation_cache()

    import time

    if args.fetch_metrics is not None:
        host, _, port_s = args.fetch_metrics.rpartition(":")
        try:
            port = int(port_s)
        except ValueError:
            port = -1
        if not host or not 0 < port < 65536:
            raise SystemExit(
                "error: --fetch-metrics expects HOST:PORT, got "
                f"{args.fetch_metrics!r}"
            )
        import json as _json

        from upmix.serve_stream import fetch_metrics

        try:
            if args.prometheus:
                print(fetch_metrics(host, port, fmt="prometheus"), end="")
            else:
                print(_json.dumps(fetch_metrics(host, port)))
        except (OSError, ConnectionError) as exc:
            raise SystemExit(f"error: {host}:{port}: {exc}")
        return 0
    if args.prometheus:
        raise SystemExit("error: --prometheus requires --fetch-metrics")
    if args.connect is not None:
        # Network-client mode: no local JAX work — the files stream
        # through a remote --serve-stream server block by block.
        if (
            args.pipe or args.streaming or args.serve
            or args.serve_stream is not None or args.save_aot is not None
        ):
            raise SystemExit(
                "error: --connect is exclusive with --serve/--serve-stream/"
                "--pipe/--streaming/--save-aot"
            )
        host, _, port_s = args.connect.rpartition(":")
        try:
            port = int(port_s)
        except ValueError:
            port = -1
        if not host or not 0 < port < 65536:
            raise SystemExit(
                f"error: --connect expects HOST:PORT, got {args.connect!r}"
            )
        if not args.inputs or args.inputs == ["-"]:
            raise SystemExit("error: --connect needs input WAV files")
        import os

        import numpy as np

        from upmix.app import load_stereo
        from upmix.io import write_wav
        from upmix.serve_stream import stream_client

        os.makedirs(args.out_dir, exist_ok=True)
        for path in args.inputs:
            L, R, sr, _peak = load_stereo(path)
            t0 = time.perf_counter()
            try:
                outs = stream_client(
                    host, port, L.astype(np.float32), R.astype(np.float32),
                    mix=args.pipe_mix, timeout=600.0, expect_sr=sr,
                )
            except (OSError, ConnectionError, ValueError) as exc:
                raise SystemExit(f"error: {path}: {exc}")
            dt = time.perf_counter() - t0
            base = os.path.splitext(os.path.basename(path))[0]
            out_path = os.path.join(
                args.out_dir, f"{base}_net_{args.pipe_mix}.wav"
            )
            write_wav(
                out_path, np.column_stack(outs), int(sr), subtype=args.subtype
            )
            n = len(outs[0])
            print(
                f"{path}: {n} frames via {host}:{port} in {dt:.2f}s "
                f"({n / sr / max(dt, 1e-9):.1f}x realtime) -> {out_path}"
            )
        return 0

    if args.save_aot is not None:
        if args.pipe or args.streaming or args.serve or args.serve_stream is not None:
            raise SystemExit(
                "error: --save-aot is exclusive with --serve/--serve-stream/"
                "--pipe/--streaming"
            )
        if args.sr is None or args.sr <= 0:
            raise SystemExit("error: --save-aot requires a positive --sr")
        if args.inputs != ["-"]:
            raise SystemExit("error: --save-aot takes no input files; pass '-'")
        from upmix import aot
        from upmix.config import UpmixConfig

        platforms = None
        if args.aot_platforms:
            platforms = [s for s in args.aot_platforms.split(",") if s.strip()]
        if args.aot_stream:
            cfg = UpmixConfig.streaming(
                edges,
                sr=args.sr,
                hw_block_size=args.hw_block,
                window=args.window,
                xover_mode=args.xover_mode,
                threshold_factor=args.threshold_factor,
                synthesis=args.synthesis or "analysis",
                bin_rounding=args.bin_rounding or "cpp",
            )
            meta = aot.save_stream_step(
                args.save_aot, cfg, args.hw_block, platforms=platforms
            )
        else:
            if args.aot_samples < 1:
                raise SystemExit("error: --aot-samples must be >= 1")
            cfg = UpmixConfig.make(
                edges,
                sr=args.sr,
                overlap=args.overlap,
                window=args.window,
                xover_mode=args.xover_mode,
                max_block_size=args.max_block_size,
                threshold_factor=args.threshold_factor,
                synthesis=args.synthesis or "wola",
                bin_rounding=args.bin_rounding or "python",
            )
            meta = aot.save_offline(
                args.save_aot,
                cfg,
                args.aot_samples,
                kernel=args.kernel,
                platforms=platforms,
            )
        import json as _json

        print(_json.dumps({"saved": args.save_aot, **{
            k: meta[k] for k in ("type", "platforms", "jax_version")
        }}))
        return 0

    if args.metrics_http is not None and args.serve_stream is None:
        raise SystemExit("error: --metrics-http requires --serve-stream")
    if args.serve_stream is not None:
        if args.pipe or args.streaming or args.serve:
            raise SystemExit(
                "error: --serve-stream is exclusive with --serve/--pipe/"
                "--streaming"
            )
        if args.sr is None or args.sr <= 0:
            raise SystemExit("error: --serve-stream requires a positive --sr")
        if args.inputs != ["-"]:
            raise SystemExit(
                "error: --serve-stream takes no input files; pass '-'"
            )
        if args.streams < 1:
            raise SystemExit("error: --streams must be >= 1")
        if args.snapshot_every is not None:
            if args.snapshot_path is None:
                raise SystemExit(
                    "error: --snapshot-every requires --snapshot-path"
                )
            if args.snapshot_every <= 0:
                raise SystemExit("error: --snapshot-every must be > 0")
        from upmix.serve_stream import run_stream_server

        pool_mesh = None
        if args.pool_mesh is not None:
            pool_mesh = build_mesh(
                args.pool_mesh, allowed=("data",), flag="--pool-mesh"
            )
        try:
            server = run_stream_server(
                args.serve_stream,
                sr=args.sr,
                n_streams=args.streams,
                hw_block_size=args.hw_block,
                band_edges=edges,
                host=args.serve_host,
                lockstep=args.lockstep,
                window=args.window,
                xover_mode=args.xover_mode,
                threshold_factor=args.threshold_factor,
                synthesis=args.synthesis or "analysis",
                bin_rounding=args.bin_rounding or "cpp",
                mesh=pool_mesh,
                snapshot_path=args.snapshot_path,
                snapshot_every=args.snapshot_every,
                metrics_http_port=args.metrics_http,
                pipeline=args.serve_pipeline,
                resume_ttl=args.resume_ttl,
            )
        except ValueError as e:
            # Config-shape problems (mesh divisibility, band validation)
            # are user errors, not tracebacks.
            raise SystemExit(f"error: {e}")
        try:
            import signal as _signal
            import threading as _threading

            # SIGTERM runs the same graceful path as ^C so a supervisor
            # restart checkpoints the live sessions.
            def _sigterm(*_args):
                raise KeyboardInterrupt

            _signal.signal(_signal.SIGTERM, _sigterm)
            _threading.Event().wait()  # serve until interrupted
        except KeyboardInterrupt:
            pass
        finally:
            if args.snapshot_path is not None:
                n = server.save_checkpoint(args.snapshot_path)
                print(f"checkpointed {n} live sessions to "
                      f"{args.snapshot_path}", flush=True)
            server.close()
        return 0

    if args.serve:
        import sys as _sys

        from upmix.app import run_jobs

        if args.pipe or args.streaming:
            raise SystemExit("error: --serve is exclusive with --pipe/--streaming")
        if args.inputs != ["-"]:
            raise SystemExit("error: --serve reads jobs from stdin; pass '-'")
        # A job server sees arbitrary lengths: bucket them by default so a
        # fresh length rarely pays a fresh compile.
        serve_pad = args.pad_granularity if args.pad_granularity is not None else 2**16
        n_ok, n_fail = run_jobs(
            _sys.stdin,
            _sys.stdout,
            out_dir=args.out_dir,
            export_mode=args.export_mode,
            band_edges=edges,
            overlap=args.overlap,
            window=args.window,
            xover_mode=args.xover_mode,
            max_block_size=args.max_block_size,
            threshold_factor=args.threshold_factor,
            synthesis=args.synthesis or "wola",
            bin_rounding=args.bin_rounding or "python",
            subtype=args.subtype,
            kernel=args.kernel,
            pad_granularity=serve_pad,
            chunk=args.chunk,
        )
        # Exit status for supervisors: 0 when the stream was healthy
        # (no jobs, or at least one success); 1 when jobs came in and
        # every one of them failed.
        return 1 if (n_fail and not n_ok) else 0

    if args.pipe:
        import sys as _sys

        from upmix.app import run_pipe

        if args.sr is None or args.sr <= 0:
            raise SystemExit(
                "error: --pipe requires a positive --sr (raw PCM has no header)"
            )
        if args.inputs != ["-"]:
            raise SystemExit("error: --pipe reads stdin; pass '-' as the input")
        try:
            run_pipe(
                _sys.stdin,
                _sys.stdout,
                sr=args.sr,
                hw_block_size=args.hw_block,
                band_edges=edges,
                window=args.window,
                xover_mode=args.xover_mode,
                threshold_factor=args.threshold_factor,
                synthesis=args.synthesis or "analysis",
                bin_rounding=args.bin_rounding or "cpp",
                engine=args.engine,
                mix=args.pipe_mix,
                align=not args.pipe_raw,
            )
        except BrokenPipeError:
            # Downstream closed early (user quit the player, `head`, ...):
            # exit quietly like any well-behaved pipe filter.  Point stdout
            # at devnull so interpreter shutdown doesn't print
            # "Exception ignored in: BufferedWriter" while flushing.
            import os as _os

            devnull = _os.open(_os.devnull, _os.O_WRONLY)
            _os.dup2(devnull, _sys.stdout.fileno())
            return 0
        return 0

    if args.streaming:
        from upmix.app import run_streaming

        if args.export_mode == "AB":
            raise SystemExit(
                "error: --export-mode AB needs the original signal aligned with "
                "the upmix; the streaming path supports stereo_sum or split"
            )
        for path in args.inputs:
            t0 = time.perf_counter()
            result = run_streaming(
                path,
                out_dir=args.out_dir,
                hw_block_size=args.hw_block,
                band_edges=edges,
                window=args.window,
                xover_mode=args.xover_mode,
                threshold_factor=args.threshold_factor,
                synthesis=args.synthesis or "analysis",
                bin_rounding=args.bin_rounding or "cpp",
                engine=args.engine,
                subtype=args.subtype,
                export_mode=args.export_mode,
                verbose=args.verbose,
            )
            _report(args, result, path, t0)
            for out in result.paths:
                print(out)
        return 0

    # Offline: share one compiled Upmixer per sample rate across the batch
    # (with --pad-granularity, files of similar length share programs too).
    upmixer_cache = {}
    mesh = build_mesh(args.mesh) if args.mesh is not None else None
    if (
        mesh is not None
        and "data" in mesh.shape
        and len(args.inputs) > 1
    ):
        # The data axis is only useful if the files actually ride it:
        # batch the whole input list through ONE mesh-sharded call per
        # sample rate instead of padding each file's batch of 1 up to D.
        from upmix.app import run_offline_batch

        t0 = time.perf_counter()
        try:
            results = run_offline_batch(
                args.inputs,
                mesh,
                out_dir=args.out_dir,
                export_mode=args.export_mode,
                band_edges=edges,
                overlap=args.overlap,
                window=args.window,
                xover_mode=args.xover_mode,
                max_block_size=args.max_block_size,
                threshold_factor=args.threshold_factor,
                synthesis=args.synthesis or "wola",
                bin_rounding=args.bin_rounding or "python",
                subtype=args.subtype,
                kernel=args.kernel,
                verbose=args.verbose,
            )
        except ValueError as e:
            # Sharded-geometry rejections (frame-grid LCM, padding
            # blowup) are user config errors, not tracebacks — same
            # treatment as the serve path.
            raise SystemExit(f"error: {e}")
        if args.meter:
            wall = time.perf_counter() - t0
            audio = sum(r.audio_seconds for r in results)
            if wall > 0 and audio > 0:
                print(
                    f"[batch x{len(results)}] {audio:.2f} audio-sec in "
                    f"{wall:.2f} s -> {audio / wall:.1f}x realtime"
                )
        for result in results:
            for out in result.paths:
                print(out)
        return 0
    for path in args.inputs:
        t0 = time.perf_counter()
        try:
            result = run_offline(
                path,
                out_dir=args.out_dir,
                export_mode=args.export_mode,
                band_edges=edges,
                overlap=args.overlap,
                window=args.window,
                xover_mode=args.xover_mode,
                max_block_size=args.max_block_size,
                threshold_factor=args.threshold_factor,
                synthesis=args.synthesis or "wola",
                bin_rounding=args.bin_rounding or "python",
                subtype=args.subtype,
                kernel=args.kernel,
                pad_granularity=args.pad_granularity if args.pad_granularity is not None else 1,
                upmixer_cache=upmixer_cache,
                mesh=mesh,
                chunk=args.chunk,
                verbose=args.verbose,
            )
        except ValueError as e:
            if mesh is None:
                raise  # plain-run behavior unchanged
            # Sharded-geometry rejections are user config errors.
            raise SystemExit(f"error: {e}")
        _report(args, result, path, t0)
        for out in result.paths:
            print(out)
    return 0


def _report(args, result, path, t0) -> None:
    """Print the realtime factor (stdout — user-facing CLI output, not a
    log record, and the duration comes from the result, not a re-decode)."""
    if not args.meter:
        return
    import time

    wall = time.perf_counter() - t0
    audio = result.audio_seconds
    if wall > 0 and audio > 0:
        print(f"[{path}] {audio:.2f} audio-sec in {wall:.2f} s -> {audio / wall:.1f}x realtime")


if __name__ == "__main__":
    sys.exit(main())
