"""Offline application layer: WAV load, peak-safe scaling, export modes.

Replicates the reference's offline app semantics (python-prototype/main.py):
mono→stereo duplication (main.py:47-48), silent-file peak guard
(main.py:53-55), a single shared scale factor across Ls/C/Rs
(main.py:85-97), the three export modes with their exact channel layouts
(main.py:110-157), and the config-encoding output filenames
(main.py:102-106).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from upmix.config import UpmixConfig
from upmix.io import read_wav, write_wav
from upmix.models.offline import Upmixer
from upmix.utils.logging import get_logger

log = get_logger(__name__)

EXPORT_MODES = ("AB", "split", "stereo_sum")


def load_stereo(path):
    """Load a WAV as stereo float64, duplicating mono, and measure the input
    peak with the silent-file guard (main.py:43-55)."""
    wave, sr = read_wav(path)
    log.info("Loaded %r, sr=%s, shape=%s", str(path), sr, wave.shape)
    if wave.ndim == 1:
        wave = np.column_stack([wave, wave])
    peak_in = float(np.max(np.abs(wave)))
    if peak_in <= 0.0:
        peak_in = 1e-9
    return wave[:, 0], wave[:, 1], sr, peak_in


def scale_lcr(C, Ls, Rs, peak_in: float):
    """Single shared scale factor so no channel exceeds the original peak
    (main.py:85-97)."""
    overall = max(
        float(np.max(np.abs(Ls))),
        float(np.max(np.abs(C))),
        float(np.max(np.abs(Rs))),
        1e-9,
    )
    scale = peak_in / overall
    log.info("Original peak = %.4f, L/C/R peak = %.4f", peak_in, overall)
    log.info("Applying scale_factor = %.4f", scale)
    return C * scale, Ls * scale, Rs * scale, scale


def band_info_str(config: UpmixConfig) -> str:
    """Output-filename band descriptor `b{block}({lo}-{hi})_...`
    (main.py:102-106)."""
    return "_".join(
        f"b{b.block_size}({int(b.f_low)}-{int(b.f_high)})" for b in config.bands
    )


@dataclass
class ExportResult:
    paths: list
    scale_factor: float
    n_samples: int = 0
    sr: int = 0

    @property
    def audio_seconds(self) -> float:
        return self.n_samples / self.sr if self.sr else 0.0


def export_lcr(
    out_dir,
    base_name: str,
    export_mode: str,
    C: np.ndarray,
    Ls: np.ndarray,
    Rs: np.ndarray,
    L: np.ndarray,
    R: np.ndarray,
    sr: int,
    config: UpmixConfig,
    subtype: str = "FLOAT",
) -> ExportResult:
    """Write output files per export mode with the reference's channel
    layouts and filename encodings (main.py:110-157)."""
    os.makedirs(out_dir, exist_ok=True)
    info = band_info_str(config)
    overlap = config.overlap
    paths = []

    if export_mode == "AB":
        upmix_sum = Ls + C + Rs
        orig_sum = np.asarray(L) + np.asarray(R)
        n = min(len(upmix_sum), len(orig_sum))
        ab = np.column_stack([upmix_sum[:n], orig_sum[:n]])
        path = os.path.join(out_dir, f"{base_name}_AB_{info}_ov{overlap:.2f}.wav")
        write_wav(path, ab, sr, subtype=subtype)
        log.info("[AB] Wrote 2-ch => %s (Left = Ls+C+Rs, Right = L+R)", path)
        paths.append(path)

    elif export_mode == "split":
        layouts = [
            ("Ls", np.column_stack([Ls, np.zeros_like(Ls)])),
            ("C", np.column_stack([C, C])),
            ("Rs", np.column_stack([np.zeros_like(Rs), Rs])),
        ]
        for tag, data in layouts:
            path = os.path.join(out_dir, f"{base_name}_{tag}_{info}.wav")
            write_wav(path, data, sr, subtype=subtype)
            log.info("[Split] Wrote => %s", path)
            paths.append(path)

    elif export_mode == "stereo_sum":
        left = Ls + 0.5 * C
        right = Rs + 0.5 * C
        n = min(len(left), len(right))
        path = os.path.join(out_dir, f"{base_name}_Sum_{info}_ov{overlap:.2f}.wav")
        write_wav(path, np.column_stack([left[:n], right[:n]]), sr, subtype=subtype)
        log.info("[StereoSum] Wrote 2-ch => %s (Left = Ls+C/2, Right = Rs+C/2)", path)
        paths.append(path)

    else:
        raise ValueError(f"unknown export_mode {export_mode!r}; one of {EXPORT_MODES}")

    return ExportResult(paths=paths, scale_factor=1.0)


def run_streaming(
    in_path,
    out_dir="out",
    hw_block_size: int = 2048,
    band_edges=(0, 500, 2000, 8000),
    window: str = "blackman_harris",
    xover_mode: str = "raised_cosine",
    threshold_factor: float = 32.0,
    synthesis: str = "analysis",
    bin_rounding: str = "cpp",
    engine: str = "jax",
    subtype: str = "FLOAT",
    export_mode: str = "stereo_sum",
    verbose: bool = False,
) -> ExportResult:
    """Streaming (block-based) pipeline: WAV → block engine → WAV,
    simulating the real-time path offline.

    Defaults replicate the C++ reference's shipped configuration: 4 bands
    at 0/500/2000/8000 Hz, 2048-sample hardware blocks, plain-BH synthesis
    and hard C++ bin rounding (bela/upmix.cpp:521-528; README.md:65).
    engine="jax" runs the scan-based JAX engine; engine="native" runs the
    C++ host shell (requires `make -C native`).

    export_mode="stereo_sum" writes the reference Bela downmix (one
    2-channel file, Ls+C/2 | Rs+C/2); export_mode="split" writes the three
    discrete channels with the offline split layout (Ls/–, C/C, –/Rs).
    """
    if export_mode not in ("stereo_sum", "split"):
        raise ValueError(
            f"streaming export_mode must be 'stereo_sum' or 'split', got {export_mode!r}"
        )
    L, R, sr, _peak = load_stereo(in_path)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)

    eng, _warmup, config = _make_streaming_engine(
        band_edges, sr, hw_block_size, window, xover_mode,
        threshold_factor, synthesis, bin_rounding, engine, verbose=verbose,
    )
    mix = "stereo_sum" if export_mode == "stereo_sum" else "lcr"
    outs = tuple(np.asarray(o) for o in eng.process_signal(L32, R32, mix=mix))

    os.makedirs(out_dir, exist_ok=True)
    info = band_info_str(config)
    base = os.path.splitext(os.path.basename(str(in_path)))[0]
    paths = []
    if export_mode == "stereo_sum":
        out_l, out_r = outs
        path = os.path.join(out_dir, f"{base}_Stream_hw{hw_block_size}_{info}.wav")
        write_wav(path, np.column_stack([out_l, out_r]), sr, subtype=subtype)
        log.info(
            "[Stream:%s] Wrote 2-ch => %s (Left = Ls+C/2, Right = Rs+C/2)", engine, path
        )
        paths.append(path)
    else:
        C, Ls, Rs = outs
        layouts = [
            ("Ls", np.column_stack([Ls, np.zeros_like(Ls)])),
            ("C", np.column_stack([C, C])),
            ("Rs", np.column_stack([np.zeros_like(Rs), Rs])),
        ]
        for tag, data in layouts:
            path = os.path.join(
                out_dir, f"{base}_Stream_hw{hw_block_size}_{tag}_{info}.wav"
            )
            write_wav(path, data, sr, subtype=subtype)
            log.info("[Stream:%s] Wrote => %s", engine, path)
            paths.append(path)
    return ExportResult(paths=paths, scale_factor=1.0, n_samples=len(outs[0]), sr=sr)


def _make_streaming_engine(
    band_edges,
    sr: float,
    hw_block_size: int,
    window: str,
    xover_mode: str,
    threshold_factor: float,
    synthesis: str,
    bin_rounding: str,
    engine: str,
    verbose: bool = False,
):
    """Shared jax/native streaming-engine construction (run_streaming and
    run_pipe).  Returns (engine, warmup_blocks, config); both engines
    expose push_block and process_signal with the same surface."""
    config = UpmixConfig.streaming(
        list(band_edges), sr=float(sr), hw_block_size=hw_block_size,
        window=window, xover_mode=xover_mode,
        threshold_factor=threshold_factor, synthesis=synthesis,
        bin_rounding=bin_rounding, verbose=verbose,
    )
    if engine == "jax":
        from upmix.models.streaming import StreamingUpmixer

        eng = StreamingUpmixer(config, hw_block_size)
        return eng, eng.warmup_blocks, config
    if engine == "native":
        from upmix.native import NativeStreamingUpmixer

        eng = NativeStreamingUpmixer(
            list(band_edges), sr=float(sr), hw_block_size=hw_block_size,
            xover_mode=xover_mode, synthesis=synthesis,
            bin_rounding=bin_rounding, threshold_factor=threshold_factor,
            window=window,
        )
        return eng, eng.latency_blocks, config
    raise ValueError(f"unknown engine {engine!r}; one of ('jax', 'native')")


def _read_exact(src, nbytes: int) -> bytes:
    """Read exactly nbytes unless EOF (raw/unbuffered pipes legally return
    short reads mid-stream — a short read is NOT end-of-stream)."""
    chunks = []
    got = 0
    while got < nbytes:
        b = src.read(nbytes - got)
        if not b:
            break
        chunks.append(b)
        got += len(b)
    return b"".join(chunks)


def run_pipe(
    stdin,
    stdout,
    sr: float,
    hw_block_size: int = 2048,
    band_edges=(0, 500, 2000, 8000),
    window: str = "blackman_harris",
    xover_mode: str = "raised_cosine",
    threshold_factor: float = 32.0,
    synthesis: str = "analysis",
    bin_rounding: str = "cpp",
    engine: str = "jax",
    mix: str = "stereo_sum",
    align: bool = True,
) -> int:
    """Raw-PCM streaming filter: interleaved float32 stereo on stdin →
    processed interleaved float32 on stdout, one hardware block at a time.

    The sox-style integration surface for audio pipelines (the L4 analog
    of the reference's Bela render() callback for hosts that speak pipes
    instead of audio callbacks):

        ffmpeg -i in.flac -f f32le -ac 2 - | upmix - --pipe --sr 44100 \\
            | ffmpeg -f f32le -ar 44100 -ac 2 -i - out.wav

    mix="stereo_sum" emits 2 channels (Ls+C/2 | Rs+C/2, the reference
    Bela downmix); mix="lcr" emits 3 interleaved channels (C, Ls, Rs).

    With align=True (default) the engine's warmup latency is compensated:
    the leading (warmup-1) blocks of silence are dropped and the stream is
    drained with zero blocks at EOF, so output frame i corresponds to
    input frame i and len(out) == len(in) — the right semantics for a
    file filter.  align=False emits the raw real-time stream (output
    delayed by the warmup, tail not drained), matching what a live audio
    callback would produce.  Returns the number of frames emitted.
    """
    if mix not in ("stereo_sum", "lcr"):
        raise ValueError(f"pipe mix must be 'stereo_sum' or 'lcr', got {mix!r}")
    hw = int(hw_block_size)
    eng, warmup_blocks, _config = _make_streaming_engine(
        band_edges, sr, hw, window, xover_mode, threshold_factor,
        synthesis, bin_rounding, engine,
    )

    def push(bl, br):
        return tuple(np.asarray(o) for o in eng.push_block(bl, br))

    src = getattr(stdin, "buffer", stdin)
    dst = getattr(stdout, "buffer", stdout)
    frame_bytes = 2 * 4  # stereo float32
    to_skip = (warmup_blocks - 1) * hw if align else 0
    emitted = 0
    total_in = 0

    def mix_out(c, ls, rs):
        if mix == "stereo_sum":
            return np.column_stack([ls + 0.5 * c, rs + 0.5 * c])
        return np.column_stack([c, ls, rs])

    def write_out(out, limit=None):
        nonlocal to_skip, emitted
        if to_skip:
            k = min(to_skip, len(out))
            out = out[k:]
            to_skip -= k
        if limit is not None:
            out = out[: max(0, limit - emitted)]
        if len(out):
            dst.write(np.ascontiguousarray(out).astype("<f4").tobytes())
            emitted += len(out)

    while True:
        raw = _read_exact(src, hw * frame_bytes)
        if not raw:
            break
        n = len(raw) // frame_bytes
        x = np.frombuffer(raw[: n * frame_bytes], dtype="<f4").reshape(n, 2)
        if n < hw:
            x = np.vstack([x, np.zeros((hw - n, 2), np.float32)])
        total_in += n
        c, ls, rs = push(
            np.ascontiguousarray(x[:, 0]), np.ascontiguousarray(x[:, 1])
        )
        # The final (partial) input block may carry output beyond the
        # input length; everything earlier cannot (emitted <= in - skip).
        write_out(mix_out(c, ls, rs), limit=total_in if n < hw else None)
        if n < hw:
            break
    if align:
        # Drain: the last (warmup-1) blocks of program material are still
        # inside the engine; push zeros until the output catches up.
        zeros = np.zeros(hw, np.float32)
        while emitted < total_in:
            c, ls, rs = push(zeros, zeros)
            write_out(mix_out(c, ls, rs), limit=total_in)
    dst.flush()
    return emitted


def run_offline(
    in_path,
    out_dir="out",
    export_mode: str = "stereo_sum",
    band_edges=(0, 30, 120, 480, 1920, 7680),
    overlap: float = 0.75,
    window: str = "blackman_harris",
    xover_mode: str = "raised_cosine",
    max_block_size: int = 2**16,
    threshold_factor: float = 32.0,
    synthesis: str = "wola",
    bin_rounding: str = "python",
    subtype: str = "FLOAT",
    upmixer: Upmixer | None = None,
    upmixer_cache: dict | None = None,
    kernel: str = "auto",
    pad_granularity: int = 1,
    mesh=None,
    chunk: int | None = None,
    verbose: bool = False,
) -> ExportResult:
    """Full offline pipeline: load → upmix → scale → export.

    Defaults replicate main.py:29-73 (minus its edit-the-source config).
    Pass a pre-built `upmixer`, or a shared `upmixer_cache` dict to reuse
    compiled programs across a batch of files — the cache is keyed by the
    full config identity (UpmixConfig is hashable) plus kernel and
    pad_granularity, so one cache is safe to share across calls with
    differing flags or sample rates.

    `mesh` (a jax.sharding.Mesh, e.g. from upmix.parallel.make_mesh)
    runs the pipeline mesh-sharded instead: the sample axis splits over
    the mesh's 'seq' axis with halo exchange (parallel/sharded.py).  The
    sharded path manages its own length padding and chunking, so
    pad_granularity and `chunk` are ignored there; a pre-built `upmixer`
    takes precedence over `mesh`.

    `chunk` overrides the scan chunk size (None = models/offline.py
    CHUNK_SAMPLES, 0 = one whole-file program) — feed it from
    `upmix.tune --offline` on new hardware.
    """
    if export_mode not in EXPORT_MODES:
        raise ValueError(f"unknown export_mode {export_mode!r}; one of {EXPORT_MODES}")
    L, R, sr, peak_in = load_stereo(in_path)

    if upmixer is None:
        config = UpmixConfig.make(
            list(band_edges),
            sr=float(sr),
            overlap=overlap,
            window=window,
            xover_mode=xover_mode,
            max_block_size=max_block_size,
            threshold_factor=threshold_factor,
            synthesis=synthesis,
            bin_rounding=bin_rounding,
            verbose=verbose,
        )
        cache_key = (config, kernel, pad_granularity, mesh, chunk)
        if upmixer_cache is not None:
            upmixer = upmixer_cache.get(cache_key)
        if upmixer is None:
            if mesh is not None:
                from upmix.parallel import ShardedUpmixer

                upmixer = ShardedUpmixer(config, mesh, kernel=kernel)
            else:
                upmixer = Upmixer(
                    config, pad_granularity=pad_granularity, kernel=kernel,
                    chunk=chunk,
                )
            if upmixer_cache is not None:
                upmixer_cache[cache_key] = upmixer
    config = upmixer.config

    C, Ls, Rs = upmixer.process_np(L.astype(np.float32), R.astype(np.float32))
    C, Ls, Rs, scale = scale_lcr(C, Ls, Rs, peak_in)

    base = os.path.splitext(os.path.basename(str(in_path)))[0]
    result = export_lcr(out_dir, base, export_mode, C, Ls, Rs, L, R, sr, config, subtype)
    result.scale_factor = scale
    result.n_samples = len(L)
    result.sr = sr
    return result


def run_offline_batch(
    paths,
    mesh,
    out_dir="out",
    export_mode: str = "stereo_sum",
    band_edges=(0, 30, 120, 480, 1920, 7680),
    overlap: float = 0.75,
    window: str = "blackman_harris",
    xover_mode: str = "raised_cosine",
    max_block_size: int = 2**16,
    threshold_factor: float = 32.0,
    synthesis: str = "wola",
    bin_rounding: str = "python",
    subtype: str = "FLOAT",
    kernel: str = "auto",
    verbose: bool = False,
) -> "list[ExportResult]":
    """Data-parallel batched offline pipeline over a mesh.

    Files are grouped by sample rate (one config + compiled program per
    rate) and processed in length-sorted sub-batches — each stacked
    [batch, 2, n_max] float32 input stays under ~256 MB with at most a
    2x pad between the shortest and longest member — one mesh-sharded
    call per sub-batch: the batch rides the mesh's 'data' axis, the
    sample axis its 'seq' axis (parallel/sharded.py).
    Per-file scaling/export semantics are identical to run_offline —
    trailing zero-padding is prefix-invariant for this pipeline (the
    same property Upmixer's pad_granularity relies on), so each file's
    trimmed output matches its solo run.  Returns ExportResults in
    input order.
    """
    from upmix.parallel import ShardedUpmixer

    if export_mode not in EXPORT_MODES:
        raise ValueError(f"unknown export_mode {export_mode!r}; one of {EXPORT_MODES}")
    loaded = []
    for i, p in enumerate(paths):
        # Keep the float64 originals: export_lcr's AB mode references the
        # unprocessed signal, which run_offline passes at full precision.
        L, R, sr, peak_in = load_stereo(p)
        loaded.append((i, p, L, R, int(sr), peak_in))
    results: list = [None] * len(loaded)
    by_sr: dict = {}
    for rec in loaded:
        by_sr.setdefault(rec[4], []).append(rec)
    # Bound the stacked-batch memory and padding waste: each sharded call
    # takes a length-sorted sub-batch whose stacked f32 input stays under
    # the budget and whose longest file is at most 2x its shortest (so a
    # stray hour-long file cannot pad fifty 3-minute files up to its
    # length — review finding).
    budget_bytes = 1 << 28  # 256 MB of stacked [B, 2, n] float32 input
    for sr, group in sorted(by_sr.items()):
        config = UpmixConfig.make(
            list(band_edges),
            sr=float(sr),
            overlap=overlap,
            window=window,
            xover_mode=xover_mode,
            max_block_size=max_block_size,
            threshold_factor=threshold_factor,
            synthesis=synthesis,
            bin_rounding=bin_rounding,
            verbose=verbose,
        )
        su = ShardedUpmixer(config, mesh, kernel=kernel)

        def flush(sub):
            n_max = max(len(r[2]) for r in sub)
            x = np.zeros((len(sub), 2, n_max), np.float32)
            for j, (_, _, L, R, _, _) in enumerate(sub):
                x[j, 0, : len(L)] = L
                x[j, 1, : len(R)] = R
            y = np.asarray(su.process_batch(x))
            for j, (i, p, L, R, sr_, peak_in) in enumerate(sub):
                n = len(L)
                C, Ls, Rs, scale = scale_lcr(
                    y[j, 0, :n], y[j, 1, :n], y[j, 2, :n], peak_in
                )
                base = os.path.splitext(os.path.basename(str(p)))[0]
                res = export_lcr(
                    out_dir, base, export_mode, C, Ls, Rs, L, R, sr_,
                    config, subtype,
                )
                res.scale_factor = scale
                res.n_samples = n
                res.sr = sr_
                results[i] = res

        sub: list = []
        for rec in sorted(group, key=lambda r: len(r[2])):
            n = len(rec[2])
            if sub and (
                (len(sub) + 1) * 2 * n * 4 > budget_bytes
                or n > 2 * len(sub[0][2])
            ):
                flush(sub)
                sub = []
            sub.append(rec)
        if sub:
            flush(sub)
    return results


def run_jobs(src, dst, out_dir: str = "out", export_mode: str = "stereo_sum",
             **offline_kwargs) -> "tuple[int, int]":
    """Line-delimited JSON job server: the persistent-process serving mode.

    Reads one JSON object per line from `src` and writes one JSON result
    line to `dst` per job — composable with sockets, FIFOs, or a work
    queue (`... | upmix - --serve | ...`).  The process stays alive
    across jobs, so compiled programs are reused: the first job at a
    given (sample rate, length bucket) pays the compile, the rest run
    warm (pass pad_granularity to widen the length buckets).

    Job fields: {"in": path, "out_dir"?: str, "export_mode"?: str} — all
    other pipeline flags are process-wide (**offline_kwargs), keeping the
    compile cache effective.  {"cmd": "ping"} answers {"ok": true,
    "pong": true} (a readiness probe); {"cmd": "stats"} reports job and
    cache counters plus completed-job wall-time percentiles
    (p50/p95/p99 via upmix.metrics.LatencyHistogram).  A failing job reports {"ok": false, "error": ...}
    on its own line; the server keeps going.

    Returns (n_ok, n_failed).  The warm caches are bounded: at most 8
    distinct configs (LRU), each holding at most 16 compiled length
    variants (Upmixer.max_programs) — a long-lived server's memory stays
    flat under arbitrary job streams.

    The reference has no serving story (single-shot main.py:25-165);
    this is the batch-serving counterpart of the real-time pipe mode.
    """
    import json as _json
    import time as _time
    from collections import OrderedDict

    class _LruDict(OrderedDict):
        # run_offline reads via .get: refresh recency on hits so the
        # eviction below drops the LEAST-recently-used config, not the
        # first-inserted one.
        def get(self, key, default=None):
            if key in self:
                self.move_to_end(key)
            return super().get(key, default)

    from upmix.metrics import LatencyHistogram

    cache: OrderedDict = _LruDict()
    job_hist = LatencyHistogram()  # completed-job wall time
    n_ok = 0
    n_fail = 0
    for line in src:
        line = line.strip()
        if not line:
            continue
        job = None
        try:
            job = _json.loads(line)
            if not isinstance(job, dict):
                raise ValueError("job must be a JSON object")
            if job.get("cmd") == "ping":
                resp = {"ok": True, "pong": True}
            elif job.get("cmd") == "stats":
                hs = job_hist.snapshot()
                resp = {
                    "ok": True,
                    "n_ok": n_ok,
                    "n_failed": n_fail,
                    "configs_cached": len(cache),
                    "programs_cached": sum(
                        len(u._cache) for u in cache.values()
                    ),
                    # Wall-time distribution of COMPLETED jobs (the
                    # cold-compile first job dominates max; p50/p95 are
                    # the warm serving latencies an operator watches).
                    "job_seconds": {
                        k: hs[k]
                        for k in ("count", "sum", "max", "p50", "p95", "p99")
                    },
                }
            else:
                unknown = set(job) - {"in", "out_dir", "export_mode"}
                if unknown:
                    raise ValueError(f"unknown job fields {sorted(unknown)}")
                in_path = job["in"]
                t0 = _time.perf_counter()
                try:
                    result = run_offline(
                        in_path,
                        out_dir=job.get("out_dir", out_dir),
                        export_mode=job.get("export_mode", export_mode),
                        upmixer_cache=cache,
                        **offline_kwargs,
                    )
                finally:
                    # run_offline inserts the Upmixer before processing, so
                    # enforce the bound even when the job fails — a stream of
                    # failing jobs at distinct sample rates must not grow the
                    # cache past the documented limit.
                    while len(cache) > 8:  # LRU bound on distinct configs
                        cache.popitem(last=False)
                resp = {
                    "ok": True,
                    "in": str(in_path),
                    "outputs": [str(p) for p in result.paths],
                    "audio_seconds": round(result.audio_seconds, 3),
                    "wall_s": round(_time.perf_counter() - t0, 3),
                }
                job_hist.record(_time.perf_counter() - t0)
                n_ok += 1
        except Exception as exc:  # job isolation: the server survives
            n_fail += 1
            resp = {
                "ok": False,
                "in": job.get("in") if isinstance(job, dict) else None,
                "error": f"{type(exc).__name__}: {exc}",
            }
        dst.write(_json.dumps(resp) + "\n")
        dst.flush()
    return n_ok, n_fail
