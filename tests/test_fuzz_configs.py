"""Generative config fuzz sweep (SURVEY §4 insurance).

Seeded random configurations over the reference's full constructor
surface (center_extraction.py:240-266, 518-580): edge counts 1-10 with
near-Nyquist/degenerate/duplicate values, sample rates 8k-192k, overlaps
incl. non-divisible odd fractions, every builtin window plus randomly
registered coefficient vectors, both xover modes, both synthesis modes,
both bin-rounding modes.

Contract per draw: either the config is rejected with a clean
config-time ValueError (never a deep-kernel traceback), or every engine
run on it must hold >60 dB SNR against the float64 NumPy oracle.

The sweep is deterministic (fixed seeds) so any failure reproduces by
seed; bump N_* or change BASE_SEED locally for a deeper hunt.
"""

import numpy as np
import pytest

from upmix.config import UpmixConfig
from upmix.models.offline import upmix_offline
from upmix.models.streaming import StreamingUpmixer
from upmix.oracle import oracle_multiband
from upmix.oracle.reference import oracle_stream_multiband
from upmix.ops.windows import is_known_window, register_window_vector

from helpers import make_stereo, snr_db

BASE_SEED = 20260820
N_OFFLINE = 50  # oracle vs mm kernel (xla on every 4th)
N_STREAMING = 12
N_NATIVE = 8

SRS = [8000.0, 16000.0, 22050.0, 44100.0, 48000.0, 96000.0, 192000.0]
OVERLAPS = [0.5, 0.75, 0.875, 0.6, 0.9375, 0.3, 0.65]
WINDOWS = ["blackman_harris", "sqrt_hann", "hann", "blackman", "hamming", "rect"]


def _rand_window_vec(rng, n=513):
    """Positive, smoothed, tapered random window (plausible analysis win)."""
    w = rng.uniform(0.2, 1.0, n)
    w = np.convolve(w, np.ones(9) / 9.0, mode="same")
    taper = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / (n - 1))
    return (w * (0.15 + 0.85 * taper)).astype(np.float32)


def _draw_window(rng, seed):
    if rng.random() < 0.2:
        name = f"fuzz:w{seed}"
        if not is_known_window(name):
            register_window_vector(name, _rand_window_vec(rng))
        return name
    return WINDOWS[rng.integers(len(WINDOWS))]


def _draw_edges(rng, sr):
    """1-10 edges incl. degenerate draws the validator must handle."""
    n_edges = int(rng.integers(1, 11))
    lo = 10.0 if rng.random() < 0.3 else 0.0
    edges = np.sort(np.exp(rng.uniform(np.log(20.0), np.log(sr / 2), n_edges - 1)))
    edges = [lo] + [float(e) for e in edges]
    r = rng.random()
    if r < 0.15 and len(edges) > 1:
        edges.append(edges[-1])  # exact duplicate edge
    elif r < 0.30:
        edges.append(sr / 2 * 0.999)  # near-Nyquist
    elif r < 0.40:
        edges.append(sr / 2 * 1.01)  # above Nyquist (should be rejected)
    elif r < 0.50 and len(edges) > 2:
        edges.insert(2, edges[1] + 0.01)  # almost-degenerate pair
    return sorted(edges)


def _draw(seed):
    rng = np.random.default_rng(seed)
    sr = SRS[rng.integers(len(SRS))]
    return dict(
        band_edges=_draw_edges(rng, sr),
        sr=sr,
        overlap=OVERLAPS[rng.integers(len(OVERLAPS))],
        window=_draw_window(rng, seed),
        xover_mode=("raised_cosine", "hard_zero")[rng.integers(2)],
        synthesis=("wola", "analysis")[rng.integers(2)],
        bin_rounding=("python", "cpp")[rng.integers(2)],
        max_block_size=int(2 ** rng.integers(7, 11)),  # 128..1024
    )


def _build_or_reject(params):
    """UpmixConfig.make, permitting ONLY a clean ValueError as rejection."""
    try:
        return UpmixConfig.make(**params)
    except ValueError:
        return None  # clean config-time rejection: acceptable
    # anything else (ZeroDivision, struct, XLA, assertion) propagates = bug


def _assert_parity(ref, got, min_snr, ctx):
    for name, r, g in zip("C Ls Rs".split(), ref, got):
        assert g.shape == r.shape, f"{ctx} {name}: shape {g.shape} != {r.shape}"
        assert np.all(np.isfinite(np.asarray(g))), f"{ctx} {name}: non-finite output"
        s = snr_db(r, g)
        assert s > min_snr, f"{ctx} {name}: SNR {s:.1f} dB < {min_snr}"


@pytest.mark.parametrize("seed", range(BASE_SEED, BASE_SEED + N_OFFLINE))
def test_fuzz_offline(seed):
    params = _draw(seed)
    cfg = _build_or_reject(params)
    if cfg is None:
        return
    rng = np.random.default_rng(seed)
    n = 3 * params["max_block_size"] + int(rng.integers(1, 700))  # ragged tail
    L, R = make_stereo(n, cfg.sr, seed=seed, kind="mix")
    L32, R32 = L.astype(np.float32), R.astype(np.float32)
    ref = oracle_multiband(L32, R32, cfg)
    ctx = f"seed={seed} {params}"
    _assert_parity(ref, upmix_offline(L32, R32, cfg, kernel="mm"), 60.0, f"mm {ctx}")
    if seed % 4 == 0:
        _assert_parity(
            ref, upmix_offline(L32, R32, cfg, kernel="xla"), 60.0, f"xla {ctx}"
        )


@pytest.mark.parametrize("seed", range(BASE_SEED + 1000, BASE_SEED + 1000 + N_STREAMING))
def test_fuzz_streaming(seed):
    rng = np.random.default_rng(seed)
    sr = SRS[rng.integers(len(SRS))]
    hw = int(2 ** rng.integers(6, 9))  # 64..256
    params = dict(
        band_edges=_draw_edges(rng, sr),
        sr=sr,
        window=_draw_window(rng, seed),
        xover_mode=("raised_cosine", "hard_zero")[rng.integers(2)],
        synthesis=("wola", "analysis")[rng.integers(2)],
        bin_rounding=("python", "cpp")[rng.integers(2)],
    )
    try:
        cfg = UpmixConfig.streaming(hw_block_size=hw, **params)
        eng = StreamingUpmixer(cfg, hw)
    except ValueError:
        return  # clean config-time rejection
    n = 14 * hw + 13  # ragged tail is truncated by both sides identically
    L, R = make_stereo(n, sr, seed=seed, kind="mix")
    L32, R32 = L.astype(np.float32), R.astype(np.float32)
    ref = oracle_stream_multiband(L32, R32, cfg, hw)
    got = eng.process_signal(L32, R32, mix="stereo_sum")
    ctx = f"seed={seed} hw={hw} {params}"
    for name, r, g in zip("outL outR".split(), ref, got):
        assert np.all(np.isfinite(np.asarray(g))), f"{ctx} {name}: non-finite"
        s = snr_db(r, g)
        assert s > 60.0, f"stream {ctx} {name}: SNR {s:.1f} dB"


N_SHARDED = 6
N_POOL = 6
N_AOT = 4


@pytest.mark.parametrize("seed", range(BASE_SEED + 3000, BASE_SEED + 3000 + N_SHARDED))
def test_fuzz_sharded(seed):
    # Random configs through the 8-way sequence-sharded pipeline: halo
    # exchange and OLA spill must hold parity at every shard seam for
    # arbitrary geometry, not just the hand-picked test configs.
    from upmix.parallel import ShardedUpmixer, make_mesh

    params = _draw(seed)
    cfg = _build_or_reject(params)
    if cfg is None:
        return
    rng = np.random.default_rng(seed)
    n = 8 * params["max_block_size"] + int(rng.integers(1, 500))
    try:
        su = ShardedUpmixer(cfg, make_mesh({"seq": 8}))
    except ValueError:
        return  # clean rejection (pathological frame-grid LCM)
    L, R = make_stereo(n, cfg.sr, seed=seed, kind="mix")
    L32, R32 = L.astype(np.float32), R.astype(np.float32)
    try:
        got = su.process(L32, R32)
    except ValueError:
        # clean n-dependent rejection (shard padding would dwarf the
        # input — sequence_plan's blowup guard); still config-time, no
        # deep-kernel traceback.
        return
    ref = oracle_multiband(L32, R32, cfg)
    _assert_parity(ref, [np.asarray(g) for g in got],
                   60.0, f"sharded seed={seed} {params}")


@pytest.mark.parametrize("seed", range(BASE_SEED + 4000, BASE_SEED + 4000 + N_POOL))
def test_fuzz_pool(seed):
    # Random streaming configs through make_stream_pool (auto engine):
    # a pooled stream must match the block-streaming oracle exactly
    # like a dedicated engine would.
    from upmix.models.streaming import make_stream_pool

    rng = np.random.default_rng(seed)
    sr = SRS[rng.integers(len(SRS))]
    hw = int(2 ** rng.integers(6, 9))
    params = dict(
        band_edges=_draw_edges(rng, sr),
        sr=sr,
        window=_draw_window(rng, seed),
        xover_mode=("raised_cosine", "hard_zero")[rng.integers(2)],
        synthesis=("wola", "analysis")[rng.integers(2)],
        bin_rounding=("python", "cpp")[rng.integers(2)],
    )
    try:
        cfg = UpmixConfig.streaming(hw_block_size=hw, **params)
        pool = make_stream_pool(cfg, hw, n_streams=8)
    except ValueError:
        return
    n_blocks = 12
    L, R = make_stereo(n_blocks * hw, sr, seed=seed, kind="mix")
    L32, R32 = L.astype(np.float32), R.astype(np.float32)
    ref_l, ref_r = oracle_stream_multiband(L32, R32, cfg, hw)
    outs = []
    zeros = np.zeros((8, hw), np.float32)
    for b in range(n_blocks):
        bl, br = zeros.copy(), zeros.copy()
        bl[0] = L32[b * hw : (b + 1) * hw]
        br[0] = R32[b * hw : (b + 1) * hw]
        c, ls, rs = pool.push_blocks(bl, br)
        c, ls, rs = (np.asarray(a)[0] for a in (c, ls, rs))
        outs.append((ls + 0.5 * c, rs + 0.5 * c))
    got_l = np.concatenate([o[0] for o in outs])
    got_r = np.concatenate([o[1] for o in outs])
    ctx = f"pool seed={seed} hw={hw} engine={type(pool).__name__} {params}"
    for name, r, g in (("outL", ref_l, got_l), ("outR", ref_r, got_r)):
        assert np.all(np.isfinite(g)), f"{ctx} {name}: non-finite"
        s = snr_db(r, g)
        assert s > 60.0, f"{ctx} {name}: SNR {s:.1f} dB"


@pytest.mark.parametrize("seed", range(BASE_SEED + 5000, BASE_SEED + 5000 + N_AOT))
def test_fuzz_aot_offline_roundtrip(seed, tmp_path):
    # Random configs survive the AOT export/load cycle: the loaded
    # artifact must hold the same oracle contract as the live pipeline.
    from upmix import aot

    params = _draw(seed)
    cfg = _build_or_reject(params)
    if cfg is None:
        return
    rng = np.random.default_rng(seed)
    n = 2 * params["max_block_size"] + int(rng.integers(1, 300))
    path = str(tmp_path / "fuzz.upmixaot")
    aot.save_offline(path, cfg, n)
    art = aot.load(path)
    L, R = make_stereo(n, cfg.sr, seed=seed, kind="mix")
    L32, R32 = L.astype(np.float32), R.astype(np.float32)
    ref = oracle_multiband(L32, R32, cfg)
    got = art.process_np(L32, R32)
    _assert_parity(ref, got, 60.0, f"aot seed={seed} {params}")


@pytest.mark.parametrize("seed", range(BASE_SEED + 2000, BASE_SEED + 2000 + N_NATIVE))
def test_fuzz_native(seed):
    native = pytest.importorskip("upmix.native")
    if not native.is_available():
        pytest.skip("native lib unavailable")
    rng = np.random.default_rng(seed)
    sr = SRS[rng.integers(len(SRS))]
    hw = int(2 ** rng.integers(6, 9))
    window = _draw_window(rng, seed)
    edges = _draw_edges(rng, sr)
    kw = dict(
        xover_mode=("raised_cosine", "hard_zero")[rng.integers(2)],
        synthesis=("wola", "analysis")[rng.integers(2)],
        bin_rounding=("python", "cpp")[rng.integers(2)],
        window=window,
    )
    try:
        cfg = UpmixConfig.streaming(edges, sr=sr, hw_block_size=hw, **kw)
        eng = native.NativeStreamingUpmixer(edges, sr=sr, hw_block_size=hw, **kw)
    except ValueError:
        return
    n = 12 * hw
    L, R = make_stereo(n, sr, seed=seed, kind="mix")
    L32, R32 = L.astype(np.float32), R.astype(np.float32)
    ref = oracle_stream_multiband(L32, R32, cfg, hw)
    got = eng.process_signal(L32, R32, mix="stereo_sum")
    ctx = f"seed={seed} hw={hw} {kw} edges={edges}"
    for name, r, g in zip("outL outR".split(), ref, got):
        assert np.all(np.isfinite(np.asarray(g))), f"{ctx} {name}: non-finite"
        s = snr_db(r, g)
        assert s > 60.0, f"native {ctx} {name}: SNR {s:.1f} dB"


N_BATCH_MESH = 4


@pytest.mark.parametrize(
    "seed", range(BASE_SEED + 6000, BASE_SEED + 6000 + N_BATCH_MESH)
)
def test_fuzz_offline_batch_mesh(seed, tmp_path):
    # Random configs through the batched data-parallel path the CLI's
    # multi-file --mesh uses (app.run_offline_batch): ragged files
    # zero-padded to the batch max, stacked over a data=2,seq=4 mesh,
    # trimmed per file — every file's export must match its SOLO
    # unsharded run (same scaling semantics on both sides).
    from upmix.app import run_offline, run_offline_batch
    from upmix.io import read_wav, write_wav
    from upmix.parallel import make_mesh

    params = _draw(seed)
    cfg = _build_or_reject(params)
    if cfg is None:
        return
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(int(rng.integers(2, 4))):
        n = (int(rng.integers(2, 5)) * params["max_block_size"]
             + int(rng.integers(0, 997)))
        L, R = make_stereo(n, cfg.sr, seed=seed * 10 + i, kind="mix")
        p = tmp_path / f"f{i}.wav"
        write_wav(p, np.column_stack([L, R]).astype(np.float32) * 0.5,
                  int(cfg.sr))
        paths.append(p)
    kw = dict(params)
    kw.pop("sr")
    try:
        results = run_offline_batch(
            paths, make_mesh({"data": 2, "seq": 4}),
            out_dir=str(tmp_path / "batch"), **kw,
        )
    except ValueError:
        return  # clean geometry rejection (same contract as ShardedUpmixer)
    for p, res in zip(paths, results):
        solo = run_offline(p, out_dir=str(tmp_path / "solo"), **kw)
        ref, _sr = read_wav(solo.paths[0])
        got, _sr2 = read_wav(res.paths[0])
        assert got.shape == ref.shape, f"seed={seed} {p}"
        for ch in range(ref.shape[1]):
            s = snr_db(ref[:, ch], got[:, ch])
            assert s > 60.0, f"batch seed={seed} {p} ch{ch}: {s:.1f} dB"
