"""Edge-case hardening across paths: non-default overlaps, the C++
shipped 48 kHz config, the 8-band streaming clamp, and signal-class
invariants on the streaming engine."""

import numpy as np
import pytest

from upmix.config import MAX_BANDS_STREAM, UpmixConfig
from upmix.models.offline import Upmixer, upmix_offline
from upmix.models.streaming import StreamingUpmixer
from upmix.oracle import oracle_multiband

from helpers import make_stereo, snr_db


# 0.6 / 0.65 / 0.9 give hop ∤ block — the gather-framing mm path
# (regression for the round-1 reshape TypeError; reference accepts any
# overlap with hop >= 1, center_extraction.py:250-254).
@pytest.mark.parametrize("overlap", [0.5, 0.6, 0.65, 0.875, 0.9])
def test_offline_parity_other_overlaps(overlap):
    cfg = UpmixConfig.make(
        [0.0, 400.0, 1600.0], sr=8000.0, max_block_size=512, overlap=overlap
    )
    L, R = make_stereo(5000, cfg.sr, seed=0)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)
    ref = oracle_multiband(L32, R32, cfg)
    for kernel in ("xla", "mm"):
        got = upmix_offline(L32, R32, cfg, kernel=kernel)
        for name, r, g in zip("C Ls Rs".split(), ref, got):
            s = snr_db(r, g)
            assert s > 60.0, f"{kernel}/{name} @ overlap={overlap}: {s:.1f} dB"


def test_nondivisible_overlap_long_input_routes_to_whole_file():
    # Above the chunk threshold the mm kernel normally runs the chunked
    # scan; non-divisible overlaps must transparently fall back to the
    # whole-file gather program instead of crashing.
    from upmix.models.offline import build_offline_chunked_fn, build_offline_fn

    cfg = UpmixConfig.make([0.0, 400.0], sr=8000.0, max_block_size=256, overlap=0.6)
    n = 2**18 + 123
    fn = build_offline_fn(cfg, n, kernel="mm")
    L, R = make_stereo(n, cfg.sr, seed=7)
    c, ls, rs = fn(L.astype(np.float32), R.astype(np.float32))
    assert c.shape == (n,)
    with pytest.raises(ValueError, match="hop"):
        build_offline_chunked_fn(cfg, n)


def test_cpp_shipped_48k_config_offline():
    # The C++ reference's shipped config (0/500/2000/8000 @ 48 kHz) through
    # the offline path with streaming-style sizing.
    cfg = UpmixConfig.streaming(
        [0.0, 500.0, 2000.0, 8000.0], sr=48000.0, hw_block_size=2048
    )
    assert [b.block_size for b in cfg.bands] == [8192, 4096, 1024, 256]
    L, R = make_stereo(16384, cfg.sr, seed=1)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)
    ref = oracle_multiband(L32, R32, cfg)
    got = Upmixer(cfg).process_np(L32, R32)
    for r, g in zip(ref, got):
        assert snr_db(r, g) > 60.0


def test_streaming_band_clamp():
    # More than 8 bands requested -> clamped to 8 (bela/upmix.cpp:444-445).
    edges = [0, 50, 100, 200, 400, 800, 1200, 1600, 2000, 2400, 2800]
    cfg = UpmixConfig.streaming(edges, sr=8000.0, hw_block_size=256)
    assert len(cfg.bands) == MAX_BANDS_STREAM


def test_streaming_silence_and_mono():
    cfg = UpmixConfig.streaming([0.0, 400.0, 1600.0], sr=8000.0, hw_block_size=256)
    s = StreamingUpmixer(cfg, 256)
    z = np.zeros(8 * 256, np.float32)
    c, ls, rs = s.process_signal(z, z, mix="lcr")
    assert np.abs(np.asarray(c)).max() == 0.0
    assert np.abs(np.asarray(ls)).max() == 0.0

    rng = np.random.default_rng(2)
    m = rng.standard_normal(8 * 256).astype(np.float32)
    s.reset()
    c, ls, rs = s.process_signal(m, m, mix="lcr")
    # Mono input: sides are numerically zero (mask sends everything to C).
    assert np.abs(np.asarray(ls)).max() < 1e-4
    assert np.abs(np.asarray(rs)).max() < 1e-4


def test_native_create_destroy_loop():
    native = pytest.importorskip("upmix.native")
    if not native.is_available():
        pytest.skip("native lib not built")
    for _ in range(50):
        eng = native.NativeStreamingUpmixer([0.0, 400.0], sr=8000.0, hw_block_size=256)
        del eng


def test_single_sample_and_empty_guarded():
    cfg = UpmixConfig.make([0.0, 400.0], sr=8000.0, max_block_size=256)
    up = Upmixer(cfg)
    c, ls, rs = up.process_np(np.zeros(1, np.float32), np.zeros(1, np.float32))
    assert c.shape == (1,)
    with pytest.raises(Exception):
        up.process_np(np.zeros(0, np.float32), np.zeros(0, np.float32))


@pytest.mark.parametrize("sr", [22050.0, 96000.0])
def test_multi_sample_rate_parity(sr):
    cfg = UpmixConfig.make([0.0, sr / 20, sr / 5], sr=sr, max_block_size=512)
    L, R = make_stereo(5000, sr, seed=3)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)
    ref = oracle_multiband(L32, R32, cfg)
    got = upmix_offline(L32, R32, cfg, kernel="mm")
    for r, g in zip(ref, got):
        assert snr_db(r, g) > 60.0


@pytest.mark.parametrize(
    "window", ["blackman_harris", "sqrt_hann", "hann", "blackman", "hamming", "rect"]
)
def test_all_windows_parity(window):
    cfg = UpmixConfig.make(
        [0.0, 400.0], sr=8000.0, max_block_size=256, window=window
    )
    L, R = make_stereo(3000, cfg.sr, seed=4)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)
    ref = oracle_multiband(L32, R32, cfg)
    got = upmix_offline(L32, R32, cfg, kernel="mm")
    for r, g in zip(ref, got):
        assert snr_db(r, g) > 60.0


def test_edge_at_or_above_nyquist_rejected():
    # A lone edge at/above Nyquist pairs with nothing; config time must
    # reject it instead of returning zero bands that crash downstream.
    with pytest.raises(ValueError, match="Nyquist"):
        UpmixConfig.make([22050.0], sr=44100.0)
    with pytest.raises(ValueError, match="Nyquist"):
        UpmixConfig.make([30000.0], sr=44100.0)
    # An edge below Nyquist plus one at it is a valid single band.
    cfg = UpmixConfig.make([0.0, 22050.0], sr=44100.0, max_block_size=512)
    assert len(cfg.bands) == 1


def test_non_power_of_two_max_block_size():
    # The reference returns max_block_size verbatim for f_low <= 0
    # (center_extraction.py:193-197), so a non-pow2 cap produces a
    # non-pow2 block; the mm kernel must route it to a working transform
    # (direct DFT or the XLA FFT fallback), not crash inside fftmm.
    L, R = make_stereo(5000, 8000.0, seed=11)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)
    # hard_zero full-range band: kept bins = everything -> the wide-
    # support non-pow2 fallback; raised_cosine multiband -> direct path.
    for edges, xover in ([[0.0], "hard_zero"], [[0.0, 400.0], "raised_cosine"]):
        cfg = UpmixConfig.make(
            edges, sr=8000.0, max_block_size=3000, xover_mode=xover
        )
        assert cfg.bands[0].block_size == 3000
        ref = oracle_multiband(L32, R32, cfg)
        got = upmix_offline(L32, R32, cfg, kernel="mm")
        for name, r, g in zip("C Ls Rs".split(), ref, got):
            s = snr_db(r, g)
            assert s > 60.0, f"non-pow2 {xover}/{name}: {s:.1f} dB"


def test_non_power_of_two_long_input_routes_to_whole_file():
    from upmix.models.offline import build_offline_chunked_fn, build_offline_fn

    cfg = UpmixConfig.make(
        [0.0, 400.0], sr=8000.0, max_block_size=3000, xover_mode="raised_cosine"
    )
    n = 2**18 + 7
    fn = build_offline_fn(cfg, n, kernel="mm")  # must not pick the chunked scan
    L, R = make_stereo(n, cfg.sr, seed=12)
    c, ls, rs = fn(L.astype(np.float32), R.astype(np.float32))
    assert c.shape == (n,)
    with pytest.raises(ValueError, match="power-of-two"):
        build_offline_chunked_fn(cfg, n)


def test_chunked_fn_rejects_foreign_kernel():
    from upmix.models.offline import build_offline_chunked_fn

    cfg = UpmixConfig.make([0.0, 400.0], sr=8000.0, max_block_size=256)
    with pytest.raises(ValueError, match="kernel"):
        build_offline_chunked_fn(cfg, 4096, kernel="xla")


def test_streaming_bad_block_leaves_state_intact():
    # A wrong-length block must raise BEFORE dispatch and leave the
    # stream state untouched (no silent warmup restart on retry).
    cfg = UpmixConfig.streaming([0.0, 400.0], sr=8000.0, hw_block_size=256)
    rng = np.random.default_rng(5)
    blocks = rng.standard_normal((10, 256)).astype(np.float32) * 0.3

    ref_eng = StreamingUpmixer(cfg, 256)
    ref_out = [ref_eng.push_block(b, -b) for b in blocks]

    eng = StreamingUpmixer(cfg, 256)
    for b in blocks[:5]:
        eng.push_block(b, -b)
    with pytest.raises(ValueError, match="push_block"):
        eng.push_block(blocks[5][:100], blocks[5][:100])
    outs = [eng.push_block(b, -b) for b in blocks[5:]]
    for (c, ls, rs), (rc, rls, rrs) in zip(outs, ref_out[5:]):
        np.testing.assert_array_equal(np.asarray(c), np.asarray(rc))
        np.testing.assert_array_equal(np.asarray(ls), np.asarray(rls))


def test_random_config_fuzz_parity():
    # Deterministic bounded fuzz: random band edges / overlaps / sizing
    # caps, every draw must hold >60 dB parity vs the oracle on both
    # kernels.
    rng = np.random.default_rng(1234)
    for trial in range(8):
        sr = float(rng.choice([8000, 16000, 22050, 44100, 96000]))
        n_edges = int(rng.integers(1, 5))
        edges = [0.0] + sorted(
            float(f) for f in rng.uniform(sr * 0.01, sr * 0.45, size=n_edges)
        )
        # Includes non-divisible hops (0.6, 0.9) so the gather-framing mm
        # path stays covered.
        overlap = float(rng.choice([0.5, 0.6, 0.75, 0.9]))
        max_block = int(rng.choice([256, 512, 1024]))
        xover = str(rng.choice(["raised_cosine", "hard_zero"]))
        cfg = UpmixConfig.make(
            edges, sr=sr, overlap=overlap, max_block_size=max_block, xover_mode=xover
        )
        n = int(rng.integers(2000, 7000))
        L, R = make_stereo(n, sr, seed=trial)
        L32, R32 = L.astype(np.float32), R.astype(np.float32)
        ref = oracle_multiband(L32, R32, cfg)
        for kernel in ("xla", "mm"):
            got = upmix_offline(L32, R32, cfg, kernel=kernel)
            for name, r, g in zip("C Ls Rs".split(), ref, got):
                if np.max(np.abs(r)) < 1e-7:
                    continue
                s = snr_db(r, g)
                assert s > 60.0, (
                    f"trial {trial} {kernel}/{name}: {s:.1f} dB "
                    f"(edges={edges}, ov={overlap}, mb={max_block}, {xover})"
                )
