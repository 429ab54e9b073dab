"""Direct parity against the ACTUAL reference implementation.

When the upstream snapshot is mounted (dev environments only), import the
reference's python-prototype and compare it function-for-function and
end-to-end against this framework's oracle and JAX pipeline.  This is the
strongest possible semantics proof — the oracle's claims are checked
against the real code, not a re-derivation of it.

Skipped when /root/reference is absent (the reference ships no package and
is not a runtime dependency).  The module is imported with a stubbed
`soundfile` (not installed here; the functions under test never touch it)
and a headless matplotlib.
"""

import os
import sys
import types

import numpy as np
import pytest

from helpers import make_stereo, snr_db

REF = "/root/reference/python-prototype"

if not os.path.isdir(REF):  # pragma: no cover - reference not mounted
    pytest.skip("reference snapshot not mounted", allow_module_level=True)


@pytest.fixture(scope="module")
def ce():
    # The reference imports soundfile (absent) and matplotlib (needs a
    # display) at module level; stub/redirect both before import.
    if "soundfile" not in sys.modules:
        sys.modules["soundfile"] = types.ModuleType("soundfile")
    import matplotlib

    matplotlib.use("Agg", force=True)
    sys.path.insert(0, REF)
    try:
        import center_extraction as mod
    finally:
        sys.path.remove(REF)
    return mod


def test_windows_match_reference(ce):
    from upmix.ops.windows import (
        design_wola_synthesis_window,
        make_blackman_harris,
        make_hann,
        make_sqrt_hann,
    )

    for n in (64, 256, 1024):
        np.testing.assert_allclose(
            make_blackman_harris(n), ce.make_blackman_harris(n), rtol=1e-6
        )
        np.testing.assert_allclose(make_hann(n), ce.make_hann(n), rtol=1e-6)
        np.testing.assert_allclose(
            make_sqrt_hann(n), ce.make_sqrt_hann(n), rtol=1e-6
        )
        aw = make_blackman_harris(n)
        ours = design_wola_synthesis_window(aw, 0.75)
        theirs = ce.design_wola_synthesis_window(aw, overlap=0.75)
        np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=1e-9)


def test_sizing_matches_reference(ce):
    from upmix.config import (
        compute_block_size_for_low_freq,
        freq_to_bin,
        hp_freq_to_crossover_width,
        next_power_of_2,
    )

    for x in (0, 1, 2, 3, 255, 256, 257, 65535):
        assert next_power_of_2(x) == ce.next_power_of_2(x)
    for f in (0.0, 20.0, 30.0, 119.9, 480.0, 7680.0, 22050.0):
        assert freq_to_bin(f, 44100.0, 4096) == ce.freq_to_bin(f, 44100.0, 4096)
        assert compute_block_size_for_low_freq(
            f, 44100.0
        ) == ce.compute_block_size_for_low_freq(f, 44100.0)
        assert hp_freq_to_crossover_width(f) == ce.hp_freq_to_crossover_width(f)


def test_oracle_matches_reference_end_to_end(ce):
    # Full multiband pipeline: the reference's chain_bands + in-memory
    # extraction vs our oracle on identical float32 input — these should
    # agree to float precision (the oracle encodes the same numerics).
    from upmix.config import UpmixConfig
    from upmix.oracle import oracle_multiband

    sr = 8000.0
    edges = [0.0, 400.0, 1600.0]
    L, R = make_stereo(5000, sr, seed=0)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)

    extractors = ce.chain_bands(
        band_edges=list(edges),
        overlap=0.75,
        window_func=ce.make_blackman_harris,
        sr=sr,
        xover_mode="raised_cosine",
    )
    ref_c, ref_ls, ref_rs = ce.extract_center_left_right_multi_band_in_memory(
        L32, R32, sr, extractors
    )

    cfg = UpmixConfig.make(edges, sr=sr)  # reference chain_bands is fixed at 2**16
    got = oracle_multiband(L32, R32, cfg)
    for name, r, g in zip(
        "C Ls Rs".split(), (ref_c, ref_ls, ref_rs), got
    ):
        s = snr_db(np.asarray(r), np.asarray(g))
        assert s > 100.0, f"oracle vs REAL reference, {name}: {s:.1f} dB"


def test_jax_pipeline_matches_reference_end_to_end(ce):
    # And the JAX pipeline itself against the real reference (>60 dB bar).
    from upmix.config import UpmixConfig
    from upmix.models.offline import upmix_offline

    sr = 8000.0
    edges = [0.0, 400.0, 1600.0]
    L, R = make_stereo(5000, sr, seed=1)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)

    extractors = ce.chain_bands(
        band_edges=list(edges),
        overlap=0.75,
        window_func=ce.make_blackman_harris,
        sr=sr,
        xover_mode="raised_cosine",
    )
    ref = ce.extract_center_left_right_multi_band_in_memory(L32, R32, sr, extractors)

    cfg = UpmixConfig.make(edges, sr=sr)  # reference chain_bands is fixed at 2**16
    got = upmix_offline(L32, R32, cfg)
    for name, r, g in zip("C Ls Rs".split(), ref, got):
        s = snr_db(np.asarray(r), np.asarray(g))
        assert s > 60.0, f"JAX vs REAL reference, {name}: {s:.1f} dB"


def test_oracle_matches_reference_default_44k_config(ce):
    # The headline configuration (main.py:62-73 defaults) end-to-end.
    from upmix.config import UpmixConfig
    from upmix.oracle import oracle_multiband

    sr = 44100.0
    edges = [0.0, 30.0, 120.0, 480.0, 1920.0, 7680.0]
    L, R = make_stereo(2**17, sr, seed=2)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)

    extractors = ce.chain_bands(
        band_edges=list(edges),
        overlap=0.75,
        window_func=ce.make_blackman_harris,
        sr=sr,
        xover_mode="raised_cosine",
    )
    ref = ce.extract_center_left_right_multi_band_in_memory(L32, R32, sr, extractors)
    got = oracle_multiband(L32, R32, UpmixConfig.make(edges, sr=sr))
    for name, r, g in zip("C Ls Rs".split(), ref, got):
        s = snr_db(np.asarray(r), np.asarray(g))
        assert s > 100.0, f"default config {name}: {s:.1f} dB"


def test_oracle_matches_reference_hard_zero(ce):
    from upmix.config import UpmixConfig
    from upmix.oracle import oracle_multiband

    sr = 8000.0
    edges = [0.0, 400.0, 1600.0]
    L, R = make_stereo(5000, sr, seed=3)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)
    extractors = ce.chain_bands(
        band_edges=list(edges),
        overlap=0.75,
        window_func=ce.make_blackman_harris,
        sr=sr,
        xover_mode="hard_zero",
    )
    ref = ce.extract_center_left_right_multi_band_in_memory(L32, R32, sr, extractors)
    got = oracle_multiband(
        L32, R32, UpmixConfig.make(edges, sr=sr, xover_mode="hard_zero")
    )
    for name, r, g in zip("C Ls Rs".split(), ref, got):
        s = snr_db(np.asarray(r), np.asarray(g))
        assert s > 100.0, f"hard_zero {name}: {s:.1f} dB"


def test_random_config_fuzz_vs_real_reference(ce):
    # Deterministic bounded fuzz where the ground truth is the ACTUAL
    # reference implementation (not our oracle): random rates, edges,
    # overlaps (including hop-not-dividing-block), windows, and crossover
    # modes.  The oracle must track the reference to float precision
    # (>100 dB) and the JAX pipeline must hold the >60 dB bar on every
    # draw.  chain_bands has no block-size cap parameter, so UpmixConfig
    # uses its matching default (2**16, center_extraction.py:173-197).
    from upmix.config import UpmixConfig
    from upmix.models.offline import upmix_offline
    from upmix.oracle import oracle_multiband

    windows = {
        "blackman_harris": ce.make_blackman_harris,
        "sqrt_hann": ce.make_sqrt_hann,
        "hann": ce.make_hann,
        "blackman": ce.make_blackman,
        "hamming": ce.make_hamming,
    }
    rng = np.random.default_rng(20260816)
    for trial in range(4):
        sr = float(rng.choice([8000, 16000, 22050, 44100]))
        n_edges = int(rng.integers(1, 4))
        edges = [0.0] + sorted(
            float(f) for f in rng.uniform(sr * 0.02, sr * 0.45, size=n_edges)
        )
        overlap = float(rng.choice([0.5, 0.6, 0.75, 0.875, 0.9]))
        wname = str(rng.choice(sorted(windows)))
        xover = str(rng.choice(["raised_cosine", "hard_zero"]))
        n = int(rng.integers(3000, 6000))
        L, R = make_stereo(n, sr, seed=100 + trial)
        L32, R32 = L.astype(np.float32), R.astype(np.float32)

        extractors = ce.chain_bands(
            band_edges=list(edges),
            overlap=overlap,
            window_func=windows[wname],
            sr=sr,
            xover_mode=xover,
        )
        ref = ce.extract_center_left_right_multi_band_in_memory(
            L32, R32, sr, extractors
        )

        cfg = UpmixConfig.make(
            edges, sr=sr, overlap=overlap, window=wname, xover_mode=xover
        )
        desc = f"trial {trial} (sr={sr}, edges={edges}, ov={overlap}, {wname}, {xover})"
        got_oracle = oracle_multiband(L32, R32, cfg)
        got_jax = upmix_offline(L32, R32, cfg, kernel="mm")
        for name, r, o, j in zip("C Ls Rs".split(), ref, got_oracle, got_jax):
            if np.max(np.abs(np.asarray(r))) < 1e-7:
                continue
            s_o = snr_db(np.asarray(r), np.asarray(o))
            assert s_o > 100.0, f"oracle vs REAL reference {name}: {s_o:.1f} dB {desc}"
            s_j = snr_db(np.asarray(r), np.asarray(j))
            assert s_j > 60.0, f"JAX vs REAL reference {name}: {s_j:.1f} dB {desc}"


def test_above_nyquist_edge_matches_reference(ce):
    # The reference accepts a top edge ABOVE Nyquist (bins simply clamp
    # and the upper fade is skipped since f_high >= sr/2,
    # center_extraction.py:318); both the oracle and the JAX pipeline
    # must track it.
    from upmix.config import UpmixConfig
    from upmix.models.offline import upmix_offline
    from upmix.oracle import oracle_multiband

    sr = 8000.0
    edges = [0.0, 500.0, 6000.0]  # 6000 > Nyquist (4000)
    L, R = make_stereo(5000, sr, seed=9)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)
    extractors = ce.chain_bands(
        band_edges=list(edges),
        overlap=0.75,
        window_func=ce.make_blackman_harris,
        sr=sr,
        xover_mode="raised_cosine",
    )
    ref = ce.extract_center_left_right_multi_band_in_memory(L32, R32, sr, extractors)
    cfg = UpmixConfig.make(edges, sr=sr)
    got_o = oracle_multiband(L32, R32, cfg)
    got_j = upmix_offline(L32, R32, cfg, kernel="mm")
    for name, r, o, j in zip("C Ls Rs".split(), ref, got_o, got_j):
        s_o = snr_db(np.asarray(r), np.asarray(o))
        assert s_o > 100.0, f"oracle above-Nyquist {name}: {s_o:.1f} dB"
        s_j = snr_db(np.asarray(r), np.asarray(j))
        assert s_j > 60.0, f"JAX above-Nyquist {name}: {s_j:.1f} dB"


@pytest.mark.parametrize("overlap", [0.6, 0.9])
def test_jax_pipeline_matches_reference_arbitrary_overlap(ce, overlap):
    # Round-2 regression: non-divisible overlaps (hop not dividing block)
    # run the gather-framing mm path; hold it against the REAL reference,
    # which accepts any overlap with hop >= 1 (center_extraction.py:250-254).
    from upmix.config import UpmixConfig
    from upmix.models.offline import upmix_offline

    sr = 8000.0
    edges = [0.0, 400.0, 1600.0]
    L, R = make_stereo(5000, sr, seed=2)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)

    extractors = ce.chain_bands(
        band_edges=list(edges),
        overlap=overlap,
        window_func=ce.make_blackman_harris,
        sr=sr,
        xover_mode="raised_cosine",
    )
    ref = ce.extract_center_left_right_multi_band_in_memory(L32, R32, sr, extractors)

    cfg = UpmixConfig.make(edges, sr=sr, overlap=overlap)
    got = upmix_offline(L32, R32, cfg, kernel="mm")
    for name, r, g in zip("C Ls Rs".split(), ref, got):
        s = snr_db(np.asarray(r), np.asarray(g))
        assert s > 60.0, f"JAX vs REAL reference @ overlap={overlap}, {name}: {s:.1f} dB"
