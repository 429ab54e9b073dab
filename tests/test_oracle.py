"""Oracle self-consistency: WOLA round-trip fidelity and mask identities
(the [verified] behaviors recorded in SURVEY.md §4/§6)."""

import numpy as np

from upmix.config import BandSpec, UpmixConfig
from upmix.oracle import oracle_band_full, oracle_multiband

from helpers import make_stereo, snr_db


def _full_band(sr=8000.0, block=512):
    return BandSpec(
        f_low=0.0,
        f_high=sr / 2,
        sr=sr,
        block_size=block,
        xover_mode="hard_zero",
    )


def test_wola_roundtrip_snr():
    # Steady-state WOLA round-trip measures ≈140 dB in float32 (SURVEY §6).
    # For mono (L == R): coherence=1, balance=0 → C reconstructs the input,
    # Ls = Rs ≈ 0.
    sr, block = 8000.0, 512
    band = _full_band(sr, block)
    L, R = make_stereo(8 * block, sr, kind="mono")
    C, Ls, Rs = oracle_band_full(L.astype(np.float32), R.astype(np.float32), band)
    lo, hi = block, len(L) - block  # exclude warm-up/tail transients
    assert snr_db(L[lo:hi], C[lo:hi]) > 120.0
    assert np.max(np.abs(Ls[lo:hi])) < 1e-5
    assert np.max(np.abs(Rs[lo:hi])) < 1e-5


def test_lcr_identity():
    # By construction Ls + C = WOLA(L) and Rs + C = WOLA(R): perfect
    # reconstruction of each input channel from its decomposition.
    sr, block = 8000.0, 512
    band = _full_band(sr, block)
    L, R = make_stereo(8 * block, sr, kind="mix", seed=3)
    C, Ls, Rs = oracle_band_full(L.astype(np.float32), R.astype(np.float32), band)
    lo, hi = block, len(L) - block
    assert snr_db(L[lo:hi], (Ls + C)[lo:hi]) > 120.0
    assert snr_db(R[lo:hi], (Rs + C)[lo:hi]) > 120.0


def test_anticorrelated_has_no_center():
    # L = -R → specL + specR = 0 → C = 0 regardless of the mask value.
    sr, block = 8000.0, 512
    band = _full_band(sr, block)
    L, R = make_stereo(8 * block, sr, kind="anticorrelated", seed=4)
    C, Ls, Rs = oracle_band_full(L.astype(np.float32), R.astype(np.float32), band)
    assert np.max(np.abs(C)) < 1e-6


def test_silence_yields_silence():
    sr, block = 8000.0, 256
    cfg = UpmixConfig.make([0.0, 400.0, 1600.0], sr=sr, max_block_size=block)
    L, R = make_stereo(2048, sr, kind="silence")
    C, Ls, Rs = oracle_multiband(L.astype(np.float32), R.astype(np.float32), cfg)
    assert np.max(np.abs(C)) == 0.0
    assert np.max(np.abs(Ls)) == 0.0


def test_multiband_bands_sum_to_full_reconstruction():
    # With hard-zero edges, adjacent bands partition the bins, so the
    # multiband (Ls + C) sum still reconstructs L (minus the bins lost to
    # rounding at shared edges, which hard_zero assigns to both or neither —
    # the shared edge bin is kept by BOTH bands; use disjoint-enough edges
    # where the boundary bin duplication is a tiny fraction of energy).
    sr = 8000.0
    cfg = UpmixConfig.make(
        [0.0, 397.0, 1601.0], sr=sr, max_block_size=512, xover_mode="hard_zero"
    )
    L, R = make_stereo(4096, sr, kind="mix", seed=5)
    C, Ls, Rs = oracle_multiband(L.astype(np.float32), R.astype(np.float32), cfg)
    lo, hi = 512, len(L) - 512
    # Boundary-bin duplication bounds attainable SNR; expect decent but not
    # perfect reconstruction.
    assert snr_db(L[lo:hi], (Ls + C)[lo:hi]) > 20.0
