"""Band-limit gain curve semantics vs a literal transcription of the
reference's in-place filter loops (center_extraction.py:273-351)."""

import numpy as np
import pytest

from upmix.config import BandSpec, freq_to_bin
from upmix.ops.gains import band_gain_curve


def _reference_filter(spec: np.ndarray, band: BandSpec) -> np.ndarray:
    """Scalar transcription of _band_limit + _raised_cosine_filter /
    _hard_zero_filter applied to a ones-spectrum, yielding the effective
    gain curve."""
    spec = spec.copy()
    n_bins = len(spec)
    fft_size = (n_bins - 1) * 2
    bin_low = freq_to_bin(band.f_low, band.sr, fft_size)
    bin_high = freq_to_bin(band.f_high, band.sr, fft_size)
    if bin_low > bin_high:
        bin_low, bin_high = bin_high, bin_low

    if band.xover_mode == "hard_zero":
        spec[:bin_low] = 0
        spec[bin_high + 1 :] = 0
        return spec

    # raised cosine
    bin_low = max(bin_low, 0)
    bin_high = min(bin_high, n_bins - 1)
    if bin_low > bin_high:
        spec[:] = 0
        return spec
    fade_bins_low = freq_to_bin(band.xover_width_low_hz, band.sr, fft_size)
    fade_bins_high = freq_to_bin(band.xover_width_high_hz, band.sr, fft_size)
    if band.f_low > 0:
        fade_in_start = max(0, bin_low - fade_bins_low)
        spec[:fade_in_start] = 0
        if fade_in_start < bin_low:
            fade_in_len = bin_low - fade_in_start
            for i in range(fade_in_len):
                x = (i + 0.5) / fade_in_len
                spec[fade_in_start + i] *= 0.5 * (1.0 - np.cos(np.pi * x))
    if band.f_high < band.sr * 0.5:
        fade_out_start = bin_high + 1
        fade_out_end = fade_out_start + fade_bins_high
        if fade_out_start < n_bins:
            fade_out_end = min(fade_out_end, n_bins)
            fade_out_len = fade_out_end - fade_out_start
            for i in range(fade_out_len):
                x = (i + 0.5) / fade_out_len
                spec[fade_out_start + i] *= 0.5 * (1.0 + np.cos(np.pi * x))
            if fade_out_end < n_bins:
                spec[fade_out_end:] = 0
    return spec


def _band(f_low, f_high, sr=8000.0, block=256, mode="raised_cosine", wl=50.0, wh=50.0):
    return BandSpec(
        f_low=f_low,
        f_high=f_high,
        sr=sr,
        block_size=block,
        xover_mode=mode,
        xover_width_low_hz=wl,
        xover_width_high_hz=wh,
    )


@pytest.mark.parametrize(
    "band",
    [
        _band(0.0, 400.0, wh=100.0),  # bottom band: no low fade
        _band(400.0, 1600.0, wl=100.0, wh=400.0),  # interior band, live fades
        _band(1600.0, 4000.0, wl=400.0, wh=0.0),  # top band to Nyquist
        _band(0.0, 4000.0, wh=0.0),  # full range: all ones
        _band(300.0, 350.0, wl=300.0, wh=350.0),  # fades wider than passband
        _band(0.0, 400.0, mode="hard_zero"),
        _band(400.0, 1600.0, mode="hard_zero"),
        _band(5000.0, 6000.0),  # entirely above Nyquist → silence
        _band(7.0, 9.0, wl=1.0, wh=1.0),  # passband narrower than a bin
    ],
)
def test_gain_curve_matches_reference_semantics(band):
    curve = band_gain_curve(band, dtype=np.float64)
    ref = _reference_filter(np.ones(band.n_bins, dtype=np.float64), band)
    np.testing.assert_allclose(curve, ref, rtol=0, atol=1e-15)


def test_full_range_band_is_transparent():
    band = _band(0.0, 4000.0)
    np.testing.assert_array_equal(band_gain_curve(band), np.ones(band.n_bins, np.float32))


def test_unknown_mode_falls_back_to_hard_zero():
    # center_extraction.py:349-351
    a = band_gain_curve(_band(400.0, 1600.0, mode="hard_zero"))
    b = band_gain_curve(_band(400.0, 1600.0, mode="mystery"))
    np.testing.assert_array_equal(a, b)


def test_adjacent_bands_crossfade_complementary():
    # At a shared boundary with matching widths, the fade-out of the lower
    # band and the fade-in of the upper band sum to ~1 (power-preserving
    # LR4-style handoff emulation).
    sr, block, fc, width = 8000.0, 512, 1000.0, 250.0
    lo = _band(0.0, fc, sr=sr, block=block, wh=width)
    hi = _band(fc, sr / 2, sr=sr, block=block, wl=width, wh=0.0)
    g = band_gain_curve(lo, np.float64) + band_gain_curve(hi, np.float64)
    # Fade zones are disjoint: lower band fades out ABOVE fc, upper band
    # fades in BELOW fc, so the sum is exactly 1 outside, and within each
    # fade zone: alpha_out(x) + alpha_in(x) where both ramps are evaluated
    # on the same bins... overlapping region is [fc-width, fc+width].
    assert g.min() >= 0.99 and g.max() <= 2.01
