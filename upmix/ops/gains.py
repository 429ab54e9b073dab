"""Band-limit gain curves.

The reference applies band limiting as in-place spectral mutation loops
(center_extraction.py:273-351).  Because the curve depends only on static
band parameters, this build precomputes each band's full [n_bins] gain
vector on the host at trace time; on device, band limiting is a single
broadcast multiply that XLA fuses into the surrounding mask math.

The "live-fade" raised-cosine semantics of the Python reference are
implemented here.  The C++ path (bela/upmix.cpp:310-361) zeroes the fade
zones before multiplying them — making its fades a no-op (verified; see
SURVEY.md §2.2) — so exact C++-parity band limiting is `hard_zero` with
`bin_rounding="cpp"`.
"""

from __future__ import annotations

import numpy as np

from upmix.config import BandSpec, freq_to_bin


def band_gain_curve(band: BandSpec, dtype=np.float32) -> np.ndarray:
    """Per-bin gain vector realizing the reference's band-limit semantics.

    hard_zero (center_extraction.py:273-281): unit passband
    [bin_low, bin_high], zero elsewhere.

    raised_cosine (center_extraction.py:282-332): half-cosine ramp-up over
    the fade zone below the passband (skipped when f_low == 0), unit
    passband, half-cosine ramp-down above (skipped when f_high >= sr/2),
    zero beyond the fades.
    """
    fft_size = band.block_size
    n_bins = band.n_bins
    r = band.bin_rounding
    bin_low = freq_to_bin(band.f_low, band.sr, fft_size, rounding=r)
    bin_high = freq_to_bin(band.f_high, band.sr, fft_size, rounding=r)
    if bin_low > bin_high:
        bin_low, bin_high = bin_high, bin_low

    g = np.ones(n_bins, dtype=np.float64)

    if band.xover_mode == "raised_cosine":
        _apply_raised_cosine(g, band, bin_low, bin_high, fft_size)
    else:
        # hard_zero, and the fallback for unknown modes
        # (center_extraction.py:349-351 defaults to hard zeroing).
        g[:bin_low] = 0.0
        g[bin_high + 1 :] = 0.0

    return g.astype(dtype)


def _apply_raised_cosine(
    g: np.ndarray, band: BandSpec, bin_low: int, bin_high: int, fft_size: int
) -> None:
    n_bins = len(g)
    bin_low = max(bin_low, 0)
    bin_high = min(bin_high, n_bins - 1)
    if bin_low > bin_high:
        # Degenerate band entirely above Nyquist → silence
        # (center_extraction.py:294-297).
        g[:] = 0.0
        return

    r = band.bin_rounding
    fade_bins_low = freq_to_bin(band.xover_width_low_hz, band.sr, fft_size, rounding=r)
    fade_bins_high = freq_to_bin(band.xover_width_high_hz, band.sr, fft_size, rounding=r)

    if band.f_low > 0:
        fade_in_start = max(0, bin_low - fade_bins_low)
        g[:fade_in_start] = 0.0
        fade_in_len = bin_low - fade_in_start
        if fade_in_len > 0:
            x = (np.arange(fade_in_len) + 0.5) / fade_in_len
            g[fade_in_start:bin_low] = 0.5 * (1.0 - np.cos(np.pi * x))

    if band.f_high < band.sr * 0.5:
        fade_out_start = bin_high + 1
        fade_out_end = min(fade_out_start + fade_bins_high, n_bins)
        if fade_out_start < n_bins:
            fade_out_len = fade_out_end - fade_out_start
            x = (np.arange(fade_out_len) + 0.5) / fade_out_len
            g[fade_out_start:fade_out_end] = 0.5 * (1.0 + np.cos(np.pi * x))
            g[fade_out_end:] = 0.0
