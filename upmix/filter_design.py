"""Host-side LR4-approximating FIR crossover design.

Parity with the reference's standalone utility
(python-prototype/filter_design.py:25-60): Hamming-windowed FIR high/low
pass, default 1025 taps at 180 Hz, pass-through [1.0] for cutoff <= 0,
applied as a causal FIR.  Per the design stance (SURVEY.md §3.4)
this stays host-side.  scipy is used when present; a
dependency-free windowed-sinc fallback produces the same taps to ~1e-9.
"""

from __future__ import annotations

import numpy as np

try:
    from scipy.signal import firwin as _scipy_firwin
    from scipy.signal import lfilter as _scipy_lfilter

    _HAVE_SCIPY = True
except ImportError:  # pragma: no cover - env without scipy
    _HAVE_SCIPY = False


def _firwin_fallback(numtaps: int, cutoff: float, pass_zero: bool) -> np.ndarray:
    """Hamming-windowed sinc FIR, matching scipy.signal.firwin's
    construction (type-I, scaled so the passband reference gain is 1)."""
    m = np.arange(numtaps) - (numtaps - 1) / 2.0
    h = cutoff * np.sinc(cutoff * m)
    if not pass_zero:
        # Spectral inversion of the complementary low-pass: delta - lp
        h = -h
        h[(numtaps - 1) // 2] += 1.0
    h *= np.hamming(numtaps)
    # Normalize at the reference frequency (DC for LP; Nyquist for HP)
    if pass_zero:
        h /= h.sum()
    else:
        ref = (h * np.cos(np.pi * m)).sum()
        h /= ref
    return h


def design_lr4_hp_fir(sr: float, cutoff_hz: float = 180.0, numtaps: int = 1025) -> np.ndarray:
    """Approximate 4th-order Linkwitz–Riley high-pass FIR
    (filter_design.py:25-38).  cutoff <= 0 → pass-through [1.0]."""
    if cutoff_hz <= 0:
        return np.array([1.0], dtype=np.float32)
    norm = cutoff_hz / (0.5 * sr)
    if _HAVE_SCIPY:
        taps = _scipy_firwin(numtaps, norm, pass_zero=False, window="hamming")
    else:
        taps = _firwin_fallback(numtaps, norm, pass_zero=False)
    return taps.astype(np.float32)


def design_lr4_lp_fir(sr: float, cutoff_hz: float = 180.0, numtaps: int = 1025) -> np.ndarray:
    """Approximate 4th-order Linkwitz–Riley low-pass FIR
    (filter_design.py:40-53).  cutoff <= 0 → pass-through [1.0]."""
    if cutoff_hz <= 0:
        return np.array([1.0], dtype=np.float32)
    norm = cutoff_hz / (0.5 * sr)
    if _HAVE_SCIPY:
        taps = _scipy_firwin(numtaps, norm, pass_zero=True, window="hamming")
    else:
        taps = _firwin_fallback(numtaps, norm, pass_zero=True)
    return taps.astype(np.float32)


def apply_fir_filter(wave: np.ndarray, fir_taps: np.ndarray) -> np.ndarray:
    """Causal FIR filtering (filter_design.py:55-60): y = taps * x, same
    length as input."""
    if _HAVE_SCIPY:
        return _scipy_lfilter(fir_taps, 1.0, wave)
    full = np.convolve(wave, fir_taps)
    return full[: len(wave)]
