"""Host-side FIR crossover design parity (reference filter_design.py)."""

import numpy as np
import pytest

from upmix.filter_design import (
    _firwin_fallback,
    apply_fir_filter,
    design_lr4_hp_fir,
    design_lr4_lp_fir,
)


def test_passthrough_for_nonpositive_cutoff():
    np.testing.assert_array_equal(design_lr4_hp_fir(44100, 0.0), [1.0])
    np.testing.assert_array_equal(design_lr4_lp_fir(44100, -5.0), [1.0])
    x = np.random.default_rng(0).standard_normal(100)
    np.testing.assert_allclose(apply_fir_filter(x, np.array([1.0])), x)


def test_lp_hp_frequency_response():
    sr, fc = 44100.0, 180.0
    lp = design_lr4_lp_fir(sr, fc)
    hp = design_lr4_hp_fir(sr, fc)
    assert len(lp) == len(hp) == 1025
    w = np.fft.rfftfreq(8192, 1 / sr)
    LP = np.abs(np.fft.rfft(lp, 8192))
    HP = np.abs(np.fft.rfft(hp, 8192))
    # DC / Nyquist behavior
    assert LP[0] == pytest.approx(1.0, abs=1e-3)
    assert HP[0] < 5e-3  # Hamming stopband leakage at this low cutoff
    assert LP[-1] < 5e-3
    assert HP[-1] == pytest.approx(1.0, abs=1e-3)
    # -6 dB-ish at cutoff (LR4-style complementary crossover)
    k = np.argmin(np.abs(w - fc))
    assert 0.3 < LP[k] < 0.7 and 0.3 < HP[k] < 0.7


def test_fallback_matches_scipy():
    # The dependency-free windowed-sinc fallback should match scipy's
    # firwin construction closely (same Hamming-windowed type-I design).
    pytest.importorskip("scipy")
    from scipy.signal import firwin

    for pass_zero in (True, False):
        ours = _firwin_fallback(257, 0.2, pass_zero)
        theirs = firwin(257, 0.2, pass_zero=pass_zero, window="hamming")
        np.testing.assert_allclose(ours, theirs, atol=1e-9)


def test_apply_fir_filter_length_and_linearity():
    x = np.random.default_rng(1).standard_normal(500)
    taps = design_lr4_lp_fir(8000.0, 500.0, numtaps=101)
    y = apply_fir_filter(x, taps)
    assert len(y) == len(x)
    y2 = apply_fir_filter(2 * x, taps)
    np.testing.assert_allclose(y2, 2 * y, rtol=1e-6, atol=1e-9)
