"""Visualization: golden checks on the arrays behind the plots plus
rendered-image sanity (round-1 verdict: these were smoke tests only).

The reference renders the WOLA invariant as a plot to eyeball
(center_extraction.py:585-640); here the same math is asserted.
"""

import numpy as np
import pytest

from upmix.ops.windows import design_wola_synthesis_window, make_blackman_harris
from upmix.visualize import (
    compare_upmix_vs_original,
    comparison_arrays,
    overlapped_window_sums,
    visualize_windows,
)


def test_wola_plot_math_golden():
    # The array the third panel plots must be ≈1.0 on the fully-overlapped
    # interior — the WOLA correctness invariant. If the synthesis design
    # or the plot math regresses, this fails.
    aw = make_blackman_harris(256)
    sw = design_wola_synthesis_window(aw, 0.75)
    asum, wsum = overlapped_window_sums(aw, sw, 0.75)
    L, hop = 256, 64
    interior = wsum[L - hop : -(L - hop)]  # region covered by all K frames
    np.testing.assert_allclose(interior, 1.0, atol=1e-3)
    # Analysis-window sum: at 75% overlap the BH4 cosine terms nearly
    # cancel; the interior sits at ~K*a0 = 4*0.35875.
    a_int = asum[L - hop : -(L - hop)]
    assert abs(a_int.mean() - 4 * 0.35875) < 0.02
    assert a_int.std() < 0.02


def test_wola_plot_math_detects_wrong_synthesis():
    # Using the analysis window as synthesis (C++-reference mode) must NOT
    # satisfy the ≈1.0 invariant — guards against the check going vacuous.
    aw = make_blackman_harris(256)
    asum, wsum = overlapped_window_sums(aw, aw, 0.75)
    interior = wsum[192:-192]
    # (BH^2 at 75% overlap sums to ~0.96-1.09: clearly outside the 1e-3
    # tolerance the WOLA-designed window meets.)
    assert np.abs(interior - 1.0).max() > 0.05


def test_comparison_arrays_golden():
    # A pure-center signal (L == R == tone): upmix sum ≈ original sum after
    # peak normalization, and the spectra peak at the tone bin.
    sr, n = 8000.0, 4096
    t = np.arange(n) / sr
    tone = np.sin(2 * np.pi * 500 * t).astype(np.float32)
    # Perfect extractor output for mono input: C = tone-ish, sides zero.
    tt, upmix, orig, freqs, up_spec, orig_spec = comparison_arrays(
        tone, np.zeros(n, np.float32), np.zeros(n, np.float32), tone, tone, sr
    )
    assert tt.shape == (n,) and freqs.shape == (n // 2 + 1,)
    np.testing.assert_allclose(upmix, orig, atol=1e-6)
    peak_bin = int(np.argmax(up_spec))
    assert abs(freqs[peak_bin] - 500.0) < sr / n + 1e-9
    assert np.argmax(orig_spec) == peak_bin


def _png_pixels(path):
    plt = pytest.importorskip("matplotlib.pyplot")
    return plt.imread(str(path))


def test_visualize_windows_renders_nonblank(tmp_path):
    pytest.importorskip("matplotlib")
    aw = make_blackman_harris(256)
    sw = design_wola_synthesis_window(aw, 0.75)
    out = visualize_windows(aw, sw, 0.75, save_path=tmp_path / "win.png")
    assert out is not None
    px = _png_pixels(tmp_path / "win.png")
    # Non-blank: real plot content varies the pixels.
    assert px.std() > 0.01


def test_compare_plot_renders_nonblank(tmp_path):
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(0)
    n = 2048
    C, Ls, Rs, L, R = (rng.standard_normal(n).astype(np.float32) for _ in range(5))
    compare_upmix_vs_original(C, Ls, Rs, L, R, 8000.0, save_path=tmp_path / "ab.png")
    px = _png_pixels(tmp_path / "ab.png")
    assert px.std() > 0.01
