"""Window + WOLA design goldens (SURVEY.md §4 unit tier)."""

import numpy as np
import pytest

from upmix.config import EPS
from upmix.ops.windows import (
    design_wola_synthesis_window,
    make_blackman,
    make_blackman_harris,
    make_hamming,
    make_hann,
    make_rect,
    make_sqrt_hann,
    make_window,
)


def test_blackman_harris_coefficients():
    # Exact 4-term coefficients (reference center_extraction.py:48,
    # bela/upmix.cpp:61-64): endpoint value is a0 - a1 + a2 - a3.
    w = make_blackman_harris(1024)
    assert w.dtype == np.float32
    endpoint = 0.35875 - 0.48829 + 0.14128 - 0.01168
    assert abs(float(w[0]) - endpoint) < 1e-7
    assert abs(float(w[-1]) - endpoint) < 1e-7
    # Peak at the center, ~1.0 for even N at n=(N-1)/2 neighborhood
    assert 0.99 < float(w[511:513].max()) <= 1.0
    # Symmetry
    np.testing.assert_allclose(w, w[::-1], atol=2e-7)


@pytest.mark.parametrize(
    "name,fn",
    [
        ("sqrt_hann", make_sqrt_hann),
        ("hann", make_hann),
        ("blackman", make_blackman),
        ("hamming", make_hamming),
        ("rect", make_rect),
    ],
)
def test_window_registry(name, fn):
    np.testing.assert_array_equal(make_window(name, 256), fn(256))
    assert make_window(name, 256).dtype == np.float32


def test_unknown_window_raises():
    with pytest.raises(ValueError):
        make_window("kaiser", 256)


def _wola_reference_loop(aw: np.ndarray, overlap: float) -> np.ndarray:
    """Direct scalar transcription of the reference's O(L*K) design loop
    (center_extraction.py:98-103), used to pin the vectorized version."""
    L = len(aw)
    hop = int(L * (1.0 - overlap))
    K = int(round(1.0 / (1.0 - overlap)))
    sw = np.zeros(L, dtype=aw.dtype)
    for n in range(L):
        s = 0.0
        for k in range(K):
            s += aw[(n + k * hop) % L] ** 2
        sw[n] = aw[n] / (s + EPS)
    return sw


@pytest.mark.parametrize("N,overlap", [(256, 0.75), (512, 0.5), (128, 0.75)])
def test_wola_matches_reference_loop(N, overlap):
    aw = make_blackman_harris(N)
    sw = design_wola_synthesis_window(aw, overlap)
    ref = _wola_reference_loop(aw, overlap)
    # Summation order (pairwise vs sequential float64 accumulation) may
    # differ by one float32 ULP after the final cast.
    np.testing.assert_allclose(sw, ref, rtol=5e-7, atol=0)


@pytest.mark.parametrize("N,overlap", [(1024, 0.75), (4096, 0.75), (512, 0.5)])
def test_wola_cola_invariant(N, overlap):
    # Sum of K overlapped analysis*synthesis products ≈ 1 on the interior —
    # the COLA/WOLA invariant the reference only visualizes
    # (center_extraction.py:592-595,626-637), here as an assert.
    aw = make_blackman_harris(N)
    sw = design_wola_synthesis_window(aw, overlap)
    hop = int(N * (1 - overlap))
    K = int(round(1 / (1 - overlap)))
    total = N + (K - 1) * hop
    acc = np.zeros(total, dtype=np.float64)
    w = (aw * sw).astype(np.float64)
    for k in range(K):
        acc[k * hop : k * hop + N] += w
    interior = acc[(K - 1) * hop : N]
    np.testing.assert_allclose(interior, 1.0, atol=1e-4)


def test_wola_rejects_extreme_overlap():
    aw = make_blackman_harris(16)
    with pytest.raises(ValueError):
        design_wola_synthesis_window(aw, 1.0)
