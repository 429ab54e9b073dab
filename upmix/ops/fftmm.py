"""Matmul-based FFT: the transform engine of the "mm" offline kernel.

A radix FFT makes O(log N) passes over the data.  The 2-stage
Cooley-Tukey factorization N = N1*N2 instead runs the transform as two
batched matmuls against small constant DFT matrices:

    x[n], n = n1*N2 + n2         (reshape to [N1, N2], row-major)
    A[k1, n2] = sum_n1 W_N1^{n1 k1} x[n1, n2]        -- matmul over n1
    B[k1, n2] = A * W_N^{n2 k1}                      -- elementwise twiddle
    X[k1, k2] = sum_n2 B[k1, n2] W_N2^{n2 k2}        -- matmul over n2

giving the full spectrum in the PERMUTED layout X[k1, k2] where the true
bin index is k = k1 + N1*k2.  Two matmuls + one elementwise pass instead
of log2(N) passes.  The pipeline never leaves the permuted layout:
per-band gain vectors are pre-permuted on the host, the center-extraction
mask is elementwise (layout-free), and the inverse transform consumes the
permuted layout directly, returning natural-order time samples.

Stereo packing: both real channels ride ONE complex transform
(z = L + i R); the unpack needs the conjugate-mirror Z[(-k) mod N], which
in the permuted layout is exactly `roll(flip(Z), 1)` on both axes.

Precision: every matmul here and in ops/dftmm.py runs at PRECISION (see
its comment); parity against the float64 NumPy oracle is held to the
60 dB bar by tests/test_fftmm.py and by bench.py's probes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np


def _split(n: int) -> tuple:
    """Factor n = n1 * n2 with n1, n2 as close to sqrt(n) as possible
    (both powers of two when n is)."""
    n1 = 1 << (int(math.log2(n)) // 2)
    return n1, n // n1


@dataclass(frozen=True)
class FftPlan:
    """Host-side constants for one transform size (complex64 matrices)."""

    n: int
    n1: int
    n2: int
    d1: np.ndarray  # [N1, N1] forward DFT matrix (W_N1^{k1 n1})
    d2: np.ndarray  # [N2, N2]
    tw: np.ndarray  # [N1, N2] twiddle W_N^{n2 k1}


@lru_cache(maxsize=None)
def make_plan(n: int) -> FftPlan:
    if n & (n - 1):
        raise ValueError(f"fftmm requires power-of-two size, got {n}")
    n1, n2 = _split(n)
    k1 = np.arange(n1)
    k2 = np.arange(n2)
    d1 = np.exp(-2j * np.pi * np.outer(k1, k1) / n1).astype(np.complex64)
    d2 = np.exp(-2j * np.pi * np.outer(k2, k2) / n2).astype(np.complex64)
    tw = np.exp(-2j * np.pi * np.outer(k1, k2) / n).astype(np.complex64)
    return FftPlan(n=n, n1=n1, n2=n2, d1=d1, d2=d2, tw=tw)


def bin_of(plan: FftPlan, k1, k2):
    """True FFT bin index of permuted-layout position (k1, k2)."""
    return k1 + plan.n1 * k2


def permute_bins(plan: FftPlan, vec: np.ndarray) -> np.ndarray:
    """Re-index a natural-order full-spectrum vector [n] into the permuted
    [N1, N2] layout (host-side; used for gain curves)."""
    k1 = np.arange(plan.n1)[:, None]
    k2 = np.arange(plan.n2)[None, :]
    return vec[k1 + plan.n1 * k2]


def half_to_full(vec_half: np.ndarray, n: int) -> np.ndarray:
    """Expand an rfft-style half-spectrum vector [n//2+1] (real gains) to
    the full conjugate-symmetric length [n]."""
    full = np.empty(n, dtype=vec_half.dtype)
    full[: n // 2 + 1] = vec_half
    full[n // 2 + 1 :] = vec_half[1 : n // 2][::-1]
    return full


# Matmul precision of every transform (this module and ops/dftmm.py).
# Measured on the H100 (PERF.md, bench.py flagship): HIGH ran 17% slower
# than HIGHEST and held 72 dB against the float64 oracle where HIGHEST
# held 136 dB, so HIGHEST is both the cheaper and the more accurate
# setting.  On the CPU both are plain f32.
PRECISION = jax.lax.Precision.HIGHEST


def fft_mm(x: jnp.ndarray, plan: FftPlan) -> jnp.ndarray:
    """Forward FFT of the trailing axis (length plan.n), any leading batch.

    x: [..., n] complex64 (or float32/complex mix — cast by caller).
    Returns the full spectrum in permuted layout [..., N1, N2].
    """
    n1, n2 = plan.n1, plan.n2
    xr = x.reshape(*x.shape[:-1], n1, n2)
    d1 = jnp.asarray(plan.d1)
    d2 = jnp.asarray(plan.d2)
    tw = jnp.asarray(plan.tw)
    a = jnp.einsum("ij,...jk->...ik", d1, xr, precision=PRECISION)
    b = a * tw
    return jnp.einsum("...ik,kl->...il", b, d2, precision=PRECISION)


def ifft_mm(z: jnp.ndarray, plan: FftPlan) -> jnp.ndarray:
    """Inverse FFT from permuted layout [..., N1, N2] back to natural-order
    time samples [..., n] (complex output; take .real/.imag as needed)."""
    n1, n2 = plan.n1, plan.n2
    d1c = jnp.asarray(np.conj(plan.d1))
    d2c = jnp.asarray(np.conj(plan.d2))
    twc = jnp.asarray(np.conj(plan.tw))
    a = jnp.einsum("...il,lk->...ik", z, d2c, precision=PRECISION)
    b = a * twc
    y = jnp.einsum("ji,...ik->...jk", d1c, b, precision=PRECISION)
    return y.reshape(*z.shape[:-2], plan.n) * (1.0 / plan.n)


def conj_mirror(z: jnp.ndarray) -> jnp.ndarray:
    """Z[(-k) mod N] in the permuted layout (pure layout ops, no gather).

    With k = k1 + N1*k2, (-k) mod N maps to (N1-k1, N2-1-k2) for k1 > 0
    but to (0, (N2-k2) mod N2) on the k1 = 0 row — flip+roll on the k1
    axis, flip on the k2 axis, with the first row additionally rolled."""
    m = jnp.flip(z, axis=-1)
    m = jnp.roll(jnp.flip(m, axis=-2), 1, axis=-2)
    row0 = jnp.roll(m[..., 0:1, :], 1, axis=-1)
    return jnp.concatenate([row0, m[..., 1:, :]], axis=-2)


def stereo_rfft_mm(l: jnp.ndarray, r: jnp.ndarray, plan: FftPlan):
    """Both real channels through one packed complex transform.

    l, r: [..., n] float32.  Returns (specL, specR) full spectra in the
    permuted layout [..., N1, N2] complex64.
    """
    z = jax.lax.complex(l, r)
    Z = fft_mm(z, plan)
    Zm = jnp.conj(conj_mirror(Z))
    spec_l = 0.5 * (Z + Zm)
    spec_r = -0.5j * (Z - Zm)
    return spec_l, spec_r


def pair_irfft_mm(s0: jnp.ndarray, s1: jnp.ndarray, plan: FftPlan):
    """Two real-signal inverse transforms packed into one complex inverse.

    s0, s1: conjugate-symmetric full spectra in permuted layout.
    Returns (y0, y1) real time signals [..., n] float32.
    """
    y = ifft_mm(s0 + 1j * s1, plan)
    return jnp.real(y).astype(jnp.float32), jnp.imag(y).astype(jnp.float32)


def irfft_mm(s: jnp.ndarray, plan: FftPlan) -> jnp.ndarray:
    """Single real-signal inverse from permuted layout."""
    return jnp.real(ifft_mm(s, plan)).astype(jnp.float32)


# ---------------------------------------------------------------------------
# Banded transforms: column-restricted stage 2.
#
# Band-limited buckets keep only a narrow bin range [lo, hi] (plus its
# conjugate mirror) — in the permuted layout that is a handful of k2
# COLUMNS.  Restricting stage 2 to those columns is the exact-semantics
# equivalent of multirate sub-band decimation: stage-2 matmul, gain/mask
# elementwise work, and the inverse's first stage all shrink by
# ~N2/len(cols) (up to 128x for the low buckets of the default config).
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BandedPlan:
    base: FftPlan
    cols: tuple  # sorted k2 columns kept (len C)
    # position (into cols) of each column's mirror under the two maps:
    mirror_rows: tuple  # for k1 > 0 rows: pos of N2-1-c
    mirror_row0: tuple  # for the k1 = 0 row: pos of (N2-c) % N2

    @property
    def n_cols(self) -> int:
        return len(self.cols)

    @property
    def is_full(self) -> bool:
        return len(self.cols) == self.base.n2


@lru_cache(maxsize=None)
def make_banded_plan(n: int, lo_bin: int, hi_bin: int) -> BandedPlan:
    """Plan for spectra supported on bins [lo_bin, hi_bin] (half-spectrum
    indices, 0 <= lo <= hi <= n//2) and their conjugate mirrors.

    Kept columns = support columns plus their first-level mirror columns.
    Contract: `stereo_rfft_banded` output is only VALID on the support
    columns — mirror-only columns may hold garbage (their own mirrors are
    not kept).  In the pipeline that garbage is annihilated by the band
    gains, which are zero outside [lo_bin, hi_bin]; standalone users must
    mask to the support themselves.
    """
    base = make_plan(n)
    n1, n2 = base.n1, base.n2
    lo_bin = max(0, int(lo_bin))
    hi_bin = min(n // 2, int(hi_bin))
    bins = set(range(lo_bin, hi_bin + 1))
    bins |= {(-b) % n for b in list(bins)}
    support = {b // n1 for b in bins}
    cols = set(support)
    cols |= {(n2 - 1 - c) for c in support}
    cols |= {(n2 - c) % n2 for c in support}
    cols = tuple(sorted(cols))
    pos = {c: i for i, c in enumerate(cols)}
    # Mirror-of-mirror columns may be absent; point them anywhere (0) —
    # only support columns are contractually valid after unpacking.
    mirror_rows = tuple(pos.get((n2 - 1 - c), 0) for c in cols)
    mirror_row0 = tuple(pos.get((n2 - c) % n2, 0) for c in cols)
    return BandedPlan(base=base, cols=cols, mirror_rows=mirror_rows, mirror_row0=mirror_row0)


def permute_bins_banded(bp: BandedPlan, vec_full: np.ndarray) -> np.ndarray:
    """Re-index a natural-order full-spectrum vector into the banded
    permuted layout [N1, C] (host-side)."""
    k1 = np.arange(bp.base.n1)[:, None]
    k2 = np.asarray(bp.cols)[None, :]
    return vec_full[k1 + bp.base.n1 * k2]


def fft_banded(x: jnp.ndarray, bp: BandedPlan) -> jnp.ndarray:
    """Forward FFT keeping only the planned k2 columns: [..., n] ->
    [..., N1, C]."""
    plan = bp.base
    n1, n2 = plan.n1, plan.n2
    xr = x.reshape(*x.shape[:-1], n1, n2)
    a = jnp.einsum("ij,...jk->...ik", jnp.asarray(plan.d1), xr, precision=PRECISION)
    b = a * jnp.asarray(plan.tw)
    d2c = jnp.asarray(plan.d2[:, list(bp.cols)])  # [N2, C]
    return jnp.einsum("...ik,kl->...il", b, d2c, precision=PRECISION)


def ifft_banded(z: jnp.ndarray, bp: BandedPlan) -> jnp.ndarray:
    """Inverse from the banded layout [..., N1, C] to time [..., n]
    (complex; spectra must be zero outside the planned columns)."""
    plan = bp.base
    d2r = jnp.asarray(np.conj(plan.d2[:, list(bp.cols)]).T)  # [C, N2]
    a = jnp.einsum("...il,lk->...ik", z, d2r, precision=PRECISION)
    b = a * jnp.asarray(np.conj(plan.tw))
    y = jnp.einsum("ji,...ik->...jk", jnp.asarray(np.conj(plan.d1)), b, precision=PRECISION)
    return y.reshape(*z.shape[:-2], plan.n) * (1.0 / plan.n)


def conj_mirror_banded(z: jnp.ndarray, bp: BandedPlan) -> jnp.ndarray:
    """Z[(-k) mod N] within the banded layout (static gathers only)."""
    rows = jnp.flip(z[..., 1:, :], axis=-2)  # row r holds Z[N1-1-r] -> Z[N1-k1]
    rows = rows[..., :, jnp.asarray(bp.mirror_rows)]
    row0 = z[..., 0:1, jnp.asarray(bp.mirror_row0)]
    return jnp.concatenate([row0, rows], axis=-2)


def stereo_rfft_banded(l: jnp.ndarray, r: jnp.ndarray, bp: BandedPlan):
    """Packed stereo forward transform in the banded layout."""
    Z = fft_banded(jax.lax.complex(l, r), bp)
    Zm = jnp.conj(conj_mirror_banded(Z, bp))
    return 0.5 * (Z + Zm), -0.5j * (Z - Zm)


def pair_irfft_banded(s0: jnp.ndarray, s1: jnp.ndarray, bp: BandedPlan):
    y = ifft_banded(s0 + 1j * s1, bp)
    return jnp.real(y).astype(jnp.float32), jnp.imag(y).astype(jnp.float32)


def irfft_banded(s: jnp.ndarray, bp: BandedPlan) -> jnp.ndarray:
    return jnp.real(ifft_banded(s, bp)).astype(jnp.float32)


# ---------------------------------------------------------------------------
# Real structure-of-arrays banded transforms — the production STFT kernel.
#
# Complex-dtype matmuls cost four real matmuls plus interleaved layouts,
# and the packed-stereo trick needs full-spectrum mirrors.  For REAL
# signals the whole dance is unnecessary: keep re/im as separate f32
# tensors (every matmul is a plain f32 matmul), keep only HALF-spectrum
# support columns, and synthesize with a real-part-only inverse
# (y = 2/N * Re[sum over supported bins], with DC/Nyquist half-weights
# folded into a precomputed spectral weight).  Per real channel:
# forward = 2 full matmuls + tiny banded stage-2; inverse = tiny banded
# stage-A + 2 full matmuls.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RealBandedPlan:
    n: int
    n1: int
    n2: int
    cols: tuple  # contiguous half-spectrum k2 columns kept
    d1r: np.ndarray  # [N1, N1] cos(2 pi k1 n1 / N1)
    d1i: np.ndarray  # [N1, N1] -sin(...)   (forward DFT imag part)
    twr: np.ndarray  # [N1, N2]
    twi: np.ndarray  # [N1, N2]
    d2r: np.ndarray  # [N2, C] forward stage-2, kept columns
    d2i: np.ndarray  # [N2, C]
    e2r: np.ndarray  # [C, N2] inverse stage-A (conj(D2) rows at cols)
    e2i: np.ndarray  # [C, N2]
    winv: np.ndarray  # [N1, C] synthesis weights: 2/N, halved at DC/Nyquist,
    #                   zero at bins outside the half spectrum

    @property
    def n_cols(self) -> int:
        return len(self.cols)


@lru_cache(maxsize=None)
def make_real_banded_plan(
    n: int, lo_bin: int, hi_bin: int, n1: int | None = None
) -> RealBandedPlan:
    """Plan for real signals whose spectra are processed only on
    half-spectrum bins [lo_bin, hi_bin] (0 <= lo <= hi <= n//2).

    n1 overrides the stage split: per transform point, stage 1 costs
    ~N1 MACs while the banded stage 2 costs ~kept_bins/N1 * N2-contraction
    (≈ independent of N1), so narrow supports favor N1 < sqrt(n) down to
    the size where the matmuls stop being efficient (~128)."""
    if n & (n - 1):
        raise ValueError(f"fftmm requires power-of-two size, got {n}")
    if n1 is None:
        n1, n2 = _split(n)
    else:
        if n % n1:
            raise ValueError(f"n1={n1} must divide n={n}")
        n2 = n // n1
    lo_bin = max(0, int(lo_bin))
    hi_bin = min(n // 2, int(hi_bin))
    c0, c1 = lo_bin // n1, hi_bin // n1
    cols = tuple(range(c0, c1 + 1))

    k1 = np.arange(n1)
    a1 = 2 * np.pi * np.outer(k1, k1) / n1
    d1r = np.cos(a1).astype(np.float32)
    d1i = (-np.sin(a1)).astype(np.float32)
    k2f = np.arange(n2)
    atw = 2 * np.pi * np.outer(k1, k2f) / n
    twr = np.cos(atw).astype(np.float32)
    twi = (-np.sin(atw)).astype(np.float32)
    a2 = 2 * np.pi * np.outer(k2f, np.asarray(cols)) / n2
    d2r = np.cos(a2).astype(np.float32)
    d2i = (-np.sin(a2)).astype(np.float32)
    # inverse stage A: conj(D2)[cols, n2] = exp(+2 pi i cols n2 / n2)
    e2r = d2r.T.copy()
    e2i = (-d2i.T).copy()

    bins = k1[:, None] + n1 * np.asarray(cols)[None, :]  # [N1, C]
    w = np.full((n1, len(cols)), 2.0 / n, dtype=np.float32)
    w[bins == 0] = 1.0 / n
    w[bins == n // 2] = 1.0 / n
    w[bins > n // 2] = 0.0
    return RealBandedPlan(
        n=n, n1=n1, n2=n2, cols=cols,
        d1r=d1r, d1i=d1i, twr=twr, twi=twi,
        d2r=d2r, d2i=d2i, e2r=e2r, e2i=e2i, winv=w,
    )


def permute_half_bins(plan: RealBandedPlan, half_vec: np.ndarray) -> np.ndarray:
    """Map an rfft half-spectrum vector [n//2+1] into the plan's [N1, C]
    layout; positions holding bins > n//2 get zero (host-side)."""
    k1 = np.arange(plan.n1)[:, None]
    bins = k1 + plan.n1 * np.asarray(plan.cols)[None, :]
    out = np.zeros(bins.shape, dtype=half_vec.dtype)
    valid = bins <= plan.n // 2
    out[valid] = half_vec[bins[valid]]
    return out


def _mm(a, b):
    return jnp.einsum("ij,...jk->...ik", a, b, precision=PRECISION)


def _mmr(a, b):
    return jnp.einsum("...ik,kl->...il", a, b, precision=PRECISION)


def rfft_real_banded(x: jnp.ndarray, plan: RealBandedPlan):
    """Forward real transform: x [..., n] f32 -> (re, im) [..., N1, C].

    Values at positions whose bin exceeds n//2 (top rows of the last
    column) are garbage; the pipeline's gains are zero there by
    construction of permute_half_bins.
    """
    xr = x.reshape(*x.shape[:-1], plan.n1, plan.n2)
    ar = _mm(jnp.asarray(plan.d1r), xr)
    ai = _mm(jnp.asarray(plan.d1i), xr)
    br = ar * jnp.asarray(plan.twr) - ai * jnp.asarray(plan.twi)
    bi = ar * jnp.asarray(plan.twi) + ai * jnp.asarray(plan.twr)
    xre = _mmr(br, jnp.asarray(plan.d2r)) - _mmr(bi, jnp.asarray(plan.d2i))
    xim = _mmr(br, jnp.asarray(plan.d2i)) + _mmr(bi, jnp.asarray(plan.d2r))
    return xre, xim


def irfft_real_banded(sre: jnp.ndarray, sim: jnp.ndarray, plan: RealBandedPlan):
    """Inverse to a real signal from banded half spectra [..., N1, C]
    (synthesis weights applied internally) -> [..., n] f32."""
    w = jnp.asarray(plan.winv)
    sre = sre * w
    sim = sim * w
    tr = _mmr(sre, jnp.asarray(plan.e2r)) - _mmr(sim, jnp.asarray(plan.e2i))
    ti = _mmr(sre, jnp.asarray(plan.e2i)) + _mmr(sim, jnp.asarray(plan.e2r))
    # conj(tw) twiddle
    twr = jnp.asarray(plan.twr)
    twi = jnp.asarray(plan.twi)
    ur = tr * twr + ti * twi
    ui = ti * twr - tr * twi
    # y = Re[conj(D1) @ u] = d1r @ ur + d1i @ ui   (conj flips d1i's sign,
    # and Re keeps d1r*ur - (-d1i)*ui)
    y = _mm(jnp.asarray(plan.d1r), ur) + _mm(jnp.asarray(plan.d1i), ui)
    return y.reshape(*sre.shape[:-2], plan.n)
