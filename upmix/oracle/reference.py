"""NumPy oracle: a faithful, sequential re-derivation of the reference
algorithm used as the golden model in tests.

Numerical semantics match python-prototype/center_extraction.py exactly:
float64 spectra (NumPy rfft of float64-promoted windowed blocks), float64
mask math with EPS = 1e-12, irfft cast to float32 *before* the synthesis
window multiply, float32 overlap-add accumulators, the reference's exact
padding/flush/trim bookkeeping, and per-band results summed in float32.

Structure is deliberately different from the reference (pure functions +
an explicit state record instead of a mutating class) — the semantics are
the contract, not the code.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from upmix.config import EPS, BandSpec, UpmixConfig
from upmix.ops.gains import band_gain_curve
from upmix.ops.windows import design_wola_synthesis_window, make_window


@dataclass
class OracleBandState:
    """Overlap-add accumulators for one band (cf. center_extraction.py:269-271)."""

    band: BandSpec
    analysis_window: np.ndarray
    synthesis_window: np.ndarray
    gain: np.ndarray  # float64 [n_bins]
    accum_c: np.ndarray
    accum_l: np.ndarray
    accum_r: np.ndarray

    @staticmethod
    def create(band: BandSpec, synthesis: str = "wola") -> "OracleBandState":
        aw = make_window(band.window, band.block_size)
        if synthesis == "wola":
            sw = design_wola_synthesis_window(aw, band.overlap)
        elif synthesis == "analysis":
            # C++ parity: synthesis window is the plain analysis window
            # (bela/upmix.cpp:200-201, README.md:95).
            sw = aw.copy()
        else:
            raise ValueError(f"unknown synthesis mode {synthesis!r}")
        zeros = lambda: np.zeros(band.block_size, dtype=np.float32)
        return OracleBandState(
            band=band,
            analysis_window=aw,
            synthesis_window=sw,
            gain=band_gain_curve(band, dtype=np.float64),
            accum_c=zeros(),
            accum_l=zeros(),
            accum_r=zeros(),
        )


def _mask_lcr(spec_l: np.ndarray, spec_r: np.ndarray):
    """Reference mask math in float64 (center_extraction.py:372-384)."""
    cross_mag = np.abs(spec_l * np.conjugate(spec_r))
    mag_l = np.abs(spec_l)
    mag_r = np.abs(spec_r)
    coherence = cross_mag / (mag_l * mag_r + EPS)
    balance = (mag_l - mag_r) / (mag_l + mag_r + EPS)
    factor = coherence * (1.0 - np.abs(balance))
    spec_c = 0.5 * factor * (spec_l + spec_r)
    return spec_c, spec_l - spec_c, spec_r - spec_c


def oracle_step(state: OracleBandState, blk_l: np.ndarray, blk_r: np.ndarray):
    """One hop: STFT → band-limit → mask → iSTFT×3 → OLA emit
    (cf. center_extraction.py:353-409)."""
    band = state.band
    hop = band.hop_size

    spec_l = np.fft.rfft(blk_l * state.analysis_window)
    spec_r = np.fft.rfft(blk_r * state.analysis_window)
    spec_l *= state.gain
    spec_r *= state.gain

    spec_c, spec_ls, spec_rs = _mask_lcr(spec_l, spec_r)

    for spec, accum in (
        (spec_c, state.accum_c),
        (spec_ls, state.accum_l),
        (spec_rs, state.accum_r),
    ):
        rec = np.fft.irfft(spec).astype(np.float32)
        accum += rec * state.synthesis_window

    chunks = []
    for accum in (state.accum_c, state.accum_l, state.accum_r):
        chunks.append(accum[:hop].copy())
        accum[:-hop] = accum[hop:]
        accum[-hop:] = 0.0
    return tuple(chunks)


def oracle_band_full(L: np.ndarray, R: np.ndarray, band: BandSpec, synthesis: str = "wola"):
    """Whole-signal single-band processing with the reference's exact
    padding, hop-loop, flush, and trim bookkeeping
    (center_extraction.py:426-472).  Returns (C, Ls, Rs) float32 of len(L)."""
    state = OracleBandState.create(band, synthesis=synthesis)
    n = len(L)
    block, hop = band.block_size, band.hop_size
    leftover = block - hop
    num_hops = math.ceil((n - leftover) / hop)
    padded = num_hops * hop + leftover
    pad = max(0, padded - n)
    Lp = np.concatenate([L, np.zeros(pad, dtype=L.dtype)])
    Rp = np.concatenate([R, np.zeros(pad, dtype=R.dtype)])

    out_c, out_l, out_r = [], [], []
    pos = 0
    while pos < len(Lp):
        blk_l = Lp[pos : pos + block]
        blk_r = Rp[pos : pos + block]
        if len(blk_l) < block:
            blk_l = np.concatenate([blk_l, np.zeros(block - len(blk_l), dtype=blk_l.dtype)])
            blk_r = np.concatenate([blk_r, np.zeros(block - len(blk_r), dtype=blk_r.dtype)])
        c, l, r = oracle_step(state, blk_l, blk_r)
        out_c.append(c)
        out_l.append(l)
        out_r.append(r)
        pos += hop

    # Flush: the reference emits the raw accumulators (center_extraction.py:411-424).
    out_c.append(state.accum_c.copy())
    out_l.append(state.accum_l.copy())
    out_r.append(state.accum_r.copy())

    return (
        np.concatenate(out_c)[:n],
        np.concatenate(out_l)[:n],
        np.concatenate(out_r)[:n],
    )


def oracle_multiband(L: np.ndarray, R: np.ndarray, config: UpmixConfig):
    """Sum of all bands' (C, Ls, Rs), float32 (center_extraction.py:477-513,
    sans thread pool — summation order is band order, as in the reference's
    main-thread join loop)."""
    n = len(L)
    total = [np.zeros(n, dtype=np.float32) for _ in range(3)]
    for band in config.bands:
        parts = oracle_band_full(L, R, band, synthesis=config.synthesis)
        for acc, part in zip(total, parts):
            acc += part
    return tuple(total)


def oracle_stream_multiband(
    L: np.ndarray,
    R: np.ndarray,
    config: UpmixConfig,
    hw_block_size: int,
):
    """Block-based streaming oracle mirroring the C++ engine's scheduling
    (bela/upmix.cpp:426-514): per hw block, each band buffers input, waits
    until stft*(hwBlock/hop) samples are available, then runs hwBlock/hop
    passes and contributes `side + 0.5*center` to the stereo output; bands
    that are not ready contribute silence.

    Returns (outL, outR) float32, same length as the input (truncated to a
    whole number of hw blocks, like a real-time device would).
    """
    n = (len(L) // hw_block_size) * hw_block_size
    out_l = np.zeros(n, dtype=np.float32)
    out_r = np.zeros(n, dtype=np.float32)

    streams = []
    for band in config.bands:
        if hw_block_size % band.hop_size != 0:
            raise ValueError("hw block size must be a multiple of every band hop")
        streams.append(
            {
                "state": OracleBandState.create(band, synthesis=config.synthesis),
                "buf_l": np.zeros(0, dtype=np.float32),
                "buf_r": np.zeros(0, dtype=np.float32),
                "consumed": 0,
            }
        )

    for start in range(0, n, hw_block_size):
        in_l = L[start : start + hw_block_size].astype(np.float32)
        in_r = R[start : start + hw_block_size].astype(np.float32)
        for s in streams:
            band = s["state"].band
            block, hop = band.block_size, band.hop_size
            s["buf_l"] = np.concatenate([s["buf_l"], in_l])
            s["buf_r"] = np.concatenate([s["buf_r"], in_r])
            passes = hw_block_size // hop
            needed = block * passes
            # fillCount semantics: written − hop per pass consumed
            # (bela/upmix.cpp:95-120, 232-237).
            fill = len(s["buf_l"]) - s["consumed"]
            if fill < needed:
                continue
            write = start
            for p in range(passes):
                rd = s["consumed"]
                blk_l = np.zeros(block, dtype=np.float32)
                blk_r = np.zeros(block, dtype=np.float32)
                avail = s["buf_l"][rd : rd + block]
                blk_l[: len(avail)] = avail
                availr = s["buf_r"][rd : rd + block]
                blk_r[: len(availr)] = availr
                c, l, r = oracle_step(s["state"], blk_l, blk_r)
                out_l[write : write + hop] += l + 0.5 * c
                out_r[write : write + hop] += r + 0.5 * c
                write += hop
                s["consumed"] += hop
    return out_l, out_r
