"""Band configuration and sizing logic.

Re-derives the reference's band plumbing as hashable, trace-time-static
dataclasses (reference: python-prototype/center_extraction.py:142-212,
518-580 and bela/upmix.cpp:34-54, 495-506).  Everything here runs on the
host at configuration time; the device programs receive the results as
compile-time constants.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterable, Sequence

EPS = 1e-12

# Streaming (C++-parity) defaults — reference: bela/upmix.cpp:24-29.
MAX_STFT_SIZE_STREAM = 8192
THRESHOLD_MULTI = 32.0
XO_FRACTION = 0.25
MAX_BANDS_STREAM = 8

_WINDOW_NAMES = (
    "blackman_harris",
    "sqrt_hann",
    "hann",
    "blackman",
    "hamming",
    "rect",
)


def next_power_of_2(x: int) -> int:
    """Smallest power of two >= x (reference: center_extraction.py:156-171).

    The reference returns 1 for x < 1.
    """
    if x < 1:
        return 1
    power = 1
    while power < x:
        power <<= 1
    return power


def freq_to_bin(freq_hz: float, sr: float, fft_size: int, rounding: str = "python") -> int:
    """Map a frequency in Hz to an rFFT bin index.

    rounding="python" replicates center_extraction.py:142-154:
      int(round(f / (sr / fft_size)))  — Python banker's rounding, no clamping.
    rounding="cpp" replicates bela/upmix.cpp:45-54:
      lround(f * fft / sr) clamped to [0, fft/2]  — round half away from zero.
    """
    if rounding == "python":
        return int(round(freq_hz / (sr / float(fft_size))))
    if rounding == "cpp":
        binf = freq_hz * fft_size / sr
        binf = min(max(binf, 0.0), float(fft_size // 2))
        return int(math.floor(binf + 0.5))
    raise ValueError(f"unknown bin rounding mode: {rounding!r}")


def compute_block_size_for_low_freq(
    f_low: float,
    sr: float,
    max_block_size: int = 2**16,
    threshold_factor: float = 32.0,
) -> int:
    """Dynamic frequency-resolution block sizing.

    threshold = sr * threshold_factor / f_low, rounded up to the next power
    of two, clamped to max_block_size; f_low <= 0 pins the band to
    max_block_size (reference: center_extraction.py:173-197).  The streaming
    engine passes max_block_size = hw_block * 4 (bela/upmix.cpp:498-506).
    """
    if f_low <= 0.0:
        return max_block_size
    threshold = (sr * threshold_factor) / f_low
    candidate = next_power_of_2(int(math.ceil(threshold)))
    return min(candidate, max_block_size)


def hp_freq_to_crossover_width(hp_freq: float, fraction: float = XO_FRACTION) -> float:
    """Crossover fade width in Hz — `fraction` of the edge frequency
    (reference: center_extraction.py:200-212; bela/upmix.cpp:29, 190-191)."""
    return hp_freq * fraction


@dataclass(frozen=True)
class BandSpec:
    """One frequency band's static parameters.

    Mirrors the constructor surface of the reference's per-band engine
    (center_extraction.py:240-266) but as an immutable, hashable record so
    it can parameterize jitted programs as a static argument.
    """

    f_low: float
    f_high: float
    sr: float
    block_size: int
    overlap: float = 0.75
    window: str = "blackman_harris"
    xover_mode: str = "raised_cosine"
    xover_width_low_hz: float = 50.0
    xover_width_high_hz: float = 50.0
    bin_rounding: str = "python"

    def __post_init__(self):
        if self.window not in _WINDOW_NAMES:
            # Not a built-in: accept user-registered windows (the
            # runtime registry lives in ops.windows; imported lazily —
            # ops.windows imports EPS from this module).
            from upmix.ops.windows import is_known_window

            if not is_known_window(self.window):
                from upmix.ops.windows import window_names

                raise ValueError(
                    f"unknown window {self.window!r}; one of "
                    f"{tuple(window_names())}"
                )
        if self.hop_size < 1:
            # Reference: center_extraction.py:252-254.
            raise ValueError("Overlap too large; hop size < 1 is not allowed.")

    @property
    def hop_size(self) -> int:
        return int(self.block_size * (1 - self.overlap))

    @property
    def n_bins(self) -> int:
        return self.block_size // 2 + 1


@dataclass(frozen=True)
class UpmixConfig:
    """Full multiband configuration (the `chain_bands` result plus globals).

    Hashable so an entire pipeline can be specialized per-config under jit.
    Defaults replicate main.py:62-73 (offline) — see `UpmixConfig.streaming`
    for the bela/upmix.cpp:521-528 parity construction.
    """

    sr: float
    bands: tuple  # tuple[BandSpec, ...]
    overlap: float = 0.75
    window: str = "blackman_harris"
    xover_mode: str = "raised_cosine"
    synthesis: str = "wola"  # "wola" (Python parity) | "analysis" (C++ parity)
    bin_rounding: str = "python"

    @property
    def band_edges(self) -> tuple:
        edges = [b.f_low for b in self.bands]
        edges.append(self.bands[-1].f_high)
        return tuple(edges)

    @staticmethod
    def make(
        band_edges: Sequence[float],
        sr: float,
        overlap: float = 0.75,
        window: str = "blackman_harris",
        xover_mode: str = "raised_cosine",
        max_block_size: int = 2**16,
        threshold_factor: float = THRESHOLD_MULTI,
        xo_fraction: float = XO_FRACTION,
        synthesis: str = "wola",
        bin_rounding: str = "python",
        verbose: bool = False,
    ) -> "UpmixConfig":
        bands = chain_bands(
            band_edges,
            overlap=overlap,
            window=window,
            sr=sr,
            xover_mode=xover_mode,
            max_block_size=max_block_size,
            threshold_factor=threshold_factor,
            xo_fraction=xo_fraction,
            bin_rounding=bin_rounding,
            verbose=verbose,
        )
        return UpmixConfig(
            sr=sr,
            bands=tuple(bands),
            overlap=overlap,
            window=window,
            xover_mode=xover_mode,
            synthesis=synthesis,
            bin_rounding=bin_rounding,
        )

    @staticmethod
    def streaming(
        band_edges: Sequence[float],
        sr: float,
        hw_block_size: int,
        threshold_factor: float = THRESHOLD_MULTI,
        xo_fraction: float = XO_FRACTION,
        window: str = "blackman_harris",
        xover_mode: str = "raised_cosine",
        synthesis: str = "analysis",
        bin_rounding: str = "cpp",
        verbose: bool = False,
    ) -> "UpmixConfig":
        """C++-parity streaming config: fixed 75% overlap, block sizes capped
        at hw_block_size * 4, at most 8 bands (bela/upmix.cpp:444-445,
        498-506)."""
        if verbose:
            print(streaming_stft_table(sr, hw_block_size, threshold_factor))
        bands = chain_bands(
            band_edges,
            overlap=0.75,
            window=window,
            sr=sr,
            xover_mode=xover_mode,
            max_block_size=hw_block_size * 4,
            threshold_factor=threshold_factor,
            xo_fraction=xo_fraction,
            bin_rounding=bin_rounding,
            verbose=verbose,
        )
        # The C++ aggregator clamps to 8 bands by dropping the excess
        # (bela/upmix.cpp:444-445, 508).
        bands = bands[:MAX_BANDS_STREAM]
        return UpmixConfig(
            sr=sr,
            bands=tuple(bands),
            overlap=0.75,
            window=window,
            xover_mode=xover_mode,
            synthesis=synthesis,
            bin_rounding=bin_rounding,
        )


def chain_bands(
    band_edges: Sequence[float],
    overlap: float,
    window: str,
    sr: float,
    xover_mode: str = "raised_cosine",
    max_block_size: int = 2**16,
    threshold_factor: float = THRESHOLD_MULTI,
    xo_fraction: float = XO_FRACTION,
    bin_rounding: str = "python",
    verbose: bool = False,
) -> list:
    """Divide the spectrum into consecutive bands (reference:
    center_extraction.py:518-580).

    Appends sr/2 if the last edge is below Nyquist; each band's low fade
    width is the previous band's high fade width, and the high fade width is
    `xo_fraction` of its upper edge.

    Edges must be non-negative and strictly ascending — the reference
    silently produces degenerate bands otherwise (via the bin swap in the
    band-limit filter); this library validates at config time, matching
    the CLI's checks.
    """
    band_edges = list(band_edges)
    if not band_edges:
        raise ValueError("band_edges is empty")
    if band_edges[0] < 0.0:
        raise ValueError(f"band_edges must be non-negative, got {band_edges[0]}")
    if any(b <= a for a, b in zip(band_edges, band_edges[1:])):
        raise ValueError(f"band_edges must be ascending, got {band_edges}")
    if band_edges[-1] < (sr / 2.0):
        band_edges = band_edges + [sr / 2.0]

    bands = []
    prev_xover_high = 0.0
    for i in range(len(band_edges) - 1):
        f_low = band_edges[i]
        f_high = band_edges[i + 1]
        block_size = compute_block_size_for_low_freq(
            f_low, sr, max_block_size=max_block_size, threshold_factor=threshold_factor
        )
        xover_low = prev_xover_high
        xover_high = hp_freq_to_crossover_width(f_high, fraction=xo_fraction)
        if verbose:
            print(
                f"[Band {i + 1}] f_low={f_low:.1f} Hz, "
                f"f_high={f_high:.1f} Hz, block_size={block_size}, "
                f"xover_low={xover_low:.1f} Hz, xover_high={xover_high:.1f} Hz"
            )
        bands.append(
            BandSpec(
                f_low=float(f_low),
                f_high=float(f_high),
                sr=float(sr),
                block_size=block_size,
                overlap=overlap,
                window=window,
                xover_mode=xover_mode,
                xover_width_low_hz=float(xover_low),
                xover_width_high_hz=float(xover_high),
                bin_rounding=bin_rounding,
            )
        )
        prev_xover_high = xover_high
    if not bands:
        # A single edge at/above Nyquist pairs with nothing; returning an
        # empty band list would fail far downstream with confusing errors.
        raise ValueError(
            f"band_edges {band_edges} yield no bands: at least one edge "
            f"must lie below Nyquist ({sr / 2.0:.1f} Hz)"
        )
    return bands


def streaming_stft_table(
    sr: float,
    hw_block_size: int,
    threshold_factor: float = THRESHOLD_MULTI,
    freqs: Sequence[float] = (20, 40, 80, 160, 320, 640, 1280, 2560, 5120),
) -> str:
    """STFT-size reference table for streaming configs — functional parity
    with the C++ engine's setup printout (bela/upmix.cpp:448-459), which
    prints the block size the dynamic-resolution rule assigns to a range of
    sample low-frequencies given the hw_block*4 cap."""
    lines = [
        f"STFT size by band low frequency (sr={sr:.0f} Hz, "
        f"hw_block={hw_block_size}, cap={hw_block_size * 4}):"
    ]
    for f in freqs:
        size = compute_block_size_for_low_freq(
            float(f), sr, max_block_size=hw_block_size * 4, threshold_factor=threshold_factor
        )
        lines.append(f"  f_low >= {f:7.1f} Hz -> stft {size}")
    return "\n".join(lines)


def bucket_bands(bands: Iterable[BandSpec]) -> dict:
    """Group bands by (block_size) for batched per-bucket processing.

    Bands sharing a block size (the default 44.1 kHz config collides on
    65536 — SURVEY.md §2) share one framed-FFT computation; the per-band
    gain/mask math is batched over the bucket's band axis.
    Returns an ordered dict {block_size: [BandSpec, ...]}.
    """
    buckets: dict = {}
    for band in bands:
        buckets.setdefault(band.block_size, []).append(band)
    return buckets
