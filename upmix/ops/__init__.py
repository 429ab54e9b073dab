"""Device-facing primitive ops and their host-side (trace-time) constants."""

from upmix.ops.windows import (
    design_wola_synthesis_window,
    make_window,
    make_blackman_harris,
    make_sqrt_hann,
    make_hann,
    make_blackman,
    make_hamming,
    make_rect,
    register_window,
    register_window_vector,
)
from upmix.ops.gains import band_gain_curve
from upmix.ops.framing import frame_signal, overlap_add
from upmix.ops.mask import center_mask

__all__ = [
    "design_wola_synthesis_window",
    "make_window",
    "make_blackman_harris",
    "make_sqrt_hann",
    "make_hann",
    "make_blackman",
    "make_hamming",
    "make_rect",
    "register_window",
    "register_window_vector",
    "band_gain_curve",
    "frame_signal",
    "overlap_add",
    "center_mask",
]
