"""Cross-spectral center-extraction mask — the heart of the algorithm.

Per-bin math identical to the reference (center_extraction.py:372-384;
bit-for-bit the same formula in scalar form at bela/upmix.cpp:363-385):

  cross        = L * conj(R)
  coherence    = |cross| / (|L| |R| + EPS)
  balance      = (|L| - |R|) / (|L| + |R| + EPS)
  centerFactor = coherence * (1 - |balance|)
  C  = 0.5 * centerFactor * (L + R);   Ls = L - C;   Rs = R - C

Pure elementwise on complex spectra — XLA fuses the whole chain into the
surrounding gain/sum computation.
"""

from __future__ import annotations

import jax.numpy as jnp

from upmix.config import EPS


def center_mask(spec_l: jnp.ndarray, spec_r: jnp.ndarray, eps: float = EPS):
    """Extract (C, Ls, Rs) spectra from L/R spectra of any matching shape."""
    cross = spec_l * jnp.conjugate(spec_r)
    cross_mag = jnp.abs(cross)
    mag_l = jnp.abs(spec_l)
    mag_r = jnp.abs(spec_r)
    coherence = cross_mag / (mag_l * mag_r + eps)
    balance = (mag_l - mag_r) / (mag_l + mag_r + eps)
    center_factor = coherence * (1.0 - jnp.abs(balance))
    spec_c = (0.5 * center_factor).astype(spec_l.real.dtype) * (spec_l + spec_r)
    return spec_c, spec_l - spec_c, spec_r - spec_c
