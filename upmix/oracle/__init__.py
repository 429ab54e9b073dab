"""Faithful NumPy re-derivation of the reference semantics — the test oracle.

This is the only place reference behavior is encoded imperatively; the JAX
pipeline is validated against it by SNR (SURVEY.md §4).
"""

from upmix.oracle.reference import (
    OracleBandState,
    oracle_band_full,
    oracle_multiband,
    oracle_stream_multiband,
)

__all__ = [
    "OracleBandState",
    "oracle_band_full",
    "oracle_multiband",
    "oracle_stream_multiband",
]
