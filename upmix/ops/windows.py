"""Window generation and WOLA synthesis-window design.

Host-side NumPy: windows are trace-time constants baked into jitted
programs.  Semantics follow the reference exactly
(center_extraction.py:42-105; bela/upmix.cpp:59-71), but the reference's
O(L*K) scalar WOLA design loop (262k iterations for the largest default
band) is replaced by a vectorized formulation.
"""

from __future__ import annotations

import numpy as np

from upmix.config import EPS


def make_blackman_harris(N: int) -> np.ndarray:
    """4-term Blackman–Harris window, a0..a3 = 0.35875/0.48829/0.14128/0.01168
    (reference: center_extraction.py:42-53; identical coefficients in
    bela/upmix.cpp:61-64)."""
    n = np.arange(N)
    a0, a1, a2, a3 = 0.35875, 0.48829, 0.14128, 0.01168
    w = (
        a0
        - a1 * np.cos(2 * np.pi * n / (N - 1))
        + a2 * np.cos(4 * np.pi * n / (N - 1))
        - a3 * np.cos(6 * np.pi * n / (N - 1))
    )
    return w.astype(np.float32)


def make_sqrt_hann(N: int) -> np.ndarray:
    """Square-root Hann (reference: center_extraction.py:56-59)."""
    return np.sqrt(np.hanning(N)).astype(np.float32)


def make_hann(N: int) -> np.ndarray:
    """Hann (reference: center_extraction.py:61-63)."""
    return np.hanning(N).astype(np.float32)


def make_blackman(N: int) -> np.ndarray:
    """Blackman (reference: center_extraction.py:65-67)."""
    return np.blackman(N).astype(np.float32)


def make_hamming(N: int) -> np.ndarray:
    """Hamming (reference: center_extraction.py:69-71)."""
    return np.hamming(N).astype(np.float32)


def make_rect(N: int) -> np.ndarray:
    """Rectangular (reference: center_extraction.py:73-75)."""
    return np.ones(N, dtype=np.float32)


_WINDOWS = {
    "blackman_harris": make_blackman_harris,
    "sqrt_hann": make_sqrt_hann,
    "hann": make_hann,
    "blackman": make_blackman,
    "hamming": make_hamming,
    "rect": make_rect,
}

# User-registered windows (reference parity: main.py:65 and
# center_extraction.py:240-249 accept ANY callable as window_func; this
# registry is the hashable-config equivalent — the name string flows
# through BandSpec/UpmixConfig unchanged, so configs stay valid static
# jit arguments and every kernel path picks the window up through
# make_window()).
_CUSTOM: dict = {}


def register_window(name: str, fn, overwrite: bool = False) -> str:
    """Register a custom analysis-window generator under `name`.

    `fn(N) -> array[N]` is called per band with that band's block size
    (exactly the reference's window_func contract).  The name can then
    be used anywhere a built-in window name is accepted (UpmixConfig,
    the CLI's --window, the native engine).  Registration is
    process-wide; jitted programs cache by config, so redefining a name
    mid-process requires overwrite=True and fresh model objects.
    """
    name = str(name)
    if name in _WINDOWS:
        raise ValueError(f"{name!r} is a built-in window name")
    if name in _CUSTOM and not overwrite:
        raise ValueError(
            f"window {name!r} already registered; pass overwrite=True "
            "(and rebuild any models created with the old definition)"
        )
    probe = np.asarray(fn(16), dtype=np.float32)
    if probe.shape != (16,) or not np.all(np.isfinite(probe)):
        raise ValueError(
            f"window fn for {name!r} must return a finite length-N 1-D "
            f"array; got shape {probe.shape}"
        )
    _CUSTOM[name] = fn
    return name


def window_from_vector(vec) -> "callable":
    """Wrap a fixed window VECTOR as a window generator.

    Bands have different block sizes (dynamic resolution,
    center_extraction.py:173-197), so a single vector serves them by
    linear resampling over [0, 1] (endpoints aligned); a band whose
    block size equals the vector length gets the vector verbatim.
    The original float32 vector is exposed as `.vector` so the native
    engine can apply identical semantics.
    """
    base = np.asarray(vec, dtype=np.float32).ravel()
    if base.size < 2:
        raise ValueError("window vector needs at least 2 samples")
    if not np.all(np.isfinite(base)):
        raise ValueError("window vector must be finite")

    def fn(N: int) -> np.ndarray:
        N = int(N)
        if N == base.size:
            return base.copy()
        x = np.linspace(0.0, 1.0, N)
        xp = np.linspace(0.0, 1.0, base.size)
        return np.interp(x, xp, base.astype(np.float64)).astype(np.float32)

    fn.vector = base
    return fn


def register_window_vector(name: str, vec, overwrite: bool = False) -> str:
    """register_window() for a fixed coefficient vector (resampled per
    band — see window_from_vector)."""
    return register_window(name, window_from_vector(vec), overwrite=overwrite)


def window_names() -> tuple:
    """All currently valid window names (built-ins first)."""
    return tuple(_WINDOWS) + tuple(_CUSTOM)


def is_known_window(name: str) -> bool:
    return name in _WINDOWS or name in _CUSTOM


def is_builtin_window(name: str) -> bool:
    return name in _WINDOWS


def window_payload(name: str, sizes) -> dict:
    """JSON-safe round-trip payload for a registered CUSTOM window, so
    configs that reference it (AOT artifacts, server checkpoints) can be
    reconstructed in a fresh process where nothing re-ran the
    registration (register_window is process-wide only).

    Vector-backed registrations (register_window_vector /
    --window-file) persist their exact coefficient vector.  Arbitrary
    callables cannot be serialized; they persist their EVALUATIONS at
    `sizes` (the band block sizes of the config being saved — the only
    lengths that config can ever ask for).
    """
    fn = _CUSTOM.get(name)
    if fn is None:
        raise ValueError(f"{name!r} is not a registered custom window")
    vec = getattr(fn, "vector", None)
    if vec is not None:
        return {"kind": "vector", "coeffs": [float(v) for v in vec]}
    return {
        "kind": "sampled",
        "sizes": {
            str(int(n)): [float(v) for v in make_window(name, int(n))]
            for n in sorted({int(s) for s in sizes})
        },
    }


def _payload_reference_coeffs(payload: dict) -> dict:
    """{size: float32 coefficients} the payload pins, for conflict checks."""
    kind = payload.get("kind")
    if kind == "vector":
        vec = np.asarray(payload["coeffs"], np.float32)
        return {int(vec.size): vec}
    if kind == "sampled":
        return {
            int(k): np.asarray(v, np.float32)
            for k, v in payload["sizes"].items()
        }
    raise ValueError(f"unknown window payload kind {kind!r}")


def restore_window(name: str, payload: dict, check_sizes=()) -> str:
    """Re-register `name` from a window_payload().

    When the name is already known, the live in-process registration is
    kept (the loaded program has its windows baked into the compiled
    artifact anyway) — but ONLY after verifying the live coefficients
    match the payload's at the payload's stored sizes AND at
    `check_sizes` (the restoring config's band block sizes — a live
    registration can agree with a vector payload at the raw vector
    length yet RESAMPLE differently at the sizes the config actually
    uses).  A same-name registration with DIFFERENT coefficients would
    make the oracle / native paths silently check against the wrong
    contract, so that case raises instead of no-op'ing."""
    if is_known_window(name):
        refs = _payload_reference_coeffs(payload)
        if payload.get("kind") == "vector":
            # The payload pins resampling semantics too: what the
            # restored registration WOULD produce at any size.
            ref_fn = window_from_vector(
                np.asarray(payload["coeffs"], np.float32)
            )
            for n in check_sizes:
                refs.setdefault(int(n), ref_fn(int(n)))
        for n, want in refs.items():
            got = make_window(name, n)
            if got.shape != want.shape or not np.allclose(
                got, want, rtol=1e-6, atol=1e-7
            ):
                raise ValueError(
                    f"window {name!r} is already registered in this "
                    f"process with coefficients that differ from the "
                    f"artifact's at N={n}; unregister or rename the live "
                    "registration before restoring this artifact"
                )
        return name
    kind = payload.get("kind")
    if kind == "vector":
        return register_window_vector(
            name, np.asarray(payload["coeffs"], np.float32)
        )
    if kind == "sampled":
        table = {
            int(k): np.asarray(v, np.float32)
            for k, v in payload["sizes"].items()
        }
        if not table:
            raise ValueError(f"sampled window payload for {name!r} is empty")
        resample = window_from_vector(table[max(table)])

        def fn(N: int) -> np.ndarray:
            N = int(N)
            if N in table:
                return table[N].copy()
            # Off-table length (a config edited after restore): resample
            # from the longest stored evaluation — same semantics as a
            # vector-backed window, documented best-effort.
            return resample(N)

        return register_window(name, fn)
    raise ValueError(f"unknown window payload kind {kind!r} for {name!r}")


def custom_window_vector(name: str):
    """The registered vector behind `name` if it was vector-backed
    (register_window_vector / --window-file), else None.  Lets the
    native engine reproduce the exact per-band resampling."""
    fn = _CUSTOM.get(name)
    return getattr(fn, "vector", None) if fn is not None else None


def make_window(name: str, N: int) -> np.ndarray:
    fn = _WINDOWS.get(name) or _CUSTOM.get(name)
    if fn is None:
        raise ValueError(
            f"unknown window {name!r}; one of {sorted(window_names())} "
            "(register custom windows via upmix.ops.windows."
            "register_window)"
        )
    w = np.asarray(fn(int(N)), dtype=np.float32)
    if w.shape != (int(N),):
        raise ValueError(
            f"window {name!r} returned shape {w.shape}, expected ({N},)"
        )
    return w


def design_wola_synthesis_window(analysis_window: np.ndarray, overlap: float) -> np.ndarray:
    """WOLA synthesis window: w_S(n) = w_A(n) / (sum_k w_A^2((n + k*H) mod L) + EPS).

    Semantics identical to the reference's scalar loop
    (center_extraction.py:80-105): H = floor(L*(1-overlap)),
    K = round(1/(1-overlap)) overlapping frames, modulo indexing simulating
    infinite tiling, float64 accumulation of float32 squared terms.
    Vectorized: the double loop becomes one fancy-indexed reduction.
    """
    L = len(analysis_window)
    hop = int(L * (1.0 - overlap))
    if hop < 1:
        raise ValueError("Overlap too large; resulting hop size < 1.")
    K = int(round(1.0 / (1.0 - overlap)))

    aw = np.asarray(analysis_window)
    idx = (np.arange(L)[:, None] + np.arange(K)[None, :] * hop) % L
    # Match the reference's accumulation: each term is squared in the input
    # dtype (float32), then summed in float64 (Python-float accumulator).
    terms = (aw[idx] * aw[idx]).astype(np.float64)
    denom = terms.sum(axis=1) + EPS
    return (aw / denom).astype(analysis_window.dtype)
