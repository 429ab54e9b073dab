"""Shared test fixtures: signal generators and SNR metrics."""

import numpy as np


def snr_db(ref: np.ndarray, test: np.ndarray) -> float:
    """Signal-to-noise ratio of `test` against `ref` in dB."""
    ref = np.asarray(ref, dtype=np.float64)
    test = np.asarray(test, dtype=np.float64)
    err = np.sum((ref - test) ** 2)
    sig = np.sum(ref**2)
    if err == 0:
        return np.inf
    return 10.0 * np.log10(sig / max(err, 1e-300))


def make_stereo(n: int, sr: float, seed: int = 0, kind: str = "mix"):
    """Stereo test signals: a common (center) component plus decorrelated
    sides, band-rich enough to exercise every band."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    if kind == "mix":
        center = 0.4 * np.sin(2 * np.pi * 220.0 * t) + 0.1 * rng.standard_normal(n)
        side_l = 0.3 * np.sin(2 * np.pi * 555.0 * t + 0.3) + 0.1 * rng.standard_normal(n)
        side_r = 0.3 * np.sin(2 * np.pi * 812.0 * t + 1.1) + 0.1 * rng.standard_normal(n)
        L = center + side_l
        R = center + side_r
    elif kind == "noise":
        L = rng.standard_normal(n)
        R = rng.standard_normal(n)
    elif kind == "mono":
        L = R = 0.5 * np.sin(2 * np.pi * 330.0 * t) + 0.2 * rng.standard_normal(n)
        R = L.copy()
    elif kind == "anticorrelated":
        L = rng.standard_normal(n)
        R = -L
    elif kind == "silence":
        L = np.zeros(n)
        R = np.zeros(n)
    else:
        raise ValueError(kind)
    return L.astype(np.float64), R.astype(np.float64)


def cpu_child_env():
    """Env for a subprocess that must run on the CPU backend."""
    import os

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return env
