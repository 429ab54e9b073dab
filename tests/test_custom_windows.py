"""Custom analysis windows end to end (reference parity: main.py:65 and
center_extraction.py:240-249 accept ANY callable as window_func).

The framework equivalent is the window registry
(upmix.ops.windows.register_window / register_window_vector): the
registered NAME flows through UpmixConfig/BandSpec unchanged (hashable,
static under jit) and every path resolves it through make_window — the
oracle, the offline kernels, the streaming scan, the serving pool, and
the native C++ engine (which receives the exact float32 vectors over
the concatenated-windows ABI).
"""

import subprocess

import numpy as np
import pytest

from upmix.config import UpmixConfig
from upmix.models.offline import upmix_offline
from upmix.models.streaming import StreamingUpmixer, make_stream_pool
from upmix.oracle import oracle_multiband
from upmix.oracle.reference import oracle_stream_multiband
from upmix.ops.windows import (
    custom_window_vector,
    is_known_window,
    make_window,
    register_window,
    register_window_vector,
    window_from_vector,
    window_names,
)

from helpers import make_stereo, snr_db


def _rand_window(rng, n):
    """A random-but-plausible window: positive, smoothed, tapered."""
    w = rng.uniform(0.2, 1.0, n)
    k = np.ones(9) / 9.0
    w = np.convolve(w, k, mode="same")
    taper = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / (n - 1))
    return (w * (0.15 + 0.85 * taper)).astype(np.float32)


def _register(rng, tag, n=777):
    vec = _rand_window(rng, n)
    name = f"test:{tag}"
    register_window_vector(name, vec, overwrite=True)
    return name, vec


# -- registry mechanics ------------------------------------------------


def test_registry_roundtrip_and_rejections():
    rng = np.random.default_rng(0)
    name, vec = _register(rng, "mech")
    assert is_known_window(name) and name in window_names()
    # Exact length -> verbatim; other lengths -> linear resample.
    np.testing.assert_array_equal(make_window(name, len(vec)), vec)
    w256 = make_window(name, 256)
    assert w256.shape == (256,) and w256.dtype == np.float32
    assert abs(w256[0] - vec[0]) < 1e-6 and abs(w256[-1] - vec[-1]) < 1e-6
    np.testing.assert_array_equal(custom_window_vector(name), vec)
    assert custom_window_vector("hann") is None
    with pytest.raises(ValueError, match="already registered"):
        register_window(name, lambda n: np.ones(n, np.float32))
    with pytest.raises(ValueError, match="built-in"):
        register_window("hann", lambda n: np.ones(n, np.float32))
    with pytest.raises(ValueError):
        window_from_vector([1.0])  # too short
    with pytest.raises(ValueError):
        window_from_vector([1.0, np.nan, 1.0])
    with pytest.raises(ValueError, match="unknown window"):
        make_window("test:nope", 64)
    with pytest.raises(ValueError, match="unknown window"):
        UpmixConfig.make([0.0, 400.0], sr=8000.0, window="test:nope")


def test_restore_window_conflict_detection():
    # restore_window keeps a MATCHING live registration but must refuse
    # a same-name registration with different coefficients (otherwise
    # the oracle/native paths silently check against the wrong window).
    from upmix.ops import windows as W

    rng = np.random.default_rng(7)
    name, vec = _register(rng, "restore")
    payload = W.window_payload(name, sizes=[256])
    assert W.restore_window(name, payload) == name  # matching -> kept
    # Conflicting live registration -> loud failure, not a silent no-op.
    register_window_vector(name, vec * 0.5, overwrite=True)
    with pytest.raises(ValueError, match="differ"):
        W.restore_window(name, payload)
    # Fresh-process path: no live registration -> restored verbatim.
    del W._CUSTOM[name]
    assert W.restore_window(name, payload) == name
    np.testing.assert_array_equal(make_window(name, len(vec)), vec)
    # Sampled payloads (arbitrary callables) get the same check at each
    # stored size.
    register_window("test:samp", lambda n: np.full(n, 0.5, np.float32),
                    overwrite=True)
    sp = W.window_payload("test:samp", sizes=[64, 128])
    assert W.restore_window("test:samp", sp) == "test:samp"
    register_window("test:samp", lambda n: np.full(n, 0.25, np.float32),
                    overwrite=True)
    with pytest.raises(ValueError, match="differ"):
        W.restore_window("test:samp", sp)


def test_restore_window_resample_divergence_detected():
    # A live callable can agree with a vector payload VERBATIM at the
    # raw vector length yet resample differently at the sizes the
    # restoring config actually uses — check_sizes must catch that
    # (round-5 review finding: the N=len(coeffs) check alone passes it).
    from upmix.ops import windows as W

    rng = np.random.default_rng(11)
    vec = _rand_window(rng, 777)
    name = "test:resample-div"

    def sneaky(n):
        n = int(n)
        if n == len(vec):
            return vec.copy()
        # squared-linear interpolation: same endpoints, different body
        lin = W.window_from_vector(vec)(n)
        return (lin.astype(np.float64) ** 2).astype(np.float32) / max(
            float(lin.max()), 1e-9
        )

    register_window(name, sneaky, overwrite=True)
    payload = {"kind": "vector", "coeffs": [float(v) for v in vec]}
    # Without check_sizes the divergence is invisible (matches at 777).
    assert W.restore_window(name, payload) == name
    with pytest.raises(ValueError, match="differ"):
        W.restore_window(name, payload, check_sizes=[256])


def test_config_from_dict_checks_band_sizes(tmp_path):
    # config_from_dict passes the config's band block sizes as
    # check_sizes, so a resample-divergent live registration fails the
    # artifact load instead of silently serving the wrong window.
    from upmix import aot
    from upmix.ops import windows as W

    rng = np.random.default_rng(13)
    name, vec = _register(rng, "cfgdict")
    cfg = UpmixConfig.make([0.0, 400.0], sr=8000.0, window=name,
                           max_block_size=512)
    d = aot.config_to_dict(cfg)
    assert aot.config_from_dict(d).window == name  # matching live: fine

    def sneaky(n):
        n = int(n)
        if n == len(vec):
            return vec.copy()
        lin = W.window_from_vector(vec)(n)
        return (lin.astype(np.float64) ** 2).astype(np.float32)

    register_window(name, sneaky, overwrite=True)
    with pytest.raises(ValueError, match="differ"):
        aot.config_from_dict(d)
    register_window_vector(name, vec, overwrite=True)  # restore sanity


def test_registered_callable_window():
    # A generator CALLABLE (not a vector): the reference's exact
    # window_func contract — called per band with that block size.
    def tukey(n):
        x = np.linspace(0.0, 1.0, n)
        w = np.ones(n)
        edge = x < 0.25
        w[edge] = 0.5 - 0.5 * np.cos(np.pi * x[edge] / 0.25)
        edge = x > 0.75
        w[edge] = 0.5 - 0.5 * np.cos(np.pi * (1.0 - x[edge]) / 0.25)
        return w.astype(np.float32)

    register_window("test:tukey", tukey, overwrite=True)
    cfg = UpmixConfig.make(
        [0.0, 400.0, 1600.0], sr=8000.0, max_block_size=512,
        window="test:tukey",
    )
    L, R = make_stereo(4096, cfg.sr, seed=3)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)
    ref = oracle_multiband(L32, R32, cfg)
    got = upmix_offline(L32, R32, cfg, kernel="mm")
    for r, g in zip(ref, got):
        assert snr_db(r, g) > 60.0


# -- fuzz: random window vectors, every path vs the oracle -------------


def test_fuzz_custom_window_offline_kernels():
    rng = np.random.default_rng(42)
    for trial in range(3):
        name, _ = _register(rng, f"off{trial}", n=int(rng.integers(64, 2048)))
        cfg = UpmixConfig.make(
            [0.0, 400.0, 1600.0], sr=8000.0, max_block_size=512, window=name
        )
        L, R = make_stereo(4096, cfg.sr, seed=trial)
        L32, R32 = L.astype(np.float32), R.astype(np.float32)
        ref = oracle_multiband(L32, R32, cfg)
        for kernel in ("xla", "mm"):
            got = upmix_offline(L32, R32, cfg, kernel=kernel)
            for ch, r, g in zip("C Ls Rs".split(), ref, got):
                s = snr_db(r, g)
                assert s > 60.0, f"{kernel}/{ch} trial {trial}: {s:.1f} dB"


def test_fuzz_custom_window_streaming_and_pool():
    rng = np.random.default_rng(7)
    hw = 256
    name, _ = _register(rng, "stream", n=513)
    cfg = UpmixConfig.streaming(
        [0.0, 400.0, 1600.0], sr=8000.0, hw_block_size=hw, window=name
    )
    L, R = make_stereo(16 * hw, cfg.sr, seed=11)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)
    ref_l, ref_r = oracle_stream_multiband(L32, R32, cfg, hw)

    eng = StreamingUpmixer(cfg, hw)
    got_l, got_r = eng.process_signal(L32, R32, mix="stereo_sum")
    assert snr_db(ref_l, got_l) > 60.0
    assert snr_db(ref_r, got_r) > 60.0

    # Serving pool: stream 0 of a tiny pool must match the same oracle.
    pool = make_stream_pool(cfg, hw, 8)
    n = len(L32)
    outC = np.zeros(n, np.float32)
    outLs = np.zeros(n, np.float32)
    outRs = np.zeros(n, np.float32)
    zeros = np.zeros((7, hw), np.float32)
    for s in range(0, n, hw):
        bl = np.concatenate([L32[None, s:s + hw], zeros])
        br = np.concatenate([R32[None, s:s + hw], zeros])
        c, ls, rs = pool.push_blocks(bl, br)
        outC[s:s + hw] = np.asarray(c)[0]
        outLs[s:s + hw] = np.asarray(ls)[0]
        outRs[s:s + hw] = np.asarray(rs)[0]
    got_l2 = outLs + 0.5 * outC
    got_r2 = outRs + 0.5 * outC
    assert snr_db(ref_l, got_l2) > 60.0
    assert snr_db(ref_r, got_r2) > 60.0


def test_fuzz_custom_window_native():
    native = pytest.importorskip("upmix.native")
    if not native.is_available():
        import os

        subprocess.run(
            ["make", "-C",
             os.path.join(os.path.dirname(__file__), "..", "native")],
            capture_output=True,
        )
    if not native.is_available():
        pytest.skip("native lib unavailable")
    rng = np.random.default_rng(13)
    hw = 256
    for trial in range(2):
        name, _ = _register(rng, f"nat{trial}", n=int(rng.integers(80, 999)))
        cfg = UpmixConfig.streaming(
            [0.0, 400.0, 1600.0], sr=8000.0, hw_block_size=hw, window=name
        )
        eng = native.NativeStreamingUpmixer(
            [0.0, 400.0, 1600.0], sr=8000.0, hw_block_size=hw,
            synthesis="analysis", bin_rounding="cpp", window=name,
        )
        cfg = UpmixConfig.streaming(
            [0.0, 400.0, 1600.0], sr=8000.0, hw_block_size=hw, window=name,
        )
        L, R = make_stereo(16 * hw, cfg.sr, seed=trial)
        L32, R32 = L.astype(np.float32), R.astype(np.float32)
        ref_l, ref_r = oracle_stream_multiband(L32, R32, cfg, hw)
        got_l, got_r = eng.process_signal(L32, R32, mix="stereo_sum")
        assert snr_db(ref_l, got_l) > 60.0, f"native L trial {trial}"
        assert snr_db(ref_r, got_r) > 60.0, f"native R trial {trial}"


def test_native_rejects_unknown_window():
    native = pytest.importorskip("upmix.native")
    if not native.is_available():
        pytest.skip("native lib unavailable")
    with pytest.raises(ValueError, match="unknown window"):
        native.NativeStreamingUpmixer(
            [0.0, 400.0], sr=8000.0, hw_block_size=256, window="test:nope"
        )


# -- CLI --window-file --------------------------------------------------


def test_cli_window_file(tmp_path):
    from upmix.cli import load_window_file, main
    from upmix.io import read_wav, write_wav

    rng = np.random.default_rng(99)
    vec = _rand_window(rng, 321)
    npy = tmp_path / "win.npy"
    np.save(npy, vec)
    txt = tmp_path / "win.txt"
    np.savetxt(txt, vec)

    # Same contents -> same content-derived name, both formats.
    n1 = load_window_file(str(npy))
    n2 = load_window_file(str(txt))
    assert n1 == n2 and n1.startswith("file:")
    np.testing.assert_array_equal(make_window(n1, len(vec)), vec)

    L, R = make_stereo(4096, 8000.0, seed=5)
    wav = tmp_path / "in.wav"
    write_wav(str(wav), np.stack([L, R], 1).astype(np.float32), 8000)
    rc = main([
        str(wav), "--out-dir", str(tmp_path / "out"),
        "--band-edges", "0,400,1600", "--max-block-size", "512",
        "--window-file", str(npy), "--export-mode", "stereo_sum",
    ])
    assert rc == 0
    outs = sorted((tmp_path / "out").glob("*.wav"))
    assert len(outs) == 1
    data, sr = read_wav(str(outs[0]))
    assert sr == 8000 and data.shape[1] == 2 and np.all(np.isfinite(data))
