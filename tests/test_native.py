"""Native C++ streaming host shell: parity vs the NumPy oracle and the JAX
streaming engine (the "real-time without a real Bela" test — SURVEY.md §4).

Skipped when native/libupmix_host.so hasn't been built (`make -C native`).
"""

import subprocess

import numpy as np
import pytest

from upmix.config import UpmixConfig
from upmix.oracle.reference import oracle_stream_multiband

from helpers import make_stereo, snr_db

native = pytest.importorskip("upmix.native")

if not native.is_available():
    import os

    # Build on demand so a fresh checkout can still run the suite.
    mk = subprocess.run(
        ["make", "-C", os.path.join(os.path.dirname(__file__), "..", "native")],
        capture_output=True,
    )
    if not native.is_available():  # pragma: no cover
        pytest.skip(
            f"native lib unavailable: {mk.stderr.decode()[-200:]}",
            allow_module_level=True,
        )

HW = 256
EDGES = [0.0, 400.0, 1600.0]
SR = 8000.0


def test_native_parity_vs_oracle_cpp_mode():
    cfg = UpmixConfig.streaming(EDGES, sr=SR, hw_block_size=HW)  # analysis+cpp
    eng = native.NativeStreamingUpmixer(
        EDGES, sr=SR, hw_block_size=HW, synthesis="analysis", bin_rounding="cpp"
    )
    L, R = make_stereo(16 * HW, SR, seed=0)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)
    ref_l, ref_r = oracle_stream_multiband(L32, R32, cfg, HW)
    got_l, got_r = eng.process_signal(L32, R32, mix="stereo_sum")
    assert snr_db(ref_l, got_l) > 60.0
    assert snr_db(ref_r, got_r) > 60.0


@pytest.mark.parametrize("synthesis,rounding", [("analysis", "cpp"), ("wola", "python")])
def test_native_float_fast_mode_parity_vs_oracle(synthesis, rounding):
    # The float32 fast mode (precision="float") must hold the same >60 dB
    # oracle bar as the double parity mode in both synthesis modes.
    cfg = UpmixConfig.streaming(
        EDGES, sr=SR, hw_block_size=HW, synthesis=synthesis, bin_rounding=rounding
    )
    eng = native.NativeStreamingUpmixer(
        EDGES, sr=SR, hw_block_size=HW, synthesis=synthesis,
        bin_rounding=rounding, precision="float",
    )
    L, R = make_stereo(16 * HW, SR, seed=0)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)
    ref_l, ref_r = oracle_stream_multiband(L32, R32, cfg, HW)
    got_l, got_r = eng.process_signal(L32, R32, mix="stereo_sum")
    assert snr_db(ref_l, got_l) > 60.0
    assert snr_db(ref_r, got_r) > 60.0


def test_native_float_mode_close_to_double_mode():
    # Fast mode should track the parity mode far tighter than the oracle
    # bar (same algorithm, narrower scalar) — catch gross wiring mistakes
    # like a wrong gain table or missing unpack term.
    kw = dict(sr=SR, hw_block_size=HW, synthesis="analysis", bin_rounding="cpp")
    eng_d = native.NativeStreamingUpmixer(EDGES, **kw)
    eng_f = native.NativeStreamingUpmixer(EDGES, precision="float", **kw)
    L, R = make_stereo(16 * HW, SR, seed=2)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)
    dl, dr = eng_d.process_signal(L32, R32, mix="stereo_sum")
    fl, fr = eng_f.process_signal(L32, R32, mix="stereo_sum")
    assert snr_db(dl, fl) > 80.0
    assert snr_db(dr, fr) > 80.0


def test_native_float_mode_pool_bit_identical():
    # The deterministic band-order reduction must hold in fast mode too.
    kw = dict(sr=SR, hw_block_size=HW, precision="float")
    eng1 = native.NativeStreamingUpmixer(EDGES, n_threads=1, **kw)
    eng4 = native.NativeStreamingUpmixer(EDGES, n_threads=4, **kw)
    L, R = make_stereo(12 * HW, SR, seed=3)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)
    a = eng1.process_signal(L32, R32)
    b = eng4.process_signal(L32, R32)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_native_rejects_bad_precision():
    with pytest.raises(ValueError):
        native.NativeStreamingUpmixer(
            EDGES, sr=SR, hw_block_size=HW, precision="half"
        )


def test_native_parity_vs_oracle_wola_mode():
    cfg = UpmixConfig.streaming(
        EDGES, sr=SR, hw_block_size=HW, synthesis="wola", bin_rounding="python"
    )
    eng = native.NativeStreamingUpmixer(
        EDGES, sr=SR, hw_block_size=HW, synthesis="wola", bin_rounding="python"
    )
    L, R = make_stereo(16 * HW, SR, seed=1)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)
    ref_l, ref_r = oracle_stream_multiband(L32, R32, cfg, HW)
    got_l, got_r = eng.process_signal(L32, R32, mix="stereo_sum")
    assert snr_db(ref_l, got_l) > 60.0
    assert snr_db(ref_r, got_r) > 60.0


def test_native_vs_jax_streaming():
    # Cross-implementation agreement: C++ shell vs the JAX scan engine.
    from upmix.models.streaming import StreamingUpmixer

    cfg = UpmixConfig.streaming(EDGES, sr=SR, hw_block_size=HW)
    s = StreamingUpmixer(cfg, HW)
    eng = native.NativeStreamingUpmixer(
        EDGES, sr=SR, hw_block_size=HW, synthesis="analysis", bin_rounding="cpp"
    )
    L, R = make_stereo(12 * HW, SR, seed=2)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)
    jc, jls, jrs = s.process_signal(L32, R32, mix="lcr")
    nc, nls, nrs = eng.process_signal(L32, R32, mix="lcr")
    assert snr_db(np.asarray(jc), nc) > 60.0
    assert snr_db(np.asarray(jls), nls) > 60.0
    assert snr_db(np.asarray(jrs), nrs) > 60.0


@pytest.mark.parametrize("window", ["hann", "hamming", "sqrt_hann"])
def test_native_window_plumbing(window):
    # The engine takes the analysis window through the C API (round-1
    # advisor finding: it silently hardcoded Blackman-Harris).
    cfg = UpmixConfig.streaming(EDGES, sr=SR, hw_block_size=HW, window=window)
    eng = native.NativeStreamingUpmixer(
        EDGES, sr=SR, hw_block_size=HW, synthesis="analysis",
        bin_rounding="cpp", window=window,
    )
    L, R = make_stereo(16 * HW, SR, seed=11)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)
    ref_l, ref_r = oracle_stream_multiband(L32, R32, cfg, HW)
    got_l, got_r = eng.process_signal(L32, R32, mix="stereo_sum")
    assert snr_db(ref_l, got_l) > 60.0
    assert snr_db(ref_r, got_r) > 60.0
    # And a mismatched window must NOT match (guards against the plumbing
    # silently regressing to a fixed window).
    bh = native.NativeStreamingUpmixer(
        EDGES, sr=SR, hw_block_size=HW, synthesis="analysis", bin_rounding="cpp"
    )
    bh_l, _ = bh.process_signal(L32, R32, mix="stereo_sum")
    assert snr_db(ref_l, bh_l) < 40.0

    with pytest.raises(ValueError):
        native.NativeStreamingUpmixer(EDGES, sr=SR, hw_block_size=HW, window="nope")


def test_native_hard_zero_mode():
    cfg = UpmixConfig.streaming(
        EDGES, sr=SR, hw_block_size=HW, xover_mode="hard_zero"
    )
    eng = native.NativeStreamingUpmixer(
        EDGES,
        sr=SR,
        hw_block_size=HW,
        xover_mode="hard_zero",
        synthesis="analysis",
        bin_rounding="cpp",
    )
    L, R = make_stereo(12 * HW, SR, seed=3)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)
    ref_l, ref_r = oracle_stream_multiband(L32, R32, cfg, HW)
    got_l, got_r = eng.process_signal(L32, R32, mix="stereo_sum")
    assert snr_db(ref_l, got_l) > 60.0
    assert snr_db(ref_r, got_r) > 60.0


def test_native_warmup_and_reset():
    eng = native.NativeStreamingUpmixer(EDGES, sr=SR, hw_block_size=HW)
    assert eng.latency_blocks == 4
    rng = np.random.default_rng(4)
    x = rng.standard_normal(HW).astype(np.float32)
    for k in range(3):
        c, ls, rs = eng.push_block(x, x)
        assert np.all(c == 0.0), f"block {k} should be warmup silence"
    c, ls, rs = eng.push_block(x, x)
    assert np.abs(c).max() > 0.0
    eng.reset()
    c, ls, rs = eng.push_block(x, x)
    assert np.all(c == 0.0)  # warmup restarts after reset


def test_native_block_sizing_matches_config():
    eng = native.NativeStreamingUpmixer(EDGES, sr=SR, hw_block_size=HW)
    cfg = UpmixConfig.streaming(EDGES, sr=SR, hw_block_size=HW)
    assert eng.block_sizes == [b.block_size for b in cfg.bands]


def test_native_invalid_config_raises():
    with pytest.raises(ValueError):
        native.NativeStreamingUpmixer(EDGES, sr=SR, hw_block_size=3)


def test_concurrent_engines_are_independent():
    # Race-safety contract (SURVEY.md §5): engines share no mutable state;
    # two instances on two threads must produce the same results as
    # sequential runs.  (Run against the TSan build via
    # `make -C native tsan` + LD_PRELOAD for full data-race checking.)
    import threading

    L, R = make_stereo(12 * HW, SR, seed=9)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)

    def run():
        eng = native.NativeStreamingUpmixer(EDGES, sr=SR, hw_block_size=HW)
        return eng.process_signal(L32, R32, mix="stereo_sum")

    seq = run()
    results = [None, None]
    threads = [
        threading.Thread(target=lambda i=i: results.__setitem__(i, run()))
        for i in range(2)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for res in results:
        np.testing.assert_array_equal(res[0], seq[0])
        np.testing.assert_array_equal(res[1], seq[1])


def test_native_band_clamp_matches_config():
    # >8 band pairs are clamped to 8, like UpmixConfig.streaming and the
    # reference aggregator.
    edges = [0, 50, 100, 200, 400, 800, 1200, 1600, 2000, 2400, 2800]
    eng = native.NativeStreamingUpmixer(edges, sr=8000.0, hw_block_size=256)
    assert eng.num_bands == 8


@pytest.mark.parametrize("n_threads", [0, 2, 3])
def test_native_band_pool_bit_identical(n_threads):
    # The worker pool (native equivalent of the reference's
    # ThreadPoolExecutor over bands) must produce bit-identical output to
    # the serial engine: bands own their scratch and the band sum is
    # reduced in band order on the calling thread.
    L, R = make_stereo(16 * HW, SR, seed=21)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)

    serial = native.NativeStreamingUpmixer(EDGES, sr=SR, hw_block_size=HW)
    pooled = native.NativeStreamingUpmixer(
        EDGES, sr=SR, hw_block_size=HW, n_threads=n_threads
    )
    ref = serial.process_signal(L32, R32, mix="lcr")
    got = pooled.process_signal(L32, R32, mix="lcr")
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(r, g)
    # And across a reset (pool state must fully recycle).
    pooled.reset()
    got2 = pooled.process_signal(L32, R32, mix="lcr")
    for r, g in zip(ref, got2):
        np.testing.assert_array_equal(r, g)


def test_native_pool_under_tsan():
    # Full data-race check of the band worker pool: run a pooled engine
    # inside ThreadSanitizer (separate process; TSan must be preloaded
    # before the CPython binary).  Skipped unless the TSan build and
    # libtsan are present (`make -C native tsan`).
    import os
    import sys

    root = os.path.join(os.path.dirname(__file__), "..")
    tsan_lib = os.path.join(root, "native", "libupmix_host_tsan.so")
    pre = subprocess.run(
        ["g++", "-print-file-name=libtsan.so"], capture_output=True, text=True
    ).stdout.strip()
    if not pre or not os.path.exists(pre):
        pytest.skip("libtsan not found")
    # Build on demand like the main lib (module-level fixture above):
    # the race gate must actually RUN in the default suite, not
    # green-light because nobody typed `make -C native tsan`.  Always
    # invoke make (it no-ops when fresh) — an existing but STALE build
    # from an older ABI would otherwise fail the version check below.
    subprocess.run(
        ["make", "-C", os.path.join(root, "native"), "tsan"],
        capture_output=True,
    )
    if not os.path.exists(tsan_lib):
        pytest.skip("TSan build failed (make -C native tsan)")
    code = """
import sys
sys.path.insert(0, %r)
import upmix.native.host as host
host._LIB_PATH = %r
host._LIB = None
import numpy as np
rng = np.random.default_rng(0)
L = rng.standard_normal(64*256).astype(np.float32)
R = rng.standard_normal(64*256).astype(np.float32)
eng = host.NativeStreamingUpmixer([0.0, 400.0, 1600.0], sr=8000.0,
                                  hw_block_size=256, n_threads=3)
a = eng.process_signal(L, R)
eng.reset()
b = eng.process_signal(L, R)
np.testing.assert_array_equal(a[0], b[0])
del eng
print("TSAN-POOL-OK")
""" % (os.path.abspath(root), tsan_lib)
    env = dict(os.environ, LD_PRELOAD=pre, TSAN_OPTIONS="exitcode=66")
    r = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        timeout=300,
    )
    assert r.returncode == 0 and "TSAN-POOL-OK" in r.stdout, (
        r.stdout[-500:] + r.stderr[-1500:]
    )


def test_native_random_config_fuzz_vs_oracle():
    # Bounded fuzz over edges/window/xover/rounding/threads: the native
    # engine must hold >60 dB vs the streaming oracle on every draw
    # (mirrors the JAX paths' fuzz coverage).
    rng = np.random.default_rng(4242)
    for trial in range(5):
        sr = float(rng.choice([8000, 16000, 44100]))
        n_edges = int(rng.integers(1, 4))
        edges = [0.0] + sorted(
            float(f) for f in rng.uniform(sr * 0.03, sr * 0.45, size=n_edges)
        )
        window = str(rng.choice(
            ["blackman_harris", "sqrt_hann", "hann", "hamming"]
        ))
        xover = str(rng.choice(["raised_cosine", "hard_zero"]))
        synthesis = str(rng.choice(["wola", "analysis"]))
        rounding = str(rng.choice(["python", "cpp"]))
        n_threads = int(rng.choice([1, 3]))
        cfg = UpmixConfig.streaming(
            edges, sr=sr, hw_block_size=HW, window=window, xover_mode=xover,
            synthesis=synthesis, bin_rounding=rounding,
        )
        eng = native.NativeStreamingUpmixer(
            edges, sr=sr, hw_block_size=HW, window=window, xover_mode=xover,
            synthesis=synthesis, bin_rounding=rounding, n_threads=n_threads,
        )
        L, R = make_stereo(12 * HW, sr, seed=200 + trial)
        L32, R32 = L.astype(np.float32), R.astype(np.float32)
        ref_l, ref_r = oracle_stream_multiband(L32, R32, cfg, HW)
        got_l, got_r = eng.process_signal(L32, R32, mix="stereo_sum")
        desc = (
            f"trial {trial} (sr={sr}, edges={edges}, {window}, {xover}, "
            f"{synthesis}, {rounding}, nt={n_threads})"
        )
        if np.abs(ref_l).max() > 1e-7:
            assert snr_db(ref_l, got_l) > 60.0, desc
            assert snr_db(ref_r, got_r) > 60.0, desc


def test_standalone_cli_binary_matches_python_pipe():
    # The no-Python deployment binary (make -C native cli) must be
    # BIT-identical to `upmix - --pipe --engine native` on the same
    # raw stream (same engine, same alignment/drain semantics).
    import io
    import os
    import sys

    from upmix.app import run_pipe

    root = os.path.join(os.path.dirname(__file__), "..")
    binary = os.path.join(root, "native", "upmix_cli")
    if not os.path.exists(binary):
        mk = subprocess.run(["make", "-C", os.path.join(root, "native"), "cli"],
                            capture_output=True)
        if not os.path.exists(binary):
            pytest.skip(f"binary build failed: {mk.stderr.decode()[-200:]}")

    rng = np.random.default_rng(0)
    n = 3001  # partial final block on purpose
    x = (rng.standard_normal((n, 2)) * 0.3).astype("<f4")
    raw = x.tobytes()

    for mix, ch in (("stereo_sum", 2), ("lcr", 3)):
        pyout = io.BytesIO()
        run_pipe(io.BytesIO(raw), pyout, sr=SR, hw_block_size=HW,
                 band_edges=list(EDGES), engine="native", mix=mix)
        p = subprocess.run(
            [binary, "--sr", str(int(SR)), "--hw", str(HW),
             "--edges", ",".join(str(int(e)) for e in EDGES), "--mix", mix],
            input=raw, capture_output=True, timeout=120)
        assert p.returncode == 0, p.stderr
        ref = np.frombuffer(pyout.getvalue(), "<f4")
        got = np.frombuffer(p.stdout, "<f4")
        assert len(got) == n * ch
        np.testing.assert_array_equal(ref, got)


def test_standalone_cli_rejects_bad_enums():
    import os
    import sys as _sys

    root = os.path.join(os.path.dirname(__file__), "..")
    binary = os.path.join(root, "native", "upmix_cli")
    if not os.path.exists(binary):
        subprocess.run(["make", "-C", os.path.join(root, "native"), "cli"],
                       capture_output=True)
    if not os.path.exists(binary):
        pytest.skip("binary unavailable")
    for flag, val in (("--window", "hanning"), ("--xover", "hz"),
                      ("--synthesis", "wol"), ("--rounding", "py"),
                      ("--mix", "mono")):
        p = subprocess.run([binary, "--sr", "8000", flag, val],
                           input=b"", capture_output=True, timeout=60)
        assert p.returncode == 2, (flag, val, p.returncode)
