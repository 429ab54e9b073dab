"""Bela adapter exercised end-to-end under a MOCK Bela runtime.

native/bela_render.cpp is the L4 audio-callback glue (reference entry
points: bela/upmix.cpp:516-553).  On the board it builds against the real
SDK; here `make -C native bela-mock` compiles the SAME translation unit
against native/mock_bela/Bela.h and a host driver (bela_mock_main.cpp)
that feeds hardware blocks through setup()/render()/cleanup(), so the
adapter's actual behavior — config construction, per-block audioRead/
audioWrite plumbing, warmup silence, and the out = side + 0.5*center
downmix (bela/upmix.cpp:289-304) — is verified, not just parsed.

Skipped when the toolchain can't build the mock binary.
"""

import os
import subprocess

import numpy as np
import pytest

from upmix.config import UpmixConfig
from upmix.oracle.reference import oracle_stream_multiband

from helpers import make_stereo, snr_db

NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "native")
BIN = os.path.join(NATIVE_DIR, "bela_mock")

if not os.path.exists(BIN):
    _mk = subprocess.run(
        ["make", "-C", NATIVE_DIR, "bela-mock"], capture_output=True
    )
    if not os.path.exists(BIN):  # pragma: no cover
        pytest.skip(
            f"bela_mock unavailable: {_mk.stderr.decode()[-200:]}",
            allow_module_level=True,
        )

# The adapter hardcodes the shipped reference band edges
# (bela/upmix.cpp:525-526); sr/block come from the BelaContext.  A small
# 16 kHz / 256-sample context keeps the oracle fast while still giving
# three bands below Nyquist.
EDGES = [0.0, 500.0, 2000.0, 8000.0]
SR, HW = 16000.0, 256


def run_mock(L32: np.ndarray, R32: np.ndarray, sr=SR, hw=HW):
    inter = np.empty(2 * len(L32), np.float32)
    inter[0::2] = L32
    inter[1::2] = R32
    p = subprocess.run(
        [BIN, "--sr", repr(sr), "--block", str(hw)],
        input=inter.tobytes(),
        capture_output=True,
    )
    assert p.returncode == 0, p.stderr.decode()
    out = np.frombuffer(p.stdout, dtype=np.float32)
    return out[0::2], out[1::2]


def test_bela_mock_parity_vs_streaming_oracle():
    n = 24 * HW
    L, R = make_stereo(n, SR, seed=3)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)
    cfg = UpmixConfig.streaming(EDGES, sr=SR, hw_block_size=HW)
    ref_l, ref_r = oracle_stream_multiband(L32, R32, cfg, HW)
    got_l, got_r = run_mock(L32, R32)
    assert len(got_l) == len(ref_l) == n
    assert snr_db(ref_l, got_l) > 60.0
    assert snr_db(ref_r, got_r) > 60.0


def test_bela_mock_warmup_blocks_are_silent():
    # Uniform K = block/hop = 4 readiness (bela/upmix.cpp:232-237): the
    # first 3 hardware callbacks emit silence while history fills; the 4th
    # callback (block index 3) sees K blocks buffered and emits the first
    # hops.  The streaming oracle places the first nonzero sample at the
    # same spot (3*HW) — asserted against it, not just hardcoded.
    L, R = make_stereo(8 * HW, SR, seed=4)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)
    got_l, got_r = run_mock(L32, R32)
    assert np.all(got_l[: 3 * HW] == 0.0)
    assert np.all(got_r[: 3 * HW] == 0.0)
    assert np.any(got_l[3 * HW : 4 * HW] != 0.0)
    cfg = UpmixConfig.streaming(EDGES, sr=SR, hw_block_size=HW)
    ref_l, _ = oracle_stream_multiband(L32, R32, cfg, HW)
    assert np.nonzero(ref_l)[0][0] == np.nonzero(got_l)[0][0]


def test_bela_mock_drops_partial_tail():
    # A real-time host never renders a fractional hardware block.
    n = 6 * HW + HW // 2
    L, R = make_stereo(n, SR, seed=5)
    got_l, got_r = run_mock(L.astype(np.float32), R.astype(np.float32))
    assert len(got_l) == 6 * HW
    assert len(got_r) == 6 * HW


def test_bela_mock_agrees_with_native_stereo_sum():
    # The adapter's downmix must match the library's stereo_sum path
    # bit-for-bit: identical engine, identical mix arithmetic.
    native = pytest.importorskip("upmix.native")
    if not native.is_available():
        subprocess.run(["make", "-C", NATIVE_DIR], capture_output=True)
    if not native.is_available():  # pragma: no cover
        pytest.skip("native lib unavailable")
    L, R = make_stereo(12 * HW, SR, seed=6)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)
    # The Bela adapter defaults to the float32 fast mode (bela_render.cpp
    # UPMIX_BELA_PRECISION) — match it for the bit-for-bit comparison.
    eng = native.NativeStreamingUpmixer(
        EDGES, sr=SR, hw_block_size=HW, synthesis="analysis",
        bin_rounding="cpp", precision="float",
    )
    ref_l, ref_r = eng.process_signal(L32, R32, mix="stereo_sum")
    got_l, got_r = run_mock(L32, R32)
    np.testing.assert_array_equal(got_l, ref_l)
    np.testing.assert_array_equal(got_r, ref_r)


def test_bela_mock_rejects_garbage_flags():
    p = subprocess.run(
        [BIN, "--block", "foo"], input=b"", capture_output=True
    )
    assert p.returncode == 2
    p = subprocess.run([BIN, "--sr", "4x8000"], input=b"", capture_output=True)
    assert p.returncode == 2
