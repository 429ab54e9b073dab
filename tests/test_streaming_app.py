"""Application-level streaming path and demo entry point."""

import os
import subprocess
import sys

import numpy as np
import pytest

from upmix.app import run_streaming
from upmix.config import streaming_stft_table
from upmix.io import read_wav, write_wav

from helpers import make_stereo


@pytest.fixture
def wav_path(tmp_path):
    sr = 8000
    L, R = make_stereo(8 * 256, float(sr), seed=0)
    p = tmp_path / "in.wav"
    write_wav(p, np.column_stack([L, R]).astype(np.float32), sr, subtype="FLOAT")
    return p


def test_run_streaming_jax(wav_path, tmp_path):
    out = run_streaming(
        wav_path,
        out_dir=tmp_path / "out",
        hw_block_size=256,
        band_edges=[0, 400, 1600],
    )
    assert len(out.paths) == 1
    assert "Stream_hw256" in os.path.basename(out.paths[0])
    w, sr = read_wav(out.paths[0])
    assert w.shape == (8 * 256, 2)
    assert np.abs(w[4 * 256 :]).max() > 0  # post-warmup audio present


def test_run_streaming_native_matches_jax(wav_path, tmp_path):
    native = pytest.importorskip("upmix.native")
    if not native.is_available():
        pytest.skip("native lib not built")
    a = run_streaming(
        wav_path, out_dir=tmp_path / "a", hw_block_size=256, band_edges=[0, 400, 1600]
    )
    b = run_streaming(
        wav_path,
        out_dir=tmp_path / "b",
        hw_block_size=256,
        band_edges=[0, 400, 1600],
        engine="native",
    )
    wa, _ = read_wav(a.paths[0])
    wb, _ = read_wav(b.paths[0])
    err = np.abs(wa - wb).max()
    assert err < 1e-3, f"jax/native mismatch {err}"


def test_run_streaming_split_export(wav_path, tmp_path):
    # export_mode="split": the three discrete channels with the offline
    # split layout (Ls/-, C/C, -/Rs).
    out = run_streaming(
        wav_path,
        out_dir=tmp_path / "out",
        hw_block_size=256,
        band_edges=[0, 400, 1600],
        export_mode="split",
    )
    assert len(out.paths) == 3
    tags = [os.path.basename(p) for p in out.paths]
    assert any("_Ls_" in t for t in tags)
    assert any("_C_" in t for t in tags)
    assert any("_Rs_" in t for t in tags)
    ls, _ = read_wav(out.paths[0])
    c, _ = read_wav(out.paths[1])
    rs, _ = read_wav(out.paths[2])
    assert np.abs(ls[:, 1]).max() == 0.0  # Ls right channel silent
    assert np.array_equal(c[:, 0], c[:, 1])  # C duplicated
    assert np.abs(rs[:, 0]).max() == 0.0  # Rs left channel silent
    # stereo_sum must be reconstructable from the split outputs.
    sum_out = run_streaming(
        wav_path, out_dir=tmp_path / "sum", hw_block_size=256,
        band_edges=[0, 400, 1600],
    )
    w, _ = read_wav(sum_out.paths[0])
    np.testing.assert_allclose(w[:, 0], ls[:, 0] + 0.5 * c[:, 0], atol=1e-6)
    np.testing.assert_allclose(w[:, 1], rs[:, 1] + 0.5 * c[:, 1], atol=1e-6)

    with pytest.raises(ValueError):
        run_streaming(wav_path, out_dir=tmp_path / "x", export_mode="AB")


def test_run_streaming_bad_engine(wav_path, tmp_path):
    with pytest.raises(ValueError):
        run_streaming(wav_path, out_dir=tmp_path, hw_block_size=256, engine="cuda")


def test_streaming_stft_table():
    table = streaming_stft_table(48000.0, 2048)
    assert "stft 8192" in table  # low freqs capped at hw*4
    assert "5120" in table


def test_cli_streaming(wav_path, tmp_path):
    from upmix.cli import main

    rc = main(
        [
            str(wav_path),
            "--streaming",
            "--hw-block",
            "256",
            "--band-edges",
            "0,400,1600",
            "--out-dir",
            str(tmp_path / "cli_out"),
            "--meter",
        ]
    )
    assert rc == 0
    outs = os.listdir(tmp_path / "cli_out")
    assert len(outs) == 1 and "Stream" in outs[0]


def test_cli_upmixer_cache_reuse(tmp_path):
    # Two same-rate files must share one Upmixer via the cache.
    from upmix.app import run_offline

    sr = 8000
    paths = []
    for i in range(2):
        L, R = make_stereo(2000, float(sr), seed=i)
        p = tmp_path / f"in{i}.wav"
        write_wav(p, np.column_stack([L, R]).astype(np.float32), sr, subtype="FLOAT")
        paths.append(p)
    cache = {}
    for p in paths:
        run_offline(
            p,
            out_dir=tmp_path / "out",
            band_edges=[0, 400],
            max_block_size=256,
            pad_granularity=4096,
            upmixer_cache=cache,
        )
    assert len(cache) == 1
    up = next(iter(cache.values()))
    assert len(up._cache) == 1  # both lengths padded to one compiled program


def test_upmixer_cache_config_keyed(tmp_path):
    # A shared cache must NOT reuse an Upmixer across differing configs
    # (round-1 advisor finding: it was keyed by sample rate only).
    from upmix.app import run_offline

    sr = 8000
    L, R = make_stereo(2000, float(sr), seed=0)
    p = tmp_path / "in.wav"
    write_wav(p, np.column_stack([L, R]).astype(np.float32), sr, subtype="FLOAT")
    cache = {}
    run_offline(p, out_dir=tmp_path / "out", band_edges=[0, 400],
                max_block_size=256, upmixer_cache=cache)
    run_offline(p, out_dir=tmp_path / "out", band_edges=[0, 400, 1600],
                max_block_size=256, upmixer_cache=cache)
    assert len(cache) == 2
    n_bands = sorted(len(k[0].bands) for k in cache)
    assert n_bands == [2, 3]


def test_demo_entry(tmp_path, wav_path):
    pytest.importorskip("matplotlib")
    from upmix.demo import run_demo

    win_png, cmp_png = run_demo(
        wav_path, out_dir=tmp_path / "demo", band_edges=[0.0, 400.0, 1600.0]
    )
    assert os.path.exists(win_png)
    assert os.path.exists(cmp_png)


def _cpu_child_env():
    from helpers import cpu_child_env

    return cpu_child_env()


def _pipe_reference(L32, R32, sr, hw, edges):
    """Aligned reference: raw stream over input + warmup-1 zero blocks,
    shifted left by the (warmup-1)*hw engine latency, trimmed to len."""
    from upmix.config import UpmixConfig
    from upmix.models.streaming import StreamingUpmixer

    cfg = UpmixConfig.streaming(edges, sr=float(sr), hw_block_size=hw)
    s = StreamingUpmixer(cfg, hw)
    n = len(L32)
    lat = (s.warmup_blocks - 1) * hw
    pad = (-n) % hw + lat
    Lp = np.pad(L32, (0, pad))
    Rp = np.pad(R32, (0, pad))
    rl, rr = (np.asarray(o) for o in s.process_signal(Lp, Rp, mix="stereo_sum"))
    return rl[lat : lat + n], rr[lat : lat + n]


def test_pipe_mode_matches_streaming_engine():
    # Raw-PCM filter surface: bytes through the CLI pipe must match the
    # latency-ALIGNED streaming reference (default align semantics:
    # output frame i corresponds to input frame i, len(out) == len(in),
    # including the drained tail after a partial final block).
    sr, hw = 8000, 256
    n = 6 * hw + 100  # partial final block
    L, R = make_stereo(n, float(sr), seed=13)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)
    raw = np.column_stack([L32, R32]).astype("<f4").tobytes()

    proc = subprocess.run(
        [
            sys.executable, "-m", "upmix.cli", "-",
            "--pipe", "--sr", str(sr), "--hw-block", str(hw),
            "--band-edges", "0,400,1600",
        ],
        input=raw, capture_output=True, env=_cpu_child_env(),
        cwd=os.path.join(os.path.dirname(__file__), ".."),
    )
    assert proc.returncode == 0, proc.stderr.decode()[-500:]
    out = np.frombuffer(proc.stdout, dtype="<f4").reshape(-1, 2)
    assert out.shape[0] == n

    rl, rr = _pipe_reference(L32, R32, sr, hw, [0, 400, 1600])
    np.testing.assert_allclose(out[:, 0], rl, atol=1e-5)
    np.testing.assert_allclose(out[:, 1], rr, atol=1e-5)


def test_pipe_raw_mode_and_short_reads():
    # align=False emits the raw real-time stream; and a source that
    # delivers short reads (raw/unbuffered pipe semantics) must not be
    # mistaken for EOF.
    import io

    from upmix.app import run_pipe
    from upmix.config import UpmixConfig
    from upmix.models.streaming import StreamingUpmixer

    sr, hw = 8000, 256
    n = 5 * hw
    L, R = make_stereo(n, float(sr), seed=14)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)
    raw = np.column_stack([L32, R32]).astype("<f4").tobytes()

    class Dribble(io.RawIOBase):
        """Returns at most 1000 bytes per read (legal short reads)."""

        def __init__(self, data):
            self._data = data
            self._pos = 0

        def readable(self):
            return True

        def read(self, size=-1):
            if self._pos >= len(self._data):
                return b""
            k = min(1000, size if size >= 0 else 1000, len(self._data) - self._pos)
            out = self._data[self._pos : self._pos + k]
            self._pos += k
            return out

    sink = io.BytesIO()
    emitted = run_pipe(
        Dribble(raw), sink, sr=sr, hw_block_size=hw,
        band_edges=[0, 400, 1600], align=False,
    )
    assert emitted == n
    out = np.frombuffer(sink.getvalue(), dtype="<f4").reshape(-1, 2)
    cfg = UpmixConfig.streaming([0, 400, 1600], sr=float(sr), hw_block_size=hw)
    s = StreamingUpmixer(cfg, hw)
    rl, rr = (np.asarray(o) for o in s.process_signal(L32, R32, mix="stereo_sum"))
    np.testing.assert_allclose(out[:, 0], rl, atol=1e-5)
    np.testing.assert_allclose(out[:, 1], rr, atol=1e-5)


def test_pipe_broken_downstream_exits_quietly(tmp_path):
    # Downstream closing early (head, user quitting a player) must not
    # produce a traceback — rc 0, quiet stderr.
    sr, hw = 8000, 256
    # Enough blocks that output far exceeds what `head` consumes, so the
    # writer reliably hits the closed pipe.
    L, R = make_stereo(64 * hw, float(sr), seed=15)
    raw_path = tmp_path / "in.raw"
    raw_path.write_bytes(np.column_stack([L, R]).astype("<f4").tobytes())
    err_path = tmp_path / "err.txt"
    cmd = (
        f"set -o pipefail; {sys.executable} -m upmix.cli - --pipe "
        f"--sr {sr} --hw-block {hw} --band-edges 0,400,1600 "
        f"< {raw_path} 2> {err_path} | head -c 64 > /dev/null"
    )
    proc = subprocess.run(
        ["bash", "-c", cmd], capture_output=True, env=_cpu_child_env(),
        cwd=os.path.join(os.path.dirname(__file__), ".."),
    )
    err = err_path.read_bytes()
    assert proc.returncode == 0, (proc.returncode, err[-400:])
    assert b"Traceback" not in err, err[-400:]
