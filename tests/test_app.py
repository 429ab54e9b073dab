"""Application-layer integration: load/scale/export semantics and filename
encoding (SURVEY.md §4 integration tier; reference main.py:25-165)."""

import numpy as np
import pytest

from upmix.app import band_info_str, export_lcr, load_stereo, run_offline, scale_lcr
from upmix.config import UpmixConfig
from upmix.io import read_wav, write_wav

from helpers import make_stereo

SR = 8000
EDGES = [0.0, 400.0, 1600.0]


def _write_input(tmp_path, n=4096, kind="mix", name="song.wav", stereo=True):
    L, R = make_stereo(n, SR, kind=kind)
    data = np.column_stack([L, R]) * 0.5 if stereo else (L * 0.5)
    path = tmp_path / name
    write_wav(path, data, SR)
    return path, L * 0.5, R * 0.5


def _cfg():
    return UpmixConfig.make(EDGES, sr=float(SR), max_block_size=512)


def test_mono_duplication(tmp_path):
    path, L, _ = _write_input(tmp_path, stereo=False)
    l, r, sr, peak = load_stereo(path)
    np.testing.assert_array_equal(l, r)
    assert sr == SR
    assert peak == pytest.approx(np.max(np.abs(L)), abs=1e-4)


def test_silent_file_guard(tmp_path):
    path = tmp_path / "silent.wav"
    write_wav(path, np.zeros((1000, 2)), SR)
    _, _, _, peak = load_stereo(path)
    assert peak == 1e-9


def test_peak_norm_invariant():
    rng = np.random.default_rng(0)
    C, Ls, Rs = (rng.standard_normal(1000).astype(np.float32) * s for s in (3.0, 2.0, 1.0))
    peak_in = 0.7
    C2, Ls2, Rs2, scale = scale_lcr(C, Ls, Rs, peak_in)
    m = max(np.abs(C2).max(), np.abs(Ls2).max(), np.abs(Rs2).max())
    assert m == pytest.approx(peak_in, rel=1e-5)
    assert scale == pytest.approx(peak_in / np.abs(C).max(), rel=1e-6)


def test_band_info_encoding():
    cfg = _cfg()
    info = band_info_str(cfg)
    assert info == "_".join(
        f"b{b.block_size}({int(b.f_low)}-{int(b.f_high)})" for b in cfg.bands
    )
    assert info.startswith("b512(0-400)")


def test_export_ab(tmp_path):
    cfg = _cfg()
    n = 2000
    C, Ls, Rs, L, R = (np.random.default_rng(i).standard_normal(n).astype(np.float32) * 0.1
                       for i in range(5))
    res = export_lcr(tmp_path, "x", "AB", C, Ls, Rs, L, R, SR, cfg)
    assert len(res.paths) == 1
    assert "_AB_" in res.paths[0] and "_ov0.75" in res.paths[0]
    y, _ = read_wav(res.paths[0])
    np.testing.assert_allclose(y[:, 0], (Ls + C + Rs).astype(np.float64), atol=1e-7)
    np.testing.assert_allclose(y[:, 1], (L + R).astype(np.float64), atol=1e-7)


def test_export_split(tmp_path):
    cfg = _cfg()
    n = 1500
    C, Ls, Rs, L, R = (np.random.default_rng(i).standard_normal(n).astype(np.float32) * 0.1
                       for i in range(5))
    res = export_lcr(tmp_path, "x", "split", C, Ls, Rs, L, R, SR, cfg)
    assert len(res.paths) == 3
    # split filenames carry no overlap suffix (main.py:131-141)
    assert all("_ov" not in p for p in res.paths)
    ls, _ = read_wav(res.paths[0])
    c, _ = read_wav(res.paths[1])
    rs, _ = read_wav(res.paths[2])
    np.testing.assert_allclose(ls[:, 0], Ls, atol=1e-7)
    assert np.all(ls[:, 1] == 0)
    np.testing.assert_allclose(c[:, 0], c[:, 1], atol=0)
    assert np.all(rs[:, 0] == 0)
    np.testing.assert_allclose(rs[:, 1], Rs, atol=1e-7)


def test_export_stereo_sum(tmp_path):
    cfg = _cfg()
    n = 1500
    C, Ls, Rs, L, R = (np.random.default_rng(i).standard_normal(n).astype(np.float32) * 0.1
                       for i in range(5))
    res = export_lcr(tmp_path, "x", "stereo_sum", C, Ls, Rs, L, R, SR, cfg)
    y, _ = read_wav(res.paths[0])
    assert "_Sum_" in res.paths[0]
    np.testing.assert_allclose(y[:, 0], (Ls + 0.5 * C).astype(np.float64), atol=1e-7)
    np.testing.assert_allclose(y[:, 1], (Rs + 0.5 * C).astype(np.float64), atol=1e-7)


def test_export_unknown_mode(tmp_path):
    cfg = _cfg()
    z = np.zeros(10, np.float32)
    with pytest.raises(ValueError):
        export_lcr(tmp_path, "x", "quad", z, z, z, z, z, SR, cfg)


def test_run_offline_end_to_end(tmp_path):
    path, L, R = _write_input(tmp_path)
    res = run_offline(
        path,
        out_dir=tmp_path / "out",
        export_mode="stereo_sum",
        band_edges=EDGES,
        max_block_size=512,
    )
    assert len(res.paths) == 1
    y, sr = read_wav(res.paths[0])
    assert sr == SR and y.shape[0] == len(L)
    # peak-norm invariant: output channels bounded by ~input peak
    peak_in = max(np.abs(L).max(), np.abs(R).max())
    assert np.abs(y).max() <= peak_in * 1.5 + 1e-6
    assert res.scale_factor > 0
