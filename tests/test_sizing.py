"""Block sizing, bin mapping, and band chaining goldens (SURVEY.md §4)."""

import pytest

from upmix.config import (
    BandSpec,
    UpmixConfig,
    compute_block_size_for_low_freq,
    freq_to_bin,
    next_power_of_2,
)


def test_next_power_of_2():
    assert next_power_of_2(0) == 1
    assert next_power_of_2(1) == 1
    assert next_power_of_2(2) == 2
    assert next_power_of_2(3) == 4
    assert next_power_of_2(1025) == 2048
    assert next_power_of_2(65536) == 65536


def test_default_44k_block_table():
    # Verified golden from SURVEY.md §4: the main.py default edges
    # [0,30,120,480,1920,7680] at 44.1 kHz produce block sizes
    # 65536/65536/16384/4096/1024/256 (bands 1 and 2 collide on 65536).
    sr = 44100.0
    edges = [0.0, 30.0, 120.0, 480.0, 1920.0, 7680.0]
    blocks = [compute_block_size_for_low_freq(f, sr) for f in edges]
    assert blocks == [65536, 65536, 16384, 4096, 1024, 256]


def test_cpp_48k_stream_table():
    # bela/upmix.cpp:448-467 semantics: clamp to hwBlock*4 = 8192 at 48 kHz
    # with 2048-sample hardware blocks.
    sr, cap = 48000.0, 2048 * 4
    table = {
        0.0: 8192,
        500.0: 4096,
        2000.0: 1024,
        8000.0: 256,
        20.0: 8192,
        5120.0: 512,
    }
    for f, expect in table.items():
        assert compute_block_size_for_low_freq(f, sr, max_block_size=cap) == expect


def test_freq_to_bin_python_vs_cpp_rounding():
    # Python: int(round(f / (sr/fft))) — banker's rounding, unclamped
    # (center_extraction.py:142-154).  C++: lround clamped
    # (bela/upmix.cpp:45-54).
    sr, fft = 48000.0, 1024
    # bin width = 46.875 Hz; f = 23.4375 → exactly 0.5 bins
    assert freq_to_bin(23.4375, sr, fft, "python") == 0  # banker's → even
    assert freq_to_bin(23.4375, sr, fft, "cpp") == 1  # half away from zero
    assert freq_to_bin(70.3125, sr, fft, "python") == 2  # 1.5 → 2 (even)
    assert freq_to_bin(1e9, sr, fft, "cpp") == fft // 2  # clamped
    assert freq_to_bin(1e9, sr, fft, "python") > fft // 2  # unclamped
    with pytest.raises(ValueError):
        freq_to_bin(100.0, sr, fft, "bogus")


def test_chain_bands_defaults():
    # chain_bands appends Nyquist, propagates fade widths across boundaries
    # (center_extraction.py:518-580).
    cfg = UpmixConfig.make([0.0, 30.0, 120.0], sr=44100.0)
    assert len(cfg.bands) == 3
    assert cfg.bands[-1].f_high == 22050.0
    assert cfg.bands[0].xover_width_low_hz == 0.0
    # Both sides of one boundary fade over the same width: band i's high
    # width equals band i+1's low width = 0.25 * boundary freq.
    assert cfg.bands[0].xover_width_high_hz == pytest.approx(7.5)
    assert cfg.bands[1].xover_width_low_hz == pytest.approx(7.5)
    assert cfg.bands[1].xover_width_high_hz == pytest.approx(30.0)
    assert cfg.band_edges == (0.0, 30.0, 120.0, 22050.0)


def test_streaming_config_caps():
    cfg = UpmixConfig.streaming([0.0, 500.0, 2000.0, 8000.0], sr=48000.0, hw_block_size=2048)
    assert [b.block_size for b in cfg.bands] == [8192, 4096, 1024, 256]
    assert all(b.hop_size == b.block_size // 4 for b in cfg.bands)
    # 8-band clamp (bela/upmix.cpp:444-445,508)
    many = UpmixConfig.streaming(
        [0, 100, 200, 400, 800, 1600, 3200, 6400, 9000, 12000, 16000],
        sr=48000.0,
        hw_block_size=2048,
    )
    assert len(many.bands) == 8


def test_hop_validation():
    with pytest.raises(ValueError):
        BandSpec(f_low=0.0, f_high=100.0, sr=8000.0, block_size=4, overlap=0.9)


def test_config_hashable():
    a = UpmixConfig.make([0, 30, 120], sr=44100.0)
    b = UpmixConfig.make([0, 30, 120], sr=44100.0)
    assert hash(a) == hash(b) and a == b


def test_library_edge_validation():
    # UpmixConfig.make rejects bad edge lists at config time (round-1
    # verdict item: the CLI validated but the library accepted descending
    # or duplicate edges silently, producing degenerate bands).
    with pytest.raises(ValueError, match="ascending"):
        UpmixConfig.make([0.0, 400.0, 200.0], sr=8000.0)
    with pytest.raises(ValueError, match="ascending"):
        UpmixConfig.make([0.0, 400.0, 400.0], sr=8000.0)
    with pytest.raises(ValueError, match="non-negative"):
        UpmixConfig.make([-10.0, 400.0], sr=8000.0)
    with pytest.raises(ValueError, match="empty"):
        UpmixConfig.make([], sr=8000.0)
    # Valid single-edge and ascending lists still work.
    assert len(UpmixConfig.make([0.0], sr=8000.0, max_block_size=256).bands) == 1
