"""Kernel parity: JAX offline pipeline vs the NumPy oracle (SURVEY.md §4).

Target: >60 dB SNR; the float32 device path vs the float64
oracle typically lands far above that.
"""

import numpy as np
import pytest

from upmix.config import UpmixConfig
from upmix.models.offline import Upmixer, upmix_offline
from upmix.oracle import oracle_multiband

from helpers import make_stereo, snr_db


def _parity(cfg, n, kind="mix", seed=0, min_snr=60.0):
    L, R = make_stereo(n, cfg.sr, kind=kind, seed=seed)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)
    ref = oracle_multiband(L32, R32, cfg)
    got = upmix_offline(L32, R32, cfg)
    for name, r, g in zip("C Ls Rs".split(), ref, got):
        assert g.shape == r.shape
        s = snr_db(r, g)
        assert s > min_snr, f"{name}: SNR {s:.1f} dB < {min_snr}"


def test_single_band_full_range():
    cfg = UpmixConfig.make([0.0], sr=8000.0, max_block_size=512)
    assert len(cfg.bands) == 1
    _parity(cfg, 4096)


def test_three_band_raised_cosine():
    cfg = UpmixConfig.make([0.0, 400.0, 1600.0], sr=8000.0, max_block_size=512)
    _parity(cfg, 5000)


def test_three_band_hard_zero():
    cfg = UpmixConfig.make(
        [0.0, 400.0, 1600.0], sr=8000.0, max_block_size=512, xover_mode="hard_zero"
    )
    _parity(cfg, 5000, seed=1)


def test_bucket_collision_bands_share_block():
    # Two bands landing on the same block size exercise the bucketed band
    # axis (the default 44.1k config collides the same way — SURVEY §2).
    cfg = UpmixConfig.make([0.0, 5.0, 400.0], sr=8000.0, max_block_size=512)
    assert cfg.bands[0].block_size == cfg.bands[1].block_size
    _parity(cfg, 4096, seed=2)


def test_many_bands():
    cfg = UpmixConfig.make(
        [0, 100, 200, 400, 800, 1200, 1600, 2400, 3200], sr=8000.0, max_block_size=1024
    )
    assert len(cfg.bands) == 9
    _parity(cfg, 6000, seed=3)


def test_awkward_length_and_short_input():
    cfg = UpmixConfig.make([0.0, 400.0], sr=8000.0, max_block_size=256)
    _parity(cfg, 997, seed=4)
    _parity(cfg, 100, seed=5, min_snr=40.0)  # shorter than one block


@pytest.mark.parametrize("kind", ["mono", "noise", "anticorrelated"])
def test_signal_classes(kind):
    cfg = UpmixConfig.make([0.0, 400.0, 1600.0], sr=8000.0, max_block_size=512)
    L, R = make_stereo(4096, cfg.sr, kind=kind, seed=6)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)
    ref = oracle_multiband(L32, R32, cfg)
    got = upmix_offline(L32, R32, cfg)
    for r, g in zip(ref, got):
        if np.max(np.abs(r)) < 1e-6:  # numerically-zero channel (e.g. mono sides)
            assert np.max(np.abs(g)) < 1e-5
        else:
            assert snr_db(r, g) > 60.0


def test_analysis_synthesis_mode():
    # C++-parity synthesis (plain BH synthesis window).
    cfg = UpmixConfig.make(
        [0.0, 400.0], sr=8000.0, max_block_size=512, synthesis="analysis", bin_rounding="cpp"
    )
    _parity(cfg, 4096, seed=7)


def test_upmixer_cache_and_padding():
    cfg = UpmixConfig.make([0.0, 400.0], sr=8000.0, max_block_size=256)
    up = Upmixer(cfg, pad_granularity=1024)
    L, R = make_stereo(3000, cfg.sr, seed=8)
    c1 = up.process_np(L.astype(np.float32), R.astype(np.float32))
    assert len(up._cache) == 1
    L2, R2 = make_stereo(3500, cfg.sr, seed=9)
    up.process_np(L2.astype(np.float32), R2.astype(np.float32))
    # 3000 and 3500 both pad to 3072/3584... granularity 1024 → 3072, 4096
    assert len(up._cache) == 2
    ref = oracle_multiband(L.astype(np.float32), R.astype(np.float32), cfg)
    for r, g in zip(ref, c1):
        assert snr_db(r, g) > 60.0


def test_upmixer_program_cache_lru_bound():
    # Long-lived processes (the --serve job server) must not accumulate
    # compiled programs without bound: the per-length cache is an LRU
    # capped at max_programs, and evicted lengths still recompute.
    import numpy as np

    from upmix.config import UpmixConfig
    from upmix.models.offline import Upmixer

    cfg = UpmixConfig.make([0.0, 400.0], sr=8000.0, max_block_size=256)
    up = Upmixer(cfg, max_programs=2)
    rng = np.random.default_rng(0)
    outs = {}
    for n in (1000, 1500, 2000):  # 3 lengths through a 2-slot cache
        L = rng.standard_normal(n).astype(np.float32)
        outs[n] = (L, up.process_np(L, 0.5 * L))
    assert len(up._cache) == 2
    assert 1000 not in up._cache  # least-recently-used length evicted
    # An evicted length recomputes identically.
    L, (c, ls, rs) = outs[1000][0], outs[1000][1]
    c2, ls2, rs2 = up.process_np(L, 0.5 * L)
    np.testing.assert_array_equal(c, c2)
    np.testing.assert_array_equal(ls, ls2)


@pytest.mark.parametrize("chunk", [1024, 4096])
def test_chunked_scan_carry_matches_whole_file(chunk):
    # The scan's chunk-to-chunk spill carry is exact: a multi-segment run
    # of the 'mm' kernel equals the whole-file 'mm' program to float
    # tolerance (same arithmetic, different summation grouping).
    import jax
    import jax.numpy as jnp

    from upmix.config import UpmixConfig
    from upmix.models.offline import build_offline_chunked_fn, build_offline_fn

    cfg = UpmixConfig.make([0.0, 400.0, 1600.0], sr=8000.0, max_block_size=512)
    n = 3 * chunk + 777  # several segments, not a multiple of the chunk
    rng = np.random.default_rng(0)
    L = jnp.asarray(rng.standard_normal(n), jnp.float32)
    R = jnp.asarray(rng.standard_normal(n), jnp.float32)
    a = jax.jit(build_offline_chunked_fn(cfg, n, kernel="mm", chunk=chunk))(L, R)
    b = jax.jit(build_offline_fn(cfg, n, kernel="mm", chunk=0))(L, R)
    for ya, yb in zip(a, b):
        assert ya.shape == (n,)
        np.testing.assert_allclose(
            np.asarray(ya), np.asarray(yb), atol=2e-5, rtol=0
        )
