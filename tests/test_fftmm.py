"""Matmul-FFT kernel tests: transform correctness vs numpy in the permuted
layout, layout helpers, and full-pipeline parity of the "mm" kernel vs the
NumPy oracle (forced on CPU, where "auto" would pick "xla")."""

import numpy as np
import pytest

import jax.numpy as jnp

from upmix.config import UpmixConfig
from upmix.models.offline import resolve_kernel, upmix_offline
from upmix.oracle import oracle_multiband
from upmix.ops.fftmm import (
    bin_of,
    conj_mirror,
    fft_mm,
    half_to_full,
    ifft_mm,
    irfft_mm,
    make_plan,
    pair_irfft_mm,
    permute_bins,
    stereo_rfft_mm,
)

from helpers import make_stereo, snr_db


@pytest.mark.parametrize("n", [16, 256, 1024, 4096])
def test_fft_mm_matches_numpy(n):
    plan = make_plan(n)
    assert plan.n1 * plan.n2 == n
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))).astype(
        np.complex64
    )
    Z = np.asarray(fft_mm(jnp.asarray(x), plan))
    ref = np.fft.fft(x)
    k1 = np.arange(plan.n1)[:, None]
    k2 = np.arange(plan.n2)[None, :]
    refp = ref[:, bin_of(plan, k1, k2)]
    assert np.abs(Z - refp).max() / np.abs(ref).max() < 1e-5
    y = np.asarray(ifft_mm(jnp.asarray(Z), plan))
    assert np.abs(y - x).max() / np.abs(x).max() < 1e-5


@pytest.mark.parametrize("n", [256, 1024])
def test_stereo_pack_unpack(n):
    plan = make_plan(n)
    rng = np.random.default_rng(1)
    l = rng.standard_normal((2, n)).astype(np.float32)
    r = rng.standard_normal((2, n)).astype(np.float32)
    sl, sr = stereo_rfft_mm(jnp.asarray(l), jnp.asarray(r), plan)
    k1 = np.arange(plan.n1)[:, None]
    k2 = np.arange(plan.n2)[None, :]
    idx = bin_of(plan, k1, k2)
    assert np.abs(np.asarray(sl) - np.fft.fft(l)[:, idx]).max() < 1e-3
    assert np.abs(np.asarray(sr) - np.fft.fft(r)[:, idx]).max() < 1e-3
    y0, y1 = pair_irfft_mm(sl, sr, plan)
    assert np.abs(np.asarray(y0) - l).max() < 1e-5
    assert np.abs(np.asarray(y1) - r).max() < 1e-5
    y2 = irfft_mm(sl, plan)
    assert np.abs(np.asarray(y2) - l).max() < 1e-5


def test_conj_mirror_is_negation_map():
    plan = make_plan(64)
    z = np.arange(64, dtype=np.complex64).reshape(plan.n1, plan.n2)
    # entry (k1,k2) holds bin value k1 + n1*k2 — mirror must hold (-k)%n
    m = np.asarray(conj_mirror(jnp.asarray(z)))
    k1 = np.arange(plan.n1)[:, None]
    k2 = np.arange(plan.n2)[None, :]
    k = bin_of(plan, k1, k2)
    flat = np.zeros(64, dtype=np.complex64)
    flat[k.reshape(-1)] = z.reshape(-1)
    expect = flat[(-k) % 64]
    np.testing.assert_allclose(m, expect)


def test_permute_and_half_to_full():
    plan = make_plan(16)
    half = np.arange(9, dtype=np.float32)
    full = half_to_full(half, 16)
    assert full[0] == 0 and full[8] == 8
    np.testing.assert_array_equal(full[9:], half[1:8][::-1])
    perm = permute_bins(plan, full)
    k1 = np.arange(plan.n1)[:, None]
    k2 = np.arange(plan.n2)[None, :]
    np.testing.assert_array_equal(perm, full[bin_of(plan, k1, k2)])


def test_non_power_of_two_rejected():
    with pytest.raises(ValueError):
        make_plan(48)


def test_resolve_kernel():
    assert resolve_kernel("mm") == "mm"
    assert resolve_kernel("xla") == "xla"
    assert resolve_kernel("auto") in ("mm", "xla")
    with pytest.raises(ValueError):
        resolve_kernel("cuda")


def test_mm_pipeline_parity_vs_oracle():
    cfg = UpmixConfig.make([0.0, 400.0, 1600.0], sr=8000.0, max_block_size=512)
    L, R = make_stereo(5000, cfg.sr, seed=0)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)
    ref = oracle_multiband(L32, R32, cfg)
    got = upmix_offline(L32, R32, cfg, kernel="mm")
    for name, r, g in zip("C Ls Rs".split(), ref, got):
        s = snr_db(r, g)
        assert s > 60.0, f"{name}: {s:.1f} dB"


def test_mm_matches_xla_kernel():
    cfg = UpmixConfig.make([0.0, 400.0], sr=8000.0, max_block_size=256)
    L, R = make_stereo(3000, cfg.sr, seed=1)
    a = upmix_offline(L.astype(np.float32), R.astype(np.float32), cfg, kernel="xla")
    b = upmix_offline(L.astype(np.float32), R.astype(np.float32), cfg, kernel="mm")
    for x, y in zip(a, b):
        assert snr_db(x, y) > 80.0


def test_banded_plan_and_transforms():
    from upmix.ops.fftmm import (
        conj_mirror_banded,
        fft_banded,
        ifft_banded,
        make_banded_plan,
        pair_irfft_banded,
        permute_bins_banded,
        stereo_rfft_banded,
    )

    n = 1024
    bp = make_banded_plan(n, 10, 80)  # narrow support -> few columns
    assert bp.n_cols < bp.base.n2
    # support columns (bins 10..80 and their conjugate mirrors) are kept
    support_cols = {b // bp.base.n1 for b in range(10, 81)}
    support_cols |= {((-b) % n) // bp.base.n1 for b in range(10, 81)}
    assert support_cols <= set(bp.cols)

    rng = np.random.default_rng(2)
    l = rng.standard_normal((3, n)).astype(np.float32)
    r = rng.standard_normal((3, n)).astype(np.float32)
    sl, sr = stereo_rfft_banded(jnp.asarray(l), jnp.asarray(r), bp)
    # banded forward must agree with numpy on the SUPPORT columns (the
    # mirror-only columns are contractually garbage — see make_banded_plan)
    ref = np.fft.fft(l)
    k1 = np.arange(bp.base.n1)[:, None]
    sup_idx = [i for i, c in enumerate(bp.cols) if c in support_cols]
    k2s = np.asarray([bp.cols[i] for i in sup_idx])[None, :]
    refb = ref[:, k1 + bp.base.n1 * k2s]
    assert (
        np.abs(np.asarray(sl)[..., sup_idx] - refb).max() / np.abs(ref).max() < 1e-5
    )

    # gain -> inverse round-trip: zero outside support, compare vs numpy
    g_half = np.zeros(n // 2 + 1, np.float32)
    g_half[10:81] = 1.0
    g_full = half_to_full(g_half, n)
    gp = jnp.asarray(permute_bins_banded(bp, g_full))
    y0, y1 = pair_irfft_banded(sl * gp, sr * gp, bp)
    ref_y0 = np.fft.irfft(np.fft.rfft(l) * g_half, n=n)
    ref_y1 = np.fft.irfft(np.fft.rfft(r) * g_half, n=n)
    assert np.abs(np.asarray(y0) - ref_y0).max() < 1e-5
    assert np.abs(np.asarray(y1) - ref_y1).max() < 1e-5


def test_banded_full_support_degenerates_to_full():
    from upmix.ops.fftmm import make_banded_plan

    bp = make_banded_plan(256, 0, 128)
    assert bp.is_full


def test_chunked_scan_parity_vs_oracle():
    from upmix.models.offline import build_offline_chunked_fn

    import jax

    cfg = UpmixConfig.make([0.0, 400.0, 1600.0], sr=8000.0, max_block_size=512)
    n = 10000
    L, R = make_stereo(n, cfg.sr, seed=3)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)
    ref = oracle_multiband(L32, R32, cfg)
    fn = jax.jit(build_offline_chunked_fn(cfg, n, kernel="mm", chunk=2048))
    got = fn(jnp.asarray(L32), jnp.asarray(R32))
    for name, r, g in zip("C Ls Rs".split(), ref, got):
        s = snr_db(r, np.asarray(g))
        assert s > 60.0, f"{name}: {s:.1f} dB"


def test_chunked_matches_whole_file():
    from upmix.models.offline import build_offline_chunked_fn, build_offline_fn

    import jax

    cfg = UpmixConfig.make([0.0, 400.0], sr=8000.0, max_block_size=256)
    n = 7000
    L, R = make_stereo(n, cfg.sr, seed=4)
    L32, R32 = jnp.asarray(L, jnp.float32), jnp.asarray(R, jnp.float32)
    whole = jax.jit(build_offline_fn(cfg, n, kernel="mm", chunk=0))(L32, R32)
    chunked = jax.jit(build_offline_chunked_fn(cfg, n, kernel="mm", chunk=1024))(L32, R32)
    for a, b in zip(whole, chunked):
        assert snr_db(np.asarray(a), np.asarray(b)) > 100.0


def test_tiny_chunk_rounded_up_to_block_lcm():
    # chunk is rounded up to a multiple of every block size, which also
    # guarantees chunk >= halo (max block > max block - hop).
    import jax

    from upmix.models.offline import build_offline_chunked_fn

    cfg = UpmixConfig.make([0.0, 400.0], sr=8000.0, max_block_size=512)
    n = 4096
    fn = jax.jit(build_offline_chunked_fn(cfg, n, kernel="mm", chunk=128))
    L, R = make_stereo(n, cfg.sr, seed=7)
    got = fn(jnp.asarray(L, jnp.float32), jnp.asarray(R, jnp.float32))
    ref = oracle_multiband(L.astype(np.float32), R.astype(np.float32), cfg)
    for r, g in zip(ref, got):
        assert snr_db(r, np.asarray(g)) > 60.0


def test_chunked_rounds_chunk_to_block_lcm():
    # A chunk that is a multiple of every hop but not every block must be
    # rounded up so grouped framing stays valid (e.g. 50% overlap, K=2).
    import jax

    from upmix.models.offline import build_offline_chunked_fn

    cfg = UpmixConfig.make(
        [0.0, 400.0], sr=8000.0, max_block_size=512, overlap=0.5
    )
    n = 6000
    L, R = make_stereo(n, cfg.sr, seed=6)
    fn = jax.jit(build_offline_chunked_fn(cfg, n, kernel="mm", chunk=768))
    got = fn(jnp.asarray(L, jnp.float32), jnp.asarray(R, jnp.float32))
    ref = oracle_multiband(L.astype(np.float32), R.astype(np.float32), cfg)
    for r, g in zip(ref, got):
        assert snr_db(r, np.asarray(g)) > 60.0


# The chunked scan (models/offline.py build_offline_chunked_fn) runs every
# bucket through the grouped-framing matmul fold; each case holds the
# oracle bar on all three channels and matches the whole-file 'mm'
# program.  Cases cover chunk sizes (incl. a chunk smaller than the big
# bucket's hop), 50% overlap, hard-zero crossovers and the 8-band limit.
_SCAN_CASES = {
    "chunk1024": dict(edges=[0.0, 400.0, 1600.0], chunk=1024),
    "chunk2048": dict(edges=[0.0, 100.0, 400.0, 1600.0], chunk=2048),
    "chunk4096_one_segment": dict(edges=[0.0, 400.0, 1600.0], chunk=16384),
    "overlap50": dict(edges=[0.0, 100.0, 400.0, 1600.0], overlap=0.5,
                      chunk=1024),
    "overlap50_hop_exceeds_chunk": dict(edges=[0.0, 2000.0], overlap=0.5,
                                        chunk=512),
    "hard_zero": dict(edges=[0.0, 100.0, 400.0, 1600.0],
                      xover_mode="hard_zero", chunk=2048),
    "8band": dict(edges=[0.0, 60.0, 120.0, 250.0, 500.0, 1000.0, 2000.0,
                         3000.0], max_block=1024, chunk=2048),
    "hann_window": dict(edges=[0.0, 400.0, 1600.0], window="hann",
                        chunk=2048),
    "analysis_synthesis": dict(edges=[0.0, 400.0, 1600.0],
                               synthesis="analysis", bin_rounding="cpp",
                               chunk=2048),
    "max_block_1024": dict(edges=[0.0, 100.0, 400.0, 1600.0],
                           max_block=1024, chunk=4096),
}


@pytest.mark.parametrize("case", sorted(_SCAN_CASES))
def test_chunked_scan_cases_vs_oracle(case):
    import jax

    from upmix.models.offline import build_offline_chunked_fn, build_offline_fn

    kw = dict(_SCAN_CASES[case])
    chunk = kw.pop("chunk")
    cfg = UpmixConfig.make(
        kw.pop("edges"), sr=8000.0, max_block_size=kw.pop("max_block", 512),
        **kw,
    )
    n = 9000
    L, R = make_stereo(n, cfg.sr, seed=5)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)
    ref = oracle_multiband(L32, R32, cfg)
    args = (jnp.asarray(L32), jnp.asarray(R32))
    got = jax.jit(build_offline_chunked_fn(cfg, n, kernel="mm", chunk=chunk))(*args)
    whole = jax.jit(build_offline_fn(cfg, n, kernel="mm", chunk=0))(*args)
    for name, r, g, w in zip("C Ls Rs".split(), ref, got, whole):
        s = snr_db(r, np.asarray(g))
        assert s > 60.0, f"{case} {name}: {s:.1f} dB"
        assert snr_db(np.asarray(w), np.asarray(g)) > 100.0, f"{case} {name}"


@pytest.mark.parametrize(
    "edges,overlap",
    [([0.0, 400.0, 1600.0], 0.75), ([0.0, 2000.0], 0.5),
     ([0.0, 100.0, 400.0, 1600.0], 0.75)],
)
def test_bucket_fold_matches_xla_bucket(edges, overlap):
    # The scan body's per-bucket matmul fold against the jnp.fft bucket
    # over the same frames (both whole-signal, trimmed to n).
    from upmix.models.offline import _bucket_lcr, _bucket_lcr_mm, _plan_buckets

    cfg = UpmixConfig.make(edges, sr=8000.0, max_block_size=512,
                           overlap=overlap)
    n = 5000
    rng = np.random.default_rng(3)
    L = jnp.asarray(rng.standard_normal(n), jnp.float32)
    R = jnp.asarray(rng.standard_normal(n), jnp.float32)
    for p in _plan_buckets(cfg, n):
        want = np.asarray(_bucket_lcr(p, L, R, n))
        got = np.asarray(_bucket_lcr_mm(p, L, R, n))
        assert snr_db(want, got) > 100.0, f"bucket {p.block_size}"


def test_chunked_scan_random_config_fuzz():
    # Bounded fuzz of the chunked scan: random edges, rates, caps, and
    # xover modes must hold >60 dB vs the oracle over several segments.
    # (The broader fuzz in test_edge_cases covers the whole-file kernels;
    # this one pins the scan the GPU runs on long inputs.)
    import jax

    from upmix.models.offline import build_offline_chunked_fn

    rng = np.random.default_rng(77)
    for trial in range(4):
        sr = float(rng.choice([8000, 22050, 48000]))
        n_edges = int(rng.integers(1, 4))
        edges = [0.0] + sorted(
            float(f) for f in rng.uniform(sr * 0.02, sr * 0.45, size=n_edges)
        )
        if any(b - a < sr * 0.01 for a, b in zip(edges, edges[1:])):
            continue  # avoid near-degenerate bands
        max_block = int(rng.choice([256, 512, 1024]))
        xover = str(rng.choice(["raised_cosine", "hard_zero"]))
        cfg = UpmixConfig.make(
            edges, sr=sr, max_block_size=max_block, xover_mode=xover
        )
        unit = 1
        for b in cfg.bands:
            unit = unit * b.block_size // np.gcd(unit, b.block_size)
        chunk = max(2 * unit, 2048)
        n = int(chunk * 2.5)
        L, R = make_stereo(n, sr, seed=100 + trial)
        L32, R32 = L.astype(np.float32), R.astype(np.float32)
        ref = oracle_multiband(L32, R32, cfg)
        fn = jax.jit(build_offline_chunked_fn(cfg, n, chunk=chunk, kernel="mm"))
        got = fn(jnp.asarray(L32), jnp.asarray(R32))
        for name, r, g in zip("C Ls Rs".split(), ref, got):
            if np.max(np.abs(r)) < 1e-7:
                continue
            s = snr_db(r, np.asarray(g))
            assert s > 60.0, (
                f"trial {trial} {name}: {s:.1f} dB "
                f"(sr={sr}, edges={edges}, mb={max_block}, {xover})"
            )
