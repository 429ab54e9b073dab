"""Streaming engine tests: parity vs the C++-semantics streaming oracle,
push_block vs scan equivalence, warmup latency, and state checkpointing
(SURVEY.md §4 "streaming parity" — substitutes for Bela-hardware testing).
"""

import numpy as np
import pytest

from upmix.config import UpmixConfig
from upmix.models.streaming import (
    WARMUP_BLOCKS,
    StreamingUpmixer,
    init_stream_state,
    mix_stereo_sum,
)
from upmix.oracle.reference import oracle_stream_multiband

from helpers import make_stereo, snr_db


HW = 256


def _stream_cfg(edges=(0.0, 400.0, 1600.0), sr=8000.0, hw=HW, **kw):
    return UpmixConfig.streaming(list(edges), sr=sr, hw_block_size=hw, **kw)


def test_stream_parity_vs_oracle():
    cfg = _stream_cfg()
    L, R = make_stereo(16 * HW, cfg.sr, seed=0)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)
    ref_l, ref_r = oracle_stream_multiband(L32, R32, cfg, HW)
    s = StreamingUpmixer(cfg, HW)
    got_l, got_r = s.process_signal(L32, R32, mix="stereo_sum")
    assert snr_db(ref_l, np.asarray(got_l)) > 60.0
    assert snr_db(ref_r, np.asarray(got_r)) > 60.0


def test_stream_parity_hard_zero_cpp_mode():
    # Full C++-parity configuration: hard-zero band limits (the effective
    # C++ behavior — SURVEY.md §2.2), analysis-window synthesis, C++ bin
    # rounding.
    cfg = _stream_cfg(xover_mode="hard_zero", synthesis="analysis", bin_rounding="cpp")
    L, R = make_stereo(12 * HW, cfg.sr, seed=1)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)
    ref_l, ref_r = oracle_stream_multiband(L32, R32, cfg, HW)
    s = StreamingUpmixer(cfg, HW)
    got_l, got_r = s.process_signal(L32, R32, mix="stereo_sum")
    assert snr_db(ref_l, np.asarray(got_l)) > 60.0
    assert snr_db(ref_r, np.asarray(got_r)) > 60.0


def test_push_block_matches_scan():
    cfg = _stream_cfg()
    L, R = make_stereo(8 * HW, cfg.sr, seed=2)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)
    s = StreamingUpmixer(cfg, HW)
    ref_c, ref_ls, ref_rs = s.process_signal(L32, R32, mix="lcr")
    s.reset()
    got = []
    for i in range(0, len(L32), HW):
        c, ls, rs = s.push_block(L32[i : i + HW], R32[i : i + HW])
        got.append(np.stack([np.asarray(c), np.asarray(ls), np.asarray(rs)]))
    got = np.concatenate(got, axis=1)
    np.testing.assert_array_equal(got[0], np.asarray(ref_c))
    np.testing.assert_array_equal(got[1], np.asarray(ref_ls))
    np.testing.assert_array_equal(got[2], np.asarray(ref_rs))


def test_warmup_latency_is_uniform_4_blocks():
    # All bands come online together after exactly 4 hw blocks
    # (bela/upmix.cpp:232-237, 498-506 — [verified] SURVEY.md §2.2).
    cfg = _stream_cfg()
    rng = np.random.default_rng(3)
    x = rng.standard_normal(8 * HW).astype(np.float32)
    s = StreamingUpmixer(cfg, HW)
    outs = []
    for i in range(0, len(x), HW):
        c, ls, rs = s.push_block(x[i : i + HW], x[i : i + HW])
        outs.append(np.max(np.abs(np.asarray(c))))
    assert all(o == 0.0 for o in outs[: WARMUP_BLOCKS - 1])
    assert outs[WARMUP_BLOCKS - 1] > 0.0  # first output at block index 3


def test_state_is_checkpointable():
    # The state pytree can be saved/restored mid-stream with identical
    # continuation (SURVEY.md §5 checkpoint/resume).
    cfg = _stream_cfg()
    L, R = make_stereo(10 * HW, cfg.sr, seed=4)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)

    s = StreamingUpmixer(cfg, HW)
    full = []
    for i in range(0, len(L32), HW):
        c, ls, rs = s.push_block(L32[i : i + HW], R32[i : i + HW])
        full.append(np.asarray(c))

    s2 = StreamingUpmixer(cfg, HW)
    half = 5 * HW
    for i in range(0, half, HW):
        s2.push_block(L32[i : i + HW], R32[i : i + HW])
    # Round-trip the state through host numpy (a checkpoint).
    import jax

    ckpt = jax.tree.map(np.asarray, s2.state)
    s3 = StreamingUpmixer(cfg, HW)
    s3.state = jax.tree.map(np.asarray, ckpt)
    resumed = []
    for i in range(half, len(L32), HW):
        c, ls, rs = s3.push_block(L32[i : i + HW], R32[i : i + HW])
        resumed.append(np.asarray(c))
    np.testing.assert_array_equal(
        np.concatenate(full[5:]), np.concatenate(resumed)
    )


def test_stream_vs_offline_parity_after_latency():
    # Offline and streaming paths share kernels; after the 4-block warmup
    # the streaming stereo_sum output must track the offline stereo_sum mix
    # of the same config (SURVEY.md §4 "streaming parity").
    from upmix.models.offline import Upmixer

    cfg = _stream_cfg()
    L, R = make_stereo(24 * HW, cfg.sr, seed=5)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)

    s = StreamingUpmixer(cfg, HW)
    st_l, st_r = s.process_signal(L32, R32, mix="stereo_sum")
    c, ls, rs = Upmixer(cfg).process_np(L32, R32)
    off_l, off_r = ls + 0.5 * c, rs + 0.5 * c

    # Streaming output is delayed by the warmup: streaming block k carries
    # the content of offline samples starting at (k-3)*hw... compare the
    # overlapping steady-state region.
    lat = (WARMUP_BLOCKS - 1) * HW
    n = len(L32) - lat - 4 * HW
    a = np.asarray(st_l)[lat : lat + n]
    b = off_l[:n]
    assert snr_db(b, a) > 60.0
    a = np.asarray(st_r)[lat : lat + n]
    b = off_r[:n]
    assert snr_db(b, a) > 60.0


def test_invalid_hw_block_raises():
    cfg = UpmixConfig.make([0.0, 400.0], sr=8000.0, max_block_size=512)
    with pytest.raises(ValueError):
        StreamingUpmixer(cfg, 100)  # not a multiple of every hop


def test_oversized_band_block_raises():
    cfg = UpmixConfig.make([0.0, 400.0], sr=8000.0, max_block_size=4096)
    with pytest.raises(ValueError):
        StreamingUpmixer(cfg, 256)  # 4096 > 4*256


def test_mix_stereo_sum_layout():
    import jax.numpy as jnp

    lcr = jnp.asarray(np.array([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]], np.float32))
    l, r = mix_stereo_sum(lcr)
    np.testing.assert_allclose(np.asarray(l), [3.5, 5.0])
    np.testing.assert_allclose(np.asarray(r), [5.5, 7.0])


def test_state_checkpoint_with_orbax(tmp_path):
    # The streaming state pytree round-trips through a real checkpointing
    # library (SURVEY.md §5 checkpoint/resume).
    orbax = pytest.importorskip("orbax.checkpoint")
    import jax

    cfg = _stream_cfg()
    L, R = make_stereo(8 * HW, cfg.sr, seed=10)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)
    s = StreamingUpmixer(cfg, HW)
    for i in range(0, 4 * HW, HW):
        s.push_block(L32[i : i + HW], R32[i : i + HW])

    ckptr = orbax.PyTreeCheckpointer()
    path = tmp_path / "ckpt"
    ckptr.save(path, jax.tree.map(np.asarray, s.state))
    restored = ckptr.restore(path)

    s2 = StreamingUpmixer(cfg, HW)
    s2.state = restored
    out_a, out_b = [], []
    for i in range(4 * HW, 8 * HW, HW):
        ca, _, _ = s.push_block(L32[i : i + HW], R32[i : i + HW])
        out_a.append(np.asarray(ca))
    for i in range(4 * HW, 8 * HW, HW):
        cb, _, _ = s2.push_block(L32[i : i + HW], R32[i : i + HW])
        out_b.append(np.asarray(cb))
    np.testing.assert_array_equal(np.concatenate(out_a), np.concatenate(out_b))


def test_stream_parity_50pct_overlap():
    # Non-75% overlaps generalize the shared-history design (K = block/hop
    # warmup blocks); parity vs the streaming oracle must hold.
    cfg = UpmixConfig.make(
        [0.0, 400.0, 1600.0], sr=8000.0, max_block_size=512, overlap=0.5
    )
    hw = 256
    L, R = make_stereo(16 * hw, cfg.sr, seed=11)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)
    ref_l, ref_r = oracle_stream_multiband(L32, R32, cfg, hw)
    s = StreamingUpmixer(cfg, hw)
    assert s.warmup_blocks == 2
    got_l, got_r = s.process_signal(L32, R32, mix="stereo_sum")
    assert snr_db(ref_l, np.asarray(got_l)) > 60.0
    assert snr_db(ref_r, np.asarray(got_r)) > 60.0


def test_stream_mixed_k_rejected():
    # Bands with different block/hop ratios cannot share the history
    # window — must be rejected, not silently wrong.
    from upmix.config import BandSpec
    from upmix.models.streaming import stream_warmup_blocks

    b1 = BandSpec(f_low=0.0, f_high=400.0, sr=8000.0, block_size=512, overlap=0.75)
    b2 = BandSpec(f_low=400.0, f_high=4000.0, sr=8000.0, block_size=256, overlap=0.5)
    cfg = UpmixConfig(sr=8000.0, bands=(b1, b2))
    with pytest.raises(ValueError):
        stream_warmup_blocks(cfg)
    with pytest.raises(ValueError):
        StreamingUpmixer(cfg, 256)


def test_streaming_random_config_fuzz():
    # Deterministic bounded fuzz over streaming configs: random edges,
    # overlap in {0.5, 0.75}, hw block sizes — engine must hold >60 dB
    # against the streaming oracle every draw.
    rng = np.random.default_rng(4321)
    for trial in range(4):
        sr = float(rng.choice([8000, 16000]))
        n_edges = int(rng.integers(1, 4))
        edges = [0.0] + sorted(
            float(f) for f in rng.uniform(sr * 0.02, sr * 0.4, size=n_edges)
        )
        overlap = float(rng.choice([0.5, 0.75]))
        hw = int(rng.choice([128, 256]))
        cfg = UpmixConfig.make(
            edges, sr=sr, overlap=overlap, max_block_size=hw * 2,
            synthesis="analysis", bin_rounding="cpp",
        )
        L, R = make_stereo(14 * hw, sr, seed=100 + trial)
        L32, R32 = L.astype(np.float32), R.astype(np.float32)
        ref_l, ref_r = oracle_stream_multiband(L32, R32, cfg, hw)
        s = StreamingUpmixer(cfg, hw)
        got_l, got_r = s.process_signal(L32, R32, mix="stereo_sum")
        sl = snr_db(ref_l, np.asarray(got_l))
        assert sl > 60.0, (
            f"trial {trial}: {sl:.1f} dB (edges={edges}, ov={overlap}, hw={hw})"
        )


def test_batch_streaming_matches_independent_streams():
    # B concurrent sessions through one vmapped dispatch must match B
    # independent single-stream engines on the same blocks.
    from upmix.models.streaming import BatchStreamingUpmixer

    cfg = _stream_cfg()
    B, n_blocks = 3, 10
    rng = np.random.default_rng(31)
    blocks = rng.standard_normal((n_blocks, B, 2, HW)).astype(np.float32) * 0.3

    batch = BatchStreamingUpmixer(cfg, HW, n_streams=B)
    got = [[] for _ in range(B)]
    for t in range(n_blocks):
        c, ls, rs = batch.push_blocks(blocks[t, :, 0], blocks[t, :, 1])
        for b in range(B):
            got[b].append(np.stack([c[b], ls[b], rs[b]]))

    for b in range(B):
        eng = StreamingUpmixer(cfg, HW)
        for t in range(n_blocks):
            c, ls, rs = eng.push_block(blocks[t, b, 0], blocks[t, b, 1])
            ref = np.stack([np.asarray(c), np.asarray(ls), np.asarray(rs)])
            mine = np.asarray(got[b][t])
            if np.abs(ref).max() > 0:
                assert snr_db(ref, mine) > 80.0, f"stream {b} block {t}"
            else:
                np.testing.assert_allclose(mine, ref, atol=1e-6)


def test_batch_streaming_slot_churn():
    # Resetting one slot replays warmup for that stream only; the other
    # slots are unaffected (bit-identical to an untouched run).
    from upmix.models.streaming import BatchStreamingUpmixer

    cfg = _stream_cfg()
    B, n_blocks = 2, 12
    rng = np.random.default_rng(32)
    blocks = rng.standard_normal((n_blocks, B, 2, HW)).astype(np.float32) * 0.3

    plain = BatchStreamingUpmixer(cfg, HW, n_streams=B)
    plain_out = [plain.push_blocks(blk[:, 0], blk[:, 1]) for blk in blocks]

    churn = BatchStreamingUpmixer(cfg, HW, n_streams=B)
    half = n_blocks // 2
    for blk in blocks[:half]:
        churn.push_blocks(blk[:, 0], blk[:, 1])
    churn.reset_streams([1])  # session on slot 1 ended; new one begins
    outs = [churn.push_blocks(blk[:, 0], blk[:, 1]) for blk in blocks[half:]]

    # Slot 0 continues bit-identically; slot 1 replays warmup (silence
    # for warmup_blocks, since its history restarted from zeros).
    for t, (c, ls, rs) in enumerate(outs):
        np.testing.assert_array_equal(
            np.asarray(c[0]), np.asarray(plain_out[half + t][0][0])
        )
        if t < churn.warmup_blocks - 1:
            assert np.abs(np.asarray(c[1])).max() == 0.0


def test_batch_streaming_bad_shape_raises():
    from upmix.models.streaming import BatchStreamingUpmixer

    cfg = _stream_cfg()
    eng = BatchStreamingUpmixer(cfg, HW, n_streams=2)
    with pytest.raises(ValueError, match="push_blocks"):
        eng.push_blocks(np.zeros((2, HW - 1)), np.zeros((2, HW - 1)))
    with pytest.raises(ValueError):
        BatchStreamingUpmixer(cfg, HW, n_streams=0)


def test_batch_streaming_checkpoint_roundtrip(tmp_path):
    # The pool's state pytree is the checkpoint format, exactly like the
    # single-stream engine: orbax round-trip + bit-identical resume.
    from upmix.models.streaming import BatchStreamingUpmixer

    orbax = pytest.importorskip("orbax.checkpoint")
    import jax

    cfg = _stream_cfg()
    B, n_blocks = 2, 8
    rng = np.random.default_rng(33)
    blocks = rng.standard_normal((n_blocks, B, 2, HW)).astype(np.float32) * 0.3

    pool = BatchStreamingUpmixer(cfg, HW, n_streams=B)
    for blk in blocks[: n_blocks // 2]:
        pool.push_blocks(blk[:, 0], blk[:, 1])
    ckptr = orbax.PyTreeCheckpointer()
    path = tmp_path / "pool_ckpt"
    ckptr.save(path, pool.snapshot())

    rest = [pool.push_blocks(blk[:, 0], blk[:, 1]) for blk in blocks[n_blocks // 2 :]]

    pool2 = BatchStreamingUpmixer(cfg, HW, n_streams=B)
    pool2.state = ckptr.restore(path)
    rest2 = [pool2.push_blocks(blk[:, 0], blk[:, 1]) for blk in blocks[n_blocks // 2 :]]
    for (a, b, c), (x, y, z) in zip(rest, rest2):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(x))
        np.testing.assert_array_equal(np.asarray(b), np.asarray(y))
        np.testing.assert_array_equal(np.asarray(c), np.asarray(z))


def test_batch_streaming_reset_bounds_checked():
    from upmix.models.streaming import BatchStreamingUpmixer

    cfg = _stream_cfg()
    pool = BatchStreamingUpmixer(cfg, HW, n_streams=4)
    with pytest.raises(ValueError, match="out of range"):
        pool.reset_streams([4])
    with pytest.raises(ValueError, match="out of range"):
        pool.reset_streams([-1])
    pool.reset_streams([0, 3])  # valid edges fine


# ---------------------------------------------------------------------------
# The serving pool (make_stream_pool -> BatchStreamingUpmixer): oracle
# parity, slot churn, snapshots, sharding.
# ---------------------------------------------------------------------------


def _pool_blocks(seed, n_blocks, S, hw=HW):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n_blocks, S, 2, hw)).astype(np.float32) * 0.3


def test_batch_pool_matches_oracle():
    # Every stream of the pool, run block by block, holds the 60 dB bar
    # against the C++-semantics streaming oracle (stereo_sum mix).
    from upmix.models.streaming import BatchStreamingUpmixer

    cfg = _stream_cfg()
    S, n_blocks = 4, 12
    blocks = _pool_blocks(41, n_blocks, S)
    pool = BatchStreamingUpmixer(cfg, HW, n_streams=S)
    outs = [pool.push_blocks(b[:, 0], b[:, 1]) for b in blocks]
    lcr = np.stack([np.stack([np.asarray(o) for o in t]) for t in outs])
    for i in range(S):
        L = blocks[:, i, 0].reshape(-1)
        R = blocks[:, i, 1].reshape(-1)
        ref_l, ref_r = oracle_stream_multiband(L, R, cfg, HW)
        c, ls, rs = (lcr[:, k, i].reshape(-1) for k in range(3))
        assert snr_db(ref_l, ls + 0.5 * c) > 60.0, f"stream {i}"
        assert snr_db(ref_r, rs + 0.5 * c) > 60.0, f"stream {i}"


def test_batch_pool_multi_slot_churn():
    # Resetting one slot of a wider pool replays warmup there and leaves
    # the slots on either side bit-identical.
    from upmix.models.streaming import BatchStreamingUpmixer

    cfg = _stream_cfg()
    S, n_blocks = 16, 12
    blocks = _pool_blocks(42, n_blocks, S)

    plain = BatchStreamingUpmixer(cfg, HW, n_streams=S)
    plain_out = [plain.push_blocks(blk[:, 0], blk[:, 1]) for blk in blocks]

    churn = BatchStreamingUpmixer(cfg, HW, n_streams=S)
    half = n_blocks // 2
    for blk in blocks[:half]:
        churn.push_blocks(blk[:, 0], blk[:, 1])
    churn.reset_streams([9])
    outs = [churn.push_blocks(blk[:, 0], blk[:, 1]) for blk in blocks[half:]]
    for t, (c, ls, rs) in enumerate(outs):
        for keep in (0, 8, 10, 15):
            np.testing.assert_array_equal(
                np.asarray(c[keep]), np.asarray(plain_out[half + t][0][keep])
            )
        if t < churn.warmup_blocks - 1:
            assert np.abs(np.asarray(c[9])).max() == 0.0


def test_batch_pool_snapshot_resume():
    # snapshot() is the checkpoint format: restore() into a fresh pool
    # resumes bit-identically.
    from upmix.models.streaming import BatchStreamingUpmixer

    cfg = _stream_cfg()
    S, n_blocks = 8, 8
    blocks = _pool_blocks(43, n_blocks, S)

    pool = BatchStreamingUpmixer(cfg, HW, n_streams=S)
    for blk in blocks[: n_blocks // 2]:
        pool.push_blocks(blk[:, 0], blk[:, 1])
    snap = pool.snapshot()
    rest = [pool.push_blocks(blk[:, 0], blk[:, 1]) for blk in blocks[n_blocks // 2 :]]

    pool2 = BatchStreamingUpmixer(cfg, HW, n_streams=S)
    pool2.restore(snap)
    rest2 = [pool2.push_blocks(blk[:, 0], blk[:, 1]) for blk in blocks[n_blocks // 2 :]]
    for (a, b, c), (x, y, z) in zip(rest, rest2):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(x))
        np.testing.assert_array_equal(np.asarray(b), np.asarray(y))
        np.testing.assert_array_equal(np.asarray(c), np.asarray(z))


def test_batch_pool_extract_load_moves_a_session():
    # extract_streams/load_streams (the serving checkpoint's unit) move a
    # live session between slots of different pools; the moved session
    # continues bit-identically and its neighbours are untouched.
    from upmix.models.streaming import BatchStreamingUpmixer

    cfg = _stream_cfg()
    S, n_blocks, cut = 8, 10, 6
    blocks = _pool_blocks(44, n_blocks, S)
    a = BatchStreamingUpmixer(cfg, HW, n_streams=S)
    b = BatchStreamingUpmixer(cfg, HW, n_streams=S)
    for t in range(cut):
        a.push_blocks(blocks[t, :, 0], blocks[t, :, 1])
        b.push_blocks(blocks[t, :, 0], blocks[t, :, 1])
    rows = a.extract_streams([2])
    assert rows["history"].shape[0] == 1
    b.load_streams([5], rows)
    for t in range(cut, n_blocks):
        xl, xr = blocks[t, :, 0].copy(), blocks[t, :, 1].copy()
        ra = a.push_blocks(xl, xr)
        xl[5], xr[5] = xl[2], xr[2]  # slot 5 of b now carries a's stream 2
        rb = b.push_blocks(xl, xr)
        for x, y in zip(ra, rb):
            np.testing.assert_array_equal(np.asarray(y)[5], np.asarray(x)[2])
            np.testing.assert_array_equal(np.asarray(y)[0], np.asarray(x)[0])
    with pytest.raises(ValueError, match="out of range"):
        a.extract_streams([S])


def test_make_stream_pool_selection():
    # Every engine name builds the vmapped XLA pool; a mesh shards it over
    # 'data'; indivisible stream counts and unknown engines are rejected.
    import jax as _jax

    from upmix.models.streaming import BatchStreamingUpmixer, make_stream_pool

    cfg = _stream_cfg()
    assert isinstance(make_stream_pool(cfg, HW, 8), BatchStreamingUpmixer)
    assert isinstance(
        make_stream_pool(cfg, HW, 8, engine="xla"), BatchStreamingUpmixer
    )
    mesh = _jax.sharding.Mesh(np.array(_jax.devices()[:2]), ("data",))
    sharded = make_stream_pool(cfg, HW, 16, mesh=mesh)
    assert isinstance(sharded, BatchStreamingUpmixer)
    assert sharded.mesh is mesh
    with pytest.raises(ValueError, match="divide evenly"):
        make_stream_pool(cfg, HW, 9, mesh=mesh)
    for bad in ("pallas", "cuda"):
        with pytest.raises(ValueError, match="unknown engine"):
            make_stream_pool(cfg, HW, 8, engine=bad)


def test_batch_pool_sharded_matches_unsharded():
    # A mesh-sharded pool runs each device on its stream shard; streams
    # are independent, so it must reproduce the single-device pool.
    import jax as _jax

    from upmix.models.streaming import BatchStreamingUpmixer

    cfg = _stream_cfg()
    S, n_blocks = 16, 8
    mesh = _jax.sharding.Mesh(np.array(_jax.devices()[:2]), ("data",))
    blocks = _pool_blocks(11, n_blocks, S)

    plain = BatchStreamingUpmixer(cfg, HW, n_streams=S)
    shard = BatchStreamingUpmixer(cfg, HW, n_streams=S, mesh=mesh)
    for t in range(n_blocks):
        a = plain.push_blocks(blocks[t, :, 0], blocks[t, :, 1])
        b = shard.push_blocks(blocks[t, :, 0], blocks[t, :, 1])
        for x, y in zip(a, b):
            np.testing.assert_allclose(
                np.asarray(x), np.asarray(y), atol=1e-6, rtol=0
            )
    assert len({d for d in b[0].sharding.device_set}) == 2
    # Slot churn keeps working on the sharded pool.
    shard.reset_streams([0, 15])
    c, ls, rs = shard.push_blocks(blocks[0, :, 0], blocks[0, :, 1])
    assert np.all(np.isfinite(np.asarray(c)))


def _nan_isolation_check(make_pool):
    # One stream receiving NaN input must not contaminate its
    # neighbours (rows are independent in both engines), and
    # reset_streams must recover the poisoned slot.
    cfg = _stream_cfg()
    S, n_blocks = 8, 10
    rng = np.random.default_rng(23)
    blocks = rng.standard_normal((n_blocks, S, 2, HW)).astype(np.float32) * 0.3

    clean = make_pool(cfg)
    dirty = make_pool(cfg)
    for t in range(n_blocks):
        cc, cls, crs = clean.push_blocks(blocks[t, :, 0], blocks[t, :, 1])
        bad = blocks[t].copy()
        if t >= 5:
            bad[2] = np.nan  # poison stream 2 from block 5 on
        dc, dls, drs = dirty.push_blocks(bad[:, 0], bad[:, 1])
        for cref, dgot in ((cc, dc), (cls, dls), (crs, drs)):
            cref, dgot = np.asarray(cref), np.asarray(dgot)
            ok = [i for i in range(S) if i != 2]
            np.testing.assert_allclose(dgot[ok], cref[ok], atol=1e-6, rtol=0)
        if t >= 5:
            assert not np.all(np.isfinite(np.asarray(dc)[2]))
    # Recover the poisoned slot: it re-warms (silent) then runs clean.
    dirty.reset_streams([2])
    for t in range(dirty.warmup_blocks + 1):
        dc, dls, drs = dirty.push_blocks(blocks[t, :, 0], blocks[t, :, 1])
        assert np.all(np.isfinite(np.asarray(dc)))


def test_batch_pool_nan_stream_isolation():
    from upmix.models.streaming import BatchStreamingUpmixer

    _nan_isolation_check(
        lambda cfg: BatchStreamingUpmixer(cfg, HW, n_streams=8)
    )


def test_batch_pool_sharded_nan_stream_isolation():
    import jax as _jax

    from upmix.models.streaming import BatchStreamingUpmixer

    mesh = _jax.sharding.Mesh(np.array(_jax.devices()[:2]), ("data",))
    _nan_isolation_check(
        lambda cfg: BatchStreamingUpmixer(cfg, HW, n_streams=8, mesh=mesh)
    )


def test_batch_pool_checkpoint_with_orbax(tmp_path):
    # The sharded pool's snapshot pytree round-trips through a real
    # checkpointing library (SURVEY.md §5 checkpoint/resume); restore()
    # re-shards it and the pool resumes bit-identically.
    orbax = pytest.importorskip("orbax.checkpoint")
    import jax as _jax

    from upmix.models.streaming import BatchStreamingUpmixer

    cfg = _stream_cfg()
    S, n_blocks = 8, 8
    mesh = _jax.sharding.Mesh(np.array(_jax.devices()[:2]), ("data",))
    blocks = _pool_blocks(47, n_blocks, S)

    pool = BatchStreamingUpmixer(cfg, HW, n_streams=S, mesh=mesh)
    for blk in blocks[: n_blocks // 2]:
        pool.push_blocks(blk[:, 0], blk[:, 1])
    ckptr = orbax.PyTreeCheckpointer()
    path = tmp_path / "pool_ckpt"
    ckptr.save(path, pool.snapshot())
    rest = [pool.push_blocks(blk[:, 0], blk[:, 1]) for blk in blocks[n_blocks // 2 :]]

    pool2 = BatchStreamingUpmixer(cfg, HW, n_streams=S, mesh=mesh)
    pool2.restore(ckptr.restore(path))
    rest2 = [pool2.push_blocks(blk[:, 0], blk[:, 1]) for blk in blocks[n_blocks // 2 :]]
    for (a, b, c), (x, y, z) in zip(rest, rest2):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(x))
        np.testing.assert_array_equal(np.asarray(b), np.asarray(y))
        np.testing.assert_array_equal(np.asarray(c), np.asarray(z))


def test_batch_pool_random_config_fuzz():
    # Deterministic bounded fuzz over streaming configs: random edges,
    # overlap in {0.5, 0.75}, hw blocks — every stream of the pool must
    # hold the 60 dB bar against the streaming oracle on every draw.
    from upmix.models.streaming import BatchStreamingUpmixer

    rng = np.random.default_rng(977)
    for trial in range(6):
        sr = float(rng.choice([8000, 16000]))
        n_edges = int(rng.integers(1, 4))
        edges = [0.0] + sorted(
            float(f) for f in rng.uniform(sr * 0.02, sr * 0.4, size=n_edges)
        )
        overlap = float(rng.choice([0.5, 0.75]))
        hw = int(rng.choice([128, 256]))
        cfg = UpmixConfig.make(
            edges, sr=sr, overlap=overlap, max_block_size=hw * 2,
            synthesis="analysis", bin_rounding="cpp",
        )
        S, n_blocks = 3, 10
        blocks = _pool_blocks(200 + trial, n_blocks, S, hw)
        pool = BatchStreamingUpmixer(cfg, hw, n_streams=S)
        outs = [pool.push_blocks(b[:, 0], b[:, 1]) for b in blocks]
        for i in range(S):
            c, ls, rs = (
                np.concatenate([np.asarray(o[k][i]) for o in outs])
                for k in range(3)
            )
            ref_l, ref_r = oracle_stream_multiband(
                blocks[:, i, 0].reshape(-1), blocks[:, i, 1].reshape(-1),
                cfg, hw,
            )
            msg = f"trial {trial} stream {i} (edges={edges}, ov={overlap}, hw={hw})"
            assert snr_db(ref_l, ls + 0.5 * c) > 60.0, msg
            assert snr_db(ref_r, rs + 0.5 * c) > 60.0, msg


@pytest.mark.parametrize("hw", [128, HW])
@pytest.mark.parametrize("donate", [True, False])
def test_batch_pool_restore_after_json_round_trip(hw, donate):
    # A snapshot that went through JSON (arrays become nested lists)
    # restores and resumes bit-identically, with and without donation.
    import json

    from upmix.models.streaming import BatchStreamingUpmixer

    cfg = _stream_cfg(hw=hw)
    S = 8
    a = BatchStreamingUpmixer(cfg, hw, n_streams=S, donate=donate)
    b = BatchStreamingUpmixer(cfg, hw, n_streams=S, donate=donate)
    blocks = _pool_blocks(41, a.warmup_blocks + 4, S, hw)
    k = a.warmup_blocks + 1
    for t in range(k):
        a.push_blocks(blocks[t, :, 0], blocks[t, :, 1])

    def to_lists(tree):
        if isinstance(tree, dict):
            return {kk: to_lists(v) for kk, v in tree.items()}
        return np.asarray(tree).tolist()

    snap = json.loads(json.dumps(to_lists(a.snapshot())))
    b.restore({"history": np.asarray(snap["history"], np.float32),
               "t": np.asarray(snap["t"], np.int32),
               "ola": {kk: np.asarray(v, np.float32)
                       for kk, v in snap["ola"].items()}})
    for t in range(k, len(blocks)):
        ra = a.push_blocks(blocks[t, :, 0], blocks[t, :, 1])
        rb = b.push_blocks(blocks[t, :, 0], blocks[t, :, 1])
    for x, y in zip(ra, rb):
        np.testing.assert_array_equal(np.asarray(y), np.asarray(x))


@pytest.mark.parametrize("engine", ["mesh", "xla"])
def test_sustained_runner_matches_push_blocks(engine):
    # make_sustained_runner chains n_blocks steps in ONE compiled
    # program (the device-side capacity protocol, used by tune.py's scan
    # mode); its per-iteration C outputs must match the dispatched
    # push_blocks path on the same inputs, sharded or not.
    import jax as _jax

    from upmix.models.streaming import BatchStreamingUpmixer

    cfg = _stream_cfg()
    S, n_blocks, unroll = 8, 12, 4
    rng = np.random.default_rng(7)
    blocks = rng.standard_normal((n_blocks, 2, S, HW)).astype(np.float32) * 0.3
    mesh = None
    if engine == "mesh":
        mesh = _jax.sharding.Mesh(np.array(_jax.devices()[:2]), ("data",))
    pool = BatchStreamingUpmixer(cfg, HW, n_streams=S, donate=False, mesh=mesh)
    want = []
    for t in range(n_blocks):
        c, _, _ = pool.push_blocks(blocks[t, 0], blocks[t, 1])
        want.append(np.asarray(c))
    assert np.abs(np.asarray(want[-1])).max() > 0  # past warmup silence

    run, fresh = pool.make_sustained_runner(n_blocks, unroll)
    _, cs = run(fresh(), blocks)
    cs = np.asarray(cs)
    assert cs.shape == (n_blocks // unroll, S, HW)
    for i in range(n_blocks // unroll):
        ref = want[(i + 1) * unroll - 1]
        np.testing.assert_allclose(cs[i], ref, atol=1e-5, rtol=0)


def test_sustained_runner_clamps_unroll_to_divisor():
    from upmix.models.streaming import BatchStreamingUpmixer

    cfg = _stream_cfg()
    pool = BatchStreamingUpmixer(cfg, HW, n_streams=2)
    run, fresh = pool.make_sustained_runner(10, unroll=4)  # -> unroll 2
    blocks = np.zeros((10, 2, 2, HW), np.float32)
    _, cs = run(fresh(), blocks)
    assert np.asarray(cs).shape == (5, 2, HW)
