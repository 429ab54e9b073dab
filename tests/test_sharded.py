"""Multi-chip sharding tests on the 8-device virtual CPU mesh:
frame-axis (sequence) sharding parity vs single-device, halo correctness
at shard boundaries, and data-parallel batching (SURVEY.md §4 "multi-chip").
"""

import jax
import numpy as np
import pytest

from upmix.config import UpmixConfig
from upmix.oracle import oracle_multiband
from upmix.parallel import ShardedUpmixer, build_sharded_offline_fn, make_mesh, sequence_plan

from helpers import make_stereo, snr_db


def _cfg(**kw):
    kw.setdefault("max_block_size", 512)
    return UpmixConfig.make([0.0, 400.0, 1600.0], sr=8000.0, **kw)


def test_mesh_helpers():
    mesh = make_mesh()
    assert mesh.shape["seq"] == len(jax.devices())
    mesh2 = make_mesh({"data": 2, "seq": 4})
    assert mesh2.shape == {"data": 2, "seq": 4}
    with pytest.raises(ValueError):
        make_mesh({"seq": 1024})


def test_sequence_plan_geometry():
    cfg = _cfg()
    plan = sequence_plan(cfg, 5000, 8)
    assert plan.n_padded == plan.chunk * 8
    assert plan.n_padded >= 5000
    assert plan.chunk >= plan.halo
    for b in cfg.bands:
        assert plan.chunk % b.hop_size == 0


def test_seq_sharded_parity_vs_oracle():
    cfg = _cfg()
    mesh = make_mesh({"seq": 8})
    su = ShardedUpmixer(cfg, mesh)
    L, R = make_stereo(5000, cfg.sr, seed=0)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)
    ref = oracle_multiband(L32, R32, cfg)
    got = su.process(L32, R32)
    for name, r, g in zip("C Ls Rs".split(), ref, got):
        s = snr_db(r, np.asarray(g))
        assert s > 60.0, f"{name}: {s:.1f} dB"


def test_seq_sharded_matches_single_device_pipeline():
    # Halo correctness: the 8-way sharded result must match the unsharded
    # JAX pipeline to float32 tolerance at every shard boundary.
    from upmix.models.offline import upmix_offline

    cfg = _cfg()
    mesh = make_mesh({"seq": 8})
    su = ShardedUpmixer(cfg, mesh)
    L, R = make_stereo(9000, cfg.sr, seed=1)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)
    single = upmix_offline(L32, R32, cfg)
    sharded = su.process(L32, R32)
    plan = sequence_plan(cfg, 9000, 8)
    for r, g in zip(single, sharded):
        g = np.asarray(g)
        assert snr_db(r, g) > 60.0
        # Inspect a window across each internal shard boundary explicitly.
        for d in range(1, 8):
            edge = d * plan.chunk
            if edge + 64 > len(r):
                break
            win_r = r[edge - 64 : edge + 64]
            win_g = g[edge - 64 : edge + 64]
            assert np.max(np.abs(win_r - win_g)) < 1e-3, f"boundary {d}"


def test_dp_sp_mesh_batch():
    cfg = _cfg()
    mesh = make_mesh({"data": 2, "seq": 4})
    su = ShardedUpmixer(cfg, mesh)
    L0, R0 = make_stereo(4000, cfg.sr, seed=2)
    L1, R1 = make_stereo(4000, cfg.sr, seed=3)
    x = np.stack(
        [np.stack([L0, R0]), np.stack([L1, R1])]
    ).astype(np.float32)
    y = su.process_batch(x)
    assert y.shape == (2, 3, 4000)
    for i, (Lx, Rx) in enumerate([(L0, R0), (L1, R1)]):
        ref = oracle_multiband(Lx.astype(np.float32), Rx.astype(np.float32), cfg)
        for c in range(3):
            assert snr_db(ref[c], np.asarray(y[i, c])) > 60.0


def test_odd_batch_padding():
    cfg = _cfg()
    mesh = make_mesh({"data": 2, "seq": 4})
    su = ShardedUpmixer(cfg, mesh)
    L, R = make_stereo(3000, cfg.sr, seed=4)
    x = np.stack([np.stack([L, R])]).astype(np.float32)  # batch of 1 on data=2
    y = su.process_batch(x)
    assert y.shape == (1, 3, 3000)
    ref = oracle_multiband(L.astype(np.float32), R.astype(np.float32), cfg)
    assert snr_db(ref[0], np.asarray(y[0, 0])) > 60.0


def test_build_sharded_fn_direct():
    cfg = _cfg()
    mesh = make_mesh({"seq": 8})
    fn, plan = build_sharded_offline_fn(cfg, 4096, mesh, data_axis=None)
    x = np.zeros((1, 2, plan.n_padded), np.float32)
    y = fn(x)
    assert y.shape == (1, 3, plan.n_padded)
    assert np.all(np.asarray(y) == 0.0)


def test_process_batch_validates_shape():
    cfg = _cfg()
    su = ShardedUpmixer(cfg, make_mesh({"seq": 8}))
    with pytest.raises(ValueError):
        su.process_batch(np.zeros((2, 3, 100), np.float32))


def test_seq_sharded_mm_kernel_parity():
    # The sharded path with the matmul-transform kernel (forced on the CPU
    # mesh) must match the oracle like the xla path does.
    cfg = _cfg()
    mesh = make_mesh({"seq": 8})
    su = ShardedUpmixer(cfg, mesh, kernel="mm")
    L, R = make_stereo(6000, cfg.sr, seed=6)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)
    ref = oracle_multiband(L32, R32, cfg)
    got = su.process(L32, R32)
    for name, r, g in zip("C Ls Rs".split(), ref, got):
        s = snr_db(r, np.asarray(g))
        assert s > 60.0, f"{name}: {s:.1f} dB"


def test_dp_sp_mm_kernel_batch():
    cfg = _cfg()
    mesh = make_mesh({"data": 2, "seq": 4})
    su = ShardedUpmixer(cfg, mesh, kernel="mm")
    L0, R0 = make_stereo(4000, cfg.sr, seed=7)
    x = np.stack([np.stack([L0, R0]), np.stack([R0, L0])]).astype(np.float32)
    y = su.process_batch(x)
    assert y.shape == (2, 3, 4000)
    ref = oracle_multiband(L0.astype(np.float32), R0.astype(np.float32), cfg)
    assert snr_db(ref[0], np.asarray(y[0, 0])) > 60.0


def test_seq_sharded_mm_all_channels_parity():
    # The matmul fold inside shard_map: every channel of both batch rows
    # holds the oracle bar and matches the unsharded 'mm' pipeline.
    from upmix.models.offline import Upmixer

    cfg = _cfg()
    mesh = make_mesh({"data": 2, "seq": 4})
    su = ShardedUpmixer(cfg, mesh, kernel="mm")
    L, R = make_stereo(5000, cfg.sr, seed=8)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)
    x = np.stack([np.stack([L32, R32]), np.stack([R32, L32])])
    y = np.asarray(su.process_batch(x))
    single = Upmixer(cfg, kernel="mm")
    for b in range(2):
        ref = oracle_multiband(x[b, 0], x[b, 1], cfg)
        one = single.process_np(x[b, 0], x[b, 1])
        for c in range(3):
            assert snr_db(ref[c], y[b, c]) > 60.0
            assert snr_db(one[c], y[b, c]) > 100.0


def test_batch_streaming_over_data_mesh():
    # The multi-stream pool sharded over the 'data' axis: communication-
    # free scale-out; results must match the unsharded pool bit-for-bit.
    import numpy as np

    from upmix.config import UpmixConfig
    from upmix.models.streaming import BatchStreamingUpmixer
    from upmix.parallel import make_mesh

    HW = 256
    cfg = UpmixConfig.streaming([0.0, 400.0, 1600.0], sr=8000.0, hw_block_size=HW)
    B, n_blocks = 8, 8
    rng = np.random.default_rng(7)
    blocks = rng.standard_normal((n_blocks, B, 2, HW)).astype(np.float32) * 0.3

    mesh = make_mesh({"data": 4})
    sharded = BatchStreamingUpmixer(cfg, HW, n_streams=B, mesh=mesh)
    plain = BatchStreamingUpmixer(cfg, HW, n_streams=B)
    for blk in blocks:
        a = sharded.push_blocks(blk[:, 0], blk[:, 1])
        b = plain.push_blocks(blk[:, 0], blk[:, 1])
        for x, y in zip(a, b):
            np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=1e-6)
    sharded.reset_streams([3])
    a = sharded.push_blocks(blocks[0][:, 0], blocks[0][:, 1])
    assert np.abs(np.asarray(a[0][3])).max() == 0.0  # slot 3 re-warming

    import pytest

    with pytest.raises(ValueError, match="divide"):
        BatchStreamingUpmixer(cfg, HW, n_streams=6, mesh=mesh)


def test_local_file_shard_round_robin():
    # The multi-host offline convention: paths[i::n] per process,
    # balanced and stable under appends (parallel/distributed.py).
    from upmix.parallel import local_file_shard

    paths = [f"f{i}.wav" for i in range(10)]
    shards = [local_file_shard(paths, index=i, count=3) for i in range(3)]
    assert shards[0] == ["f0.wav", "f3.wav", "f6.wav", "f9.wav"]
    assert shards[1] == ["f1.wav", "f4.wav", "f7.wav"]
    assert sorted(sum(shards, [])) == sorted(paths)
    import pytest

    with pytest.raises(ValueError, match="out of range"):
        local_file_shard(paths, index=3, count=3)


def test_init_distributed_single_process():
    # Bring up the real jax.distributed runtime (num_processes=1) in a
    # SUBPROCESS — the runtime is process-global and must not leak into
    # the shared test process.  Exercises init, idempotency, and the
    # introspection helpers end-to-end.
    import socket
    import subprocess
    import sys

    from helpers import cpu_child_env

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    code = f"""
import jax
jax.config.update("jax_platforms", "cpu")
from upmix.parallel import (
    init_distributed, is_initialized, process_count, process_index,
    local_file_shard,
)
assert not is_initialized()
info = init_distributed("127.0.0.1:{port}", num_processes=1, process_id=0)
assert is_initialized()
assert info["process_index"] == 0 and info["process_count"] == 1
assert info["local_devices"] == info["global_devices"] >= 1
info2 = init_distributed()  # idempotent: no re-init, same topology
assert info2 == info
assert process_index() == 0 and process_count() == 1
assert local_file_shard(["a", "b", "c"]) == ["a", "b", "c"]
print("DIST_OK")
"""
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True,
        text=True,
        timeout=120,
        env=cpu_child_env(),
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "DIST_OK" in out.stdout


# -- production geometry ------------------------------------------------
# The default 44.1 kHz config's largest bucket is a 65536-sample block
# with a 49,152-sample halo (block - hop at 75% overlap) — by far the
# largest communication footprint the framework ships.  These tests run
# that real geometry (not a scaled-down stand-in) through the 8-way
# virtual mesh.


def _prod_cfg():
    # Reference defaults: main.py:62-73 edges, max_block_size 2^16 ->
    # blocks 65536/65536/16384/4096/1024/256 (SURVEY.md §4 goldens).
    return UpmixConfig.make(
        [0.0, 30.0, 120.0, 480.0, 1920.0, 7680.0], sr=44100.0
    )


def test_production_geometry_plan():
    cfg = _prod_cfg()
    plan = sequence_plan(cfg, 2**17, 8)
    assert plan.halo == 65536 - 16384 == 49152
    # chunk is padded up to the bucket lcm (65536), so the halo NEVER
    # exceeds a shard's local chunk even when the input is far shorter
    # than n_seq * halo — the degenerate split the geometry rules out.
    assert plan.chunk == 65536 >= plan.halo
    assert plan.n_padded == 8 * 65536
    tiny = sequence_plan(cfg, 1000, 8)
    assert tiny.chunk >= tiny.halo


def test_production_geometry_seq8_parity_vs_oracle():
    cfg = _prod_cfg()
    mesh = make_mesh({"seq": 8})
    su = ShardedUpmixer(cfg, mesh)
    L, R = make_stereo(2**17, cfg.sr, seed=3)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)
    ref = oracle_multiband(L32, R32, cfg)
    got = su.process(L32, R32)
    for name, r, g in zip("C Ls Rs".split(), ref, got):
        s = snr_db(r, np.asarray(g))
        assert s > 60.0, f"{name}: {s:.1f} dB"


def test_production_geometry_short_input_padding():
    # Input much shorter than n_seq * halo: most shards see pure padding
    # and the halo spans multiple shards' worth of real signal — the
    # exchange must still reconstruct.
    cfg = _prod_cfg()
    mesh = make_mesh({"seq": 8})
    su = ShardedUpmixer(cfg, mesh)
    n = 70000  # > one block (65536) so the big bucket produces signal
    L, R = make_stereo(n, cfg.sr, seed=4)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)
    ref = oracle_multiband(L32, R32, cfg)
    got = su.process(L32, R32)
    for name, r, g in zip("C Ls Rs".split(), ref, got):
        s = snr_db(r, np.asarray(g))
        assert s > 60.0, f"{name}: {s:.1f} dB"


def test_production_geometry_dp_sp_mm_kernel():
    # data x seq mesh with the matmul-transform kernels (the GPU path's
    # program structure) at full geometry.
    cfg = _prod_cfg()
    mesh = make_mesh({"data": 2, "seq": 4})
    su = ShardedUpmixer(cfg, mesh, kernel="mm")
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, 2, 2**17)) * 0.3).astype(np.float32)
    y = np.asarray(su.process_batch(x))
    assert y.shape == (2, 3, 2**17)
    for b in range(2):
        ref = oracle_multiband(x[b, 0], x[b, 1], cfg)
        for ch in range(3):
            s = snr_db(ref[ch], y[b, ch])
            assert s > 60.0, f"batch {b} ch {ch}: {s:.1f} dB"


def test_data_only_mesh_pure_dp():
    # A mesh with no 'seq' axis is pure data parallelism: one sequence
    # shard, no halo collectives (found via the CLI batch path: the
    # builder used to KeyError on mesh.shape['seq']).
    cfg = _cfg()
    mesh = make_mesh({"data": 2})
    su = ShardedUpmixer(cfg, mesh)
    L0, R0 = make_stereo(5000, cfg.sr, seed=3)
    L1, R1 = make_stereo(5000, cfg.sr, seed=4)
    x = np.stack([
        np.stack([L0, R0]).astype(np.float32),
        np.stack([L1, R1]).astype(np.float32),
    ])
    y = np.asarray(su.process_batch(x))
    assert y.shape == (2, 3, 5000)
    for i, (L, R) in enumerate(((L0, R0), (L1, R1))):
        ref = oracle_multiband(L.astype(np.float32), R.astype(np.float32), cfg)
        for ch, r in enumerate(ref):
            assert snr_db(r, y[i, ch]) > 60.0


def test_data_only_mesh_arbitrary_overlap():
    # A data-only mesh has no sequence shards, so the frame-grid LCM /
    # padding-blowup restrictions must not apply: overlap 0.65 (rejected
    # or wildly padded by the seq machinery for short inputs) runs fine
    # through the pure-DP vmapped pipeline (review finding).
    cfg = UpmixConfig.make([0.0, 400.0, 1600.0], sr=8000.0,
                           max_block_size=512, overlap=0.65)
    mesh = make_mesh({"data": 2})
    su = ShardedUpmixer(cfg, mesh)
    L, R = make_stereo(5000, cfg.sr, seed=9)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)
    got = su.process(L32, R32)
    ref = oracle_multiband(L32, R32, cfg)
    for r, g in zip(ref, got):
        assert snr_db(r, np.asarray(g)) > 60.0


@pytest.mark.parametrize(
    "axes", [{"seq": 4}, {"data": 2, "seq": 2}, {"data": 4}],
    ids=["seq4", "data2_seq2", "data4"],
)
def test_sharded_output_spans_every_mesh_device(axes):
    # The result stays distributed: a batch run on a 4-device mesh comes
    # back with its shards on 4 distinct devices (nothing gathered onto
    # device 0), and matches the oracle.
    cfg = _cfg()
    su = ShardedUpmixer(cfg, make_mesh(axes), kernel="mm")
    batch = axes.get("data", 1)
    rng = np.random.default_rng(12)
    x = (rng.standard_normal((batch, 2, 6000)) * 0.3).astype(np.float32)
    y = su.process_batch(x)
    assert len({s.device for s in y.addressable_shards}) == 4
    y = np.asarray(y)
    for b in range(batch):
        ref = oracle_multiband(x[b, 0], x[b, 1], cfg)
        for ch in range(3):
            assert snr_db(ref[ch], y[b, ch]) > 60.0
