"""Batched multi-file engine: geometry, ordering, parity, DP sharding."""

import numpy as np
import pytest

from upmix.config import UpmixConfig
from upmix.models.batch import BatchUpmixer
from upmix.oracle import oracle_multiband
from upmix.parallel import make_mesh

from helpers import make_stereo, snr_db


def _cfg():
    return UpmixConfig.make([0.0, 400.0, 1600.0], sr=8000.0, max_block_size=512)


def test_batch_parity_and_trim():
    cfg = _cfg()
    bu = BatchUpmixer(cfg, n_samples=4096, batch_size=2)
    items = []
    for i, n in enumerate([4096, 3000]):
        L, R = make_stereo(n, cfg.sr, seed=i)
        items.append(np.stack([L, R]).astype(np.float32))
    handle = bu.submit(items)
    outs = bu.collect(handle)
    assert [o.shape for o in outs] == [(3, 4096), (3, 3000)]
    for i, item in enumerate(items):
        ref = oracle_multiband(item[0], item[1], cfg)
        for c in range(3):
            # item 1 is zero-padded to 4096 inside the batch; the trailing
            # block of the oracle output differs only in the padded tail,
            # so compare the unpadded region.
            n = item.shape[-1]
            assert snr_db(ref[c][: n - 512], outs[i][c][: n - 512]) > 60.0


def test_pipeline_ordering_and_partial_batch():
    cfg = _cfg()
    bu = BatchUpmixer(cfg, n_samples=2048, batch_size=2)
    items = []
    for i in range(5):  # 2 full batches + 1 partial
        L, R = make_stereo(2048, cfg.sr, seed=10 + i)
        items.append(np.stack([L, R]).astype(np.float32))
    outs = list(bu.process_files(items))
    assert len(outs) == 5
    for i, item in enumerate(items):
        ref = oracle_multiband(item[0], item[1], cfg)
        assert snr_db(ref[0], outs[i][0]) > 60.0, f"item {i} out of order?"


def test_batch_overflow_raises():
    cfg = _cfg()
    bu = BatchUpmixer(cfg, n_samples=1024, batch_size=1)
    L, R = make_stereo(1024, cfg.sr, seed=0)
    item = np.stack([L, R]).astype(np.float32)
    with pytest.raises(ValueError):
        bu.submit([item, item])


def test_batch_dp_sharded():
    cfg = _cfg()
    mesh = make_mesh({"data": 2})
    bu = BatchUpmixer(cfg, n_samples=2048, batch_size=4, mesh=mesh)
    items = []
    for i in range(4):
        L, R = make_stereo(2048, cfg.sr, seed=20 + i)
        items.append(np.stack([L, R]).astype(np.float32))
    outs = bu.collect(bu.submit(items))
    for i, item in enumerate(items):
        ref = oracle_multiband(item[0], item[1], cfg)
        assert snr_db(ref[0], outs[i][0]) > 60.0


def test_overlong_item_rejected():
    cfg = _cfg()
    bu = BatchUpmixer(cfg, n_samples=1024, batch_size=1)
    L, R = make_stereo(2048, cfg.sr, seed=30)
    with pytest.raises(ValueError):
        bu.submit([np.stack([L, R]).astype(np.float32)])
