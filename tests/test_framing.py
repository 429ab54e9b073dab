"""Framing / overlap-add fold correctness."""

import numpy as np
import pytest

from upmix.ops.framing import frame_signal, offline_frame_plan, overlap_add


def _naive_frames(x, block, hop, F):
    return np.stack([x[f * hop : f * hop + block] for f in range(F)])


def _naive_fold(frames, hop):
    F, block = frames.shape
    out = np.zeros((F - 1) * hop + block, dtype=frames.dtype)
    for f in range(F):
        out[f * hop : f * hop + block] += frames[f]
    return out


@pytest.mark.parametrize("block,hop", [(64, 16), (64, 32), (48, 16), (60, 25)])
def test_frame_matches_naive(block, hop):
    F = 9
    total = (F - 1) * hop + block
    x = np.random.default_rng(0).standard_normal(total).astype(np.float32)
    got = np.asarray(frame_signal(x, block, hop, F))
    np.testing.assert_array_equal(got, _naive_frames(x, block, hop, F))


@pytest.mark.parametrize("block,hop", [(64, 16), (48, 16), (60, 25)])
def test_fold_matches_naive(block, hop):
    F = 7
    frames = np.random.default_rng(1).standard_normal((F, block)).astype(np.float32)
    got = np.asarray(overlap_add(frames, hop))
    np.testing.assert_allclose(got, _naive_fold(frames, hop), rtol=1e-6, atol=1e-6)


def test_frame_fold_batched():
    block, hop, F = 32, 8, 5
    total = (F - 1) * hop + block
    x = np.random.default_rng(2).standard_normal((3, 2, total)).astype(np.float32)
    frames = np.asarray(frame_signal(x, block, hop, F))
    assert frames.shape == (3, 2, F, block)
    folded = np.asarray(overlap_add(frames, hop))
    for i in range(3):
        for j in range(2):
            np.testing.assert_allclose(
                folded[i, j], _naive_fold(frames[i, j], hop), rtol=1e-6, atol=1e-6
            )


def test_frame_shape_validation():
    with pytest.raises(ValueError):
        frame_signal(np.zeros(100, np.float32), 64, 16, 4)


def test_offline_frame_plan_reference_math():
    # Reference padding math (center_extraction.py:437-445): leftover =
    # block - hop; num_hops = ceil((N - leftover)/hop); the hop loop then
    # runs ceil(padded/hop) iterations.
    block, hop = 64, 16
    for n in [1, 15, 16, 48, 49, 64, 100, 1000]:
        F, total = offline_frame_plan(n, block, hop)
        # Simulate the reference loop to count frames
        import math

        leftover = block - hop
        num_hops = math.ceil((n - leftover) / hop)
        padded = max(num_hops * hop + leftover, n)
        count = 0
        idx = 0
        while idx < padded:
            count += 1
            idx += hop
        assert F == count, n
        assert total == (F - 1) * hop + block
        assert total >= n
