"""Framing and overlap-add as static tensor ops.

The reference realizes the STFT hop structure imperatively: a sequential
hop loop reading overlapping windows (center_extraction.py:449-460) and a
mutable accumulate/pop/shift state machine (center_extraction.py:391-407;
bela/upmix.cpp:145-162).  Here both become single fused tensor programs:

  - frame_signal: all hops extracted at once.  When hop divides the block
    (true for all power-of-two overlaps like the fixed 75%), framing is a
    reshape plus K static slices — no gather.
  - overlap_add: the inverse fold, expressed as K static pads summed —
    XLA fuses it; no scatter, deterministic accumulation order.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def frame_signal(x: jnp.ndarray, block_size: int, hop_size: int, num_frames: int) -> jnp.ndarray:
    """Extract overlapping frames: out[..., f, n] = x[..., f*hop + n].

    x must have trailing length (num_frames - 1) * hop_size + block_size.
    """
    total = (num_frames - 1) * hop_size + block_size
    if x.shape[-1] != total:
        raise ValueError(f"expected trailing length {total}, got {x.shape[-1]}")
    batch = x.shape[:-1]
    if block_size % hop_size == 0:
        k_frames = block_size // hop_size
        rows = num_frames - 1 + k_frames
        z = x.reshape(*batch, rows, hop_size)
        parts = [z[..., k : k + num_frames, :] for k in range(k_frames)]
        return jnp.stack(parts, axis=-2).reshape(*batch, num_frames, block_size)
    idx = np.arange(num_frames)[:, None] * hop_size + np.arange(block_size)[None, :]
    return x[..., idx]


def overlap_add(frames: jnp.ndarray, hop_size: int) -> jnp.ndarray:
    """Fold overlapping frames back into a signal by summation.

    frames: [..., num_frames, block_size] → [..., (num_frames-1)*hop + block].
    Expressed as block//hop statically-padded partial signals summed, which
    XLA fuses without scatter.
    """
    *batch, num_frames, block_size = frames.shape
    total = (num_frames - 1) * hop_size + block_size
    if block_size % hop_size == 0:
        k_frames = block_size // hop_size
        rows = num_frames - 1 + k_frames
        z = frames.reshape(*batch, num_frames, k_frames, hop_size)
        pad_cfg = [(0, 0)] * len(batch)
        acc = None
        for k in range(k_frames):
            part = jnp.pad(z[..., :, k, :], pad_cfg + [(k, k_frames - 1 - k), (0, 0)])
            acc = part if acc is None else acc + part
        return acc.reshape(*batch, rows * hop_size)
    # General (non-divisible) hop: scatter-add fold.
    idx = np.arange(num_frames)[:, None] * hop_size + np.arange(block_size)[None, :]
    out = jnp.zeros((*batch, total), dtype=frames.dtype)
    return out.at[..., idx.reshape(-1)].add(frames.reshape(*batch, -1))


def offline_frame_plan(n_samples: int, block_size: int, hop_size: int) -> tuple:
    """Frame-count bookkeeping matching the reference's padding math.

    The reference pads so every window is full and loops hops over the
    padded signal (center_extraction.py:437-460): leftover = block - hop,
    num_hops = ceil((N - leftover)/hop), padded = num_hops*hop + leftover
    (never shrinking below N), and the hop loop then runs
    ceil(padded/hop) iterations.  Returns (num_frames, total_padded) where
    total_padded = (num_frames-1)*hop + block is the zero-padded length the
    framed view needs.
    """
    import math

    leftover = block_size - hop_size
    num_hops = math.ceil((n_samples - leftover) / hop_size)
    padded_len = max(num_hops * hop_size + leftover, n_samples)
    num_frames = math.ceil(padded_len / hop_size)
    total_padded = (num_frames - 1) * hop_size + block_size
    return num_frames, total_padded
