"""Real-time-style streaming with mid-stream checkpoint/resume.

The streaming engine is a pure scan step over an explicit state pytree
(input history + overlap-add accumulators + block counter) — the state IS
the checkpoint format.  This example streams block by block, snapshots
the state halfway, resumes a second engine from the snapshot, and shows
the continuation is bit-identical.

    python examples/02_streaming_checkpoint.py

(Use orbax-checkpoint to persist the snapshot to disk — the state is a
plain pytree of arrays; tests/test_streaming.py shows the round-trip.)
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from upmix.config import UpmixConfig
from upmix.models.streaming import StreamingUpmixer

# The reference's shipped real-time config: edges 0/500/2000/8000 Hz at
# 48 kHz, 2048-sample hardware blocks (bela/upmix.cpp:525-528).
SR, HW = 48000.0, 2048
cfg = UpmixConfig.streaming([0.0, 500.0, 2000.0, 8000.0], sr=SR, hw_block_size=HW)

rng = np.random.default_rng(0)
n_blocks = 12
blocks = rng.standard_normal((n_blocks, 2, HW)).astype(np.float32) * 0.3

eng = StreamingUpmixer(cfg, HW)
print(f"bands: {[b.block_size for b in cfg.bands]}, warmup {eng.warmup_blocks} blocks")

outs = []
snap = None
for i, (bl, br) in enumerate(blocks):
    if i == n_blocks // 2:
        snap = eng.snapshot()  # host-side copy, safe to persist
        print(f"checkpointed at block {i}")
    c, ls, rs = eng.push_block(bl, br)
    outs.append(np.asarray(c))

# Resume a NEW engine from the snapshot and replay the second half.
eng2 = StreamingUpmixer(cfg, HW)
eng2.state = snap
resumed = []
for bl, br in blocks[n_blocks // 2 :]:
    c, _, _ = eng2.push_block(bl, br)
    resumed.append(np.asarray(c))

np.testing.assert_array_equal(
    np.concatenate(outs[n_blocks // 2 :]), np.concatenate(resumed)
)
print("resumed continuation is bit-identical to the uninterrupted stream")
