"""Multi-chip scale-out: data-parallel batches + sequence-parallel long
inputs over a jax.sharding.Mesh.

Without real multi-chip hardware this example forces an 8-device virtual
CPU mesh (the same trick tests/conftest.py and the driver's multi-chip
dry-run use), so it runs anywhere:

    python examples/03_multichip_sharded.py

On a multi-GPU host, drop the two env lines and build the mesh from
jax.devices() — the program is identical; XLA inserts the collectives
(one nearest-neighbor ppermute halo exchange for the input overlap and
one for the overlap-add spill) over NVLink.

The same path is one flag at the CLI: `upmix in.wav --mesh seq=8`
(or `data=2,seq=4`); serving shards with `--serve-stream ...
--pool-mesh data=D`.
"""

import os
import sys

# MUST be set before jax is imported.
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

from upmix.config import UpmixConfig
from upmix.models.offline import upmix_offline
from upmix.parallel import ShardedUpmixer, make_mesh

print(f"devices: {jax.device_count()}")

cfg = UpmixConfig.make([0.0, 400.0, 1600.0], sr=8000.0, max_block_size=512)

# 2 x 4 mesh: batches of files across 'data', each file's sample axis
# across 'seq' (halo exchange keeps the overlapped frames exact).
mesh = make_mesh({"data": 2, "seq": 4})
up = ShardedUpmixer(cfg, mesh=mesh)

rng = np.random.default_rng(0)
x = rng.standard_normal((2, 2, 40960)).astype(np.float32) * 0.3
y = np.asarray(up.process_batch(x))  # [batch, 3, n]
print(f"sharded output: {y.shape}")

# Parity vs the single-device offline path.
ref = np.stack(upmix_offline(x[0, 0], x[0, 1], cfg))
err = np.abs(y[0] - ref).max()
snr = 10 * np.log10((ref**2).sum() / max(((y[0] - ref) ** 2).sum(), 1e-30))
print(f"vs single-device offline: max|diff|={err:.2e}, SNR={snr:.1f} dB")
assert snr > 60.0
