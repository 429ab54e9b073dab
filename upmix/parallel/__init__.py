"""Mesh-sharded execution: data parallelism over batches of files and
sequence parallelism over the frame axis of long inputs.

The reference's only parallelism is a per-band ThreadPoolExecutor
(center_extraction.py:499-511).  Here scale-out is a device mesh
(SURVEY.md §2.3): a `jax.sharding.Mesh` with a ``data`` axis (batch of
inputs) and a ``seq`` axis (frame/sample axis of one long input), with
halo exchange over the device interconnect via `ppermute` at shard
boundaries.
"""

from upmix.parallel.distributed import (
    init_distributed,
    is_initialized,
    local_file_shard,
    process_count,
    process_index,
)
from upmix.parallel.pod_check import run_pod_check
from upmix.parallel.sharded import (
    ShardedUpmixer,
    build_sharded_offline_fn,
    make_mesh,
    sequence_plan,
)

__all__ = [
    "ShardedUpmixer",
    "build_sharded_offline_fn",
    "init_distributed",
    "is_initialized",
    "local_file_shard",
    "make_mesh",
    "process_count",
    "process_index",
    "run_pod_check",
    "sequence_plan",
]
