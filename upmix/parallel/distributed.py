"""Multi-host runtime initialization.

Single-host multi-device scale-out needs nothing from this module: a
`jax.sharding.Mesh` over the local devices (make_mesh) is enough, and
XLA routes the sequence-parallel halo exchange over the device
interconnect.  A multi-host cluster — each host owning a subset of the
devices — additionally needs the
JAX distributed runtime brought up once per process before any device
is touched, so `jax.devices()` is the GLOBAL device list every
process agrees on.  This module wraps that bring-up with the
framework's conventions:

- `init_distributed()` — idempotent `jax.distributed.initialize`
  (auto-detection on clusters jax.distributed knows; explicit
  coordinator arguments for manual launches), returning a small info
  record.
- `is_initialized()`, `process_index()`, `process_count()` — cheap
  introspection used by logging and by hosts that split file lists.
- `local_file_shard(paths)` — the multi-host batch convention for the
  offline path: process i takes paths[i::n], each host feeds its own
  BatchUpmixer/serving pool over its local slice of a data-axis mesh.

Validated at num_processes=2 in the test suite (tests/test_distributed.py
spawns two OS processes with gloo TCP collectives on the CPU backend and
runs `pod_check`: cross-process psum, the global-mesh sharded pipeline
with halo ppermutes crossing the process boundary, and per-process file
shards — all oracle-gated); GPU clusters use the identical call path
with NCCL collectives.
"""

from __future__ import annotations

_INIT_INFO: dict | None = None


def is_initialized() -> bool:
    """True once this process's distributed runtime is up (via this
    module OR a direct jax.distributed.initialize by the launcher)."""
    import jax

    if _INIT_INFO is not None:
        return True
    state = getattr(jax._src.distributed, "global_state", None)
    return bool(state is not None and state.client is not None)


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
) -> dict:
    """Bring up the JAX distributed runtime (idempotent).

    With no arguments, jax.distributed auto-detects the cluster from the
    environment (SLURM, Open MPI, GKE); manual launches pass
    the coordinator's ``host:port`` plus this process's id and the
    process count.  Returns {"process_index", "process_count",
    "local_devices", "global_devices"} — after this call,
    ``jax.devices()`` is the cluster-global list and make_mesh() over it
    builds cluster-wide meshes.

    Call BEFORE any other jax API touches a device (jax requirement);
    calling again (or when the launcher already initialized) is a no-op
    returning the current topology.
    """
    global _INIT_INFO
    import jax

    if not is_initialized():
        kwargs = {}
        if coordinator_address is not None:
            kwargs["coordinator_address"] = coordinator_address
        if num_processes is not None:
            kwargs["num_processes"] = int(num_processes)
        if process_id is not None:
            kwargs["process_id"] = int(process_id)
        if local_device_ids is not None:
            kwargs["local_device_ids"] = local_device_ids
        jax.distributed.initialize(**kwargs)
    _INIT_INFO = {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }
    return dict(_INIT_INFO)


def process_index() -> int:
    import jax

    return jax.process_index()


def process_count() -> int:
    import jax

    return jax.process_count()


def local_file_shard(paths, index: int | None = None, count: int | None = None):
    """This process's slice of a cluster-wide work list (round-robin
    ``paths[i::n]`` — balanced for homogeneous files and stable under
    appends).  The multi-host offline convention: every host runs the
    same program over its own shard; no cross-host communication is
    needed because files are independent (the data axis)."""
    import jax

    i = jax.process_index() if index is None else int(index)
    n = jax.process_count() if count is None else int(count)
    if not 0 <= i < n:
        raise ValueError(f"process index {i} out of range [0, {n})")
    return list(paths)[i::n]
