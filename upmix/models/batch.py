"""Batched multi-file offline processing with pipelined host I/O.

The reference processes one file per run (main.py).  For production
throughput the framework stacks many stereo files into one [batch, 2, n]
tensor and runs them through a single jitted (optionally mesh-sharded)
program, overlapping the host-side WAV decode + H2D upload of the next
chunk with device compute on the current one (JAX dispatch is async: the
upload of chunk i+1 is enqueued before the result of chunk i is fetched).

SURVEY.md §7 M5 / §6 "Host I/O overlap".
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from upmix.config import UpmixConfig
from upmix.models.offline import build_offline_fn


class BatchUpmixer:
    """Fixed-geometry batch engine: [batch, 2, n] -> [batch, 3, n].

    Lengths are padded to `n_samples`; batches are padded to `batch_size`
    (both fixed at construction so one compiled program serves the whole
    run).  For multi-chip data parallelism pass a mesh — the batch axis is
    sharded over its 'data' axis.
    """

    def __init__(
        self,
        config: UpmixConfig,
        n_samples: int,
        batch_size: int,
        mesh=None,
        kernel: str = "auto",
    ):
        self.config = config
        self.n_samples = int(n_samples)
        self.batch_size = int(batch_size)
        self.mesh = mesh
        fn = build_offline_fn(config, self.n_samples, kernel=kernel)

        def batched(x):  # [batch, 2, n]
            c, ls, rs = jax.vmap(lambda p: fn(p[0], p[1]))(x)
            return jnp.stack([c, ls, rs], axis=1)  # [batch, 3, n]

        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            self._in_sharding = NamedSharding(mesh, P("data", None, None))
            self._fn = jax.jit(
                batched,
                in_shardings=self._in_sharding,
                out_shardings=NamedSharding(mesh, P("data", None, None)),
            )
        else:
            self._in_sharding = None
            self._fn = jax.jit(batched)

    def _prep(self, arrays):
        """Stack a list of [2, n_i] float arrays into the fixed geometry."""
        x = np.zeros((self.batch_size, 2, self.n_samples), np.float32)
        lengths = []
        for i, a in enumerate(arrays):
            if i >= self.batch_size:
                raise ValueError(f"got more than batch_size={self.batch_size} items")
            n = a.shape[-1]
            if n > self.n_samples:
                raise ValueError(
                    f"item {i} has {n} samples > n_samples={self.n_samples}; "
                    f"split long inputs or build a larger-geometry engine"
                )
            x[i, :, :n] = a
            lengths.append(n)
        return x, lengths

    def submit(self, arrays):
        """Enqueue one batch; returns an opaque handle (device array).

        Does not block: decode/upload of the next batch can proceed while
        the device computes this one.
        """
        x, lengths = self._prep(arrays)
        xd = jnp.asarray(x)
        if self._in_sharding is not None:
            xd = jax.device_put(xd, self._in_sharding)
        return self._fn(xd), lengths

    def collect(self, handle):
        """Fetch a submitted batch: list of [3, n_i] numpy arrays."""
        y, lengths = handle
        y = np.asarray(y)
        return [y[i, :, : lengths[i]] for i in range(len(lengths))]

    def process_files(self, arrays_iter, pipeline: bool = False):
        """Run an iterable of [2, n] arrays through fixed-size batches,
        yielding [3, n] results in order.

        `pipeline=True` keeps one batch in flight: the next batch's host
        prep + upload overlaps the device computing the current one.
        That only wins with host cores to spare and transfers that do
        not contend with the compute stream, so the default is the
        sequential submit+collect path (DESIGN.md §7).
        """
        if not pipeline:
            chunk = []
            for a in arrays_iter:
                chunk.append(np.asarray(a, np.float32))
                if len(chunk) == self.batch_size:
                    yield from self.collect(self.submit(chunk))
                    chunk = []
            if chunk:
                yield from self.collect(self.submit(chunk))
            return
        pending = None
        chunk = []
        for a in arrays_iter:
            chunk.append(np.asarray(a, np.float32))
            if len(chunk) == self.batch_size:
                handle = self.submit(chunk)  # enqueue before draining previous
                if pending is not None:
                    yield from self.collect(pending)
                pending = handle
                chunk = []
        if chunk:
            handle = self.submit(chunk)
            if pending is not None:
                yield from self.collect(pending)
            pending = handle
        if pending is not None:
            yield from self.collect(pending)
