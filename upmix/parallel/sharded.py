"""Sharded offline pipeline: DP over a batch axis × SP over the frame axis.

Design (SURVEY.md §2.3/§5 "long-context"):

  - The sample/frame axis of one long input is the "sequence".  It is
    sharded over the mesh's ``seq`` axis; each device processes a
    contiguous chunk of hops.  Frames that straddle a shard boundary need
    ``block - hop`` samples from the right neighbor (input halo), and the
    local overlap-add fold spills ``block - hop`` output samples into the
    right neighbor's region (output halo).  Both are one `ppermute` each
    — nearest-neighbor traffic over the device interconnect.
  - A batch of independent inputs is sharded over the ``data`` axis with
    zero communication.

Everything runs inside one jitted `shard_map`; XLA overlaps the
`ppermute`s with per-device compute.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from upmix.config import UpmixConfig, bucket_bands
from upmix.models.offline import (
    _bucket_fold_mm,
    _plan_buckets,
    _spectral_lcr_mm,
    resolve_kernel,
)
from upmix.ops.framing import frame_signal, overlap_add
from upmix.ops.gains import band_gain_curve
from upmix.ops.mask import center_mask
from upmix.ops.windows import design_wola_synthesis_window, make_window


def make_mesh(axis_sizes: dict | None = None, devices=None) -> Mesh:
    """Build a mesh over the available devices.

    axis_sizes e.g. {"data": 2, "seq": 4}; defaults to all devices on one
    ``seq`` axis (the long-file case).
    """
    devices = list(devices if devices is not None else jax.devices())
    if axis_sizes is None:
        axis_sizes = {"seq": len(devices)}
    names = tuple(axis_sizes)
    sizes = tuple(axis_sizes[n] for n in names)
    total = math.prod(sizes)
    if total > len(devices):
        raise ValueError(f"mesh needs {total} devices, have {len(devices)}")
    arr = np.array(devices[:total]).reshape(sizes)
    return Mesh(arr, names)


@dataclass(frozen=True)
class _SeqBucketPlan:
    block_size: int
    hop_size: int
    analysis_window: np.ndarray
    synthesis_window: np.ndarray
    gains: np.ndarray  # [n_bands, n_bins]


@dataclass(frozen=True)
class SequencePlan:
    """Host-side geometry of a sequence-sharded run."""

    n_samples: int
    n_devices: int
    chunk: int  # samples per device (multiple of every hop)
    halo: int  # max(block - hop) over buckets
    n_padded: int  # chunk * n_devices


def _plan_seq_buckets(config: UpmixConfig):
    plans = []
    for block_size, bands in bucket_bands(config.bands).items():
        hop = bands[0].hop_size
        aw = make_window(config.window, block_size)
        if config.synthesis == "wola":
            sw = design_wola_synthesis_window(aw, config.overlap)
        elif config.synthesis == "analysis":
            sw = aw
        else:
            raise ValueError(f"unknown synthesis mode {config.synthesis!r}")
        gains = np.stack([band_gain_curve(b, dtype=np.float32) for b in bands])
        plans.append(
            _SeqBucketPlan(
                block_size=block_size,
                hop_size=hop,
                analysis_window=aw,
                synthesis_window=sw,
                gains=gains,
            )
        )
    return plans


def sequence_plan(config: UpmixConfig, n_samples: int, n_seq: int) -> SequencePlan:
    """Choose the per-device chunk size: a multiple of every bucket's block
    size (so per-device frame counts divide the grouped-framing factor K)
    AND hop size (so shard boundaries land on the global frame grid —
    required for exactness at ANY overlap, not just power-of-two ones;
    found by the round-5 config fuzz at overlap=0.65), at least as large
    as the largest input halo ``block - hop``."""
    buckets = _plan_seq_buckets(config)
    unit = 1
    for p in buckets:
        bu = p.block_size * p.hop_size // math.gcd(p.block_size, p.hop_size)
        unit = unit * bu // math.gcd(unit, bu)
    if unit > (1 << 24):
        # Pathological overlaps (hop coprime to the blocks) drive the
        # frame-grid LCM into the tens of millions of samples per device;
        # reject at config time rather than compile an absurd chunk.
        raise ValueError(
            f"sequence sharding needs a per-device chunk that is a "
            f"multiple of every block AND hop; this config's LCM is "
            f"{unit} samples (> {1 << 24}) — use a divisible overlap "
            "(hop | block) or process unsharded"
        )
    halo = max(p.block_size - p.hop_size for p in buckets)
    chunk = max(math.ceil(n_samples / (n_seq * unit)), 1) * unit
    while chunk < halo:
        chunk += unit
    n_padded = chunk * n_seq
    if n_padded > max(4 * n_samples, n_samples + (1 << 22)):
        # The frame-grid unit can dwarf a short input (e.g. overlap 0.65
        # with blocks 256+512 gives unit ~8.2M): padding a clip by
        # orders of magnitude would look like a hang/OOM, not a run.
        # Reject cleanly; the unsharded pipeline handles any length.
        raise ValueError(
            f"sequence sharding would pad {n_samples} samples to "
            f"{n_padded} (chunk {chunk} x {n_seq} devices; frame-grid "
            f"unit {unit}) — input too short for this config's shard "
            "geometry; process unsharded or use a divisible overlap"
        )
    return SequencePlan(
        n_samples=n_samples,
        n_devices=n_seq,
        chunk=chunk,
        halo=halo,
        n_padded=chunk * n_seq,
    )


def _local_lcr(
    plans,
    chunk: int,
    halo: int,
    seq_axis: str,
    axis_size: int,
    kern: str,
    x_loc: jnp.ndarray,
):
    """Per-device body: x_loc [..., 2, chunk] -> y_loc [..., 3, chunk].

    Two nearest-neighbor `ppermute`s realize the input and output halos.
    kern="mm" routes every bucket through the grouped-framing matmul fold
    (the same body as the single-device chunked scan); kern="xla" keeps
    the jnp.fft path (the CPU default).
    """
    # Input halo: receive the first `halo` samples of the right neighbor.
    # (Each device sends its head to its left neighbor; the last device
    # receives zeros — its halo lies in the zero padding.)
    perm = [(d, d - 1) for d in range(1, axis_size)]
    halo_in = jax.lax.ppermute(x_loc[..., :halo], seq_axis, perm)
    x_ext = jnp.concatenate([x_loc, halo_in], axis=-1)  # [..., 2, chunk+halo]

    if kern == "mm":
        lead = x_ext.shape[:-2]
        xb = x_ext.reshape((-1,) + x_ext.shape[-2:])  # [S, 2, chunk+halo]

        y_total = None
        for plan in plans:
            B, H = plan.block_size, plan.hop_size
            F = chunk // H  # exact: sequence_plan makes chunk % H == 0
            T = chunk + B - H  # fold length incl. spill tail <= chunk + halo
            if B % H:
                # Non-divisible overlap: grouped framing doesn't apply —
                # gather framing + scatter-add fold (the sharded analog
                # of offline.py's _bucket_lcr_mm_gather), same matmul
                # transforms/gains/mask.
                def gather_contrib(xe, plan=plan, F=F, B=B, H=H):
                    fr = frame_signal(xe[:, : (F - 1) * H + B], B, H, F)
                    rec = _spectral_lcr_mm(plan, fr)  # [3, F, B]
                    return overlap_add(rec, H)  # [3, chunk + B - H]

                contrib = jax.vmap(gather_contrib)(xb)
            else:
                contrib = jax.vmap(
                    lambda xe, plan=plan, F=F, T=T: _bucket_fold_mm(plan, xe[:, :T], F)
                )(xb)
            pad = chunk + halo - T
            if pad:
                contrib = jnp.pad(contrib, ((0, 0), (0, 0), (0, pad)))
            y_total = contrib if y_total is None else y_total + contrib
        y_total = y_total.reshape(lead + (3, chunk + halo))
    else:
        y_total = jnp.zeros((*x_loc.shape[:-2], 3, chunk + halo), jnp.float32)
        for plan in plans:
            B, H = plan.block_size, plan.hop_size
            n_frames = chunk // H
            needed = (n_frames - 1) * H + B  # = chunk + (B - H) <= chunk + halo
            frames = frame_signal(x_ext[..., :needed], B, H, n_frames)
            frames = frames * jnp.asarray(plan.analysis_window)
            spec = jnp.fft.rfft(frames)  # [..., 2, F, n_bins]
            gains = jnp.asarray(plan.gains)[:, None, :]
            spec_l = spec[..., 0, None, :, :] * gains
            spec_r = spec[..., 1, None, :, :] * gains
            spec_c, spec_ls, spec_rs = center_mask(spec_l, spec_r)
            summed = jnp.stack(
                [spec_c.sum(axis=-3), spec_ls.sum(axis=-3), spec_rs.sum(axis=-3)],
                axis=-3,
            )  # [..., 3, F, n_bins]
            rec = jnp.fft.irfft(summed, n=B) * jnp.asarray(plan.synthesis_window)
            folded = overlap_add(rec, H)  # [..., 3, chunk + (B - H)]
            pad = chunk + halo - folded.shape[-1]
            if pad:
                folded = jnp.pad(
                    folded, [(0, 0)] * (folded.ndim - 1) + [(0, pad)]
                )
            y_total = y_total + folded

    # Output halo: our fold's tail [chunk:] overlaps the right neighbor's
    # head — send it right and add the tail received from the left.
    perm = [(d, d + 1) for d in range(axis_size - 1)]
    spill = jax.lax.ppermute(y_total[..., chunk:], seq_axis, perm)
    y = y_total[..., :chunk]
    return y.at[..., :halo].add(spill)


def build_sharded_offline_fn(
    config: UpmixConfig,
    n_samples: int,
    mesh: Mesh,
    data_axis: str | None = "data",
    seq_axis: str = "seq",
    kernel: str = "auto",
):
    """Build the jitted sharded pipeline.

    Returns (fn, plan): fn maps x [batch, 2, n_padded] -> y [batch, 3,
    n_padded] with batch sharded over `data_axis` (if present in the mesh)
    and samples sharded over `seq_axis`.  A mesh without `seq_axis` is
    pure data parallelism (one sequence shard, no halo collectives).
    Use `plan` to pad/trim.
    """
    if seq_axis is not None and seq_axis not in mesh.shape:
        seq_axis = None
    if seq_axis is None:
        # Pure data parallelism: no shard boundaries in the sample axis,
        # so none of the sequence machinery's frame-grid constraints
        # (LCM chunk units, halo exchange, padding-blowup guards) apply —
        # vmap the full single-chip pipeline (which handles arbitrary
        # geometry, non-divisible overlaps included) and shard only the
        # batch axis.
        from upmix.models.offline import build_offline_fn

        base = build_offline_fn(config, n_samples, kernel=kernel)
        spec = P(
            data_axis if (data_axis is not None and data_axis in mesh.shape)
            else None,
            None,
            None,
        )
        fn = jax.jit(
            jax.vmap(lambda x: jnp.stack(base(x[0], x[1]))),
            in_shardings=NamedSharding(mesh, spec),
            out_shardings=NamedSharding(mesh, spec),
        )
        plan = SequencePlan(
            n_samples=n_samples, n_devices=1, chunk=n_samples, halo=0,
            n_padded=n_samples,
        )
        return fn, plan
    n_seq = mesh.shape[seq_axis]
    plan = sequence_plan(config, n_samples, n_seq)
    plans = _plan_buckets(config, plan.chunk)
    kern = resolve_kernel(kernel)

    use_data = data_axis is not None and data_axis in mesh.shape
    batch_spec = data_axis if use_data else None
    in_spec = P(batch_spec, None, seq_axis)
    out_spec = P(batch_spec, None, seq_axis)

    def local_fn(x_loc):
        return _local_lcr(
            plans, plan.chunk, plan.halo, seq_axis, n_seq, kern, x_loc
        )

    sharded = jax.shard_map(
        local_fn, mesh=mesh, in_specs=(in_spec,), out_specs=out_spec
    )
    fn = jax.jit(sharded)
    return fn, plan


class ShardedUpmixer:
    """Mesh-sharded offline upmixer for batches of (long) inputs.

    process_batch(x): x [batch, 2, n] float — returns [batch, 3, n]
    (C, Ls, Rs).  The batch axis is data-parallel; the sample axis is
    sequence-parallel with halo exchange.
    """

    def __init__(
        self,
        config: UpmixConfig,
        mesh: Mesh | None = None,
        kernel: str = "auto",
    ):
        self.config = config
        self.mesh = mesh if mesh is not None else make_mesh()
        self.kernel = kernel
        self._cache = {}
        # Fail n-independent geometry problems (pathological frame-grid
        # LCM) at construction, not first process(); the n-dependent
        # padding-blowup check still runs per call in sequence_plan.
        # A data-only mesh has no sequence shards, hence no frame-grid
        # constraints at all (pure-DP branch in build_sharded_offline_fn).
        if "seq" in self.mesh.shape:
            sequence_plan(config, 1 << 30, self.mesh.shape["seq"])
            # huge n: only the n-independent LCM guard can fire here

    def _compiled(self, n_padded: int):
        key = n_padded
        if key not in self._cache:
            self._cache[key] = build_sharded_offline_fn(
                self.config, n_padded, self.mesh, kernel=self.kernel
            )
        return self._cache[key]

    def process_batch(self, x):
        x = jnp.asarray(x, jnp.float32)
        if x.ndim != 3 or x.shape[1] != 2:
            raise ValueError(f"expected [batch, 2, n], got {x.shape}")
        n = x.shape[-1]
        batch = x.shape[0]
        fn, plan = self._compiled(n)
        if plan.n_padded != n:
            x = jnp.pad(x, ((0, 0), (0, 0), (0, plan.n_padded - n)))
        use_data = "data" in self.mesh.shape
        if use_data:
            # The batch axis must divide evenly across the data axis.
            d = self.mesh.shape["data"]
            batch_padded = -(-batch // d) * d
            if batch_padded != batch:
                x = jnp.pad(x, ((0, batch_padded - batch), (0, 0), (0, 0)))
        sharding = NamedSharding(
            self.mesh,
            P(
                "data" if use_data else None,
                None,
                "seq" if "seq" in self.mesh.shape else None,
            ),
        )
        x = jax.device_put(x, sharding)
        y = fn(x)
        return y[:batch, :, :n]

    def process(self, L, R):
        """Single stereo pair convenience: returns (C, Ls, Rs)."""
        x = jnp.stack([jnp.asarray(L, jnp.float32), jnp.asarray(R, jnp.float32)])
        y = self.process_batch(x[None])[0]
        return y[0], y[1], y[2]

    def process_np(self, L, R):
        """Upmixer-compatible numpy-out variant (app.run_offline's engine
        contract), so a mesh-sharded upmixer slots into the offline
        pipeline / CLI unchanged."""
        c, ls, rs = self.process(L, R)
        return np.asarray(c), np.asarray(ls), np.asarray(rs)
