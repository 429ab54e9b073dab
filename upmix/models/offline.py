"""Offline (whole-file) multiband upmix pipeline — the flagship model.

Re-design of the reference's offline path (center_extraction.py:426-513)
for an accelerator.  Instead of a per-band ThreadPoolExecutor running
sequential hop loops, the entire job is ONE jitted program:

  - Bands are bucketed by block size (config.bucket_bands); each bucket's
    frames are extracted once, windowed, and transformed as a single
    batched transform shared by all bands in the bucket.
  - Per-band band-limit gains and the center-extraction mask are fused
    elementwise math batched over the bucket's band axis; the band sum is
    taken IN THE SPECTRAL DOMAIN (linearity of the iSTFT), so each bucket
    needs only 1-2 forward + 2-3 inverse transforms regardless of band
    count — versus 2+3 per band per hop in the reference.
  - Overlap-add is a static fold; the reference's accumulator state
    machine disappears.

Two kernel strategies (kernel= argument; "auto" asks upmix.backend):

  - "mm" (the GPU default): grouped zero-copy framing + matmul transforms.
    With hop = block/K, frames j ≡ g (mod K) are non-overlapping and
    contiguous, so framing is K reshapes (no gather/copy) and the OLA
    fold is K shifted adds.  Narrow buckets use the direct banded DFT
    (ops.dftmm, one matmul per direction); wide ones the 2-stage matmul
    FFT (ops.fftmm).  Long inputs run as a chunked scan whose memory is
    bounded by the chunk.
  - "xla": jnp.fft.rfft/irfft with strided framing over the whole file —
    the portable reference path (the CPU default, where XLA's FFT is
    cheap and the matmul FLOPs are not).

Numerics: float32 / complex64 throughout, matmuls at
ops.fftmm.PRECISION; parity vs the float64 NumPy oracle is held to the
60 dB bar by the tests.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from upmix.backend import engines
from upmix.config import UpmixConfig, bucket_bands
from upmix.ops.dftmm import irdft_direct, make_direct_plan, rdft_direct
from upmix.ops.fftmm import (
    _split,
    irfft_real_banded,
    make_real_banded_plan,
    permute_half_bins,
    rfft_real_banded,
)
from upmix.ops.framing import frame_signal, offline_frame_plan, overlap_add
from upmix.ops.gains import band_gain_curve
from upmix.ops.mask import center_mask
from upmix.ops.windows import design_wola_synthesis_window, make_window


@dataclass(frozen=True)
class _BucketPlan:
    block_size: int
    hop_size: int
    num_frames: int
    total_padded: int
    analysis_window: np.ndarray  # [block]
    synthesis_window: np.ndarray  # [block]
    gains: np.ndarray  # [n_bands_in_bucket, n_bins]


def _plan_buckets(config: UpmixConfig, n_samples: int):
    plans = []
    for block_size, bands in bucket_bands(config.bands).items():
        hop = bands[0].hop_size
        num_frames, total_padded = offline_frame_plan(n_samples, block_size, hop)
        aw = make_window(config.window, block_size)
        if config.synthesis == "wola":
            sw = design_wola_synthesis_window(aw, config.overlap)
        elif config.synthesis == "analysis":
            sw = aw
        else:
            raise ValueError(f"unknown synthesis mode {config.synthesis!r}")
        gains = np.stack([band_gain_curve(b, dtype=np.float32) for b in bands])
        plans.append(
            _BucketPlan(
                block_size=block_size,
                hop_size=hop,
                num_frames=num_frames,
                total_padded=total_padded,
                analysis_window=aw,
                synthesis_window=sw,
                gains=gains,
            )
        )
    return plans


def _bucket_lcr(plan: _BucketPlan, L: jnp.ndarray, R: jnp.ndarray, n_samples: int):
    """One bucket's (C, Ls, Rs) contribution via the XLA-FFT path.

    L, R: [n] float32.  Shapes are static; everything fuses under jit.
    """
    pad = plan.total_padded - n_samples
    x = jnp.stack([L, R])  # [2, n]
    x = jnp.pad(x, ((0, 0), (0, pad)))
    frames = frame_signal(x, plan.block_size, plan.hop_size, plan.num_frames)
    frames = frames * jnp.asarray(plan.analysis_window)
    spec = jnp.fft.rfft(frames)  # [2, F, n_bins] complex64
    gains = jnp.asarray(plan.gains)[:, None, :]  # [B, 1, n_bins]
    spec_l = spec[0][None, :, :] * gains
    spec_r = spec[1][None, :, :] * gains
    spec_c, spec_ls, spec_rs = center_mask(spec_l, spec_r)
    # Band sum in the spectral domain (iSTFT is linear).
    summed = jnp.stack(
        [spec_c.sum(axis=0), spec_ls.sum(axis=0), spec_rs.sum(axis=0)]
    )  # [3, F, n_bins]
    rec = jnp.fft.irfft(summed, n=plan.block_size)  # [3, F, block] float32
    rec = rec * jnp.asarray(plan.synthesis_window)
    folded = overlap_add(rec, plan.hop_size)  # [3, total_padded]
    return folded[:, :n_samples]


def _spectral_lcr_mm(plan: _BucketPlan, fr: jnp.ndarray) -> jnp.ndarray:
    """Spectral core shared by the grouped and gather framing paths.

    fr: [2, *lead, B] un-windowed frames -> [3, *lead, B] band-summed,
    synthesis-windowed LCR frames, via the matmul transforms (direct
    banded DFT when the kept-bin weight slices fit, 2-stage real SoA
    matmul FFT otherwise).
    """
    B = plan.block_size
    n_lead = fr.ndim - 2  # batch dims between channel axis and samples
    n_bands = plan.gains.shape[0]

    # Support restriction: outside the bands' passbands+fades every
    # spectral value is zeroed by the gains, so the transforms only
    # materialize the bins that carry energy (exact semantics — the
    # multirate-decimation equivalent).
    nz = np.nonzero(plan.gains.max(axis=0))[0]
    lo, hi = (int(nz[0]), int(nz[-1])) if len(nz) else (0, 0)
    kept = hi - lo + 1
    pow2 = B & (B - 1) == 0
    # The 2-stage factorization requires power-of-two sizes; _split is
    # meaningless otherwise (non-pow2 blocks arise from a non-pow2
    # max_block_size on an f_low=0 band — the reference returns
    # max_block_size verbatim there, center_extraction.py:193-197).
    n1, n2 = _split(B) if pow2 else (0, 0)

    # Direct-DFT weight slices are [B, 2*kept] program constants; bound
    # their size so compiled programs stay small (large blocks use the
    # 2-stage kernel, whose constants are O(sqrt(B)^2) tiny).
    weight_bytes = B * 2 * kept * 4
    if (kept <= n1 + n2 or not pow2) and weight_bytes <= (8 << 20):
        # Narrow support: direct banded DFT — one matmul per direction
        # with the analysis/synthesis windows and normalization folded
        # into the weight slices.
        dplan = make_direct_plan(
            B, lo, hi, plan.analysis_window, plan.synthesis_window
        )
        sre, sim = rdft_direct(fr, dplan)  # [2, *lead, kept]
        g = jnp.asarray(plan.gains[:, lo : hi + 1]).reshape(
            (1, n_bands) + (1,) * n_lead + (kept,)
        )
        spec = jax.lax.complex(sre[:, None] * g, sim[:, None] * g)
        sc, sls, srs = center_mask(spec[0], spec[1])
        summed = jnp.stack([sc, sls, srs]).sum(axis=1)  # [3, *lead, kept]
        rec = irdft_direct(
            jnp.real(summed), jnp.imag(summed), dplan
        )  # [3, *lead, B], synthesis-windowed
    elif not pow2:
        # Wide support at a non-power-of-two block: neither the direct
        # slices nor the 2-stage factorization apply — fall back to XLA's
        # FFT for this bucket (same semantics; only the transform backend
        # differs).
        frw = fr * jnp.asarray(plan.analysis_window)
        spec = jnp.fft.rfft(frw)  # [2, *lead, n_bins]
        g = jnp.asarray(plan.gains).reshape(
            (1, n_bands) + (1,) * n_lead + (plan.gains.shape[1],)
        )
        spec = spec[:, None] * g  # [2, n_bands, *lead, n_bins]
        sc, sls, srs = center_mask(spec[0], spec[1])
        summed = jnp.stack([sc, sls, srs]).sum(axis=1)
        rec = jnp.fft.irfft(summed, n=B) * jnp.asarray(plan.synthesis_window)
    else:
        # Wide support: 2-stage real SoA matmul FFT in the permuted
        # banded layout.
        fplan = make_real_banded_plan(B, lo, hi)
        frw = fr * jnp.asarray(plan.analysis_window)
        sre, sim = rfft_real_banded(frw, fplan)  # [2, *lead, N1, C]
        gains_perm = np.stack([permute_half_bins(fplan, g) for g in plan.gains])
        g = jnp.asarray(gains_perm).reshape(
            (1, n_bands) + (1,) * n_lead + gains_perm.shape[1:]
        )
        spec = jax.lax.complex(sre[:, None] * g, sim[:, None] * g)
        sc, sls, srs = center_mask(spec[0], spec[1])
        summed = jnp.stack([sc, sls, srs]).sum(axis=1)  # [3, *lead, N1, C]
        rec = irfft_real_banded(jnp.real(summed), jnp.imag(summed), fplan)
        rec = rec * jnp.asarray(plan.synthesis_window)
    return rec


def _bucket_fold_mm(plan: _BucketPlan, x_ext: jnp.ndarray, F: int):
    """One bucket's folded (C, Ls, Rs) over F frames via grouped framing +
    matmul transforms.

    x_ext: [2, T] with T = (F + K - 1) * H, F a multiple of K = block/hop.
    Frames start at 0, H, ..., (F-1)*H.  Returns [3, T].

    Requires hop | block (true for every power-of-two overlap).  Frames
    with index ≡ g (mod K) start at g*hop and are exactly one block apart
    — non-overlapping and contiguous, so framing is K reshapes of slices
    and the OLA fold is K shifted adds.  Non-divisible overlaps go
    through _bucket_lcr_mm_gather instead.
    """
    B, H = plan.block_size, plan.hop_size
    if B % H:
        raise ValueError(
            f"grouped framing requires hop | block (block={B}, hop={H}); "
            "use the gather path for non-divisible overlaps"
        )
    K = B // H
    if F % K:
        raise ValueError(f"frame count {F} must be a multiple of K={K}")
    M = F // K  # frames per group
    T = (F + K - 1) * H
    if x_ext.shape != (2, T):
        raise ValueError(f"expected x_ext [2, {T}], got {x_ext.shape}")

    groups = [x_ext[:, g * H : g * H + M * B].reshape(2, M, B) for g in range(K)]
    fr = jnp.stack(groups, axis=1)  # [2, K, M, B] (un-windowed)
    rec = _spectral_lcr_mm(plan, fr)  # [3, K, M, B]

    # Fold: groups are internally non-overlapping -> flat reshape, then K
    # statically-shifted adds.
    flat = rec.reshape(3, K, M * B)
    acc = None
    for g_ in range(K):
        part = jnp.pad(flat[:, g_], ((0, 0), (g_ * H, T - g_ * H - M * B)))
        acc = part if acc is None else acc + part
    return acc  # [3, T]


def _bucket_lcr_mm(plan: _BucketPlan, L: jnp.ndarray, R: jnp.ndarray, n_samples: int):
    """Whole-signal wrapper over _bucket_fold_mm (grouped framing + matmul
    transforms): pads to the grouped geometry and trims to n_samples.
    Dispatches to the gather path when hop does not divide the block
    (arbitrary overlaps — reference: center_extraction.py:250-254 accepts
    any overlap with hop >= 1)."""
    B, H = plan.block_size, plan.hop_size
    if B % H:
        return _bucket_lcr_mm_gather(plan, L, R, n_samples)
    K = B // H
    Fp = -(-plan.num_frames // K) * K
    T = (Fp + K - 1) * H
    x = jnp.stack([L, R])
    x = jnp.pad(x, ((0, 0), (0, T - n_samples)))
    return _bucket_fold_mm(plan, x, Fp)[:, :n_samples]


def _bucket_lcr_mm_gather(
    plan: _BucketPlan, L: jnp.ndarray, R: jnp.ndarray, n_samples: int
):
    """Matmul-transform bucket for arbitrary overlaps (hop ∤ block).

    Framing is a strided gather and the fold a scatter-add instead of the
    zero-copy reshapes — only the layout trick is lost; the transforms,
    gains, and mask are identical to the grouped path.
    """
    pad = plan.total_padded - n_samples
    x = jnp.stack([L, R])
    x = jnp.pad(x, ((0, 0), (0, pad)))
    fr = frame_signal(x, plan.block_size, plan.hop_size, plan.num_frames)
    rec = _spectral_lcr_mm(plan, fr)  # [3, F, B]
    folded = overlap_add(rec, plan.hop_size)  # [3, total_padded]
    return folded[:, :n_samples]


_KERNELS = ("auto", "mm", "xla")


def resolve_kernel(kernel: str) -> str:
    if kernel not in _KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; one of {_KERNELS}")
    if kernel == "auto":
        return engines().offline_kernel
    return kernel


# Long inputs are processed as a scan over fixed-size chunks with
# overlap-discard halos; the spill of each chunk's overlap-add tail is
# carried into the next chunk — exact semantics, same math as the
# sequence-parallel halo exchange in parallel/sharded.py.  The chunk
# bounds the program's working set; `python -m upmix.tune --offline`
# re-derives the best size for a device.  Short inputs clamp the chunk
# down (build_offline_chunked_fn), so small files don't pad up.
CHUNK_SAMPLES = 2**21
_CHUNK_THRESHOLD = 2**18  # below this, one whole-file program is faster


def _chain_block_lcm(plans) -> int:
    # Grouped framing needs per-chunk frame counts divisible by K =
    # block/hop, i.e. the chunk must be a multiple of every BLOCK size
    # (not just every hop).
    import math as _math

    unit = 1
    for p in plans:
        unit = unit * p.block_size // _math.gcd(unit, p.block_size)
    return unit


def build_offline_chunked_fn(
    config: UpmixConfig,
    n_samples: int,
    kernel: str = "auto",
    chunk: int = CHUNK_SAMPLES,
):
    """Chunked-scan variant of build_offline_fn (kernel 'mm' only).

    Returns fn(L, R) -> (C, Ls, Rs) each [n_samples].  One compiled chunk
    body is reused across ceil(n/chunk) scan steps; every bucket runs
    through the grouped-framing matmul fold (_bucket_fold_mm).
    """
    if kernel not in ("auto", "mm"):
        raise ValueError(
            f"the chunked scan supports only the 'mm' kernel, got {kernel!r}"
        )
    odd = [b for b in config.bands if b.block_size & (b.block_size - 1)]
    if odd:
        raise ValueError(
            "the chunked scan requires power-of-two block sizes (got "
            f"{odd[0].block_size}); non-power-of-two blocks run as a "
            "whole-file program (build_offline_fn routes them automatically)"
        )
    bad = [b for b in config.bands if b.block_size % b.hop_size]
    if bad:
        raise ValueError(
            "the chunked scan requires hop | block for every band "
            f"(got block={bad[0].block_size}, hop={bad[0].hop_size} at "
            f"overlap={bad[0].overlap}); non-divisible overlaps run as a "
            "whole-file program (build_offline_fn routes them automatically)"
        )
    plans = _plan_buckets(config, chunk)  # geometry is per-chunk
    unit = _chain_block_lcm(plans)
    # Clamp to the input length (unit-rounded) so short inputs don't pad
    # up to the full default chunk, then round up to the unit.
    chunk = min(chunk, max(-(-n_samples // unit) * unit, unit))
    if chunk % unit:
        chunk = -(-chunk // unit) * unit
    halo = max(p.block_size - p.hop_size for p in plans)
    if chunk < halo:
        raise ValueError(f"chunk {chunk} smaller than halo {halo}")
    n_seg = -(-n_samples // chunk)
    n_pad = n_seg * chunk

    def fn(L: jnp.ndarray, R: jnp.ndarray):
        x = jnp.stack([L.astype(jnp.float32), R.astype(jnp.float32)])
        x = jnp.pad(x, ((0, 0), (0, n_pad + halo - n_samples)))
        # segments with right halo: [n_seg, 2, chunk + halo]
        idx = np.arange(n_seg) * chunk
        segs = (
            x[None]
            if n_seg == 1
            else jnp.stack(
                [
                    jax.lax.dynamic_slice_in_dim(x, int(s), chunk + halo, axis=1)
                    for s in idx
                ]
            )
        )

        def body(carry, seg):  # carry: spill tail [3, halo]
            y = None
            for p in plans:
                F = chunk // p.hop_size  # frames whose output starts here
                T = chunk + p.block_size - p.hop_size  # <= chunk + halo
                contrib = _bucket_fold_mm(p, seg[:, :T], F)  # [3, T]
                pad = chunk + halo - T
                if pad:
                    contrib = jnp.pad(contrib, ((0, 0), (0, pad)))
                y = contrib if y is None else y + contrib
            out = y[:, :chunk].at[:, :halo].add(carry)
            return y[:, chunk:], out

        zero = jnp.zeros((3, halo), jnp.float32)
        if n_seg == 1:
            # Single segment: skip the scan and the [n_seg, 3, chunk]
            # moveaxis/copy entirely (saves ~2 full-output HBM passes).
            _, full = body(zero, segs[0])
        else:
            _, outs = jax.lax.scan(body, zero, segs)  # [n_seg, 3, chunk]
            full = jnp.moveaxis(outs, 0, 1).reshape(3, n_pad)
        return full[0, :n_samples], full[1, :n_samples], full[2, :n_samples]

    return fn


def build_offline_fn(
    config: UpmixConfig,
    n_samples: int,
    kernel: str = "auto",
    chunk: int | None = None,
):
    """Build the (un-jitted) whole-file processing function for a fixed
    input length.  Returns fn(L, R) -> (C, Ls, Rs), each [n_samples] f32.

    Long inputs on the 'mm' kernel automatically run as a chunked scan
    (see build_offline_chunked_fn); pass chunk=0 to force one whole-file
    program, or a positive chunk size to override the default.
    """
    kern = resolve_kernel(kernel)
    divisible = all(b.block_size % b.hop_size == 0 for b in config.bands)
    pow2 = all(b.block_size & (b.block_size - 1) == 0 for b in config.bands)
    if kern == "mm" and chunk != 0 and divisible and pow2:
        chunk_size = chunk if chunk else CHUNK_SAMPLES
        if n_samples > (_CHUNK_THRESHOLD if chunk is None else 0):
            return build_offline_chunked_fn(
                config, n_samples, kernel=kern, chunk=chunk_size
            )
    plans = _plan_buckets(config, n_samples)
    bucket_fn = _bucket_lcr_mm if kern == "mm" else _bucket_lcr

    def fn(L: jnp.ndarray, R: jnp.ndarray):
        L = L.astype(jnp.float32)
        R = R.astype(jnp.float32)
        acc = None
        for plan in plans:
            contrib = bucket_fn(plan, L, R, n_samples)
            acc = contrib if acc is None else acc + contrib
        return acc[0], acc[1], acc[2]

    return fn


class Upmixer:
    """Config-specialized offline upmixer with a per-length jit cache.

    Distinct input lengths trigger recompilation (static shapes are what
    lets XLA tile the FFTs and fuse the pipeline); `pad_granularity` rounds
    lengths up to bound the number of compiled variants, and the cache is
    an LRU capped at `max_programs` so long-lived processes (the --serve
    job server, notably) do not grow without bound.
    """

    def __init__(
        self,
        config: UpmixConfig,
        pad_granularity: int = 1,
        kernel: str = "auto",
        max_programs: int = 16,
        chunk: int | None = None,
    ):
        from collections import OrderedDict

        self.config = config
        self.pad_granularity = max(1, int(pad_granularity))
        self.kernel = kernel
        self.max_programs = max(1, int(max_programs))
        # Scan chunk-size override (None = CHUNK_SAMPLES, 0 = one
        # whole-file program) — the knob upmix.tune --offline
        # derives for new hardware.
        self.chunk = chunk
        self._cache = OrderedDict()

    def _compiled(self, n_padded: int):
        fn = self._cache.get(n_padded)
        if fn is None:
            fn = jax.jit(
                build_offline_fn(
                    self.config, n_padded, self.kernel, chunk=self.chunk
                )
            )
            self._cache[n_padded] = fn
            while len(self._cache) > self.max_programs:
                self._cache.popitem(last=False)
        else:
            self._cache.move_to_end(n_padded)
        return fn

    def process(self, L, R):
        """stereo in → (C, Ls, Rs) out, each a length-len(L) jax array."""
        n = len(L)
        if n < 1:
            raise ValueError("input must contain at least one sample")
        if len(R) != n:
            raise ValueError(f"channel length mismatch: {n} vs {len(R)}")
        g = self.pad_granularity
        n_padded = -(-n // g) * g
        L = jnp.asarray(L, dtype=jnp.float32)
        R = jnp.asarray(R, dtype=jnp.float32)
        if n_padded != n:
            L = jnp.pad(L, (0, n_padded - n))
            R = jnp.pad(R, (0, n_padded - n))
        c, ls, rs = self._compiled(n_padded)(L, R)
        return c[:n], ls[:n], rs[:n]

    def process_np(self, L, R):
        c, ls, rs = self.process(L, R)
        return np.asarray(c), np.asarray(ls), np.asarray(rs)


def upmix_offline(L, R, config: UpmixConfig, kernel: str = "auto"):
    """One-shot convenience wrapper (numpy in/out)."""
    return Upmixer(config, kernel=kernel).process_np(np.asarray(L), np.asarray(R))
