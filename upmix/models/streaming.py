"""Streaming (block-based, real-time) multiband upmix engine.

Re-design of the reference's real-time path (bela/upmix.cpp) for an
accelerator.
The reference realizes streaming imperatively: per-band ring buffers
(upmix.cpp:77-128), mutable overlap-add accumulators (upmix.cpp:134-166),
and a readiness check that gates each band until enough input is buffered
(upmix.cpp:232-237).  Here the whole engine is a pure function

    step : (StreamState, in_block[2, hw]) -> (StreamState, out_block)

so a real-time host calls one jitted step per hardware block, an offline
caller runs `lax.scan` over all blocks in a single compiled program, and
the state pytree is trivially checkpointable (SURVEY.md §5).

Structural facts exploited (all verified in SURVEY.md §2.2/§3.2):

  - With the fixed 75% overlap, every band's readiness threshold is exactly
    ``4 * hw_block`` samples, so all bands come online together at the 4th
    hardware block.  One shared input-history buffer of the last
    ``4 * hw_block`` samples therefore serves every band: at processing
    time for block t, band pass p reads history[p*hop : p*hop + block].
  - Bands sharing a block size share their forward FFTs, and since the
    iSTFT/OLA is linear, their masked spectra are summed **in the spectral
    domain** — each bucket needs 2 forward + 3 inverse FFTs per pass batch
    regardless of band count (vs 2+3 per band per pass in the reference).
  - The not-ready branch emits silence without touching OLA state, exactly
    the reference's degraded mode (upmix.cpp:485-491).

Output modes: ``"stereo_sum"`` reproduces the Bela mix
``out = side + 0.5*center`` (upmix.cpp:295-303); ``"lcr"`` emits the three
discrete channels for parity with the offline path.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from upmix.backend import engines
from upmix.config import UpmixConfig, bucket_bands
from upmix.ops.framing import frame_signal
from upmix.ops.gains import band_gain_curve
from upmix.ops.mask import center_mask
from upmix.ops.windows import design_wola_synthesis_window, make_window

# Readiness latency at the reference's fixed 75% overlap (K = block/hop
# = 4; bela/upmix.cpp:232-237 [verified]).  Other overlaps generalize to
# K blocks — see stream_warmup_blocks.
WARMUP_BLOCKS = 4


@dataclass(frozen=True)
class _StreamBucketPlan:
    block_size: int
    hop_size: int
    passes: int  # hw_block // hop
    analysis_window: np.ndarray  # [block]
    synthesis_window: np.ndarray  # [block]
    gains: np.ndarray  # [n_bands_in_bucket, n_bins]
    direct: object = None  # (DirectPlan, lo, hi) matmul-DFT fast path, or None


def stream_warmup_blocks(config: UpmixConfig) -> int:
    """Uniform readiness latency in hardware blocks: K = block/hop.

    Every band's readiness threshold is block*passes = K*hw samples, so
    all bands come online together at the K-th block — but ONLY when K is
    the same for every band (a single overlap value; K=4 at the
    reference's fixed 75%).  Mixed K would break the shared-history
    design, so it is rejected.
    """
    ks = set()
    for b in config.bands:
        if b.block_size % b.hop_size:
            raise ValueError(
                f"streaming requires hop | block (band block {b.block_size}, "
                f"hop {b.hop_size})"
            )
        ks.add(b.block_size // b.hop_size)
    if len(ks) != 1:
        raise ValueError(
            f"streaming requires a uniform block/hop ratio across bands, got {sorted(ks)}"
        )
    return ks.pop()


def _plan_stream_buckets(config: UpmixConfig, hw_block_size: int):
    warmup = stream_warmup_blocks(config)
    plans = []
    for block_size, bands in bucket_bands(config.bands).items():
        hop = bands[0].hop_size
        if hw_block_size % hop != 0:
            raise ValueError(
                f"hw block size {hw_block_size} must be a multiple of every "
                f"band hop (violated by block {block_size}, hop {hop})"
            )
        # Reads must stay inside the K*hw shared history: the last pass
        # reads [hw - hop, hw - hop + block) (the C++ engine's cap is
        # block <= hw*4 at 75% — bela/upmix.cpp:498-506).
        if hw_block_size - hop + block_size > warmup * hw_block_size:
            raise ValueError(
                f"band block size {block_size} exceeds the shared-history "
                f"window ({warmup}x hw_block = {warmup * hw_block_size}); "
                f"build the config with UpmixConfig.streaming "
                f"(max_block_size = hw_block*4)"
            )
        aw = make_window(config.window, block_size)
        if config.synthesis == "wola":
            sw = design_wola_synthesis_window(aw, config.overlap)
        elif config.synthesis == "analysis":
            # C++ parity: synthesis window is the plain analysis window
            # (bela/upmix.cpp:200-201).
            sw = aw
        else:
            raise ValueError(f"unknown synthesis mode {config.synthesis!r}")
        gains = np.stack([band_gain_curve(b, dtype=np.float32) for b in bands])
        # Matmul-DFT path (upmix.backend decides per backend): the
        # same direct banded transform as the offline kernels, windows
        # folded into the weight slices; falls back to jnp.fft when the
        # support is too wide to bake (same bound as offline).
        direct = None
        if engines().stream_matmul_dft:
            from upmix.ops.dftmm import make_direct_plan

            nz = np.nonzero(gains.max(axis=0))[0]
            if len(nz):
                lo, hi = int(nz[0]), int(nz[-1])
                if block_size * 2 * (hi - lo + 1) * 4 <= (8 << 20):
                    direct = (make_direct_plan(block_size, lo, hi, aw, sw), lo, hi)
        plans.append(
            _StreamBucketPlan(
                block_size=block_size,
                hop_size=hop,
                passes=hw_block_size // hop,
                analysis_window=aw,
                synthesis_window=sw,
                gains=gains,
                direct=direct,
            )
        )
    return plans


def init_stream_state(config: UpmixConfig, hw_block_size: int):
    """Fresh engine state: {history [2, 4*hw], t (blocks seen), ola{block: [3, block]}}.

    A plain dict-of-arrays pytree — works under jit/scan, serializes with
    any checkpointing library, and is the explicit analog of the
    reference's ring-buffer + accumulator mutable state
    (upmix.cpp:121-127, 164).
    """
    plans = _plan_stream_buckets(config, hw_block_size)
    warmup = stream_warmup_blocks(config)
    return {
        "history": jnp.zeros((2, warmup * hw_block_size), dtype=jnp.float32),
        "t": jnp.zeros((), dtype=jnp.int32),
        # String keys: checkpoint formats (orbax) stringify dict keys on
        # restore, so use strings from the start.
        "ola": {
            str(plan.block_size): jnp.zeros((3, plan.block_size), dtype=jnp.float32)
            for plan in plans
        },
    }


def _bucket_pass_block(plan: _StreamBucketPlan, history: jnp.ndarray, ola: jnp.ndarray):
    """Run one hardware block's worth of passes for a bucket.

    history: [2, 4*hw] (the last 4 hw blocks).  ola: [3, block].
    Returns (out [3, hw], new_ola [3, block]).
    """
    B, H, P = plan.block_size, plan.hop_size, plan.passes
    # Pass p reads history[p*H : p*H + B]; trailing length (P-1)*H + B.
    needed = (P - 1) * H + B
    frames = frame_signal(history[:, :needed], B, H, P)  # [2, P, B]
    if plan.direct is not None:
        from upmix.ops.dftmm import irdft_direct, rdft_direct

        dplan, lo, hi = plan.direct
        sre, sim = rdft_direct(frames, dplan)  # windows folded; [2, P, kept]
        g = jnp.asarray(plan.gains[:, lo : hi + 1])[None, :, None, :]
        spec = jax.lax.complex(sre[:, None] * g, sim[:, None] * g)
        spec_c, spec_ls, spec_rs = center_mask(spec[0], spec[1])
        summed = jnp.stack(
            [spec_c.sum(axis=0), spec_ls.sum(axis=0), spec_rs.sum(axis=0)]
        )  # [3, P, kept]
        rec = irdft_direct(jnp.real(summed), jnp.imag(summed), dplan)  # sw folded
    else:
        framesw = frames * jnp.asarray(plan.analysis_window)
        spec = jnp.fft.rfft(framesw)  # [2, P, n_bins]
        gains = jnp.asarray(plan.gains)[:, None, :]  # [nb, 1, n_bins]
        spec_l = spec[0][None] * gains
        spec_r = spec[1][None] * gains
        spec_c, spec_ls, spec_rs = center_mask(spec_l, spec_r)
        summed = jnp.stack(
            [spec_c.sum(axis=0), spec_ls.sum(axis=0), spec_rs.sum(axis=0)]
        )  # [3, P, n_bins]
        rec = jnp.fft.irfft(summed, n=B) * jnp.asarray(plan.synthesis_window)

    # OLA over the passes as a STATIC fold (same math as the reference's
    # sequential accumulator, upmix.cpp:145-162 / ce.py:391-407, but with
    # the P dependent scan steps replaced by a tree of shifted adds —
    # round 3: the scan's 1+2+8+32 sequential tiny steps per block were
    # the serving pool's bottleneck).  Pass p lands at offset p*H in a
    # length (P-1)*H + B buffer; the carried accumulator adds at 0; the
    # first P*H samples emit and the remainder (zero-extended by H) is
    # the new accumulator.
    L = (P - 1) * H + B
    K = B // H
    if P % K == 0 and P > 1:
        # Group trick: passes p ≡ g (mod K) are non-overlapping and
        # contiguous -> K shifted adds of flat [3, (P//K)*B] groups.
        M = P // K
        acc = None
        for g in range(K):
            flat = rec[:, g::K].reshape(3, M * B)
            part = jnp.pad(flat, ((0, 0), (g * H, L - g * H - M * B)))
            acc = part if acc is None else acc + part
    else:
        acc = None
        for p in range(P):
            part = jnp.pad(rec[:, p], ((0, 0), (p * H, L - p * H - B)))
            acc = part if acc is None else acc + part
    acc = jnp.concatenate([acc[:, :B] + ola, acc[:, B:]], axis=1)
    out = acc[:, : P * H]  # [3, hw]
    # acc tail has length L - P*H = B - H; extend by H zeros -> [3, B].
    new_ola = jnp.concatenate(
        [acc[:, P * H :], jnp.zeros((3, H), jnp.float32)], axis=1
    )
    return out, new_ola


def build_stream_step(config: UpmixConfig, hw_block_size: int):
    """Build the pure streaming step: (state, in_block[2, hw]) -> (state, out).

    out is [3, hw] (C, Ls, Rs) — mix with `mix_stereo_sum` for the Bela
    2-channel output.  Jit-compatible; scan-compatible.
    """
    plans = _plan_stream_buckets(config, hw_block_size)
    warmup = stream_warmup_blocks(config)
    hw = hw_block_size

    def step(state, x_block):
        x_block = x_block.astype(jnp.float32)
        history = jnp.concatenate([state["history"][:, hw:], x_block], axis=1)
        t = state["t"] + 1

        def go(olas):
            out = None
            new_olas = {}
            for plan in plans:
                key = str(plan.block_size)
                o, new_olas[key] = _bucket_pass_block(plan, history, olas[key])
                out = o if out is None else out + o
            return out, new_olas

        def silent(olas):
            # Not-ready bands contribute silence and leave OLA state
            # untouched (upmix.cpp:485-491).
            return jnp.zeros((3, hw), jnp.float32), olas

        out, new_olas = jax.lax.cond(t >= warmup, go, silent, state["ola"])
        return {"history": history, "t": t, "ola": new_olas}, out

    return step


def mix_stereo_sum(lcr: jnp.ndarray):
    """Bela output mix: (L, R) = (Ls + 0.5*C, Rs + 0.5*C)
    (upmix.cpp:295-303; same layout as the offline stereo_sum export,
    main.py:143-157).  lcr: [3, ...] ordered (C, Ls, Rs)."""
    c, ls, rs = lcr[0], lcr[1], lcr[2]
    return ls + 0.5 * c, rs + 0.5 * c


class StreamingUpmixer:
    """Stateful host-side wrapper around the pure streaming step.

    `push_block` is the real-time call (one jitted step per hardware
    block); `process_signal` scans all blocks inside one compiled program
    for offline use and parity testing.

    The state buffers are DONATED to each step by default (in-place
    update, no state copy per block).  Checkpoint with ``snapshot()`` BEFORE the next
    push — a raw reference to ``engine.state`` is invalidated by the
    next call.  ``donate=False`` opts out (state survives a failed
    push; buffers may be re-pushed).
    """

    def __init__(
        self, config: UpmixConfig, hw_block_size: int, donate: bool = True
    ):
        self.config = config
        self.hw_block_size = int(hw_block_size)
        self.warmup_blocks = stream_warmup_blocks(config)
        self.donate = bool(donate)
        step = build_stream_step(config, self.hw_block_size)
        self._step = (
            jax.jit(step, donate_argnums=(0,)) if donate else jax.jit(step)
        )
        self.state = init_stream_state(config, self.hw_block_size)
        self._scan_cache = {}

    def reset(self):
        self.state = init_stream_state(self.config, self.hw_block_size)

    def snapshot(self):
        """Host-side copy of the current state, safe to keep across pushes
        (with donate=True the live state buffers are invalidated by the
        next push_block — checkpoint from this, not from .state)."""
        import numpy as _np

        return jax.tree.map(_np.asarray, self.state)

    def push_block(self, in_l, in_r):
        """Feed one hardware block; returns (C, Ls, Rs) each [hw]."""
        x = jnp.stack(
            [jnp.asarray(in_l, jnp.float32), jnp.asarray(in_r, jnp.float32)]
        )
        if x.shape != (2, self.hw_block_size):
            # Reject bad blocks BEFORE dispatch: the state is still valid
            # (nothing was donated), so the stream keeps its history.
            raise ValueError(
                f"push_block expects two length-{self.hw_block_size} "
                f"channels; got stacked input shape {tuple(x.shape)}"
            )
        try:
            self.state, out = self._step(self.state, x)
        except Exception:
            if self.donate:
                # The step donated the state buffers; after a failure
                # mid-call they may be unusable, so restart the stream
                # rather than leave the engine permanently broken.
                self.reset()
            raise
        return out[0], out[1], out[2]

    def _scan_fn(self, n_blocks: int):
        fn = self._scan_cache.get(n_blocks)
        if fn is None:
            step = build_stream_step(self.config, self.hw_block_size)

            @jax.jit
            def scan_all(state, blocks):  # blocks [n_blocks, 2, hw]
                return jax.lax.scan(step, state, blocks)

            fn = scan_all
            self._scan_cache[n_blocks] = fn
        return fn

    def process_signal(self, L, R, mix: str = "lcr"):
        """Whole-signal streaming processing (truncates to whole hw blocks,
        like a real-time device — cf. oracle_stream_multiband).

        mix="lcr" returns (C, Ls, Rs); mix="stereo_sum" returns (outL, outR)
        with the Bela 2-channel mix.
        """
        hw = self.hw_block_size
        n = (len(L) // hw) * hw
        n_blocks = n // hw
        x = jnp.stack(
            [jnp.asarray(L[:n], jnp.float32), jnp.asarray(R[:n], jnp.float32)]
        )  # [2, n]
        blocks = jnp.moveaxis(x.reshape(2, n_blocks, hw), 1, 0)  # [nb, 2, hw]
        state = init_stream_state(self.config, hw)
        _, outs = self._scan_fn(n_blocks)(state, blocks)  # [nb, 3, hw]
        lcr = jnp.moveaxis(outs, 0, 1).reshape(3, n)
        if mix == "stereo_sum":
            return mix_stereo_sum(lcr)
        if mix == "lcr":
            return lcr[0], lcr[1], lcr[2]
        raise ValueError(f"unknown mix {mix!r}; one of ('lcr', 'stereo_sum')")


def _check_stream_indices(indices, n_streams: int):
    """Validated int list — out-of-range indices would silently scatter
    to the wrong live session."""
    indices = [int(i) for i in indices]
    bad = [i for i in indices if not 0 <= i < n_streams]
    if bad:
        raise ValueError(
            f"stream indices {bad} out of range [0, {n_streams})"
        )
    return indices


def make_stream_pool(
    config: UpmixConfig,
    hw_block_size: int,
    n_streams: int,
    engine: str = "auto",
    mesh=None,
):
    """Build the serving pool for this config: a BatchStreamingUpmixer.

    ``engine`` is "auto" or "xla"; both name the vmapped XLA engine, the
    one pool engine there is.  A `mesh` with a 'data' axis shards the
    pool's streams across devices.
    """
    if engine not in ("auto", "xla"):
        raise ValueError(f"unknown engine {engine!r}; one of ('auto', 'xla')")
    return BatchStreamingUpmixer(config, hw_block_size, n_streams, mesh=mesh)


class BatchStreamingUpmixer:
    """Many concurrent live streams on one device: the pure stream step
    vmapped over a leading stream axis, so ONE dispatch per hardware
    block serves every session (the multi-stream serving counterpart of
    the single-stream engine; the reference serves exactly one stream,
    bela/upmix.cpp:519).

    All streams share one config and block size (that is what makes the
    batch a single compiled program).  Sessions can start/stop at any
    time: `reset_streams([i, ...])` zeroes those slots (each then replays
    the engine's normal warmup), so a fixed-size pool of slots serves a
    churning population of streams.

    Pass a `mesh` with a 'data' axis to shard the stream pool across
    chips — streams are independent, so the scale-out is communication-
    free (each chip serves n_streams/mesh.shape['data'] sessions; XLA
    inserts no collectives).  n_streams must divide evenly.

    State is donated per step by default, like StreamingUpmixer —
    `snapshot()` before the next push to checkpoint; ``donate=False``
    opts out.
    """

    def __init__(
        self,
        config: UpmixConfig,
        hw_block_size: int,
        n_streams: int,
        mesh=None,
        donate: bool = True,
    ):
        if n_streams < 1:
            raise ValueError(f"n_streams must be >= 1, got {n_streams}")
        self.config = config
        self.hw_block_size = int(hw_block_size)
        self.n_streams = int(n_streams)
        self.mesh = mesh
        self.warmup_blocks = stream_warmup_blocks(config)
        step = build_stream_step(config, self.hw_block_size)
        self._shardings = None
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec

            d = mesh.shape.get("data", 1)
            if self.n_streams % d:
                raise ValueError(
                    f"n_streams {self.n_streams} must divide evenly across "
                    f"the mesh 'data' axis ({d})"
                )
            # Every pytree leaf (state arrays and the in/out blocks) has
            # the stream axis leading; shard exactly that axis.
            def shard_like(a):
                spec = PartitionSpec("data", *([None] * (a.ndim - 1)))
                return NamedSharding(mesh, spec)

            self._shardings = shard_like
        self.donate = bool(donate)
        vstep = jax.vmap(step)
        self._raw_step = vstep  # un-jitted: make_sustained_runner scans it
        self._step = (
            jax.jit(vstep, donate_argnums=(0,)) if donate else jax.jit(vstep)
        )
        self.state = self._fresh_state()

    def make_sustained_runner(self, n_blocks: int, unroll: int = 1):
        """One-dispatch sustained capacity runner.

        Returns ``(run, fresh)``: ``run(state, blocks)`` with ``blocks``
        a device-resident ``[n_blocks, 2, n_streams, hw]`` float32 array
        chains ``n_blocks`` block steps inside ONE compiled program and
        returns ``(final_state, cs)``, where ``cs`` holds one C output
        slab per scan iteration (kept as a scan output so the emit path
        cannot be dead-code-eliminated; fetch one scalar of ``cs[-1]``
        to bound the whole chain).  Timing `run` measures the device's
        sustained cost with no per-block host overhead.  ``unroll``
        steps run per scan iteration (clamped to a divisor of
        ``n_blocks``)."""
        n_blocks = int(n_blocks)
        unroll = max(1, min(int(unroll), n_blocks))
        while n_blocks % unroll:
            unroll -= 1
        step = self._raw_step

        def multi(state, xs):  # xs [unroll, 2, S, hw]
            out = None
            for u in range(unroll):
                state, out = step(state, jnp.swapaxes(xs[u], 0, 1))
            return state, out[:, 0]

        @jax.jit
        def run(state, blocks):
            g = blocks.reshape(
                n_blocks // unroll, unroll, *blocks.shape[1:]
            )
            return jax.lax.scan(multi, state, g)

        return run, self._fresh_state

    def _fresh_state(self):
        one = init_stream_state(self.config, self.hw_block_size)
        # All-zero init: broadcasting the fresh single-stream state is
        # exact (it is zeros plus a zero counter).
        state = jax.tree.map(
            lambda a: jnp.zeros((self.n_streams,) + a.shape, a.dtype), one
        )
        if self._shardings is not None:
            state = jax.tree.map(
                lambda a: jax.device_put(a, self._shardings(a)), state
            )
        return state

    def reset(self):
        self.state = self._fresh_state()

    def reset_streams(self, indices):
        """Zero the given stream slots (ended sessions; slots re-warm)."""
        idx = jnp.asarray(
            _check_stream_indices(indices, self.n_streams), jnp.int32
        )
        self.state = jax.tree.map(
            lambda a: a.at[idx].set(jnp.zeros_like(a[0])), self.state
        )

    def snapshot(self):
        """Host-side copy safe to keep across pushes (required when the
        pool was built with donate=True)."""
        import numpy as _np

        return jax.tree.map(_np.asarray, self.state)

    def restore(self, snap):
        """Load a snapshot() (host or device arrays) as the live state."""
        state = jax.tree.map(jnp.asarray, snap)
        if self._shardings is not None:
            state = jax.tree.map(
                lambda a: jax.device_put(a, self._shardings(a)), state
            )
        self.state = state

    def extract_streams(self, indices, snap=None):
        """Per-stream rows (leaves get leading dim len(indices)) of
        `snap` (a snapshot()) or of the live state — the unit
        load_streams accepts."""
        idx = np.asarray(_check_stream_indices(indices, self.n_streams))
        src = self.snapshot() if snap is None else snap
        return jax.tree.map(lambda a: np.asarray(a)[idx], src)

    def load_streams(self, indices, rows):
        """Inject per-stream state rows (from extract_streams — e.g. a
        checkpointed session resuming into a live pool) without touching
        other streams' state.  The inverse of reset_streams' zeroing."""
        idx = jnp.asarray(
            _check_stream_indices(indices, self.n_streams), jnp.int32
        )
        self.state = jax.tree.map(
            lambda a, r: a.at[idx].set(jnp.asarray(r, a.dtype)),
            self.state,
            rows,
        )

    def push_blocks(self, in_l, in_r):
        """One hardware block for EVERY stream: in_l/in_r [n_streams, hw]
        -> (C, Ls, Rs), each [n_streams, hw]."""
        x = jnp.stack(
            [jnp.asarray(in_l, jnp.float32), jnp.asarray(in_r, jnp.float32)],
            axis=1,
        )  # [n_streams, 2, hw]
        if x.shape != (self.n_streams, 2, self.hw_block_size):
            raise ValueError(
                f"push_blocks expects two [{self.n_streams}, "
                f"{self.hw_block_size}] channel arrays; got stacked shape "
                f"{tuple(x.shape)}"
            )
        if self._shardings is not None:
            x = jax.device_put(x, self._shardings(x))
        try:
            self.state, out = self._step(self.state, x)
        except Exception:
            if self.donate:
                self.reset()
            raise
        return out[:, 0], out[:, 1], out[:, 2]
