"""AOT deployment artifacts: freeze a config-specialized program to disk.

The reference has no deployment story — every run re-derives everything
from source (python-prototype/main.py edits constants in place;
bela/upmix.cpp recompiles per config).  A production serving host wants
the opposite: a version-stable artifact, built once, that the server
loads and calls without re-tracing Python.  This module provides that
via `jax.export`:

- `save_offline(path, config, n_samples)` freezes the whole-file offline
  pipeline (models/offline.py::build_offline_fn) for one padded input
  length to a single-file StableHLO artifact.
- `save_stream_step(path, config, hw_block_size)` freezes the pure
  real-time step (models/streaming.py::build_stream_step) — the
  (state, block) -> (state, lcr) function a host calls per hardware
  block.
- `load(path)` restores any kind and wraps it with the same
  pad/trim/state conveniences as the live classes.

What an artifact buys: loading skips Python tracing and pins the program
bytes (StableHLO) against library drift; XLA still compiles the loaded
module once per process, and the persistent compilation cache
(utils/cache.py::enable_compilation_cache) makes THAT a disk hit too —
together a warm restart pays neither tracing nor compilation.  Artifacts
record the lowering platform(s): one exported for ("cuda",) runs on GPU
serving hosts regardless of the builder host's backend.

Format: `UPMIXAOT1\n` magic, one JSON metadata line (format version,
artifact type, the full band-resolved config, shapes, platforms, jax
version), then the `jax.export` serialization bytes verbatim.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Sequence

import numpy as np

from upmix.config import BandSpec, UpmixConfig

_MAGIC = b"UPMIXAOT1\n"
_FORMAT = 1


# ---------------------------------------------------------------------------
# Config <-> JSON
# ---------------------------------------------------------------------------

def config_to_dict(config: UpmixConfig) -> dict:
    """JSON-safe dict carrying the FULL band-resolved config (not the
    make() inputs), so the loaded artifact reconstructs the exact bands
    it was built from even if sizing defaults drift.

    Custom analysis windows (ops.windows.register_window[_vector] /
    --window-file) are process-local registrations, so their
    coefficients ride along under "custom_windows" — without them an
    artifact or server checkpoint built with a custom window could
    never load in a fresh process (BandSpec validates window names)."""
    from upmix.ops import windows as _win

    d = dataclasses.asdict(config)
    payloads = {}
    for b in config.bands:
        if not _win.is_builtin_window(b.window) and b.window not in payloads:
            payloads[b.window] = _win.window_payload(
                b.window,
                [bb.block_size for bb in config.bands if bb.window == b.window],
            )
    if payloads:
        d["custom_windows"] = payloads
    return d


def config_from_dict(d: dict) -> UpmixConfig:
    from upmix.ops import windows as _win

    for name, payload in (d.get("custom_windows") or {}).items():
        _win.restore_window(
            name,
            payload,
            check_sizes=[
                b["block_size"] for b in d["bands"] if b["window"] == name
            ],
        )
    bands = tuple(BandSpec(**b) for b in d["bands"])
    rest = {
        k: v for k, v in d.items() if k not in ("bands", "custom_windows")
    }
    return UpmixConfig(bands=bands, **rest)


# ---------------------------------------------------------------------------
# Export
# ---------------------------------------------------------------------------

def _norm_platforms(platforms: Sequence[str] | None):
    if platforms is None:
        return None
    plats = tuple(str(p).lower() for p in platforms)
    if not plats:
        raise ValueError("platforms must be None or a non-empty sequence")
    return plats


def export_offline(
    config: UpmixConfig,
    n_samples: int,
    kernel: str = "auto",
    platforms: Sequence[str] | None = None,
):
    """Export the fixed-length offline pipeline as a jax.export.Exported.

    `n_samples` is the artifact's input length; the load()ed wrapper
    zero-pads shorter inputs up to it (the same static-shape discipline as
    models/offline.py::Upmixer, whose pad_granularity plays this role for
    the live class).  `kernel` resolves HERE (resolve_kernel consults the
    builder's backend), so cross-building a GPU artifact from a CPU host
    should pass kernel="mm" explicitly.
    """
    import jax
    from jax import export as jax_export

    from upmix.models.offline import build_offline_fn, resolve_kernel

    n = int(n_samples)
    if n < 1:
        raise ValueError("n_samples must be >= 1")
    kern = resolve_kernel(kernel)
    fn = jax.jit(build_offline_fn(config, n, kern))
    spec = jax.ShapeDtypeStruct((n,), np.float32)
    return (
        jax_export.export(fn, platforms=_norm_platforms(platforms))(spec, spec),
        kern,
    )


def export_stream_step(
    config: UpmixConfig,
    hw_block_size: int,
    platforms: Sequence[str] | None = None,
):
    """Export the pure streaming step (state, [2, hw]) -> (state, [3, hw])."""
    import jax
    from jax import export as jax_export

    from upmix.models.streaming import build_stream_step, init_stream_state

    hw = int(hw_block_size)
    step = jax.jit(build_stream_step(config, hw))
    state = init_stream_state(config, hw)
    state_spec = jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(np.shape(x), x.dtype), state
    )
    block_spec = jax.ShapeDtypeStruct((2, hw), np.float32)
    return jax_export.export(step, platforms=_norm_platforms(platforms))(
        state_spec, block_spec
    )


def _write(path: str, meta: dict, payload: bytes) -> dict:
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(json.dumps(meta, sort_keys=True).encode("utf-8"))
        f.write(b"\n")
        f.write(payload)
    return meta


def save_offline(
    path: str,
    config: UpmixConfig,
    n_samples: int,
    kernel: str = "auto",
    platforms: Sequence[str] | None = None,
) -> dict:
    """Build and write an offline-pipeline artifact; returns its metadata."""
    import jax

    exported, kern = export_offline(
        config, n_samples, kernel=kernel, platforms=platforms
    )
    meta = {
        "format": _FORMAT,
        "type": "offline",
        "config": config_to_dict(config),
        "n_samples": int(n_samples),
        "kernel": kern,
        "platforms": list(exported.platforms),
        "jax_version": jax.__version__,
    }
    return _write(path, meta, exported.serialize())


def save_stream_step(
    path: str,
    config: UpmixConfig,
    hw_block_size: int,
    platforms: Sequence[str] | None = None,
) -> dict:
    """Build and write a streaming-step artifact; returns its metadata."""
    import jax

    exported = export_stream_step(config, hw_block_size, platforms=platforms)
    meta = {
        "format": _FORMAT,
        "type": "stream_step",
        "config": config_to_dict(config),
        "hw_block_size": int(hw_block_size),
        "platforms": list(exported.platforms),
        "jax_version": jax.__version__,
    }
    return _write(path, meta, exported.serialize())


# ---------------------------------------------------------------------------
# Load
# ---------------------------------------------------------------------------

class AotOffline:
    """Loaded offline artifact: process()/process_np() like models.Upmixer,
    for inputs up to the artifact's frozen length (zero-padded up, trimmed
    back — identical semantics to Upmixer with pad_granularity=n_samples,
    minus the re-trace)."""

    def __init__(self, meta: dict, exported):
        self.meta = meta
        self.config = config_from_dict(meta["config"])
        self.n_samples = int(meta["n_samples"])
        self.exported = exported

    def process(self, L, R):
        import jax.numpy as jnp

        n = len(L)
        if n < 1:
            raise ValueError("input must contain at least one sample")
        if len(R) != n:
            raise ValueError(f"channel length mismatch: {n} vs {len(R)}")
        if n > self.n_samples:
            raise ValueError(
                f"artifact is frozen at {self.n_samples} samples; got {n} "
                "(build a larger artifact or chunk the input)"
            )
        L = jnp.asarray(L, dtype=jnp.float32)
        R = jnp.asarray(R, dtype=jnp.float32)
        if n != self.n_samples:
            L = jnp.pad(L, (0, self.n_samples - n))
            R = jnp.pad(R, (0, self.n_samples - n))
        c, ls, rs = self.exported.call(L, R)
        return c[:n], ls[:n], rs[:n]

    def process_np(self, L, R):
        c, ls, rs = self.process(L, R)
        return np.asarray(c), np.asarray(ls), np.asarray(rs)


class AotStreamStep:
    """Loaded streaming-step artifact: init_state() + step(state, block),
    plus a stateful push_block convenience mirroring StreamingUpmixer
    (without donation — artifact calls go through Exported.call)."""

    def __init__(self, meta: dict, exported):
        self.meta = meta
        self.config = config_from_dict(meta["config"])
        self.hw_block_size = int(meta["hw_block_size"])
        self.exported = exported
        self.state = None

    def init_state(self):
        from upmix.models.streaming import init_stream_state

        return init_stream_state(self.config, self.hw_block_size)

    def step(self, state, x_block):
        return self.exported.call(state, x_block)

    def push_block(self, in_l, in_r):
        import jax.numpy as jnp

        if self.state is None:
            self.state = self.init_state()
        x = jnp.stack(
            [jnp.asarray(in_l, jnp.float32), jnp.asarray(in_r, jnp.float32)]
        )
        if x.shape != (2, self.hw_block_size):
            raise ValueError(
                f"push_block expects two length-{self.hw_block_size} "
                f"channels; got stacked input shape {tuple(x.shape)}"
            )
        self.state, out = self.step(self.state, x)
        return out[0], out[1], out[2]


def read_meta(path: str) -> dict:
    """Read just the JSON metadata line of an artifact (cheap inspection)."""
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic != _MAGIC:
            raise ValueError(f"{path}: not an upmix AOT artifact")
        header = f.readline()
    meta = json.loads(header.decode("utf-8"))
    if meta.get("format") != _FORMAT:
        raise ValueError(
            f"{path}: unsupported artifact format {meta.get('format')!r}"
        )
    return meta


def load(path: str):
    """Load an artifact written by save_offline / save_stream_step (the
    type is read from the metadata line)."""
    from jax import export as jax_export

    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic != _MAGIC:
            raise ValueError(f"{path}: not an upmix AOT artifact")
        header = f.readline()
        payload = f.read()
    meta = json.loads(header.decode("utf-8"))
    if meta.get("format") != _FORMAT:
        raise ValueError(
            f"{path}: unsupported artifact format {meta.get('format')!r}"
        )
    kinds = {"offline": AotOffline, "stream_step": AotStreamStep}
    if meta.get("type") not in kinds:
        raise ValueError(f"{path}: unknown artifact type {meta.get('type')!r}")
    return kinds[meta["type"]](meta, jax_export.deserialize(payload))
