"""upmix — multi-band stereo→LCR upmix framework in JAX.

A JAX/XLA implementation with the capabilities of the willleskowitz/upmix
reference (stereo→LCR center extraction via multi-band WOLA STFT
processing; see SURVEY.md).  The compute path is accelerator-first:
frames-as-tensors, batched transforms, fused elementwise masking vmapped
over bands, overlap-add as a static pad-sum fold, scan-based streaming,
and mesh-sharded batch/long-input execution.

Public surface:
  - config: UpmixConfig / BandSpec / chain_bands — band plumbing and sizing
  - models.offline: Upmixer — whole-file offline pipeline (the flagship path)
  - models.streaming: StreamingUpmixer — block-based real-time engine;
    BatchStreamingUpmixer / make_stream_pool — multi-stream serving pool
    (the stream step vmapped over sessions)
  - io.wav: read_wav / write_wav — pure-NumPy WAV I/O
  - oracle: faithful NumPy re-derivation of the reference semantics (test oracle)
  - aot: jax.export deployment artifacts — freeze a config-specialized
    offline pipeline or streaming step to a version-stable file a serving
    host loads without re-tracing
  - serve_stream: multi-client TCP stream server (StreamServer,
    stream_client, fetch_metrics) with checkpoint/resume + metrics
  - metrics: serving observability (latency histograms, Prometheus text)
  - tune: on-device serving-pool autotuner (tune_pool)
"""

from upmix.config import (
    EPS,
    BandSpec,
    UpmixConfig,
    chain_bands,
    compute_block_size_for_low_freq,
    freq_to_bin,
    hp_freq_to_crossover_width,
    next_power_of_2,
    streaming_stft_table,
)

__version__ = "0.2.0"

__all__ = [
    "EPS",
    "BandSpec",
    "UpmixConfig",
    "chain_bands",
    "compute_block_size_for_low_freq",
    "freq_to_bin",
    "hp_freq_to_crossover_width",
    "next_power_of_2",
    "streaming_stft_table",
    "__version__",
]


def __getattr__(name):
    # Lazy heavyweight surfaces (importing them pulls in jax program
    # construction; keep bare `import upmix` light).
    if name in ("Upmixer", "upmix_offline", "StreamingUpmixer",
                "BatchStreamingUpmixer", "make_stream_pool"):
        import upmix.models as _m

        return getattr(_m, name)
    if name == "BatchUpmixer":
        from upmix.models.batch import BatchUpmixer

        return BatchUpmixer
    if name == "ShardedUpmixer":
        from upmix.parallel import ShardedUpmixer

        return ShardedUpmixer
    if name in ("run_offline", "run_streaming", "run_pipe", "run_jobs"):
        import upmix.app as _a

        return getattr(_a, name)
    raise AttributeError(f"module 'upmix' has no attribute {name!r}")
