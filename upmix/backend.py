"""Which engines each JAX backend runs.

This is the one place the package inspects the backend.  Every engine
choice that depends on the device reads `engines()`, and a backend that
is not in the table is an error rather than a silent default.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Engines:
    """Engine choice for one backend.

    offline_kernel: what ``kernel="auto"`` resolves to in the offline
      pipeline — "mm" (matmul transforms; long inputs run as the chunked
      scan, whose memory is bounded by the chunk) or "xla" (jnp.fft over
      the whole file).
    stream_matmul_dft: the streaming step computes each band-limited
      bucket as one matmul against a baked DFT slice (True) or through
      jnp.fft (False).
    """

    offline_kernel: str
    stream_matmul_dft: bool


# CPU: XLA's FFT is cheap there and the matmul transforms' extra FLOPs
# are not.  GPU: the matmul transforms run on the tensor cores, and "mm"
# is the only kernel with the bounded-memory chunked scan.
ENGINES = {
    "cpu": Engines(offline_kernel="xla", stream_matmul_dft=False),
    "gpu": Engines(offline_kernel="mm", stream_matmul_dft=True),
}


def engines(backend: str | None = None) -> Engines:
    """Engines for `backend` (default: JAX's default backend)."""
    if backend is None:
        import jax

        backend = jax.default_backend()
    try:
        return ENGINES[backend]
    except KeyError:
        raise ValueError(
            f"no engine table for JAX backend {backend!r}; known backends: "
            f"{', '.join(sorted(ENGINES))}"
        ) from None
