"""Direct banded DFT as a single matmul — the fast path for band-limited
buckets.

When a bucket keeps only K spectral bins (K << N/2, true for every bucket
of a multiband config: band passband + crossover fades), the cheapest
transform is not an FFT at all: it is ONE real matmul against a
precomputed [N, 2K] DFT slice with the analysis window folded in,

    S_re | S_im = (x * aw) @ [cos | -sin]  =  x @ (aw ⊙ [cos | -sin])

and the inverse is one matmul against [2K, N] with the synthesis window,
the 2/N normalization, and the DC/Nyquist half-weights folded in.  Per
bucket: framing (zero-copy reshapes) + 1 matmul + tiny elementwise mask +
1 matmul + fold.  FLOPs scale with K instead of N log N or sqrt(N); HBM
traffic is two passes over the frames plus the weight slices.

Crossover rule (models/offline.py): direct wins while K <= N1+N2 of the
2-stage factorization (ops/fftmm.py), which also bounds the weight-matrix
memory; wideband buckets fall back to the 2-stage kernel.

Precision: ops.fftmm.PRECISION, shared with the 2-stage kernel.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import jax.numpy as jnp
import numpy as np

from upmix.ops import fftmm as _fftmm


@dataclass(frozen=True)
class DirectPlan:
    n: int
    lo_bin: int
    hi_bin: int  # inclusive; K = hi - lo + 1 kept bins
    w_fwd: np.ndarray  # [N, 2K]  (re columns then im columns)
    w_inv: np.ndarray  # [2K, N]

    @property
    def n_bins(self) -> int:
        return self.hi_bin - self.lo_bin + 1


@lru_cache(maxsize=None)
def _make_direct_plan_cached(n, lo_bin, hi_bin, aw_bytes, sw_bytes):
    aw = np.frombuffer(aw_bytes, dtype=np.float32)
    sw = np.frombuffer(sw_bytes, dtype=np.float32)
    k = np.arange(lo_bin, hi_bin + 1)[None, :]  # [1, K]
    t = np.arange(n)[:, None]  # [N, 1]
    ang = 2.0 * np.pi * (t * k) / n
    cos = np.cos(ang)
    sin = np.sin(ang)
    w_fwd = np.concatenate(
        [aw[:, None] * cos, aw[:, None] * (-sin)], axis=1
    ).astype(np.float32)  # [N, 2K]

    # Inverse weights: y[t] = sum_k w_k (S_re cos - S_im (-sin) ...):
    # y = S_re @ (w 2/N cos * sw) + S_im @ (-w 2/N sin * sw)
    wk = np.full(k.shape[1], 2.0 / n)
    wk[k[0] == 0] = 1.0 / n
    wk[k[0] == n // 2] = 1.0 / n
    inv_re = (wk[:, None] * cos.T) * sw[None, :]
    inv_im = (wk[:, None] * (-sin.T)) * sw[None, :]
    w_inv = np.concatenate([inv_re, inv_im], axis=0).astype(np.float32)  # [2K, N]
    return DirectPlan(n=n, lo_bin=int(lo_bin), hi_bin=int(hi_bin), w_fwd=w_fwd, w_inv=w_inv)


def make_direct_plan(
    n: int, lo_bin: int, hi_bin: int, analysis_window: np.ndarray, synthesis_window: np.ndarray
) -> DirectPlan:
    lo_bin = max(0, int(lo_bin))
    hi_bin = min(n // 2, int(hi_bin))
    aw = np.ascontiguousarray(analysis_window, dtype=np.float32)
    sw = np.ascontiguousarray(synthesis_window, dtype=np.float32)
    return _make_direct_plan_cached(int(n), lo_bin, hi_bin, aw.tobytes(), sw.tobytes())


def rdft_direct(x: jnp.ndarray, plan: DirectPlan):
    """Windowed forward DFT on kept bins: x [..., N] f32 (un-windowed
    frames) -> (re, im) [..., K] f32."""
    s = jnp.einsum(
        "...i,ij->...j", x, jnp.asarray(plan.w_fwd), precision=_fftmm.PRECISION
    )
    k = plan.n_bins
    return s[..., :k], s[..., k:]


def irdft_direct(sre: jnp.ndarray, sim: jnp.ndarray, plan: DirectPlan) -> jnp.ndarray:
    """Inverse from kept bins to synthesis-windowed time frames:
    (re, im) [..., K] -> [..., N] f32."""
    s = jnp.concatenate([sre, sim], axis=-1)
    return jnp.einsum(
        "...j,ji->...i", s, jnp.asarray(plan.w_inv), precision=_fftmm.PRECISION
    )
