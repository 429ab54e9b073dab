"""Backend capability table (upmix/backend.py), the matmul precision
each backend lowers with, and chip_smoke.py's refusal to run without a
GPU.  The ``chip``-marked test at the end runs only on a GPU host."""

import os
import re
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

from upmix import backend
from upmix.config import UpmixConfig

from helpers import cpu_child_env, make_stereo, snr_db

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize(
    "name,kernel,matmul_dft",
    [("cpu", "xla", False), ("gpu", "mm", True)],
)
def test_engines_per_backend(name, kernel, matmul_dft):
    eng = backend.engines(name)
    assert eng.offline_kernel == kernel
    assert eng.stream_matmul_dft is matmul_dft


@pytest.mark.parametrize("name", ["neuron", "rocm", "METAL", ""])
def test_engines_unknown_backend_raises(name):
    with pytest.raises(ValueError, match="no engine table"):
        backend.engines(name)


def test_engines_default_is_current_backend():
    assert backend.engines() is backend.ENGINES[jax.default_backend()]


@pytest.mark.parametrize("name,want", [("cpu", "xla"), ("gpu", "mm")])
def test_resolve_kernel_follows_backend(monkeypatch, name, want):
    from upmix.models.offline import resolve_kernel

    monkeypatch.setattr(jax, "default_backend", lambda: name)
    assert resolve_kernel("auto") == want
    assert resolve_kernel("xla") == "xla" and resolve_kernel("mm") == "mm"


def test_resolve_kernel_unknown_backend_raises(monkeypatch):
    from upmix.models.offline import resolve_kernel

    monkeypatch.setattr(jax, "default_backend", lambda: "neuron")
    with pytest.raises(ValueError, match="no engine table"):
        resolve_kernel("auto")


@pytest.mark.parametrize("name", ["cpu", "gpu"])
def test_stream_plan_dft_follows_backend(monkeypatch, name):
    # The streaming step bakes the matmul DFT exactly where the table
    # says so (GPU), and uses jnp.fft elsewhere (CPU).
    from upmix.models.streaming import _plan_stream_buckets

    monkeypatch.setattr(jax, "default_backend", lambda: name)
    cfg = UpmixConfig.streaming([0.0, 400.0, 1600.0], sr=8000.0,
                                hw_block_size=256)
    plans = _plan_stream_buckets(cfg, 256)
    baked = [p.direct is not None for p in plans]
    assert baked == [backend.engines(name).stream_matmul_dft] * len(plans)


def _dot_precisions(exported):
    return set(re.findall(r"precision = \[(\w+), (\w+)\]",
                          exported.mlir_module()))


@pytest.mark.parametrize("platform", ["cpu", "cuda"])
def test_matmul_precision_per_backend(platform):
    # Every transform matmul of the 'mm' pipeline and of the streaming
    # step lowers at ops.fftmm.PRECISION, for the CPU and for the GPU.
    from jax import export

    from upmix.models.offline import build_offline_fn
    from upmix.models.streaming import build_stream_step, init_stream_state
    from upmix.ops import fftmm

    want = str(fftmm.PRECISION).rsplit(".", 1)[-1]
    assert want == "HIGHEST"
    cfg = UpmixConfig.make([0.0, 400.0, 1600.0], sr=8000.0, max_block_size=512)
    spec = jax.ShapeDtypeStruct((4096,), np.float32)
    off = export.export(jax.jit(build_offline_fn(cfg, 4096, "mm")),
                        platforms=(platform,))(spec, spec)
    assert _dot_precisions(off) == {(want, want)}

    scfg = UpmixConfig.streaming([0.0, 400.0, 1600.0], sr=8000.0,
                                 hw_block_size=256)
    state = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                         init_stream_state(scfg, 256))
    block = jax.ShapeDtypeStruct((2, 256), np.float32)
    backend_name = "gpu" if platform == "cuda" else platform
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "default_backend", lambda: backend_name)
        step = jax.jit(build_stream_step(scfg, 256))
    st = export.export(step, platforms=(platform,))(state, block)
    dots = _dot_precisions(st)
    if backend.engines(backend_name).stream_matmul_dft:
        assert dots == {(want, want)}
    else:
        assert dots == set()  # jnp.fft path: no transform matmuls


def _smoke_module():
    sys.path.insert(0, ROOT)
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("noise,passes", [(1e-5, True), (1e-2, False)])
def test_chip_smoke_probe_gate(noise, passes):
    # The smoke test's numerics gate: head/middle/tail probes of every
    # channel against the reference at 60 dB.
    cs = _smoke_module()
    rng = np.random.default_rng(0)
    ref = [rng.standard_normal(40000) for _ in range(3)]
    got = [r + noise * rng.standard_normal(r.shape) for r in ref]
    if passes:
        assert cs.check_probes("t", ref, got) > 60.0
    else:
        with pytest.raises(AssertionError, match="dB <"):
            cs.check_probes("t", ref, got)


def test_chip_smoke_aligned_stream_oracle_matches_engine():
    # The serving phase's reference — the streaming oracle, warmup-
    # aligned — is what a stream_client receives from the engine.
    from upmix.models.streaming import StreamingUpmixer, stream_warmup_blocks

    cs = _smoke_module()
    hw = 256
    cfg = UpmixConfig.streaming([0.0, 400.0, 1600.0], sr=8000.0,
                                hw_block_size=hw)
    L, R = cs.stereo(10 * hw, 8000.0, seed=3)
    ref_l, ref_r = cs.aligned_stream_oracle(L, R, cfg, hw)
    skip = (stream_warmup_blocks(cfg) - 1) * hw
    pad = np.zeros(skip + hw, np.float32)
    got_l, got_r = StreamingUpmixer(cfg, hw).process_signal(
        np.concatenate([L, pad]), np.concatenate([R, pad]), mix="stereo_sum"
    )
    n = len(L)
    assert len(ref_l) == n
    assert snr_db(ref_l, np.asarray(got_l)[skip:skip + n]) > 60.0
    assert snr_db(ref_r, np.asarray(got_r)[skip:skip + n]) > 60.0


def test_measure_gpu_refuses_cpu():
    proc = subprocess.run(
        [sys.executable, os.path.join("scripts", "measure_gpu.py")],
        capture_output=True, text=True, cwd=ROOT, env=cpu_child_env(),
        timeout=300,
    )
    assert proc.returncode != 0 and proc.stdout == ""
    assert "needs a GPU" in proc.stderr


def _run_smoke(cwd, env):
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], capture_output=True, text=True,
        cwd=cwd, env=env, timeout=300,
    )


def test_chip_smoke_refuses_cpu():
    proc = _run_smoke(ROOT, cpu_child_env())
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "needs a GPU" in proc.stderr


def test_chip_smoke_fails_without_the_package(tmp_path):
    # Alone in a directory (no upmix beside it) the script must fail
    # and print no result, whatever the device.
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = cpu_child_env()
    env.pop("PYTHONPATH", None)
    proc = _run_smoke(str(tmp_path), env)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    # Past the device check, every phase imports the package it drives.
    probe = subprocess.run(
        [sys.executable, "-c",
         "import chip_smoke; chip_smoke.offline_config()"],
        capture_output=True, text=True, cwd=str(tmp_path), env=env,
        timeout=300,
    )
    assert probe.returncode != 0
    assert "No module named 'upmix'" in probe.stderr


@pytest.mark.chip
def test_gpu_offline_mm_matches_oracle(gpu_device):
    # On the card: the 'mm' chunked scan over several segments holds the
    # 60 dB bar against the float64 oracle.
    from upmix.models import Upmixer
    from upmix.oracle import oracle_multiband

    cfg = UpmixConfig.make([0.0, 400.0, 1600.0], sr=8000.0, max_block_size=512)
    L, R = make_stereo(9000, cfg.sr, seed=1)
    L, R = L.astype(np.float32), R.astype(np.float32)
    got = Upmixer(cfg, chunk=2048).process_np(L, R)
    for r, g in zip(oracle_multiband(L, R, cfg), got):
        assert snr_db(r, g) > 60.0
