"""AOT artifact tests: save/load round trips of the exported programs.

The artifact must reproduce the live classes exactly (same program, same
backend) and survive a metadata round trip — this is the deployment
subsystem's correctness contract (upmix/aot.py)."""

import numpy as np
import pytest

from upmix import aot
from upmix.config import UpmixConfig
from upmix.models.offline import Upmixer
from upmix.models.streaming import StreamingUpmixer

from helpers import make_stereo, snr_db

SR = 16000.0


def small_config():
    return UpmixConfig.make([0.0, 400.0, 1600.0], sr=SR, max_block_size=1024)


def test_config_dict_round_trip():
    cfg = small_config()
    d = aot.config_to_dict(cfg)
    # JSON-safe: survives an actual encode/decode.
    import json

    cfg2 = aot.config_from_dict(json.loads(json.dumps(d)))
    assert cfg2 == cfg


def test_offline_artifact_matches_live_upmixer(tmp_path):
    cfg = small_config()
    n = 4096
    path = str(tmp_path / "offline.upmixaot")
    meta = aot.save_offline(path, cfg, n)
    assert meta["type"] == "offline"
    assert meta["n_samples"] == n

    art = aot.load(path)
    assert isinstance(art, aot.AotOffline)
    assert art.config == cfg

    L, R = make_stereo(n, SR, seed=3)
    want = Upmixer(cfg).process_np(L, R)
    got = art.process_np(L, R)
    for w, g in zip(want, got):
        assert g.shape == w.shape
        assert snr_db(w, g) > 120.0  # identical program; numerically exact


def test_offline_artifact_pads_short_inputs(tmp_path):
    cfg = small_config()
    n = 4096
    path = str(tmp_path / "offline.upmixaot")
    aot.save_offline(path, cfg, n)
    art = aot.load(path)

    n_short = 3000
    L, R = make_stereo(n_short, SR, seed=4)
    # The live Upmixer with pad_granularity=n runs the same padded program.
    want = Upmixer(cfg, pad_granularity=n).process_np(L, R)
    got = art.process_np(L, R)
    for w, g in zip(want, got):
        assert g.shape == (n_short,)
        assert snr_db(w, g) > 120.0

    with pytest.raises(ValueError, match="frozen at"):
        art.process_np(np.zeros(n + 1), np.zeros(n + 1))


def test_stream_step_artifact_matches_live_engine(tmp_path):
    hw = 256
    cfg = UpmixConfig.streaming([0.0, 500.0], sr=SR, hw_block_size=hw)
    path = str(tmp_path / "stream.upmixaot")
    meta = aot.save_stream_step(path, cfg, hw)
    assert meta["type"] == "stream_step"

    art = aot.load(path)
    assert isinstance(art, aot.AotStreamStep)
    assert art.hw_block_size == hw

    live = StreamingUpmixer(cfg, hw)
    n_blocks = 12
    L, R = make_stereo(n_blocks * hw, SR, seed=5)
    for i in range(n_blocks):
        sl = slice(i * hw, (i + 1) * hw)
        want = live.push_block(L[sl], R[sl])
        got = art.push_block(L[sl], R[sl])
        for w, g in zip(want, got):
            np.testing.assert_allclose(
                np.asarray(g), np.asarray(w), rtol=0, atol=1e-6
            )

    with pytest.raises(ValueError, match="length-256"):
        art.push_block(np.zeros(hw - 1), np.zeros(hw - 1))


def test_offline_artifact_cross_platform_lowering(tmp_path):
    # A CPU build host can produce the GPU serving artifact: lowering for
    # ("cpu", "cuda") records both platforms, and the CPU half runs here
    # and matches the live 'mm' pipeline.
    cfg = small_config()
    n = 4096
    path = str(tmp_path / "both.upmixaot")
    meta = aot.save_offline(path, cfg, n, kernel="mm",
                            platforms=["cpu", "cuda"])
    assert meta["platforms"] == ["cpu", "cuda"] and meta["kernel"] == "mm"
    art = aot.load(path)
    L, R = make_stereo(n, SR, seed=9)
    want = Upmixer(cfg, kernel="mm").process_np(L, R)
    for w, g in zip(want, art.process_np(L, R)):
        assert snr_db(w, g) > 120.0


def test_stream_step_artifact_for_cuda_only_refuses_cpu(tmp_path):
    # An artifact lowered only for the GPU loads anywhere (metadata and
    # program bytes) but refuses to run on another platform.
    hw = 256
    cfg = UpmixConfig.streaming([0.0, 500.0], sr=SR, hw_block_size=hw)
    path = str(tmp_path / "gpu_step.upmixaot")
    meta = aot.save_stream_step(path, cfg, hw, platforms=["cuda"])
    assert meta["platforms"] == ["cuda"]
    art = aot.load(path)
    assert art.exported.platforms == ("cuda",)
    with pytest.raises(ValueError, match="exported for platforms"):
        art.push_block(np.zeros(hw), np.zeros(hw))


@pytest.mark.parametrize("kernel,want", [("auto", "xla"), ("mm", "mm"),
                                         ("xla", "xla")])
def test_offline_artifact_records_resolved_kernel(tmp_path, kernel, want):
    # kernel="auto" resolves at export time on the builder's backend (the
    # CPU here picks "xla"); the metadata records the resolved kernel.
    meta = aot.save_offline(str(tmp_path / "k.upmixaot"), small_config(),
                            2048, kernel=kernel)
    assert meta["kernel"] == want


def test_load_rejects_unknown_artifact_type(tmp_path):
    # A file of a type this version does not build (e.g. the former
    # serving-pool artifacts) is refused with a clear error.
    import json

    path = tmp_path / "pool.upmixaot"
    meta = {"format": 1, "type": "stream_pool"}
    path.write_bytes(b"UPMIXAOT1\n" + json.dumps(meta).encode() + b"\n")
    with pytest.raises(ValueError, match="unknown artifact type"):
        aot.load(str(path))


def test_read_meta_and_bad_files(tmp_path):
    cfg = small_config()
    path = str(tmp_path / "offline.upmixaot")
    aot.save_offline(path, cfg, 2048)
    meta = aot.read_meta(path)
    assert meta["type"] == "offline"
    assert meta["platforms"]  # records the lowering platform

    bad = tmp_path / "bad.upmixaot"
    bad.write_bytes(b"not an artifact")
    with pytest.raises(ValueError, match="not an upmix AOT artifact"):
        aot.load(str(bad))
    with pytest.raises(ValueError, match="not an upmix AOT artifact"):
        aot.read_meta(str(bad))


def test_custom_window_artifact_loads_without_registration(tmp_path):
    # A config built on a registered custom window must round-trip
    # through an artifact into a process that never ran the
    # registration: config_to_dict persists the coefficients under
    # "custom_windows" and config_from_dict re-registers them
    # (regression: load() used to raise "unknown window" from
    # BandSpec.__post_init__ even though the exported program has the
    # window baked in).
    from upmix.ops import windows as W

    name = "test:aot-vec-window"
    n = 512
    vec = (
        0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)
    ).astype(np.float32) * 0.97
    W.register_window_vector(name, vec, overwrite=True)
    try:
        cfg = UpmixConfig.streaming(
            [0.0, 400.0, 1600.0], sr=SR, hw_block_size=256, window=name
        )
        path = str(tmp_path / "win.upmixaot")
        meta = aot.save_stream_step(path, cfg, 256, platforms=["cpu"])
        assert name in meta["config"]["custom_windows"]

        # Simulate the fresh process: drop the live registration.
        del W._CUSTOM[name]
        assert not W.is_known_window(name)
        art = aot.load(path)
        assert art.config.bands[0].window == name
        # The restored registration serves the EXACT original vector.
        np.testing.assert_array_equal(W.make_window(name, n), vec)
        # And the loaded program runs (one block through the step).
        state = art.init_state()
        blk = np.zeros((256,), np.float32)
        state, out = art.step(state, np.stack([blk, blk]))
        assert np.asarray(out).shape[-1] == 256
    finally:
        W._CUSTOM.pop(name, None)


def test_callable_window_config_round_trips_sampled(tmp_path):
    # Arbitrary callable windows (the reference's window_func contract,
    # main.py:65) cannot be pickled; config_to_dict persists their
    # per-band-size EVALUATIONS instead, and restore serves those sizes
    # exactly.
    from upmix.ops import windows as W

    name = "test:aot-callable-window"

    def tukey_ish(N):
        x = np.linspace(0, 1, N, dtype=np.float64)
        return (np.sin(np.pi * x) ** 1.5).astype(np.float32)

    W.register_window(name, tukey_ish, overwrite=True)
    try:
        cfg = UpmixConfig.make(
            [0.0, 400.0, 1600.0], sr=SR, max_block_size=1024, window=name
        )
        import json

        d = json.loads(json.dumps(aot.config_to_dict(cfg)))
        sizes = sorted({b.block_size for b in cfg.bands})
        assert d["custom_windows"][name]["kind"] == "sampled"

        del W._CUSTOM[name]
        cfg2 = aot.config_from_dict(d)
        assert cfg2 == cfg
        for bs in sizes:
            np.testing.assert_array_equal(
                W.make_window(name, bs), tukey_ish(bs)
            )
    finally:
        W._CUSTOM.pop(name, None)
