"""CLI surface tests (in-process main)."""

import numpy as np
import pytest

from upmix.cli import main, parse_edges
from upmix.io import read_wav, write_wav

from helpers import make_stereo


def _input(tmp_path, name="clip.wav", n=3000, sr=8000):
    L, R = make_stereo(n, sr)
    path = tmp_path / name
    write_wav(path, np.column_stack([L, R]) * 0.4, sr)
    return path


def test_parse_edges():
    assert parse_edges("0,30,120") == [0.0, 30.0, 120.0]
    with pytest.raises(SystemExit):
        parse_edges("0,abc")
    with pytest.raises(SystemExit):
        parse_edges("120,30")
    with pytest.raises(SystemExit):
        parse_edges("")


def test_cli_stereo_sum(tmp_path, capsys):
    path = _input(tmp_path)
    rc = main(
        [
            str(path),
            "--out-dir",
            str(tmp_path / "out"),
            "--band-edges",
            "0,400,1600",
            "--max-block-size",
            "512",
        ]
    )
    assert rc == 0
    printed = capsys.readouterr().out.strip().splitlines()
    assert len(printed) == 1
    y, sr = read_wav(printed[0])
    assert y.shape[1] == 2 and sr == 8000


def test_cli_split_and_batch(tmp_path, capsys):
    a = _input(tmp_path, "a.wav")
    b = _input(tmp_path, "b.wav")
    rc = main(
        [
            str(a),
            str(b),
            "--out-dir",
            str(tmp_path / "out"),
            "--export-mode",
            "split",
            "--band-edges",
            "0,400",
            "--max-block-size",
            "256",
        ]
    )
    assert rc == 0
    printed = capsys.readouterr().out.strip().splitlines()
    assert len(printed) == 6  # 3 files per input
    names = [p.split("/")[-1] for p in printed]
    assert any(n.startswith("a_Ls_") for n in names)
    assert any(n.startswith("b_Rs_") for n in names)


def test_cli_bad_mode_rejected(tmp_path):
    path = _input(tmp_path)
    with pytest.raises(SystemExit):
        main([str(path), "--export-mode", "quad"])


def test_cli_missing_file(tmp_path):
    with pytest.raises(FileNotFoundError):
        main([str(tmp_path / "nope.wav"), "--out-dir", str(tmp_path)])


def test_cli_pad_granularity_zero_rejected(tmp_path):
    # Explicit 0 must be an error, not truthiness-coerced to the default.
    path = _input(tmp_path)
    with pytest.raises(SystemExit, match="pad-granularity"):
        main([str(path), "--pad-granularity", "0"])


def test_compilation_cache_helper(tmp_path, monkeypatch):
    import os

    from upmix.utils.cache import enable_compilation_cache

    # explicit dir is used (and created) when the env var is unset
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d = enable_compilation_cache(str(tmp_path / "jc"))
    assert d == str(tmp_path / "jc")
    assert os.path.isdir(d)
    # env var is respected when no explicit dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    assert enable_compilation_cache() == str(tmp_path / "env")


@pytest.mark.parametrize(
    "env, arg, want",
    [
        ("env", None, "env"),  # env set: used
        ("env", "arg", "env"),  # env set: an explicit argument does not win
        (None, "arg", "arg"),  # env unset: the argument
        (None, None, "default"),  # env unset: the fixed in-checkout path
    ],
)
def test_compilation_cache_dir_rules(tmp_path, monkeypatch, env, arg, want):
    import os

    from upmix.utils.cache import DEFAULT_CACHE_DIR, compilation_cache_dir

    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / env))
    got = compilation_cache_dir(None if arg is None else str(tmp_path / arg))
    if want == "default":
        assert got == DEFAULT_CACHE_DIR
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert got == os.path.join(root, ".jax_cache")
    else:
        assert got == str(tmp_path / want)


def test_cli_save_aot_offline(tmp_path, capsys):
    art_path = tmp_path / "prog.upmixaot"
    rc = main(
        [
            "-",
            "--save-aot",
            str(art_path),
            "--sr",
            "16000",
            "--band-edges",
            "0,400",
            "--max-block-size",
            "1024",
            "--aot-samples",
            "4096",
        ]
    )
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    import json

    info = json.loads(out)
    assert info["saved"] == str(art_path)
    assert info["type"] == "offline"

    from upmix import aot

    art = aot.load(str(art_path))
    L, R = make_stereo(4096, 16000)
    C, Ls, Rs = art.process_np(L, R)
    assert C.shape == (4096,)
    assert np.isfinite(C).all()


def test_cli_save_aot_stream(tmp_path, capsys):
    art_path = tmp_path / "step.upmixaot"
    rc = main(
        [
            "-",
            "--save-aot",
            str(art_path),
            "--aot-stream",
            "--sr",
            "16000",
            "--band-edges",
            "0,500",
            "--hw-block",
            "256",
        ]
    )
    assert rc == 0
    from upmix import aot

    meta = aot.read_meta(str(art_path))
    assert meta["type"] == "stream_step"
    assert meta["hw_block_size"] == 256


@pytest.mark.parametrize("platforms", [None, "cpu"])
def test_cli_save_aot_platforms(tmp_path, capsys, platforms):
    # --aot-platforms defaults to the current backend (the CPU here);
    # an explicit list is recorded as given.
    import json

    art_path = tmp_path / "step.upmixaot"
    args = ["-", "--save-aot", str(art_path), "--aot-stream", "--sr",
            "16000", "--band-edges", "0,500", "--hw-block", "256"]
    if platforms is not None:
        args += ["--aot-platforms", platforms]
    assert main(args) == 0
    info = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert info["type"] == "stream_step"
    assert info["platforms"] == ["cpu"]


@pytest.mark.parametrize(
    "flag", ["--aot-pool=16", "--pool-group=8", "--serve-hops=2",
             "--pool-engine=xla", "--pool-ola=time"]
)
def test_cli_rejects_removed_pool_flags(flag):
    # The serving-pool kernel knobs went with the kernel; argparse must
    # reject them instead of silently ignoring a stale deployment flag.
    with pytest.raises(SystemExit):
        main(["-", "--serve-stream", "0", "--sr", "8000", flag])


def test_cli_save_aot_requires_sr_and_dash(tmp_path):
    with pytest.raises(SystemExit, match="requires a positive --sr"):
        main(["-", "--save-aot", str(tmp_path / "x.upmixaot")])
    with pytest.raises(SystemExit, match="pass '-'"):
        main(
            [
                str(_input(tmp_path)),
                "--save-aot",
                str(tmp_path / "x.upmixaot"),
                "--sr",
                "8000",
            ]
        )


def test_cli_fetch_metrics(capsys):
    # --fetch-metrics is a pure network client: query a live stream
    # server's metrics in JSON and Prometheus form through the CLI.
    import json

    from upmix.config import UpmixConfig
    from upmix.models.streaming import BatchStreamingUpmixer
    from upmix.serve_stream import StreamServer

    cfg = UpmixConfig.streaming([0.0, 400.0, 1600.0], sr=8000.0,
                                hw_block_size=256)
    pool = BatchStreamingUpmixer(cfg, 256, n_streams=2)
    with StreamServer(pool, lockstep=True) as srv:
        addr = f"{srv.address[0]}:{srv.address[1]}"
        assert main(["-", "--fetch-metrics", addr]) == 0
        snap = json.loads(capsys.readouterr().out)
        assert snap["config"]["n_slots"] == 2
        assert main(["-", "--fetch-metrics", addr, "--prometheus"]) == 0
        assert "upmix_blocks_total" in capsys.readouterr().out


def test_cli_fetch_metrics_validation(tmp_path):
    with pytest.raises(SystemExit):
        main(["-", "--fetch-metrics", "nonsense"])  # no port
    with pytest.raises(SystemExit):
        main(["-", "--prometheus"])  # requires --fetch-metrics
    # Dead port: connection error surfaces as a clean CLI error.
    with pytest.raises(SystemExit):
        main(["-", "--fetch-metrics", "127.0.0.1:9"])


def test_cli_unknown_window_rejected(tmp_path):
    # --window lost argparse choices= when custom registrations were
    # allowed; a typo must stay a clean exit, not a ValueError traceback
    # out of BandSpec.__post_init__.
    path = _input(tmp_path)
    with pytest.raises(SystemExit, match="unknown --window"):
        main([str(path), "--window", "blackman_haris"])


def test_cli_mesh_offline_parity(tmp_path, capsys):
    # --mesh runs the same pipeline sharded over the virtual devices;
    # output must match the single-device CLI run (accumulation-order
    # float noise only).
    from helpers import snr_db

    path = _input(tmp_path, n=5000)
    common = ["--band-edges", "0,400,1600", "--max-block-size", "512"]
    assert main([str(path), "--out-dir", str(tmp_path / "a"), *common]) == 0
    ref_path = capsys.readouterr().out.strip().splitlines()[-1]
    assert (
        main(
            [str(path), "--out-dir", str(tmp_path / "b"), "--mesh", "seq=4", *common]
        )
        == 0
    )
    got_path = capsys.readouterr().out.strip().splitlines()[-1]
    ref, sr = read_wav(ref_path)
    got, sr2 = read_wav(got_path)
    assert sr == sr2 and ref.shape == got.shape
    for ch in range(ref.shape[1]):
        assert snr_db(ref[:, ch], got[:, ch]) > 60.0


def test_cli_mesh_dp_sp_batch(tmp_path, capsys):
    # data+seq axes over a multi-file batch: the whole input list rides
    # the data axis in ONE sharded call (run_offline_batch), ragged
    # lengths zero-padded and trimmed per file.  Each file's output
    # must match its solo unsharded run.
    from helpers import snr_db

    a = _input(tmp_path, "a.wav", n=4000)
    b = _input(tmp_path, "b.wav", n=2900)  # ragged: pads to a's length
    c = _input(tmp_path, "c.wav", n=3500)  # odd batch: pads to data=2
    common = ["--band-edges", "0,400,1600", "--max-block-size", "512"]
    solo = {}
    for p in (a, b, c):
        assert main([str(p), "--out-dir", str(tmp_path / "solo"), *common]) == 0
        solo[p] = read_wav(capsys.readouterr().out.strip().splitlines()[-1])[0]
    rc = main(
        [
            str(a), str(b), str(c),
            "--out-dir", str(tmp_path / "out"),
            "--mesh", "data=2,seq=2",
            "--meter",
            *common,
        ]
    )
    assert rc == 0
    printed = capsys.readouterr().out.strip().splitlines()
    assert printed[0].startswith("[batch x3]")
    assert len(printed) == 4
    for p, line in zip((a, b, c), printed[1:]):
        y, sr = read_wav(line)
        ref = solo[p]
        assert sr == 8000 and y.shape == ref.shape
        for ch in range(2):
            assert snr_db(ref[:, ch], y[:, ch]) > 60.0


def test_cli_mesh_validation(tmp_path):
    path = _input(tmp_path)
    # Malformed specs and impossible sizes are clean CLI errors.
    for spec in ("seq=abc", "seq=0", "seq", "", "seq=2,seq=2", "model=2"):
        with pytest.raises(SystemExit):
            main([str(path), "--mesh", spec])
    with pytest.raises(SystemExit):  # more devices than exist
        main([str(path), "--mesh", "seq=1024"])
    # Offline-only: rejected with the streaming/pipe/serve surfaces.
    with pytest.raises(SystemExit, match="offline"):
        main([str(path), "--mesh", "seq=2", "--streaming"])
    # --pool-mesh requires --serve-stream.
    with pytest.raises(SystemExit, match="pool-mesh"):
        main([str(path), "--pool-mesh", "data=2"])


def test_cli_chunk_override(tmp_path, capsys):
    # --chunk forces the scan chunk size (0 = whole-file program); both
    # must produce the same audio as the default.  --kernel mm so the
    # scan kernel (the only chunked path) actually runs on the CPU
    # backend — under the default auto->xla resolution the flag would
    # be inert and this test would pass vacuously (review finding).
    from helpers import snr_db

    path = _input(tmp_path, n=5000)
    common = ["--band-edges", "0,400,1600", "--max-block-size", "512",
              "--kernel", "mm"]
    outs = {}
    for name, extra in (
        ("default", []),
        ("chunk2048", ["--chunk", "2048"]),
        ("whole", ["--chunk", "0"]),
    ):
        rc = main(
            [str(path), "--out-dir", str(tmp_path / name), *common, *extra]
        )
        assert rc == 0
        outs[name] = read_wav(capsys.readouterr().out.strip().splitlines()[-1])[0]
    for name in ("chunk2048", "whole"):
        for ch in range(2):
            assert snr_db(outs["default"][:, ch], outs[name][:, ch]) > 60.0
    with pytest.raises(SystemExit, match="chunk"):
        main([str(path), "--chunk", "-1"])
    with pytest.raises(SystemExit, match="chunk"):
        main([str(path), "--chunk", "2048", "--mesh", "seq=2"])


def test_cli_mesh_batch_mixed_sample_rates(tmp_path, capsys):
    # run_offline_batch groups by sample rate: one config + sharded call
    # per rate, results still in input order.
    a = _input(tmp_path, "a8k.wav", n=3000, sr=8000)
    b = _input(tmp_path, "b16k.wav", n=5000, sr=16000)
    rc = main(
        [
            str(a), str(b),
            "--out-dir", str(tmp_path / "out"),
            "--mesh", "data=2",
            "--band-edges", "0,400,1600",
            "--max-block-size", "512",
        ]
    )
    assert rc == 0
    printed = capsys.readouterr().out.strip().splitlines()
    assert len(printed) == 2
    ya, sra = read_wav(printed[0])
    yb, srb = read_wav(printed[1])
    assert (sra, len(ya)) == (8000, 3000)
    assert (srb, len(yb)) == (16000, 5000)


def test_cli_serve_stream_config_errors_are_clean(tmp_path):
    # Pool-construction ValueErrors (mesh divisibility) must exit as
    # clean CLI errors, not tracebacks.
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs >= 2 devices")
    with pytest.raises(SystemExit, match="divide evenly"):
        main(["-", "--serve-stream", "0", "--sr", "8000", "--streams", "3",
              "--pool-mesh", "data=2", "--band-edges", "0,400,1600",
              "--hw-block", "256"])
