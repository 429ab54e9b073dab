"""Pure-NumPy WAV codec round-trips and error handling."""

import numpy as np
import pytest

from upmix.io import read_wav, write_wav


@pytest.mark.parametrize(
    "subtype,tol",
    [("PCM_16", 2**-15), ("PCM_24", 2**-23), ("PCM_32", 2**-30), ("FLOAT", 1e-7), ("DOUBLE", 0)],
)
def test_roundtrip_stereo(tmp_path, subtype, tol):
    rng = np.random.default_rng(0)
    x = np.clip(rng.standard_normal((1000, 2)) * 0.3, -1, 0.999)
    path = tmp_path / "t.wav"
    write_wav(path, x, 44100, subtype=subtype)
    y, sr = read_wav(path)
    assert sr == 44100
    assert y.shape == (1000, 2)
    np.testing.assert_allclose(y, x, atol=max(tol, 1e-18))


def test_mono_shapes(tmp_path):
    x = np.linspace(-0.5, 0.5, 321)
    path = tmp_path / "m.wav"
    write_wav(path, x, 8000)
    y, sr = read_wav(path)
    assert y.ndim == 1 and len(y) == 321
    y2d, _ = read_wav(path, always_2d=True)
    assert y2d.shape == (321, 1)


def test_clipping_on_pcm_write(tmp_path):
    x = np.array([1.5, -1.5, 0.0])
    path = tmp_path / "c.wav"
    write_wav(path, x, 8000, subtype="PCM_16")
    y, _ = read_wav(path)
    assert y[0] == pytest.approx(1.0 - 2**-15)
    assert y[1] == pytest.approx(-1.0)


def test_extensible_format(tmp_path):
    # Hand-build a WAVE_FORMAT_EXTENSIBLE float32 file and read it.
    import struct

    x = np.linspace(-0.9, 0.9, 64).astype("<f4")
    payload = x.tobytes()
    guid = b"\x03\x00" + b"\x00" * 14  # subformat FLOAT + junk GUID tail
    fmt_body = struct.pack("<HHIIHH", 0xFFFE, 1, 16000, 64000, 4, 32)
    fmt_body += struct.pack("<H", 22) + struct.pack("<H", 32) + b"\x0f\x00\x00\x00" + guid
    chunks = struct.pack("<4sI", b"fmt ", len(fmt_body)) + fmt_body
    chunks += struct.pack("<4sI", b"data", len(payload)) + payload
    raw = struct.pack("<4sI4s", b"RIFF", 4 + len(chunks), b"WAVE") + chunks
    path = tmp_path / "ext.wav"
    path.write_bytes(raw)
    y, sr = read_wav(path)
    assert sr == 16000
    np.testing.assert_allclose(y, x.astype(np.float64), atol=1e-7)


def test_error_paths(tmp_path):
    p = tmp_path / "bad.wav"
    p.write_bytes(b"RIFFxxxxJUNK")
    with pytest.raises(ValueError):
        read_wav(p)
    p.write_bytes(b"short")
    with pytest.raises(ValueError):
        read_wav(p)
    with pytest.raises(ValueError):
        write_wav(tmp_path / "x.wav", np.zeros(4), 8000, subtype="OGG")
    # fmt present but no data chunk
    import struct

    fmt_body = struct.pack("<HHIIHH", 1, 1, 8000, 16000, 2, 16)
    raw = (
        struct.pack("<4sI4s", b"RIFF", 4 + 8 + len(fmt_body), b"WAVE")
        + struct.pack("<4sI", b"fmt ", len(fmt_body))
        + fmt_body
    )
    p.write_bytes(raw)
    with pytest.raises(ValueError):
        read_wav(p)


def test_malformed_fmt_chunks_raise_valueerror(tmp_path):
    # The documented contract is ValueError for unreadable files — a
    # zero-channel fmt must not escape as ZeroDivisionError, nor a
    # truncated fmt body as struct.error.
    import struct

    def build(fmt_body, payload=b"\x00\x00"):
        chunks = struct.pack("<4sI", b"fmt ", len(fmt_body)) + fmt_body
        chunks += struct.pack("<4sI", b"data", len(payload)) + payload
        return struct.pack("<4sI4s", b"RIFF", 4 + len(chunks), b"WAVE") + chunks

    p = tmp_path / "zero_ch.wav"
    p.write_bytes(build(struct.pack("<HHIIHH", 1, 0, 8000, 16000, 2, 16)))
    with pytest.raises(ValueError, match="channels"):
        read_wav(p)

    p2 = tmp_path / "short_fmt.wav"
    p2.write_bytes(build(b"\x01\x00\x01\x00"))  # 4-byte fmt body
    with pytest.raises(ValueError):
        read_wav(p2)


def test_odd_sized_data_chunk_alignment(tmp_path):
    # 24-bit mono with odd payload length exercises the pad byte.
    x = np.linspace(-0.5, 0.5, 7)
    path = tmp_path / "odd.wav"
    write_wav(path, x, 8000, subtype="PCM_24")
    y, _ = read_wav(path)
    np.testing.assert_allclose(y, x, atol=2**-22)


def test_non_wav_error_mentions_soundfile(tmp_path, monkeypatch):
    from upmix.io import wav as wavmod

    p = tmp_path / "x.flac"
    p.write_bytes(b"fLaC" + b"\x00" * 64)
    monkeypatch.setattr(wavmod, "_sf", None)  # deterministic: no soundfile
    with pytest.raises(ValueError, match="soundfile"):
        read_wav(p)


class _FakeSoundfile:
    """Minimal working soundfile stand-in (the API surface io/wav.py uses).

    `write` records the samples and stamps a fLaC magic so read_wav's
    RIFF sniff routes the file to the soundfile branch; `read` hands the
    samples back with soundfile's conventions (float64, always_2d,
    numpy sample rate scalar — read_wav must coerce it to int).
    """

    def __init__(self):
        self._store = {}

    def write(self, path, data, sr, format=None):
        from pathlib import Path

        self._store[str(path)] = (np.asarray(data, np.float64), sr)
        Path(path).write_bytes(b"fLaC" + b"\x00" * 16)

    def read(self, path, always_2d=False, dtype="float64"):
        key = str(path)
        if key not in self._store:
            raise RuntimeError("unrecognised format (fake libsndfile)")
        data, sr = self._store[key]
        if data.ndim == 1 and always_2d:
            data = data[:, None]
        if data.ndim == 2 and data.shape[1] == 1 and not always_2d:
            data = data[:, 0]
        return data.astype(dtype), np.int64(sr)


def _soundfile_or_fake(monkeypatch):
    """Real soundfile when installed and functional, else the fake wired in."""
    from upmix.io import wav as wavmod

    try:
        import soundfile as sf

        if hasattr(sf, "write") and hasattr(sf, "read"):
            return sf
    except ImportError:
        pass
    fake = _FakeSoundfile()
    monkeypatch.setattr(wavmod, "_sf", fake)
    return fake


def test_flac_roundtrip_via_soundfile(tmp_path, monkeypatch):
    # Exercises the non-WAV routing branch (reference: main.py:22,43 reads
    # anything libsndfile supports) — against real soundfile when present,
    # else a working fake so the branch is covered on every box.
    sf = _soundfile_or_fake(monkeypatch)
    x = np.linspace(-0.5, 0.5, 1000).astype(np.float32)
    p = tmp_path / "x.flac"
    sf.write(p, np.column_stack([x, x]), 8000, format="FLAC")
    y, sr = read_wav(p)
    assert sr == 8000 and isinstance(sr, int)
    assert y.shape == (1000, 2) and y.dtype == np.float64
    np.testing.assert_allclose(y[:, 0], x, atol=2e-4)


def test_non_wav_mono_always_2d_via_soundfile(tmp_path, monkeypatch):
    sf = _soundfile_or_fake(monkeypatch)
    x = np.linspace(-0.3, 0.3, 64)
    p = tmp_path / "m.flac"
    sf.write(p, x, 22050, format="FLAC")
    y, sr = read_wav(p, always_2d=True)
    assert sr == 22050 and y.shape == (64, 1)
    y1, _ = read_wav(p)
    assert y1.ndim == 1 and len(y1) == 64


def test_soundfile_decode_failure_wrapped_as_valueerror(tmp_path, monkeypatch):
    # A file soundfile itself cannot decode must surface as the documented
    # ValueError("unreadable audio file"), never a raw backend exception.
    from upmix.io import wav as wavmod

    monkeypatch.setattr(wavmod, "_sf", _FakeSoundfile())
    p = tmp_path / "mystery.ogg"
    p.write_bytes(b"OggS" + b"\x00" * 32)  # non-RIFF, unknown to the fake
    with pytest.raises(ValueError, match="unreadable audio file"):
        read_wav(p)


def test_garbage_bytes_never_escape_valueerror(tmp_path):
    # Property: arbitrary byte soup must produce ValueError (the
    # documented contract), never ZeroDivisionError/struct.error/etc.
    rng = np.random.default_rng(99)
    p = tmp_path / "garbage.wav"
    for trial in range(20):
        n = int(rng.integers(0, 200))
        body = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
        if trial % 2:
            body = b"RIFF" + body  # looks vaguely WAV-ish
        p.write_bytes(body)
        with pytest.raises(ValueError):
            read_wav(p)


def test_pcm8_read(tmp_path):
    # 8-bit WAV PCM is unsigned with a 128 midpoint; reference reads it
    # via libsndfile (main.py:43) — the built-in codec matches.
    import struct

    vals = np.array([0, 64, 128, 192, 255], np.uint8)
    fmt_body = struct.pack("<HHIIHH", 1, 1, 8000, 8000, 1, 8)
    chunks = struct.pack("<4sI", b"fmt ", len(fmt_body)) + fmt_body
    payload = vals.tobytes() + b"\x00"  # odd length -> pad byte
    chunks += struct.pack("<4sI", b"data", len(vals)) + payload
    raw = struct.pack("<4sI4s", b"RIFF", 4 + len(chunks), b"WAVE") + chunks
    p = tmp_path / "u8.wav"
    p.write_bytes(raw)
    y, sr = read_wav(p)
    assert sr == 8000
    np.testing.assert_allclose(y, (vals.astype(np.float64) - 128) / 128)
