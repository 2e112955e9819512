"""Twins of tests/unit/test_wav_native.py (all 25 cases) and of
tests/unit/test_wav_io.py::test_pcm8_native_parity for the port's
``io/wav_native``, held against the JAX package's ``io/wav`` and the
port's ``io/wav`` (the files written, and read back, by each), as the
reference tests hold the JAX package's native reader against its
``io/wav``; and the port's copy of ``native/asp_io.c`` is the JAX package's, byte for
byte, built only under the package's ``_build/``."""

import shutil

import numpy as np
import pytest
import torch

from audiosignalprocess_tpu.io import wav as jaxwav
from audiosignalprocess_tpu_torch.io import wav as pywav
from audiosignalprocess_tpu_torch.io import wav_native

REFS = (jaxwav, pywav)  # the reference readers and writers: JAX package, port

pytestmark = pytest.mark.skipif(shutil.which("cc") is None, reason="no C compiler")


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(51)


@pytest.mark.parametrize("bits,float_fmt", ((16, False), (24, False), (32, False),
                                            (32, True)))
@pytest.mark.parametrize("nch", (1, 2, 8))
def test_native_read_matches_python(rng, tmp_path, bits, float_fmt, nch):
    x = np.clip(0.5 * rng.standard_normal((nch, 1000)), -0.99, 0.99)
    for ref in REFS:
        path = str(tmp_path / f"t_{ref.__name__}.wav")
        ref.write_wav(path, x, 48000, bits=bits, float_fmt=float_fmt)
        a, ra = ref.read_wav(path, dtype=np.float32)
        b, rb = wav_native.read_wav(path)
        assert ra == rb == 48000
        np.testing.assert_allclose(a, b, atol=2e-7)


@pytest.mark.parametrize("bits,float_fmt", ((16, False), (24, False), (32, True)))
def test_native_write_matches_python(rng, tmp_path, bits, float_fmt):
    x = np.clip(0.5 * rng.standard_normal((2, 500)), -0.99, 0.99).astype(np.float32)
    pb = str(tmp_path / "na.wav")
    wav_native.write_wav(pb, x, 44100, bits=bits, float_fmt=float_fmt)
    for ref in REFS:
        pa = str(tmp_path / f"{ref.__name__}.wav")
        ref.write_wav(pa, x, 44100, bits=bits, float_fmt=float_fmt)
        a, _ = ref.read_wav(pa, dtype=np.float64)
        b, _ = ref.read_wav(pb, dtype=np.float64)
        np.testing.assert_allclose(a, b, atol=1e-9)


def test_probe(tmp_path, rng):
    x = rng.standard_normal((3, 777)).astype(np.float32)
    for ref in REFS:
        path = str(tmp_path / f"p_{ref.__name__}.wav")
        ref.write_wav(path, x, 96000, float_fmt=True)
        info = wav_native.probe(path)
        assert (info.sample_rate, info.num_channels, info.num_frames) == (96000, 3, 777)
        assert info.float_fmt == 1


class TestRingBuffer:
    def test_push_pop_roundtrip(self, rng):
        rb = wav_native.RingBuffer(channels=2, capacity=1024)
        x = rng.standard_normal((2, 700)).astype(np.float32)
        assert rb.push(x) == 700
        assert rb.readable == 700
        out, got = rb.pop(700)
        assert got == 700
        np.testing.assert_array_equal(out, x)

    def test_wraparound(self, rng):
        rb = wav_native.RingBuffer(channels=1, capacity=256)
        total_in, total_out = [], []
        for _ in range(10):
            x = rng.standard_normal((1, 200)).astype(np.float32)
            pushed = rb.push(x)
            total_in.append(x[:, :pushed])
            out, got = rb.pop(150, pad=False)
            total_out.append(out[:, :got])
        out, got = rb.pop(rb.readable, pad=False)
        total_out.append(out[:, :got])
        np.testing.assert_array_equal(np.concatenate(total_in, axis=1),
                                      np.concatenate(total_out, axis=1))

    def test_pad_short_read(self):
        rb = wav_native.RingBuffer(channels=1, capacity=64)
        rb.push(np.ones((1, 10), np.float32))
        out, got = rb.pop(32, pad=True)
        assert got == 10
        np.testing.assert_array_equal(out[0, :10], 1.0)
        np.testing.assert_array_equal(out[0, 10:], 0.0)


def test_ring_between_two_threads_keeps_every_frame_in_order():
    """A producer thread and this consumer share the ring (ctypes drops the
    interpreter lock in each call), with the switch interval shortened:
    every frame comes out once, in order, across many wraps."""
    import sys
    import threading
    import time

    x = np.arange(3 * 20000, dtype=np.float32).reshape(3, -1)
    rb = wav_native.RingBuffer(channels=3, capacity=97)
    sizes = np.random.default_rng(3).integers(1, 200, 400)

    def produce():
        off = 0
        while off < x.shape[1]:
            off += rb.push(x[:, off : off + int(sizes[off % 400])])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        th = threading.Thread(target=produce, daemon=True)
        th.start()
        got, n = [], 0
        deadline = time.monotonic() + 30
        while n < x.shape[1]:
            assert time.monotonic() < deadline, f"{n} of {x.shape[1]} frames in 30 s"
            out, k = rb.pop(int(sizes[n % 400]), pad=False)
            got.append(out[:, :k])
            n += k
        th.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not th.is_alive()
    np.testing.assert_array_equal(np.concatenate(got, axis=1), x)


def test_float64_decode_matches_python(rng, tmp_path):
    """The native reader decodes IEEE float64 WAVs (io/wav writes them)."""
    x = np.clip(0.5 * rng.standard_normal((2, 500)), -0.99, 0.99)
    for ref in REFS:
        path = str(tmp_path / f"f64_{ref.__name__}.wav")
        ref.write_wav(path, x, 48000, bits=64, float_fmt=True)
        a, _ = ref.read_wav(path, dtype=np.float32)
        b, _ = wav_native.read_wav(path)
        np.testing.assert_array_equal(a, b)
        assert np.abs(b).max() > 0.1  # not silent zeros


def test_float64_native_write_raises(tmp_path):
    """The native encoder is float32-planar in; a float64 request errors
    (pointing at io.wav), never silently downgrades the format."""
    with pytest.raises(ValueError, match="float64"):
        wav_native.write_wav(str(tmp_path / "x.wav"), np.zeros((1, 10)),
                             48000, bits=64, float_fmt=True)


def test_unsupported_format_errors_not_silence(tmp_path):
    """An a-law (tag=6) WAV raises, not decodes to a zero array."""
    import struct

    body = bytes(100 * 2)  # 100 stereo 8-bit frames of a-law junk
    hdr = b"RIFF" + struct.pack("<I", 36 + len(body)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 6, 2, 8000, 16000, 2, 8)
    hdr += b"data" + struct.pack("<I", len(body))
    path = str(tmp_path / "alaw.wav")
    with open(path, "wb") as f:
        f.write(hdr + body)
    with pytest.raises(ValueError, match="unsupported format"):
        wav_native.read_wav(path)
    with pytest.raises(ValueError):
        wav_native.WavReader(path)


def test_first_data_chunk_wins(rng, tmp_path):
    """Two data chunks: both readers size and decode the first."""
    import struct

    x1 = np.clip(0.5 * rng.standard_normal(100), -0.99, 0.99)
    b1 = np.clip(np.round(x1 * 32768.0), -32768, 32767).astype("<i2").tobytes()
    b2 = np.zeros(200, dtype="<i2").tobytes()
    hdr = b"RIFF" + struct.pack("<I", 36 + 8 + len(b1) + len(b2)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, 16000, 32000, 2, 16)
    payload = b"data" + struct.pack("<I", len(b1)) + b1
    payload += b"data" + struct.pack("<I", len(b2)) + b2
    path = str(tmp_path / "two.wav")
    with open(path, "wb") as f:
        f.write(hdr + payload)
    b, _ = wav_native.read_wav(path)
    for ref in REFS:
        a, _ = ref.read_wav(path, dtype=np.float32)
        assert a.shape == (1, 100) and b.shape == (1, 100)
        np.testing.assert_array_equal(a, b)


def test_truncated_fmt_chunk_errors(tmp_path):
    import struct

    hdr = b"RIFF" + struct.pack("<I", 20) + b"WAVE"
    hdr += b"fmt " + struct.pack("<I", 8) + bytes(8)  # 8-byte fmt: invalid
    path = str(tmp_path / "shortfmt.wav")
    with open(path, "wb") as f:
        f.write(hdr)
    with pytest.raises(ValueError):
        wav_native.probe(path)
    for ref in REFS:
        with pytest.raises(ValueError):
            ref.read_wav(path)


def test_checkpoint_extension_normalized(tmp_path):
    """save_carry/load_carry agree on the .npz suffix whatever path the
    caller passes (np.savez appends it, np.load does not)."""
    from audiosignalprocess_tpu_torch.utils.checkpoint import load_carry, save_carry

    carry = {"a": torch.arange(4.0), "b": torch.zeros((2, 3))}
    p = str(tmp_path / "carry.state")  # no .npz
    save_carry(p, carry, 7)
    got, blk = load_carry(p, carry)
    assert blk == 7
    np.testing.assert_array_equal(got["a"].numpy(), np.arange(4.0))


def test_pcm8_native_parity(tmp_path):
    """Native C decoder/encoder match the numpy reader/writer on PCM8."""
    x = np.clip(np.random.default_rng(0).standard_normal((2, 300)) * 0.4, -1,
                1).astype(np.float32)
    pn = str(tmp_path / "u8w.wav")
    wav_native.write_wav(pn, x, 16000, bits=8)
    for ref in REFS:
        p = str(tmp_path / f"u8n_{ref.__name__}.wav")
        ref.write_wav(p, x, 16000, bits=8)
        ypy, _ = ref.read_wav(p)
        ync, rate = wav_native.read_wav(p)
        assert rate == 16000
        np.testing.assert_allclose(ync, ypy, atol=1e-7)
        assert open(pn, "rb").read() == open(p, "rb").read()


def test_source_is_the_jax_packages_byte_for_byte():
    """One spec: the port's asp_io.c is the JAX package's file."""
    import pathlib

    jax_src = pathlib.Path(__file__).resolve().parent.parent / "audiosignalprocess_tpu" / \
        "native" / "asp_io.c"
    assert wav_native.SRC.read_bytes() == jax_src.read_bytes()


def test_library_built_under_build_dir_only(tmp_path, monkeypatch):
    """The library lands in the package's _build/, named by the source's
    and flags' hash, and nothing is written beside the source; a missing
    cc raises an error naming the command (no fallback)."""
    lib = wav_native.build()
    assert lib.parent == wav_native.BUILD_DIR and lib == wav_native.library_path()
    assert sorted(p.name for p in wav_native.SRC.parent.iterdir()) == ["asp_io.c"]
    monkeypatch.setattr(wav_native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(wav_native.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="cc -O2 -shared -fPIC"):
        wav_native.build()
