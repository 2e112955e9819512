"""Twins of tests/unit/test_wav_io.py for the port's ``io/wav`` (all but
``test_pcm8_native_parity``, whose twin is in
``tests/test_torch_wav_native.py`` with the port of ``io/wav_native``).

Each twin runs the reference test's own file through the port and holds
it to the same assertions; where the JAX package's reader or writer runs
on the same file, the port's bytes and samples must equal its output.
"""

import os
import struct

import numpy as np
import pytest
import torch

from audiosignalprocess_tpu.io import wav as jax_wav
from audiosignalprocess_tpu_torch.io import read_wav, stream_blocks, write_wav

RNG = np.random.default_rng(0)


def _same_as_jax(p, dtype=np.float32):
    """The port's read of ``p`` equals the JAX package's; returns it."""
    y, rate = read_wav(p, dtype=dtype)
    yj, rj = jax_wav.read_wav(p, dtype=dtype)
    assert rate == rj and y.dtype == yj.dtype
    np.testing.assert_array_equal(y, yj)
    return y, rate


@pytest.mark.parametrize("bits,float_fmt,tol", [
    (16, False, 2 ** -15),
    (24, False, 2 ** -23),
    (32, False, 1e-7),  # float32 return precision dominates PCM32
    (32, True, 1e-7),
])
@pytest.mark.parametrize("nch", [1, 2, 8])
def test_roundtrip(tmp_path, bits, float_fmt, tol, nch):
    x = np.clip(RNG.standard_normal((nch, 1000)) * 0.3, -1, 1).astype(np.float32)
    p, pj = str(tmp_path / "t.wav"), str(tmp_path / "tj.wav")
    write_wav(p, x, 48000, bits=bits, float_fmt=float_fmt)
    jax_wav.write_wav(pj, x, 48000, bits=bits, float_fmt=float_fmt)
    assert open(p, "rb").read() == open(pj, "rb").read()
    y, rate = _same_as_jax(p)
    assert rate == 48000 and y.shape == x.shape
    np.testing.assert_allclose(y, x, atol=tol * 1.01)


def test_mono_1d_write(tmp_path):
    x = np.sin(np.arange(256) * 0.1).astype(np.float32) * 0.5
    p = str(tmp_path / "m.wav")
    write_wav(p, x, 16000)
    y, rate = _same_as_jax(p)
    assert y.shape == (1, 256) and rate == 16000


def test_stream_blocks_pads_final(tmp_path):
    x = RNG.standard_normal((2, 1000)).astype(np.float32) * 0.1
    p = str(tmp_path / "s.wav")
    write_wav(p, x, 48000, float_fmt=True)
    blocks = list(stream_blocks(p, 256, device="cpu"))
    assert len(blocks) == 4
    assert all(isinstance(b, torch.Tensor) and b.shape == (2, 256) for b in blocks)
    cat = torch.cat(blocks, dim=1).numpy()
    np.testing.assert_allclose(cat[:, :1000], x, atol=1e-7)
    np.testing.assert_array_equal(cat[:, 1000:], 0.0)
    np.testing.assert_array_equal(cat, np.concatenate(list(jax_wav.stream_blocks(p, 256)), 1))


def test_odd_data_chunk_pad(tmp_path):
    """24-bit mono with an odd frame count: the data chunk gets a RIFF pad
    byte and the file still round-trips."""
    x = np.linspace(-0.5, 0.5, 1001)
    p = str(tmp_path / "odd.wav")
    write_wav(p, x, 8000, bits=24)
    assert os.path.getsize(p) % 2 == 0
    y, rate = _same_as_jax(p, np.float64)
    assert rate == 8000 and y.shape == (1, 1001)
    np.testing.assert_allclose(y[0], x, atol=2e-7)


def test_float64_roundtrip(tmp_path):
    """tag 3 (IEEE float) with 64-bit samples decodes bit-exactly."""
    x = RNG.standard_normal((2, 500)) * 0.3
    p = str(tmp_path / "f64.wav")
    write_wav(p, x, 96000, bits=64, float_fmt=True)
    y, rate = _same_as_jax(p, np.float64)
    assert rate == 96000
    np.testing.assert_array_equal(y, x)


def test_truncated_data_chunk(tmp_path):
    """A data chunk whose size field points past the end of the file clamps
    to the frames present."""
    x = np.linspace(-0.5, 0.5, 100).astype(np.float32)
    p = str(tmp_path / "trunc.wav")
    write_wav(p, x, 8000, bits=16)
    blob = open(p, "rb").read()
    open(p, "wb").write(blob[:-10])  # drop 5 frames
    y, rate = _same_as_jax(p)
    assert rate == 8000 and y.shape == (1, 95)
    np.testing.assert_allclose(y[0], x[:95], atol=1e-4)


def test_first_data_chunk_wins(tmp_path):
    """Extra trailing data chunks (some writers append them) are ignored."""
    x = np.linspace(-0.5, 0.5, 64).astype(np.float32)
    p = str(tmp_path / "dup.wav")
    write_wav(p, x, 8000, bits=16)
    blob = bytearray(open(p, "rb").read())
    junk = b"\x7f\x00" * 32
    blob += b"data" + struct.pack("<I", len(junk)) + junk
    blob[4:8] = struct.pack("<I", len(blob) - 8)
    open(p, "wb").write(bytes(blob))
    y, _ = _same_as_jax(p)
    assert y.shape == (1, 64)
    np.testing.assert_allclose(y[0], x, atol=1e-4)


@pytest.mark.parametrize("match", ("fmt chunk too short", "inconsistent fmt",
                                   "extensible fmt chunk too short"))
def test_malformed_headers_raise(tmp_path, match):
    x = np.zeros(16, dtype=np.float32)
    p = str(tmp_path / "bad.wav")
    write_wav(p, x, 8000, bits=16)
    blob = bytearray(open(p, "rb").read())
    if "inconsistent" in match:
        blob[32:34] = struct.pack("<H", 0)  # block align field
    elif "extensible" in match:
        blob[20:22] = struct.pack("<H", 0xFFFE)  # the tag, but no extension
    else:
        blob = bytearray(bytes(blob)[:16] + bytes(blob)[20:])
        blob[16:20] = struct.pack("<I", 12)  # fmt size
    open(p, "wb").write(bytes(blob))
    with pytest.raises(ValueError, match=match):
        read_wav(p)
    with pytest.raises(ValueError, match=match):
        jax_wav.read_wav(p)


def test_pcm8_roundtrip(tmp_path):
    """8-bit PCM: unsigned with a 128 offset (the RIFF convention)."""
    x = np.clip(RNG.standard_normal((2, 500)) * 0.3, -1, 1).astype(np.float32)
    p = str(tmp_path / "u8.wav")
    write_wav(p, x, 22050, bits=8)
    y, rate = _same_as_jax(p)
    assert rate == 22050 and y.shape == x.shape
    np.testing.assert_allclose(y, x, atol=2 ** -7 * 1.01)
    # silence encodes exactly to the 128 midpoint
    write_wav(p, np.zeros((1, 10), np.float32), 8000, bits=8)
    assert open(p, "rb").read()[-10:] == b"\x80" * 10


def test_rf64_raises(tmp_path):
    p = str(tmp_path / "r.wav")
    write_wav(p, np.zeros(16, np.float32), 8000)
    blob = bytearray(open(p, "rb").read())
    blob[:4] = b"RF64"
    open(p, "wb").write(bytes(blob))
    with pytest.raises(ValueError, match="RF64"):
        read_wav(p)


def test_chunks_before_fmt_and_cbsize(tmp_path):
    """LIST/JUNK chunks ahead of fmt, a size-18 fmt chunk (cbSize 0) and pad
    bytes all parse to the same audio."""
    x = np.linspace(-0.5, 0.5, 64).astype(np.float32)
    p = str(tmp_path / "multi.wav")
    write_wav(p, x, 8000, bits=16)
    blob = open(p, "rb").read()
    fmt_chunk, data_chunk = blob[12:36], blob[36:]
    junk = b"JUNK" + struct.pack("<I", 5) + b"abcde" + b"\x00"  # odd + pad
    lst = b"LIST" + struct.pack("<I", 4) + b"INFO"
    fmt18 = b"fmt " + struct.pack("<I", 18) + fmt_chunk[8:] + b"\x00\x00"
    body = junk + lst + fmt18 + data_chunk
    open(p, "wb").write(b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE" + body)
    y, rate = _same_as_jax(p)
    assert rate == 8000 and y.shape == (1, 64)
    np.testing.assert_allclose(y[0], x, atol=1e-4)


def test_extensible_float_subformat(tmp_path):
    """WAVE_FORMAT_EXTENSIBLE wrapping IEEE float32."""
    x = (np.sin(np.arange(100) * 0.2) * 0.7).astype(np.float32)
    p = str(tmp_path / "extf.wav")
    write_wav(p, x, 48000, bits=32, float_fmt=True)
    blob = open(p, "rb").read()
    base = blob[20:36]  # the 16-byte fmt body (tag 3)
    ext = struct.pack("<HHI", 22, 32, 4)  # cbSize, valid bits, channel mask
    guid = struct.pack("<H", 3) + b"\x00\x00" + bytes(
        [0x00, 0x00, 0x10, 0x00, 0x80, 0x00, 0x00, 0xAA, 0x00, 0x38, 0x9B, 0x71])
    fmt_body = struct.pack("<H", 0xFFFE) + base[2:] + ext + guid
    body = b"fmt " + struct.pack("<I", len(fmt_body)) + fmt_body + blob[36:]
    open(p, "wb").write(b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE" + body)
    y, rate = _same_as_jax(p)
    assert rate == 48000
    np.testing.assert_allclose(y[0], x, atol=1e-7)
