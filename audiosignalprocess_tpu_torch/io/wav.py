"""WAV (RIFF) file I/O, host-side numpy.

A copy of the JAX package's ``io/wav.py`` (the port cannot import that
module without importing jax): RIFF header parse, PCM8/16/24/32 and
float32/64 decode, encode, interleaved <-> planar channels, and the
block reader ``stream_blocks``.  ``read_wav`` returns numpy; the caller
moves the planar array to its device.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np
import torch

_PCM = 1
_FLOAT = 3
_EXTENSIBLE = 0xFFFE


@dataclass
class WavInfo:
    sample_rate: int
    num_channels: int
    num_frames: int
    bits: int
    float_fmt: bool


def read_wav(path: str, dtype=np.float32) -> tuple[np.ndarray, int]:
    """Read a WAV file -> (planar array (channels, frames) in [-1, 1], rate)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] == b"RF64":
        # 64-bit RIFF (>4 GB WAV): sizes live in a ds64 chunk; out of scope
        raise ValueError(f"{path}: RF64 (64-bit WAV) is not supported")
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    raw = None
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4 : pos + 8])
        # a size field pointing past EOF (truncated file) clamps to what is
        # actually present — the frame count below adjusts accordingly
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            if size < 16:
                raise ValueError(f"{path}: fmt chunk too short ({size} bytes)")
            tag, nch, rate, _brate, balign, bits = struct.unpack("<HHIIHH", body[:16])
            if tag == _EXTENSIBLE:
                # the real format tag is the first word of the extension's
                # SubFormat GUID (WAVE_FORMAT_EXTENSIBLE layout)
                if size < 40:
                    raise ValueError(
                        f"{path}: extensible fmt chunk too short ({size} bytes)")
                (tag,) = struct.unpack("<H", body[24:26])
            fmt = (tag, nch, rate, balign, bits)
        elif cid == b"data" and raw is None:  # first data chunk wins
            raw = body
        pos += 8 + size + (size & 1)
    if fmt is None or raw is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    tag, nch, rate, balign, bits = fmt
    if nch == 0 or balign == 0 or balign != nch * bits // 8:
        raise ValueError(
            f"{path}: inconsistent fmt (channels={nch}, block align={balign}, "
            f"bits={bits})")
    nframes = len(raw) // balign
    raw = raw[: nframes * balign]
    if tag == _FLOAT and bits == 32:
        x = np.frombuffer(raw, dtype="<f4").astype(np.float64)
    elif tag == _FLOAT and bits == 64:
        x = np.frombuffer(raw, dtype="<f8").astype(np.float64)
    elif tag == _PCM and bits == 8:
        # 8-bit PCM is unsigned with a 128 offset (RIFF legacy convention)
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float64) - 128.0) / 128.0
    elif tag == _PCM and bits == 16:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float64) / 32768.0
    elif tag == _PCM and bits == 32:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float64) / 2147483648.0
    elif tag == _PCM and bits == 24:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        v = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        v = np.where(v >= 1 << 23, v - (1 << 24), v)
        x = v.astype(np.float64) / 8388608.0
    else:
        raise ValueError(f"{path}: unsupported format tag={tag} bits={bits}")
    x = x.reshape(nframes, nch).T  # interleaved -> planar
    return np.ascontiguousarray(x, dtype=dtype), rate


def write_wav(path: str, x: np.ndarray, rate: int, bits: int = 16,
              float_fmt: bool = False) -> None:
    """Write planar (channels, frames) or (frames,) audio to WAV."""
    x = np.asarray(x)
    if x.ndim == 1:
        x = x[None, :]
    nch, nframes = x.shape
    # planar -> interleaved; float64 so integer clip bounds are exact
    # (float32 * 2^31 cannot represent 2^31-1 and overflows at +-1.0)
    inter = np.ascontiguousarray(x.T).astype(np.float64)
    if float_fmt:
        if bits == 64:
            body = inter.astype("<f8").tobytes()
            tag = _FLOAT
        else:
            body = inter.astype("<f4").tobytes()
            tag, bits = _FLOAT, 32
    elif bits == 16:
        body = np.clip(np.round(inter * 32768.0), -32768, 32767).astype("<i2").tobytes()
        tag = _PCM
    elif bits == 32:
        body = (
            np.clip(np.round(inter * 2147483648.0), -(1 << 31), (1 << 31) - 1)
            .astype("<i4")
            .tobytes()
        )
        tag = _PCM
    elif bits == 8:
        body = (np.clip(np.round(inter * 128.0), -128, 127) + 128).astype(np.uint8).tobytes()
        tag = _PCM
    elif bits == 24:
        v = np.clip(np.round(inter * 8388608.0), -(1 << 23), (1 << 23) - 1).astype(np.int32)
        b = np.empty((v.size, 3), dtype=np.uint8)
        flat = v.reshape(-1)
        b[:, 0] = flat & 0xFF
        b[:, 1] = (flat >> 8) & 0xFF
        b[:, 2] = (flat >> 16) & 0xFF
        body = b.tobytes()
        tag = _PCM
    else:
        raise ValueError(f"unsupported bits={bits}")
    balign = nch * bits // 8
    pad = b"\x00" if len(body) % 2 else b""  # RIFF chunks are word-aligned
    hdr = b"RIFF" + struct.pack("<I", 36 + len(body) + len(pad)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, tag, nch, rate, rate * balign, balign, bits)
    hdr += b"data" + struct.pack("<I", len(body))
    with open(path, "wb") as f:
        f.write(hdr + body + pad)


def stream_blocks(path: str, block: int, dtype=np.float32, device="cuda"):
    """Yield planar (channels, block) tensors on ``device``; final block
    zero-padded.  The file moves to the device once; each block is a view.
    """
    x, _ = read_wav(path, dtype)
    n = x.shape[1]
    nblocks = -(-n // block)
    pad = nblocks * block - n
    if pad:
        x = np.pad(x, ((0, 0), (0, pad)))
    x = torch.as_tensor(x, device=device)
    for k in range(nblocks):
        yield x[:, k * block : (k + 1) * block]
