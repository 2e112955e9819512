"""ctypes binding of the native WAV I/O and ring buffer (``native/asp_io.c``).

The JAX package's ``io/wav_native``: RIFF probe and decode straight to
planar float32 in C, PCM 8/16/24/32 and float32 encode, a sequential
block reader (``WavReader``) and a single-producer/single-consumer float32
ring (``RingBuffer``), which the config-5 driver's ring mode uses to
overlap host decode with device compute.

``native/asp_io.c`` is a byte-for-byte copy of the JAX package's source.
``lib()`` builds it with ``cc -O2 -shared -fPIC`` at first use into the
package's ``_build/`` directory (beside the CUDA library), named by a hash
of the source and the flags, so a changed source gets a new library and
nothing is written beside the source.  ctypes releases the GIL during
each call, so a producer thread and the consumer run the C loops at once.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from audiosignalprocess_tpu_torch.utils.validate import check

_PKG = Path(__file__).resolve().parent.parent
SRC = _PKG / "native" / "asp_io.c"
BUILD_DIR = _PKG / "_build"
CC_FLAGS = ("-O2", "-shared", "-fPIC")


class WavInfo(ctypes.Structure):
    _fields_ = [
        ("sample_rate", ctypes.c_int),
        ("num_channels", ctypes.c_int),
        ("num_frames", ctypes.c_long),
        ("bits", ctypes.c_int),
        ("float_fmt", ctypes.c_int),
    ]


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    digest = hashlib.sha256(" ".join(CC_FLAGS).encode())
    digest.update(SRC.read_bytes())
    return BUILD_DIR / f"libasp_io_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Build the library unless it exists; returns its path.  Raises a
    RuntimeError naming the command when ``cc`` is missing or fails."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
    cmd = ["cc", *CC_FLAGS, "-o", str(tmp), str(SRC)]
    if shutil.which("cc") is None:
        raise RuntimeError(f"cc not found on PATH: the native WAV reader and ring are built "
                           f"at first use with: {' '.join(cmd)}")
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"cc failed with code {proc.returncode}:\n{' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


@functools.cache
def lib() -> ctypes.CDLL:
    """The built library (building it first if needed), loaded once per
    process with every function's argument and return types set."""
    lb = ctypes.CDLL(str(build()))
    vp, fp, i, lg = ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_long
    sigs = {
        "asp_wav_probe": ([ctypes.c_char_p, ctypes.POINTER(WavInfo)], i),
        "asp_wav_read": ([ctypes.c_char_p, fp, lg], lg),
        "asp_wav_write": ([ctypes.c_char_p, fp, i, lg, i, i, i], i),
        "asp_wav_open": ([ctypes.c_char_p], vp),
        "asp_wav_reader_info": ([vp, ctypes.POINTER(WavInfo)], i),
        "asp_wav_read_block": ([vp, fp, lg], lg),
        "asp_wav_reader_close": ([vp], None),
        "asp_ring_create": ([i, lg], vp),
        "asp_ring_destroy": ([vp], None),
        "asp_ring_writable": ([vp], lg),
        "asp_ring_readable": ([vp], lg),
        "asp_ring_push": ([vp, fp, lg], lg),
        "asp_ring_pop": ([vp, fp, lg, i], lg),
    }
    for name, (args, res) in sigs.items():
        fn = getattr(lb, name)
        fn.argtypes = args
        fn.restype = res
    return lb


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


_ERRORS = {  # asp_io.c's return codes
    -1: "cannot open file / out of memory",
    -2: "not a RIFF/WAVE file",
    -3: "truncated or malformed fmt chunk",
    -4: "missing or inconsistent fmt/data chunks",
    -5: "no data chunk payload",
    -6: "unsupported PCM bit depth",
    -7: "unsupported format (decoder handles PCM 8/16/24/32 and float 32/64)",
    -8: "file would exceed the 4 GiB RIFF size limit",
    -9: "float64 output unsupported by the native (float32) encoder — "
        "use io.wav.write_wav",
}


def _err(path: str, what: str, rc: int) -> ValueError:
    return ValueError(
        f"{path}: WAV {what} failed ({rc}: {_ERRORS.get(rc, 'unknown error')})")


def probe(path: str) -> WavInfo:
    info = WavInfo()
    rc = lib().asp_wav_probe(path.encode(), ctypes.byref(info))
    if rc:
        raise _err(path, "probe", rc)
    return info


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Native decode -> (planar float32 (channels, frames), rate)."""
    info = probe(path)
    out = np.empty((info.num_channels, info.num_frames), dtype=np.float32)
    got = lib().asp_wav_read(path.encode(), _fp(out), info.num_frames)
    if got < 0:
        raise _err(path, "read", got)
    return out[:, :got], info.sample_rate


def write_wav(path: str, x: np.ndarray, rate: int, bits: int = 16,
              float_fmt: bool = False) -> None:
    x = np.ascontiguousarray(np.asarray(x, dtype=np.float32))
    if x.ndim == 1:
        x = x[None, :]
    rc = lib().asp_wav_write(path.encode(), _fp(x), x.shape[0], x.shape[1],
                             rate, bits, int(float_fmt))
    if rc:
        raise _err(path, "write", rc)


class WavReader:
    """Sequential native block decoder: pulls planar float32 blocks
    without loading the file (the decode side of the ring)."""

    def __init__(self, path: str):
        self._h = lib().asp_wav_open(path.encode())
        if not self._h:
            raise ValueError(f"{path}: WAV open failed")
        info = WavInfo()
        lib().asp_wav_reader_info(self._h, ctypes.byref(info))
        self.rate = info.sample_rate
        self.channels = info.num_channels
        self.num_frames = info.num_frames

    def read_block(self, frames: int) -> np.ndarray:
        """Next (channels, <=frames) planar block; empty at EOF."""
        out = np.empty((self.channels, frames), dtype=np.float32)
        got = lib().asp_wav_read_block(self._h, _fp(out), frames)
        if got < 0:
            raise ValueError(f"WAV block read failed ({got})")
        return out[:, :got]

    def close(self) -> None:
        if getattr(self, "_h", None):
            lib().asp_wav_reader_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 -- interpreter shutdown
            pass


class RingBuffer:
    """SPSC float32 planar ring buffer (native): one thread pushes, one
    pops."""

    def __init__(self, channels: int, capacity: int):
        self.channels = channels
        self.capacity = capacity
        self._h = lib().asp_ring_create(channels, capacity)

    def __del__(self):
        try:
            lib().asp_ring_destroy(self._h)
        except Exception:  # noqa: BLE001 -- interpreter shutdown
            pass

    @property
    def writable(self) -> int:
        return lib().asp_ring_writable(self._h)

    @property
    def readable(self) -> int:
        return lib().asp_ring_readable(self._h)

    def push(self, x: np.ndarray) -> int:
        """Push planar (channels, frames); returns the frames it took."""
        x = np.ascontiguousarray(x, dtype=np.float32)
        check(x.shape[0] == self.channels,
              f"pushed {x.shape[0]} channels into a {self.channels}-channel ring")
        return lib().asp_ring_push(self._h, _fp(x), x.shape[1])

    def pop(self, frames: int, pad: bool = True,
            out: np.ndarray | None = None) -> tuple[np.ndarray, int]:
        """Pop up to ``frames`` frames: (a fresh (channels, frames) array,
        or ``out``, and the frames popped; short reads zero-padded when
        ``pad``).  ``out`` (C-contiguous float32 (channels, frames)) lets
        the consumer pop straight into pinned memory for an upload."""
        if out is None:
            out = np.empty((self.channels, frames), dtype=np.float32)
        check(out.shape == (self.channels, frames) and out.dtype == np.float32
              and out.flags.c_contiguous,
              f"out must be C-contiguous float32 {(self.channels, frames)}")
        got = lib().asp_ring_pop(self._h, _fp(out), frames, int(pad))
        return out, got
