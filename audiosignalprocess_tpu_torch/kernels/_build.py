"""Build the package's CUDA sources with nvcc and load them with ctypes.

The sources in ``csrc/`` have a plain C interface (no PyTorch headers),
so nvcc builds them in seconds: one compile per ``.cu`` file, all started
together, then one link.  The shared library goes into ``_build/`` beside
``csrc/``, named by a hash of the sources and flags, and is built at
first use; a changed source gets a new library.  The helpers at the end
are what every kernel wrapper shares.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from audiosignalprocess_tpu_torch.utils.profiling import span
from audiosignalprocess_tpu_torch.utils.validate import check

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
DEFAULT_CUDA_HOME = "/usr/local/cuda"
SMEM_LIMIT = 232448
"""Dynamic shared memory one block may use on Hopper (227 KB)."""
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libasp_kernels_{digest.hexdigest()[:16]}.so"


def _nvcc() -> str:
    """$CUDA_HOME/bin/nvcc, else nvcc on PATH, else the toolkit's default place."""
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path(DEFAULT_CUDA_HOME) / "bin" / "nvcc")
    for cand in candidates:
        if cand.is_file():
            return str(cand)
    raise RuntimeError(
        f"nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        f"{DEFAULT_CUDA_HOME}/bin): the CUDA kernels are built from csrc/ "
        f"with the CUDA toolkit at first use")


def build() -> tuple[Path, str]:
    """Build the library unless it exists; returns (path, compiler log).

    The log holds ptxas's register and shared-memory report when this call
    compiled, and is empty when the library was already there.
    """
    out = library_path()
    if out.is_file():
        return out, ""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(exist_ok=True)
    stem = f"{out.stem}.{os.getpid()}"
    srcs = [src for src in _sources() if src.suffix == ".cu"]
    objs = [BUILD_DIR / f"{stem}.{src.stem}.o" for src in srcs]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(srcs, objs)]
    tmp = out.with_name(f"{stem}.tmp")
    try:
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for cmd in cmds]
        log = []
        for cmd, proc in zip(cmds, procs):
            log.append(proc.communicate()[0])
            if proc.returncode != 0:
                for p in procs:
                    p.wait()
                raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                                   f"{' '.join(cmd)}\n{log[-1]}")
        link = [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                               f"{' '.join(link)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        for f in [tmp, *objs]:
            f.unlink(missing_ok=True)
    return out, "".join(log)


@functools.cache
def load() -> ctypes.CDLL:
    """The built library (building it first if needed), loaded once per
    process: a step kernel launches once per block, and hashing the
    sources at every launch would cost host time on each one."""
    return ctypes.CDLL(str(build()[0]))


# ---------------------------------------------------------------------------
# what every kernel wrapper shares
# ---------------------------------------------------------------------------

@functools.cache
def kernel_fn(name: str, nargs: int):
    """``name`` from the built library, as ``int name(const Args*...,
    int smem_bytes, int device, void* stream)`` with ``nargs`` argument
    structs; it returns the launch's CUDA error code.  Bound once per
    process."""
    fn = getattr(load(), name)
    fn.argtypes = [ctypes.c_void_p] * nargs + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def raise_on_error(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        fn = load().asp_error_string
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_char_p
        raise RuntimeError(f"{what} kernel launch failed: {fn(rc).decode()} ({rc})")


def launch(what: str, fn, *args) -> None:
    """Launch a kernel: ``fn(*args)``, one of the library's launch
    functions, inside the span ``asp.launch``, raising on the CUDA error
    code it returns.  The arguments are made before the span opens, so the
    span times the launch alone and its wrapper's span the rest."""
    with span("asp.launch"):
        raise_on_error(fn(*args), what)


def rows_view(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """x (..., b) as rows of b samples for a kernel: (x2d, row stride).
    A column slice of a (C, n) stream is used in place (stride n)."""
    b = x.shape[-1]
    xf = x.reshape(-1, b)
    if xf.stride(-1) != 1 or (xf.shape[0] > 1 and xf.stride(0) < b):
        xf = xf.contiguous()
    return xf, (xf.stride(0) if xf.shape[0] > 1 else b)


def check_cuda_f32(x: torch.Tensor, name: str, plain: str) -> None:
    """The kernels take CUDA float32 tensors; anything else raises
    (``plain`` says where float64 goes instead)."""
    check(x.is_cuda, f"{name} runs on CPU or CUDA, not {x.device}")
    check(x.dtype == torch.float32,
          f"the CUDA kernel computes in float32, got {x.dtype} ({plain})")
