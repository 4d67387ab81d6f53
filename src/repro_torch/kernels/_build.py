"""Build the CUDA sources under ``csrc/`` into shared libraries at first use.

Each source is compiled by ``nvcc`` on its own into
``<repo>/build/kernels/lib<name>_<hash>.so`` (the hash covers the source,
the shared headers ``csrc/*.cuh`` and the flags, so an edited source or
header rebuilds and an unchanged one is reused), with a plain C interface
loaded through ctypes.  The compiler's
``-Xptxas -v`` report (registers, shared memory, spills per kernel) is
kept beside the library as ``.log``.  :func:`build_all` starts one
``nvcc`` per source, all at once.  The ctypes glue every launcher shares
(the once-per-process loader, dtype codes, the current stream, the
launch-error check) lives here too.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["BUILD_DIR", "BuildError", "CSRC", "DTYPE_CODE", "LaunchError",
           "NVCC_FLAGS", "STICKY_CUDA_ERRORS", "build_all", "build_library",
           "check_launch", "find_nvcc", "load_library", "stream_of"]

CSRC = Path(__file__).resolve().parent / "csrc"
# src/repro_torch/kernels/_build.py -> repository root
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: cudaError codes that leave the CUDA context unusable: an illegal
#: address (700), a device-side assert (710), a hardware stack error
#: (714), an illegal instruction (715), a misaligned address (716) and an
#: unspecified launch failure (719).  Nothing in the same process can
#: recover from them, so the degradation ladder must not try.
STICKY_CUDA_ERRORS = frozenset({700, 710, 714, 715, 716, 719})


class BuildError(RuntimeError):
    """A kernel source could not be built: no ``nvcc``, or ``nvcc``
    failed on it."""


class LaunchError(RuntimeError):
    """A C launcher returned a CUDA error; ``code`` is the cudaError and
    ``sticky`` says whether it left the context unusable."""

    def __init__(self, name: str, code: int):
        self.code = int(code)
        self.sticky = self.code in STICKY_CUDA_ERRORS
        super().__init__(f"{name}: CUDA launch failed with cudaError "
                         f"{self.code}" + (" (sticky)" if self.sticky else ""))


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's default location.  Raises when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise BuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin);"
        " the CUDA kernels are built from source at first use"
    )


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for ``csrc/<name>.cu``; returns (target, tmp, process) or
    (target, None, None) when the library is already built."""
    out = _target(name)
    if out.exists():
        return out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return out, tmp, proc


def _finish(name: str, out: Path, tmp, proc) -> Path:
    if proc is None:
        return out
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        if tmp.exists():
            tmp.unlink()
        raise BuildError(f"nvcc failed on csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent reader sees all or nothing
    return out


def build_library(name: str) -> Path:
    """Build ``csrc/<name>.cu`` if needed; returns the library's path."""
    return _finish(name, *_start(name))


def build_all(names=None) -> dict:
    """Build every source (or ``names``) with one nvcc each, started
    together; returns ``{name: library path}``."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    started = {n: _start(n) for n in names}
    built, errors = {}, []
    for n in names:  # wait for every nvcc before raising any failure
        try:
            built[n] = _finish(n, *started[n])
        except BuildError as e:
            errors.append(e)
    if errors:
        raise errors[0]
    return built


# ---------------------------------------------------------------------------
# ctypes glue shared by the launchers
# ---------------------------------------------------------------------------

#: the ``dtype`` argument of every C launcher
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
P = ctypes.c_void_p  # pointers and the stream
I = ctypes.c_int  # noqa: E741
F = ctypes.c_float

_loaded: dict = {}  # name -> CDLL, once per process


def load_library(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``'s library once per
    process; ``signatures`` maps each C launcher to its argtypes (every
    launcher returns a CUDA error code as an int)."""
    if name not in _loaded:
        lib = ctypes.CDLL(str(build_library(name)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = I
        _loaded[name] = lib
    return _loaded[name]


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a pointer value."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_launch(name: str, err: int) -> None:
    """Raise :class:`LaunchError` if a C launcher returned a CUDA error
    code."""
    if err != 0:
        raise LaunchError(name, err)
