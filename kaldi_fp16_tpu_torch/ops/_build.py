"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every `csrc/*.cu` file is compiled for Hopper (`sm_90a`) into one shared
library with a plain C interface, at first use, under
`<checkout>/build/kaldi_fp16_tpu_torch/<hash>/`.  The hash covers the
sources and the flags, so an edited kernel is rebuilt and an unchanged one
is reused.  No PyTorch headers are involved, so a build takes seconds.

Only sources in the repository are compiled and nothing is downloaded.
A missing `nvcc` or a failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kaldi_fp16_tpu_torch"
LIB_NAME = "libkaldi_fp16_tpu_torch.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class BuildError(RuntimeError):
    """nvcc is missing or refused the sources."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise BuildError("nvcc not found on PATH or under CUDA_HOME "
                     f"({cuda_home}); the CUDA kernels cannot be built")


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise BuildError(f"no CUDA sources under {CSRC}")
    return srcs


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(srcs + sorted(CSRC.glob("*.cuh"))):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple:
    """Compile the kernels if this source hash has no library yet.

    Returns (library path, seconds spent compiling: 0.0 when reused)."""
    srcs = _sources()
    out_dir = BUILD_ROOT / _digest(srcs)
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib, 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent build never
    # sees a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, srcs)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    (out_dir / "build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise BuildError(f"nvcc failed (exit {proc.returncode}):\n"
                         f"{proc.stderr[-4000:]}")
    os.replace(tmp, lib)
    return lib, seconds


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernels, loaded once per process, with C signatures set."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    # den_matmul(M, v, out, F, n, transpose, stream) -> cudaError_t
    lib.den_matmul.argtypes = [p, p, p, i, i, i, p]
    lib.den_matmul.restype = i
    return lib
