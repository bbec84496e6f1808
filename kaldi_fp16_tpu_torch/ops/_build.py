"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every `csrc/*.cu` file is compiled for Hopper (`sm_90a`), one nvcc
process per source, all started together, and the objects are linked into
one shared library with a plain C interface, at first use, under
`<checkout>/build/kaldi_fp16_tpu_torch/<hash>/`.  The hash covers the
sources, the `csrc/*.cuh` headers they include and the flags, so an edited
kernel is rebuilt and an unchanged one is reused.  No PyTorch headers are
involved, so a build takes seconds.

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

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kaldi_fp16_tpu_torch"
LIB_NAME = "libkaldi_fp16_tpu_torch.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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
    nvcc = _nvcc()
    t0 = time.perf_counter()
    # compile every source at once into a private directory, then link and
    # rename: a concurrent build never sees a half-written library
    work = Path(tempfile.mkdtemp(dir=out_dir))
    compiles = []
    for src in srcs:
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(work / (src.stem + ".o")),
               str(src)]
        compiles.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for cmd, proc in compiles:
        out = proc.communicate()[0]
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} (exit {proc.returncode}):\n{out[-4000:]}")
    if not failed:
        cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(work / LIB_NAME),
               *(str(work / (src.stem + ".o")) for src in srcs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link (exit {proc.returncode}):\n"
                          f"{proc.stderr[-4000:]}")
    seconds = time.perf_counter() - t0
    (out_dir / "build.log").write_text("\n".join(log))
    if failed:
        shutil.rmtree(work, ignore_errors=True)
        raise BuildError("nvcc failed: " + "\n".join(failed))
    os.replace(work / LIB_NAME, lib)
    shutil.rmtree(work, ignore_errors=True)
    return lib, seconds


def launch(name: str, dev: torch.device, *args) -> None:
    """Call the C entry point `name` on `dev`'s current stream.  Tensors
    are passed as pointers (each must be contiguous), other arguments as
    they are; a launch error raises."""
    for a in args:
        if isinstance(a, torch.Tensor) and not a.is_contiguous():
            raise ValueError(f"{name}: every tensor must be contiguous")
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(library(), name)(*c_args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernels, loaded once per process, with C signatures set."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # den_split_v(v, panels, F, n, Fp, stream) -> cudaError_t
    lib.den_split_v.argtypes = [p, p, i, i, i, p]
    lib.den_split_v.restype = i
    # den_split_planes(M, planes, F, Fp, stream)
    lib.den_split_planes.argtypes = [p, p, i, i, p]
    lib.den_split_planes.restype = i
    # den_mma_slices(Fp, np) -> K slices of the product
    lib.den_mma_slices.argtypes = [i, i]
    lib.den_mma_slices.restype = i
    # den_matmul(A, pre, v, out, panels, ws, F, Fp, n, slices, transpose,
    #            terms, stream)
    lib.den_matmul.argtypes = [p, i, p, p, p, p] + [i] * 6 + [p]
    lib.den_matmul.restype = i
    # den_scan_forward(A, pre, xs_self, xs_fwd, xs_res, init, state, parts,
    #                  panels, ws, hist, asum, logc, a_final,
    #                  L, F, N, T, slices, terms, leaky, stream)
    lib.den_scan_forward.argtypes = [p, i] + [p] * 12 + [i] * 6 + [f, p]
    lib.den_scan_forward.restype = i
    # den_scan_backward(A, pre, xs_self, xs_fwd, xs_res, asum, init, real,
    #                   total, state, parts, panels, ws, tot, hist,
    #                   L, F, N, T, slices, terms, leaky, stream)
    lib.den_scan_backward.argtypes = [p, i] + [p] * 13 + [i] * 6 + [f, p]
    lib.den_scan_backward.restype = i
    lib.den_scan_row_block.argtypes = []
    lib.den_scan_row_block.restype = i
    # segment_order(labels, order, offsets, NB, K, sb, stream)
    lib.segment_order.argtypes = [p, p, p, i, i, i, p]
    lib.segment_order.restype = i
    # segment_reduce(vals, labels, order, offsets, out, NB, K, n, sb, exact,
    #                stream)
    lib.segment_reduce.argtypes = [p] * 5 + [i] * 5 + [p]
    lib.segment_reduce.restype = i
    # chain_numerator(x, arc_src, arc_dst, arc_pdf, arc_logw, arc_mask,
    #                 start, final_logw, alpha_hist, total, post,
    #                 B, T, P, S, A, stream)
    lib.chain_numerator.argtypes = [p] * 11 + [i] * 5 + [p]
    lib.chain_numerator.restype = i
    lib.numerator_max_states.argtypes = []
    lib.numerator_max_states.restype = i
    lib.numerator_max_arcs.argtypes = []
    lib.numerator_max_arcs.restype = i
    # lstmp_forward(z, wr, peep, wrr, br, c, m, r, gates, bar,
    #               B, T, C, R, start, D, s, bf16, reverse, stream)
    lib.lstmp_forward.argtypes = [p] * 10 + [i] * 6 + [f, i, i, p]
    lib.lstmp_forward.restype = i
    # lstmp_backward(gates, c, wr, peep, wrr, g_r, g_m, dz, drt, rc, rr,
    #                parts, bar, B, T, C, R, start, D, lo, hi, s, clip, zthr,
    #                zi, rec, frame0, frame_step, reverse, stream)
    lib.lstmp_backward.argtypes = [p] * 13 + [i] * 8 + [f] * 3 + [i] * 5 + [p]
    lib.lstmp_backward.restype = i
    return lib
