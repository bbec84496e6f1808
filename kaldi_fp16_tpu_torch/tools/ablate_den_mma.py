"""Ablation of the den product tile (csrc/den_mma.cuh): where its time goes.

    python -m kaldi_fp16_tpu_torch.tools.ablate_den_mma [--iters 98]

Builds the den_matmul library (den_matmul.cu, den_split.cu) from copies of
the sources in which one part of the product is cut out, and times one
application (M^T @ v at F = 3526, n = 128, split="kernel", CUDA events,
--iters back-to-back) with each:

  base          the kernel as it is
  no_loads      no copies into shared memory (the products read stale data)
  no_split      A fragments are zeros (no fragment loads, no bf16 split)
  no_products   no wgmma (loads and splits only)
  no_loads_no_split
                the wgmma chain, the barriers and the partial sums alone

each at terms=6 and terms=3, and the base at K slices S = 1..4.  The cut
variants compute wrong products on purpose: only their times mean
anything; the line gives each one's error against float64 so that the
base's correctness shows beside them.  The first line is the card's name
and power limit.  Needs a card and nvcc; builds under
build/kaldi_fp16_tpu_torch/ablate/.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from kaldi_fp16_tpu_torch.ops import _build

LOAD = """                                           int row0, int ct, int ks,
                                           uint64_t* bar) {"""
WAIT = """__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {"""
FRAG = """                                       uint32_t (&a)[3][4]) {"""
ZERO_A = (FRAG + "\n  if (kk >= 0) {\n    for (int p = 0; p < 3; ++p)\n"
          "      for (int q = 0; q < 4; ++q) a[p][q] = 0u;\n    return;\n  }")
PROD = """                                               const char* bs) {"""
VARIANTS = {
    "base": [],
    "no_loads": [(LOAD, LOAD + "\n  if (ks >= 0) return;"),
                 (WAIT, WAIT + "\n  if (parity < 2u) return;")],
    "no_split": [(FRAG, ZERO_A)],
    "no_products": [(PROD, PROD + "\n  if (bs != nullptr) return;")],
    "no_loads_no_split": [(LOAD, LOAD + "\n  if (ks >= 0) return;"),
                          (WAIT, WAIT + "\n  if (parity < 2u) return;"),
                          (FRAG, ZERO_A)],
}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=98)
    return ap.parse_args(argv)


def build_variants(out_root: Path):
    """{variant: ctypes library}, all compiled at once."""
    nvcc = _build._nvcc()
    procs = {}
    for name, subs in VARIANTS.items():
        d = out_root / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        header = (d / "den_mma.cuh").read_text()
        for old, new in subs:
            if header.count(old) != 1:
                raise RuntimeError(f"{name}: the source no longer has the "
                                   f"text this variant cuts at: {old!r}")
            header = header.replace(old, new)
        (d / "den_mma.cuh").write_text(header)
        cmd = [nvcc, *_build.NVCC_FLAGS[:-2], "-shared", "-o",
               str(d / "lib.so"), str(d / "den_matmul.cu"),
               str(d / "den_split.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(out_root / name / "lib.so"))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.den_matmul.argtypes = [p, i, p, p, p, p] + [i] * 6 + [p]
        lib.den_matmul.restype = i
        libs[name] = lib
    return libs


def main(argv=None):
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ablate_den_mma: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    libs = build_variants(_build.BUILD_ROOT / "ablate")
    dev = torch.device("cuda", torch.cuda.current_device())
    F, n, Fp = 3526, 128, 3584
    rng = np.random.default_rng(0)
    M = (rng.random((F, F)) * (rng.random((F, F)) < 0.008)).astype(np.float32)
    v = rng.random((F, n)).astype(np.float32)
    ref = M.astype(np.float64).T @ v.astype(np.float64)
    A = torch.zeros((Fp, Fp), device=dev)
    A[:F, :F] = torch.from_numpy(M).to(dev)
    vd = torch.from_numpy(v).to(dev)
    out = torch.empty((F, n), device=dev)
    panels = torch.empty(3 * Fp * n, dtype=torch.bfloat16, device=dev)
    ws = torch.empty((4, Fp, n), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call(lib, S, terms):
        err = lib.den_matmul(A.data_ptr(), 0, vd.data_ptr(), out.data_ptr(),
                             panels.data_ptr(), ws.data_ptr(), F, Fp, n, S,
                             1, terms, stream)
        if err != 0:
            raise RuntimeError(f"den_matmul launch failed: cudaError_t {err}")

    def time_us(fn):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            fn()
        end.record()
        end.synchronize()
        return 1e3 * start.elapsed_time(end) / args.iters

    rows = []
    for name, lib in libs.items():
        for S in ((1, 2, 3, 4) if name == "base" else (4,)):
            for terms in (6, 3):
                call(lib, S, terms)
                torch.cuda.synchronize()
                rel = float(np.max(np.abs(out.cpu().numpy() - ref)
                                   / (np.abs(ref) + 1e-8)))
                rows.append({"variant": name, "slices": S, "terms": terms,
                             "us": time_us(lambda: call(lib, S, terms)),
                             "max_rel_err_fp64": rel})
    for row in rows:
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
