"""(M or M^T) @ v for the structured denominator's constant [F, F] matrix.

The port of kaldi_fp16_tpu/ops/pallas_den_matmul.py (`PallasDenMatmul`)
and of the probe _probe_pallas_den.py (`make_msplit`, `make_mpre`).  The
structured den's loop scans apply the phone-LM residual matrix M to a
[F, N] vector once per frame in each direction, 2*T = 98 times per
training step at production scale (F = 3526, N = 128).

`DenMatmul.apply` launches the hand-written CUDA kernels (csrc/den_split.cu
splits v, csrc/den_matmul.cu multiplies on the tensor cores through
csrc/den_mma.cuh) for a CUDA tensor, in the TPU kernel's arithmetic: M and
v split into three bf16 terms each, and `terms` = 3 or 6 of their cross
products summed in fp32.  `split` picks where M is split: "kernel" (each
application reads the fp32 M and splits its tiles in registers, the
package's #3 and the probe's msplit) or "pre" (M split once, here, into
three bf16 planes that every application streams, the probe's mpre).

For a CPU tensor `apply` computes `den_matmul_plain`, one fp32 matmul,
which the tests compare against; `den_matmul_split_plain` is the split
arithmetic in plain PyTorch, for the tests and chip_smoke.py.  A CUDA
tensor never falls back to a plain version: if the kernel cannot be
built or launched, the call raises.
"""

from __future__ import annotations

import contextlib
import functools

import torch

from kaldi_fp16_tpu_torch.device import resolve_device
from kaldi_fp16_tpu_torch.ops._build import launch, library

TILE = 128   # row and column tile of the kernel: F and n are padded to it
# (M plane, v plane) of each cross product, in the TPU kernel's order
SPLIT_PRODUCTS = {3: ((0, 0), (1, 0), (0, 1)),
                  6: ((0, 0), (1, 0), (0, 1), (1, 1), (2, 0), (0, 2))}


@contextlib.contextmanager
def fp32_matmuls():
    """Full-fp32 matrix products (TF32 off for cuBLAS and cuDNN) inside.

    The chain denominator and numerator need the fp32 class: even the TPU's
    2-term bf16 split drifted the den posteriors to ~7e-4
    (docs/PERFORMANCE.md:625-627).  The previous flags are restored on exit.
    """
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def den_matmul_plain(M: torch.Tensor, v: torch.Tensor,
                     transpose: bool) -> torch.Tensor:
    """The plain version: [F, ...] -> [F, ...] = (M^T if transpose else M) @ v
    as one fp32 torch.matmul with TF32 off."""
    F = M.shape[0]
    with fp32_matmuls():
        out = (M.t() if transpose else M) @ v.reshape(F, -1)
    return out.reshape(v.shape)


def split3(x: torch.Tensor):
    """fp32 x -> (x0, x1, x2), three bf16 tensors with x0 = bf16(x), x1 =
    bf16(x - x0), x2 = bf16(x - x0 - x1), each rounded to nearest even."""
    x0 = x.to(torch.bfloat16)
    r = x - x0.float()
    x1 = r.to(torch.bfloat16)
    return x0, x1, (r - x1.float()).to(torch.bfloat16)


def den_matmul_split_plain(M: torch.Tensor, v: torch.Tensor, transpose: bool,
                           terms: int = 6) -> torch.Tensor:
    """The kernels' arithmetic in plain PyTorch: (M^T or M) @ v as the sum
    of `terms` bf16 cross products of the 3-term splits of M and v, each
    product exact in fp32 and summed in fp32, in the TPU kernel's order."""
    if terms not in SPLIT_PRODUCTS:
        raise ValueError(f"terms must be 3 or 6, got {terms}")
    F = M.shape[0]
    m = [p.float() for p in split3(M.t() if transpose else M)]
    w = [p.float() for p in split3(v.reshape(F, -1))]
    with fp32_matmuls():
        out = None
        for i, j in SPLIT_PRODUCTS[terms]:
            prod = m[i] @ w[j]
            out = prod if out is None else out + prod
    return out.reshape(v.shape)


def padded(F: int) -> int:
    return -(-F // TILE) * TILE


@functools.cache
def _slices(Fp: int, np_: int, index: int) -> int:
    with torch.cuda.device(index):
        return int(library().den_mma_slices(Fp, np_))


def slices(Fp: int, np_: int, dev: torch.device) -> int:
    """K slices of the product for an [Fp, np_] output on card `dev`: the
    workspace holds that many fp32 [Fp, np_] partials."""
    return _slices(Fp, np_, dev.index if dev.index is not None
                   else torch.cuda.current_device())


def split_planes(M: torch.Tensor, Fp: int) -> torch.Tensor:
    """M [F, F] fp32 on a card -> its bf16 planes [3, Fp, Fp], zero beyond
    F (csrc/den_split.cu)."""
    F = M.shape[0]
    planes = torch.empty((3, Fp, Fp), dtype=torch.bfloat16, device=M.device)
    launch("den_split_planes", M.device, M, planes, F, Fp)
    return planes


class DenMatmul:
    """A constant fp32 matrix M on `device` (default: the current CUDA
    device), applied by the CUDA kernels.

    split: "kernel" (the fp32 M, split in registers) or "pre" (M split
    once into bf16 planes); terms: 3 or 6 cross products.  `launches` and
    `launches_pre` count kernel applications of each split across all
    instances: a run can read them to show that its path went through the
    kernel.
    """

    launches = 0
    launches_pre = 0

    def __init__(self, M, device=None, split: str = "kernel",
                 terms: int = 6):
        if split not in ("kernel", "pre"):
            raise ValueError(f"split must be 'kernel' or 'pre', got {split!r}")
        if terms not in SPLIT_PRODUCTS:
            raise ValueError(f"terms must be 3 or 6, got {terms}")
        M = torch.as_tensor(M, dtype=torch.float32,
                            device=resolve_device(device))
        if M.ndim != 2 or M.shape[0] != M.shape[1]:
            raise ValueError(f"M must be square [F, F], got {tuple(M.shape)}")
        self.M = M.contiguous()
        self.F = int(M.shape[0])
        self.Fp = padded(self.F)
        self.split = split
        self.terms = terms
        self.A = None      # the kernel's A operand, on a card only
        if self.M.device.type == "cuda":
            if split == "pre":
                self.A = split_planes(self.M, self.Fp)
            elif self.Fp == self.F:
                self.A = self.M
            else:
                self.A = torch.zeros((self.Fp, self.Fp), dtype=torch.float32,
                                     device=self.M.device)
                self.A[:self.F, :self.F] = self.M

    def apply(self, v: torch.Tensor, transpose: bool) -> torch.Tensor:
        """[F, ...] -> [F, ...] = (M^T if transpose else M) @ v."""
        if v.device != self.M.device:
            raise ValueError(f"v is on {v.device}, M on {self.M.device}")
        if v.dtype != torch.float32:
            raise TypeError(f"v must be float32, got {v.dtype}")
        if v.ndim < 1 or v.shape[0] != self.F:
            raise ValueError(f"v must be [F={self.F}, ...], got "
                             f"{tuple(v.shape)}")
        if v.device.type == "cpu":
            return den_matmul_plain(self.M, v, transpose)
        if v.device.type != "cuda":
            raise ValueError(f"no den_matmul kernel for {v.device}")
        if not v.is_contiguous():
            raise ValueError("v must be contiguous")
        n = v.numel() // self.F
        out = torch.empty(v.shape, dtype=torch.float32, device=v.device)
        if n == 0:
            return out
        dev = v.device
        Fp = self.Fp
        np_ = padded(n)
        S = slices(Fp, np_, dev)
        # one scratch allocation: the bf16 panels of v, then the fp32 slice
        # partials
        panel_bytes = 3 * Fp * np_ * 2
        scratch = torch.empty(panel_bytes + S * Fp * np_ * 4,
                              dtype=torch.uint8, device=dev)
        base = scratch.data_ptr()
        launch("den_matmul", dev, self.A, int(self.split == "pre"), v, out,
               base, base + panel_bytes, self.F, Fp, n, S,
               int(bool(transpose)), self.terms)
        if self.split == "pre":
            DenMatmul.launches_pre += 1
        else:
            DenMatmul.launches += 1
        return out
