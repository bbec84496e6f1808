"""(M or M^T) @ v for the structured denominator's constant [F, F] matrix.

The port of kaldi_fp16_tpu/ops/pallas_den_matmul.py (`PallasDenMatmul`).
The structured den scans apply the phone-LM residual matrix M to a
[F, N] vector once per frame in each direction, 2*T = 98 times per
training step at production scale (F = 3526, N = 128).

`DenMatmul.apply` launches the hand-written CUDA kernel
(csrc/den_matmul.cu) for a CUDA tensor; for a CPU tensor it computes the
plain version, `den_matmul_plain`, which the tests compare against.  A
CUDA tensor never falls back to the plain version: if the kernel cannot
be built or launched, the call raises.
"""

from __future__ import annotations

import contextlib

import torch


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


class DenMatmul:
    """A constant fp32 matrix M on `device`, applied by the CUDA kernel.

    `launches` counts kernel launches across all instances: a run can read
    it to show that its path went through the kernel.
    """

    launches = 0

    def __init__(self, M, device=None):
        M = torch.as_tensor(M, dtype=torch.float32, device=device)
        if M.ndim != 2 or M.shape[0] != M.shape[1]:
            raise ValueError(f"M must be square [F, F], got {tuple(M.shape)}")
        self.M = M.contiguous()
        self.F = int(M.shape[0])

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
        from kaldi_fp16_tpu_torch.ops._build import library
        with torch.cuda.device(v.device):
            stream = torch.cuda.current_stream(v.device).cuda_stream
            err = library().den_matmul(self.M.data_ptr(), v.data_ptr(),
                                       out.data_ptr(), self.F, n,
                                       int(bool(transpose)), stream)
        if err != 0:
            raise RuntimeError(f"den_matmul kernel launch failed: "
                               f"cudaError_t {err}")
        DenMatmul.launches += 1
        return out
