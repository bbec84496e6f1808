"""denverify: the denominator against the float64 oracle and the dense
brute force, on zero and random outputs.

The twin of tools/denverify.py: the same graph (the den.fst given, or a
seed-0 12-state random one), the same inputs and the same lines, with the
den on --device (default: the current CUDA device) and TF32 off.

Usage:
  python -m kaldi_fp16_tpu_torch.tools.denverify [--den-fst PATH]
      [--pdfs 24] [--frames 10] [--tol 2e-3] [--device cpu]

`main(argv)` returns {"failures", "rows": [{name, logprob, oracle, brute,
err_oracle, err_brute, grad_err, ok}]}; run as a program it exits 1 on a
failure.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from kaldi_fp16_tpu_torch.chain.denominator import DenominatorComputation
from kaldi_fp16_tpu_torch.chain.graph import (
    DenominatorGraph, make_simple_den_fst,
)
from kaldi_fp16_tpu_torch.chain.reference import (
    denominator_brute_force, denominator_forward_backward_ref,
)
from kaldi_fp16_tpu_torch.io.fst import read_fst_file
from kaldi_fp16_tpu_torch.ops.den_matmul import fp32_matmuls
from kaldi_fp16_tpu_torch.tools._common import device_arg, tool_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m kaldi_fp16_tpu_torch.tools.denverify",
        description=__doc__.split("\n")[0])
    ap.add_argument("--den-fst")
    ap.add_argument("--pdfs", type=int, default=24)
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--tol", type=float, default=2e-3)
    device_arg(ap)
    args = ap.parse_args(argv)
    dev = tool_device("denverify", args.device)

    if args.den_fst:
        fst = read_fst_file(args.den_fst)
        print(f"den.fst: {fst.num_states} states, {fst.num_arcs} arcs")
    else:
        fst = make_simple_den_fst(num_pdfs=args.pdfs, num_states=12, seed=0)
        print(f"synthetic den fst: {fst.num_states} states, "
              f"{fst.num_arcs} arcs")
    graph = DenominatorGraph.from_fst(fst, args.pdfs)
    print(f"initial probs: sum={graph.initial.sum():.6f} "
          f"nonzero={int((graph.initial > 0).sum())}/{graph.num_states}")

    failures = 0
    rows = []
    rng = np.random.default_rng(0)
    inputs = [("zero", np.zeros((args.frames, args.pdfs))),
              ("random", rng.normal(size=(args.frames, args.pdfs)) * 0.5)]
    with fp32_matmuls():
        den = DenominatorComputation(graph, leaky=1e-5, device=dev)
        for name, out in inputs:
            ref_lp, ref_grad = denominator_forward_backward_ref(graph, out)
            bf_lp = denominator_brute_force(graph, out, leaky=1e-5)
            lp, grad = den.forward_backward(
                torch.from_numpy(out[None].astype(np.float32)).to(dev))
            lp, grad = float(lp[0]), grad[0].cpu().numpy()
            err_ref = abs(lp - ref_lp)
            err_bf = abs(ref_lp - bf_lp)
            err_grad = float(np.abs(grad - ref_grad).max())
            ok = err_ref < args.tol and err_bf < 1e-8 and err_grad < args.tol
            print(f"[{name}] logprob: device={lp:.6f} oracle={ref_lp:.6f} "
                  f"brute={bf_lp:.6f}")
            print(f"  |device-oracle|={err_ref:.2e} |oracle-brute|="
                  f"{err_bf:.2e} grad max|err|={err_grad:.2e}  "
                  f"{'OK' if ok else 'FAIL'}")
            rows.append(dict(name=name, logprob=lp, oracle=ref_lp,
                             brute=bf_lp, err_oracle=err_ref,
                             err_brute=err_bf, grad_err=err_grad, ok=ok))
            if not ok:
                failures += 1
    print("PASS" if failures == 0 else "FAIL")
    return {"failures": failures, "rows": rows}


if __name__ == "__main__":
    sys.exit(1 if main()["failures"] else 0)
