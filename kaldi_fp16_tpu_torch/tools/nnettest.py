"""nnettest: xconfig parse, model summary and execution order.

The twin of tools/nnettest.py; host work, no device.

Usage: python -m kaldi_fp16_tpu_torch.tools.nnettest [xconfig]
"""

from __future__ import annotations

import argparse
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m kaldi_fp16_tpu_torch.tools.nnettest")
    ap.add_argument("xconfig", nargs="?",
                    default=str(ROOT / "configs" / "cnn_tdnn.xconfig"))
    args = ap.parse_args(argv)

    from kaldi_fp16_tpu_torch.models.model import build_model
    model = build_model(args.xconfig)
    print(model.summary())
    print("\nexecution order:",
          " -> ".join(l.name for l in model.execution_order()))
    chain = model.chain_output()
    xent = model.xent_output()
    print(f"chain output: {chain.name if chain else None}, "
          f"xent output: {xent.name if xent else None}")
    return model


if __name__ == "__main__":
    main()
