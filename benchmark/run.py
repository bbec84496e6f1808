"""Run one benchmark cell once and print its result line.

  python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout, on a machine with the CUDA devices the
cell asks for; see benchmark/README.md.
"""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# kernel caches of the program at fixed paths inside the checkout
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("USE_FLAX", "0")
sys.path.insert(0, str(ROOT))

from benchmark.harness.core import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
