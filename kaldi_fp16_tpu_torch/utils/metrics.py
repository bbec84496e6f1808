"""Structured training metrics: JSONL logging + aggregation.

(The reference logged via fmt.Printf with structured result types,
SURVEY.md §5 observability; this provides a machine-readable stream.)

Copy of kaldi_fp16_tpu/utils/metrics.py; values with an `item()` (numpy
or torch scalars) are logged as Python numbers.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    """Append-only JSONL metrics log with stdout echo."""

    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.path = path
        self.echo = echo
        self._f = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a")
        self._t0 = time.time()

    def log(self, step: int, **metrics) -> None:
        rec: Dict = {"step": step, "time": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            if hasattr(v, "item"):
                v = v.item()
            if isinstance(v, float):
                v = round(v, 6)
            rec[k] = v
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        if self.echo:
            kv = " ".join(f"{k}={v}" for k, v in rec.items() if k != "time")
            print(f"[metrics] {kv}")

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None
