"""FST data classes: the port's own copy of what it uses of
kaldi_fp16_tpu/io/fst.py (the dataclasses, not the OpenFst binary reader
and writer).  Weights are tropical = -log(prob); a final weight of +inf
means not final.  numpy-free, torch-free.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List

INF = float("inf")


@dataclass
class FstArc:
    label: int          # ilabel (== olabel for acceptors); pdf-id + 1 for chain FSTs
    weight: float       # tropical: -log(prob)
    next_state: int
    olabel: int = -1    # output label for transducers (HCLG); -1 => acceptor

    def __post_init__(self):
        if self.olabel < 0:
            self.olabel = self.label


@dataclass
class FstState:
    final: float = INF  # final weight; +inf means not final
    arcs: List[FstArc] = field(default_factory=list)

    @property
    def is_final(self) -> bool:
        return not math.isinf(self.final)


@dataclass
class Fst:
    start: int
    states: List[FstState]
    properties: int = 0

    @property
    def num_states(self) -> int:
        return len(self.states)

    @property
    def num_arcs(self) -> int:
        return sum(len(s.arcs) for s in self.states)
