"""The phone-LM denominator graph.

A frozen copy of `make_phone_lm_den_fst` of kaldi_fp16_tpu_torch/chain/
graph.py at commit de5aca0, returning the arcs as arrays: a phone LM over
two-state left-to-right HMMs, as `chain-est-phone-lm | chain-make-den-fst`
produces, at Kaldi's production scale (7052 states, ~113K arcs, 3080 pdfs).
Every state is final with weight 0.  The same seed gives the same graph,
arc for arc, as the port's generator.
"""

from __future__ import annotations

import numpy as np


def phone_lm_arcs(num_pdfs: int = 3080, num_phones: int = 3526,
                  states_per_phone: int = 2, branching: int = 28,
                  seed: int = 0) -> dict:
    """{"src", "dst", "label" (1-based pdf), "weight" (tropical), "states",
    "start"}, arcs in the port generator's order (state by state)."""
    rng = np.random.default_rng(seed)
    S = num_phones * states_per_phone
    pdf_of_state = (np.arange(S, dtype=np.int64) % num_pdfs) + 1
    initials = np.arange(num_phones, dtype=np.int64) * states_per_phone
    arcs = [[] for _ in range(S)]
    for ph in range(num_phones):
        base = ph * states_per_phone
        for k in range(states_per_phone):
            s = base + k
            arcs[s].append((int(pdf_of_state[s]),
                            float(rng.uniform(0.3, 1.2)), s))
            if k + 1 < states_per_phone:
                nxt = s + 1
                arcs[s].append((int(pdf_of_state[nxt]),
                                float(rng.uniform(0.3, 1.2)), nxt))
        last = base + states_per_phone - 1
        succ = rng.choice(num_phones, size=min(branching, num_phones),
                          replace=False)
        for sp in succ:
            dst = int(initials[sp])
            arcs[last].append((int(pdf_of_state[dst]),
                               float(rng.uniform(1.0, 4.0)), dst))
    src = np.asarray([s for s in range(S) for _ in arcs[s]], np.int64)
    flat = [a for s in range(S) for a in arcs[s]]
    return {"src": src,
            "label": np.asarray([a[0] for a in flat], np.int64),
            "weight": np.asarray([a[1] for a in flat], np.float64),
            "dst": np.asarray([a[2] for a in flat], np.int64),
            "states": S, "start": 0}


def den_arcs(den_cfg: dict) -> dict:
    """The arcs of a configuration's "den" entry."""
    if den_cfg["generator"] != "phone_lm":
        raise ValueError(f"unknown den generator {den_cfg['generator']!r}")
    return phone_lm_arcs(den_cfg["num_pdfs"], den_cfg["num_phones"],
                         den_cfg["states_per_phone"], den_cfg["branching"],
                         den_cfg["seed"])
