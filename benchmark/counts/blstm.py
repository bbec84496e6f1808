"""Work of a TDNN-BLSTM training step, from the shapes: counts/lstmp.py's
recurrence work (`recurrence_work`) for each fast-lstmp layer in the
direction of its delay's sign, at the steps it walks in the program's
step, and the step's FLOPs as counts/lstmp.py's `step_flops` counts them.

A forward layer (delay < 0) walks the grid steps from the first at which
its input is defined to the chunk's last; a reverse one (delay > 0) from
the last at which its input is defined (the chunk's right edge less the
context below it) down to the chunk's first.  The work of one step is the
same either way.
"""

from __future__ import annotations

from benchmark.counts.lstmp import defined_from, grid_geometry, recurrence_work


def defined_until(model, frames_in: int) -> dict:
    """The last input frame at which each layer is defined."""
    hi = {}
    for l in model.layers:
        if l.kind == "input":
            hi[l.name] = frames_in - 1
            continue
        hi[l.name] = min(hi[s] - o for s, o in l.inputs if o is not None)
        if l.kind == "output-layer":
            hi[l.name] += int(l.num("output-delay", 0))
    return hi


def recurrences(model, batch: int, frames_in: int, stride: int, left: int,
                op_bytes: int = 2) -> list:
    """[(layer, steps, reverse, recurrence_work)] of each fast-lstmp layer
    in the program's step."""
    geo = grid_geometry(model, frames_in, stride, left)
    lo, hi = defined_from(model), defined_until(model, frames_in)
    out = []
    for l in model.layers:
        if l.kind != "fast-lstmp-layer":
            continue
        f0, rate, n = geo[l.name]
        reverse = int(l.opts.get("delay", -1)) > 0
        if reverse:
            steps = max(0, min(n - 1, (hi[l.name] - f0) // rate) + 1)
        else:
            steps = n - min(n, max(0, -((f0 - lo[l.name]) // rate)))
        out.append((l.name, steps, reverse, recurrence_work(
            batch, steps, int(l.opts["cell-dim"]),
            int(l.opts["recurrent-projection-dim"]), op_bytes)))
    return out


def bound(model, batch: int, frames_in: int, stride: int, left: int,
          reverse: bool) -> dict:
    """The least time a step on the card of the recurrence kernels of one
    direction (the larger of operations over the bf16 peak and bytes over
    HBM bandwidth, per layer and pass), and their launches a step."""
    work = [w for _, _, rev, w in recurrences(model, batch, frames_in,
                                              stride, left) if rev == reverse]
    return {"bound_s_per_step": sum(w["forward"]["bound_s"]
                                    + w["backward"]["bound_s"] for w in work),
            "launches_per_step": 2 * len(work)}


def step_flops(model, batch: int, frames_in: int, stride: int,
               left: int) -> float:
    """FLOPs of one training step's network forward and backward: every
    matmul's forward, the weight gradient of every trainable one and the
    input gradient where the input carries a gradient to a trainable leaf
    (the fixed LDA: its forward only), at the frames each layer runs; the
    recurrences' products over the steps they walk."""
    geo = grid_geometry(model, frames_in, stride, left)
    steps = {name: n for name, n, _, _ in recurrences(model, batch, frames_in,
                                                       stride, left)}
    grad = set()           # layers whose output carries a gradient
    total = 0.0
    for l in model.layers:
        if l.kind == "input":
            continue
        rows = batch * geo[l.name][2]
        grad_in = any(s in grad for s, _ in l.inputs)
        if l.kind == "fixed-affine-layer":
            total += 2.0 * rows * l.in_dim * l.dim
            continue
        if l.kind in ("relu-renorm-layer", "output-layer"):
            mats = [(rows, l.in_dim, l.dim, grad_in)]
        else:
            C = int(l.opts["cell-dim"])
            R = int(l.opts["recurrent-projection-dim"])
            rec = batch * steps[l.name]
            mats = [(rows, l.in_dim, 4 * C, grad_in),   # the hoisted product
                    (rows, C, l.dim - R, True),         # W_rp's other columns
                    (rec, R, 4 * C, True),              # the recurrence's
                    (rec, C, R, True)]
        for n, fan_in, fan_out, with_input in mats:
            f = 2.0 * n * fan_in * fan_out
            total += 2.0 * f + (f if with_input else 0.0)
        grad.add(l.name)
    return total
