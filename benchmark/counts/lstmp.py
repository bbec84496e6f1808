"""Work of Kaldi's fast-lstmp recurrence and of a TDNN-LSTM training step,
from the shapes, as the algorithm needs it (not as the program's kernel
happens to move it).

The recurrence of one layer over `steps` steps of B sequences (C cells, R
recurrent projections, operands of `op_bytes` bytes):

- forward: per step a [B, R] x [R, 4C] and a [B, C] x [C, R] product and
  the cell (GATE_OPS operations a cell); bytes: the gates' float32
  pre-activations read once, c (float32), m (operands) and r (float32)
  written once, the two recurrent weights read once;
- backward: per step dm = dr W_rr^T and dr' = dz W_r^T and the cell's
  backward (GATE_BWD_OPS a cell); bytes: the saved gates and c and the
  derivatives of r and m read once, the gates' derivatives and r's written
  once, the weights once.

`step_flops` counts a whole training step of the TDNN-LSTM as
counts/network.py counts the others: every matmul's forward, the weight
gradient of every trainable one and the input gradient where the input
carries a gradient to a trainable leaf (the fixed LDA: its forward only),
at the frames each layer runs: the full rate below the first recurrence,
the grid (shifted by the output-delay) from there on; the recurrences'
products over the steps they run, forward, backward and weight gradients.
"""

from __future__ import annotations

from benchmark.counts.peaks import H100_PEAK_BF16_FLOPS, H100_PEAK_HBM_BYTES

GATE_OPS = 20          # three sigmoids, two tanh, the peepholes, c and m
GATE_BWD_OPS = 30


def _bound(flops: float, nbytes: float) -> dict:
    t_flops = flops / H100_PEAK_BF16_FLOPS
    t_bytes = nbytes / H100_PEAK_HBM_BYTES
    return {"flops": flops, "bytes": nbytes,
            "bound_s": max(t_flops, t_bytes),
            "bound_by": "bytes" if t_bytes >= t_flops else "compute"}


def recurrence_work(B: int, steps: int, C: int, R: int,
                    op_bytes: int = 2) -> dict:
    """{"forward": {...}, "backward": {...}}: each {"flops", "bytes",
    "bound_s", "bound_by"} of one layer's pass."""
    rows = B * steps
    weights = op_bytes * (R * 4 * C + C * R)
    fwd_flops = steps * (2.0 * B * R * 4 * C + 2.0 * B * C * R
                         + GATE_OPS * B * C)
    fwd_bytes = rows * (4 * 4 * C + 4 * C + op_bytes * C + 4 * R) + weights
    bwd_flops = steps * (2.0 * B * R * C + 2.0 * B * 4 * C * R
                         + GATE_BWD_OPS * B * C)
    bwd_bytes = (rows * (4 * 4 * C + 4 * C + 4 * R + 4 * C)
                 + rows * (4 * 4 * C + 4 * R) + weights)
    return {"forward": _bound(fwd_flops, float(fwd_bytes)),
            "backward": _bound(bwd_flops, float(bwd_bytes))}


def grid_geometry(model, frames_in: int, stride: int, left: int) -> dict:
    """Where each layer of a reference model (reference/tdnn_lstm.py) runs
    in the program's step: {layer: (first input frame, frames a step,
    frames)}, with the grid seeded at the outputs and shifted below them by
    their output-delay."""
    consumers = {l.name: [] for l in model.layers}
    for l in model.layers:
        for src, _ in l.inputs:
            consumers[src].append(l.name)
    grid = set()
    for l in reversed(model.layers):
        offs_ok = all(o is None or o % stride == 0 for _, o in l.inputs)
        if l.kind == "fast-lstmp-layer":
            offs_ok = offs_ok and int(l.opts.get("delay", -1)) % stride == 0
        if l.kind == "input" or not offs_ok:
            continue
        cons = consumers[l.name]
        if (l.kind == "output-layer" and not cons) or (
                cons and all(c in grid for c in cons)):
            grid.add(l.name)
    n_grid = (frames_in - stride) // stride + 1
    p0 = left % stride
    delay = max((int(l.num("output-delay", 0)) for l in model.layers
                 if l.kind == "output-layer" and l.name in grid), default=0)
    shifted = p0 - delay
    pad_lo = max(0, -(shifted // stride))
    last = shifted + (n_grid - 1) * stride
    pad_hi = max(0, -((frames_in - 1 - last) // stride))
    q0, n_q = shifted + pad_lo * stride, n_grid - pad_lo - pad_hi
    out = {}
    for l in model.layers:
        if l.name not in grid:
            out[l.name] = (0, 1, frames_in)
        elif l.kind == "output-layer":
            out[l.name] = (p0, stride, n_grid)
        else:
            out[l.name] = (q0, stride, n_q)
    return out


def defined_from(model) -> dict:
    """The first input frame at which each layer is defined."""
    lo = {}
    for l in model.layers:
        if l.kind == "input":
            lo[l.name] = 0
            continue
        lo[l.name] = max(lo[s] - o for s, o in l.inputs if o is not None)
        if l.kind == "output-layer":
            lo[l.name] += int(l.num("output-delay", 0))
    return lo


def recurrences(model, batch: int, frames_in: int, stride: int, left: int,
                op_bytes: int = 2) -> list:
    """[(layer, steps, recurrence_work)] of each fast-lstmp layer in the
    program's step: the grid steps from the first at which its input is
    defined."""
    geo = grid_geometry(model, frames_in, stride, left)
    lo = defined_from(model)
    out = []
    for l in model.layers:
        if l.kind != "fast-lstmp-layer":
            continue
        f0, rate, n = geo[l.name]
        start = min(n, max(0, -((f0 - lo[l.name]) // rate)))
        steps = n - start
        out.append((l.name, steps, recurrence_work(
            batch, steps, int(l.opts["cell-dim"]),
            int(l.opts["recurrent-projection-dim"]), op_bytes)))
    return out


def step_flops(model, batch: int, frames_in: int, stride: int,
               left: int) -> float:
    """FLOPs of one training step's network forward and backward."""
    geo = grid_geometry(model, frames_in, stride, left)
    steps = {name: n for name, n, _ in recurrences(model, batch, frames_in,
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
            P = l.dim - R
            rec = batch * steps[l.name]
            mats = [(rows, l.in_dim, 4 * C, grad_in),   # the hoisted product
                    (rows, C, P, True),                 # W_rp's other columns
                    (rec, R, 4 * C, True),              # the recurrence's
                    (rec, C, R, True)]
        for n, fan_in, fan_out, with_input in mats:
            f = 2.0 * n * fan_in * fan_out
            total += 2.0 * f + (f if with_input else 0.0)
        grad.add(l.name)
    return total
