"""Plain float32 reference of Kaldi's TDNN-BLSTM chain model (the benchmark's
`tdnn_blstm` configuration): the xconfig, the training forward, the chain
loss, the backward and SGD with momentum and max-change over a run's first
steps.

Written from Kaldi's equations, not from the port's code.  The layer
kinds, their equations and the frames are reference/tdnn_lstm.py's, whose
parser, weights, cell settings and forward recurrence this file takes;
what a BLSTM adds is the fast-lstmp layer with a positive delay d (+3),
which walks backward in time:

- c' = s c_{t+d} and r' = s r_{t+d}, zero where frame t + d is past the
  last frame the layer computes (IfDefined on the right: the last frame at
  which the layer's input is defined, the chunk's right edge less the
  context below the layer), with s = 1 - |d| / decay-time (0.85); the rest
  of the cell is the forward layer's;
- the BackpropTruncationComponent on [c ; r] is the forward layer's: the
  scale s, each row's derivative clipped to norm 30, and zeroed above norm
  15 where floor((t - n) / 20) != floor((t - rec - n) / 20), rec = |d|,
  t the row's time (the frame whose state it carries) from the chunk's
  first supervised frame and n its sequence;
- a layer that reads Append(blstmk-forward, blstmk-backward) reads the two
  layers' outputs side by side at the same frame.

The trainer's derivative window (deriv-truncate-margin, 8 in the recipe)
is tdnn_lstm.py's: input frames before origin - margin - left or after
last + margin + right pass no derivative on, left and right the model's
context; here the right end cuts the reverse walks' first frames.

Departures from Kaldi, each a choice where the repository holds no Kaldi
source to confirm the detail:
- those of reference/tdnn_lstm.py (the zeroing rule as remembered, the
  clipping and zeroing read before the scale, max-change per xconfig
  layer, no self-repair, no NG-SGD);
- the reverse direction's zeroing rule is the forward's, applied to the
  time of the row that carries the state (BackpropTruncationComponent
  takes rec = |delay| from the xconfig whatever the delay's sign, as
  remembered);
- the layer list of the recipe is as remembered (benchmark/configs/
  tdnn_blstm.json `assumed`).

`quant` rounds every matrix product's operands (the controls' float8);
`faults` runs the model with a known fault, to show the comparison's
limits catch it: "no_reverse" (the backward layers walked forward),
"right_edge" (each reverse walk started at the last supervised frame, not
at the right context's edge), "bf16_c" (the cell state held in bf16),
"s1" (no decay scale), and tdnn_lstm.py's "no_peephole".

Plain `torch` only, in float32 with TF32 off; no kernel of the program.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from .chain import DenGraph, chain_objective
from .tdnn_lstm import (  # noqa: F401  (the configuration's model API)
    CONST, Cell, Frames, RLayer, RModel, _Truncation, _frame_window,
    _in_window, _mm, cell_of, hyperparams, load, make_weights, param_shapes,
    parse, recurrence,
)
from .train import sgd_update


def reverse_recurrence(xw: torch.Tensor, w_r, peep, w_rp, b_rp, R: int,
                       lo: int, cell: Cell, origin: int,
                       first: Optional[int] = None, window=None, quant=None,
                       faults=(), stride: int = 1) -> Tuple[torch.Tensor,
                                                            torch.Tensor]:
    """The cell walking back in time over frames lo + j * stride, j = n - 1
    .. 0, of xw [B, n, 4C] (cell.delay > 0, a multiple of the stride): the
    state of frame t + delay where that frame is at or before `first` (the
    walk's first frame; None: the last of xw), else zero.  Returns ([r ; p]
    [B, n, R + P], m [B, n, C])."""
    B, n_frames, G = xw.shape
    C = G // 4
    d = cell.delay
    if d <= 0:
        raise ValueError(f"a reverse walk needs a positive delay, got {d}")
    last = lo + (n_frames - 1) * stride if first is None else first
    rows = torch.arange(B, device=xw.device)
    if "no_peephole" in faults:
        peep = peep * 0.0
    state, ys, ms = {}, [None] * n_frames, [None] * n_frames
    for j in reversed(range(n_frames)):
        t = lo + j * stride
        if t + d <= last and t + d in state:
            c_prev, r_prev = state[t + d]
            # the truncation row of time t + d: a multiple of the interval
            # in (t + d - rec - n, t + d - n]
            tr = t + d - origin
            zero = (torch.div(tr - rows, cell.interval, rounding_mode="floor")
                    != torch.div(tr - d - rows, cell.interval,
                                 rounding_mode="floor"))
            cr = _Truncation.apply(torch.cat([c_prev, r_prev], 1), cell.scale,
                                   cell.clip, cell.threshold, zero)
            cp, rp = cr[:, :C], cr[:, C:]
        else:
            cp = torch.zeros((B, C), device=xw.device)
            rp = torch.zeros((B, R), device=xw.device)
        a = xw[:, j] + _mm(rp, w_r, quant)
        i = torch.sigmoid(a[:, :C] + peep[0] * cp)
        f = torch.sigmoid(a[:, C:2 * C] + peep[1] * cp)
        c = f * cp + i * torch.tanh(a[:, 2 * C:3 * C])
        if "bf16_c" in faults:
            c = c.to(torch.bfloat16).float()
        o = torch.sigmoid(a[:, 3 * C:] + peep[2] * c)
        m = o * torch.tanh(c)
        y = _mm(m, w_rp, quant) + b_rp
        if not _in_window(t, window):
            c, y, m = c.detach(), y.detach(), m.detach()
        state[t] = (c, y[:, :R])
        ys[j], ms[j] = y, m
    return torch.stack(ys, 1), torch.stack(ms, 1)


def walk(l: RLayer, xw: torch.Tensor, w_r, peep, w_rp, b_rp, lo: int,
         hi: int, origin: int, last_sup: int, window, quant, faults,
         stride: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """A fast-lstmp layer's recurrence over frames lo + j * stride of its
    input's product xw (W_all's recurrent rows w_r, the peepholes, W_rp's
    columns w_rp and b_rp, the first R of them r), in the direction of its
    delay's sign; a reverse walk starts at frame `hi` (under "right_edge":
    at the last supervised frame `last_sup`, if earlier).  Returns (y, m)
    as recurrence does."""
    cell = cell_of(l, faults)
    w = (w_r, peep, w_rp, b_rp, w_r.shape[0])
    if cell.delay < 0:
        return recurrence(xw, *w, lo, cell, origin, window, quant, faults,
                          stride=stride)
    if "no_reverse" in faults:
        return recurrence(xw, *w, lo, dataclasses.replace(
            cell, delay=-cell.delay), origin, window, quant, faults,
            stride=stride)
    first = min(hi, last_sup) if "right_edge" in faults else hi
    return reverse_recurrence(xw, *w, lo, cell, origin, first, window, quant,
                              faults, stride=stride)


def forward(model: RModel, params: dict, feats: torch.Tensor,
            ivectors: torch.Tensor, origin: int, n_out: int, stride: int,
            window=None, quant=None, faults=()) -> Dict[str, torch.Tensor]:
    """{output: [B, n_out, dim]} at the supervised frames origin + k *
    stride.  window: (first, last) input frame whose derivatives count."""
    vals: Dict[str, Frames] = {}
    consts: Dict[str, torch.Tensor] = {}
    outs = {}
    sup = origin + stride * torch.arange(n_out, device=feats.device)
    last_sup = origin + stride * (n_out - 1)
    for l in model.layers:
        if l.kind == "input":
            if l.name == "ivector":
                consts[l.name] = ivectors
            else:
                vals[l.name] = Frames(feats, 0)
            continue
        p = params.get(l.name, {})
        timed = [(s, o) for s, o in l.inputs if o is not CONST]
        lo = max(vals[s].lo - o for s, o in timed)
        hi = min(vals[s].hi - o for s, o in timed)
        parts = []
        for s, o in l.inputs:
            if o is CONST:
                parts.append(consts[s][:, None, :].expand(-1, hi - lo + 1, -1))
            else:
                v = vals[s]
                parts.append(v.x[:, lo + o - v.lo:hi + o - v.lo + 1])
        x = Frames(torch.cat(parts, -1), lo)
        if l.kind == "fixed-affine-layer":
            y = Frames(_mm(x.x, p["w"], quant) + p["b"], lo)
        elif l.kind == "relu-renorm-layer":
            h = torch.relu(_mm(x.x, p["w"], quant) + p["b"])
            rms2 = l.num("target-rms", 1.0) ** 2
            y = Frames(h * torch.rsqrt((h * h).mean(-1, keepdim=True) / rms2
                                       + 2.0 ** -66), lo)
        elif l.kind == "fast-lstmp-layer":
            xw = _mm(x.x, p["w_all"][:l.in_dim], quant) + p["b_all"]
            y = Frames(walk(l, xw, p["w_all"][l.in_dim:], p["peephole"],
                            p["w_rp"], p["b_rp"], x.lo, x.hi, origin,
                            last_sup, window, quant, faults)[0], lo)
        else:                                   # output-layer
            rows = sup - int(l.num("output-delay", 0)) - x.lo
            if int(rows.min()) < 0 or int(rows.max()) > x.hi - x.lo:
                raise ValueError(f"{l.name}: supervised frames outside the "
                                 "chunk's computable frames")
            z = _mm(x.x[:, rows], p["w"], quant) + p["b"]
            if l.opts.get("include-log-softmax", "true") != "false":
                z = torch.log_softmax(z, dim=-1)
            outs[l.name] = z
            continue
        vals[l.name] = _frame_window(y, window)
    return outs


def follow_steps(model: RModel, weights: dict, batches: List[dict],
                 den: DenGraph, cfg: dict, lrs: List[float], quant=None,
                 faults=()) -> dict:
    """len(batches) training steps from `weights`, as reference/
    tdnn_lstm.py's follow_steps takes them (SGD with momentum and
    max-change; the fixed-affine layers held; the same batches, cfg and
    readings), through this file's forward."""
    stride = cfg["frame_subsampling_factor"]
    fixed = {l.name for l in model.layers if l.kind == "fixed-affine-layer"}
    hyper = hyperparams(model)
    left, right = model.context()
    margin = cfg.get("deriv_truncate_margin")
    params = {l: {k: w.detach().clone().float() for k, w in p.items()}
              for l, p in weights.items() if l not in fixed}
    velocity = {l: {k: torch.zeros_like(w) for k, w in p.items()}
                for l, p in params.items()}
    out = {"loss": [], "num_lp": [], "den_lp": [], "grad1": None}
    for i, b in enumerate(batches):
        origin = b["left_context"]
        n_out = b["deriv_weights"].shape[1]
        window = None if margin is None else (
            origin - margin - left,
            origin + (n_out - 1) * stride + margin + right)
        leaves = {l: {k: w.requires_grad_(True) for k, w in p.items()}
                  for l, p in params.items()}
        every = dict(leaves)
        every.update({l: weights[l] for l in fixed})
        outs = forward(model, every, b["features"], b["ivectors"], origin,
                       n_out, stride, window, quant, faults)
        chain_out = outs["output"]
        objf, deriv, num_post, num_lp, den_lp = chain_objective(
            den, b["num"], chain_out.detach(), b["weights"],
            b["deriv_weights"], cfg["l2"], cfg["oor"], cfg["leaky"])
        surrogate = -(chain_out * deriv.float()).sum()
        loss = -objf
        xent_reg = cfg.get("xent_regularize", 0.0)
        if xent_reg > 0 and "output-xent" in outs:
            xent = outs["output-xent"] * b["deriv_weights"][:, :, None]
            xent_objf = torch.sum(b["weights"][:, None, None]
                                  * num_post.float() * xent)
            surrogate = surrogate - xent_reg * xent_objf
            loss = loss - xent_reg * xent_objf.detach().double()
        surrogate.backward()
        grads = {l: {k: (w.grad.detach() if w.grad is not None
                         else torch.zeros_like(w)) for k, w in p.items()}
                 for l, p in leaves.items()}
        params, velocity = sgd_update(
            {l: {k: w.detach() for k, w in p.items()}
             for l, p in leaves.items()},
            grads, velocity, lrs[i], cfg["momentum"],
            cfg["max_param_change"], hyper)
        if i == 0:
            out["grad1"] = {(l, k): (velocity[l][k].clone() if l in velocity
                                     else torch.zeros_like(w))
                            for l, p in weights.items()
                            for k, w in p.items()}
            out["outs"] = {k: v.detach().cpu() for k, v in outs.items()}
        out["loss"].append(float(loss))
        out["num_lp"].append(float(num_lp.mean()))
        out["den_lp"].append(float(den_lp.mean()))
        del outs, chain_out, deriv, num_post, surrogate, grads
    out["params"] = dict(params)
    out["params"].update({l: weights[l] for l in fixed})
    return out
