"""Plain float32 reference of Kaldi's TDNN-LSTM chain model (the benchmark's
`tdnn_lstm` configuration): the xconfig, the training forward, the chain
loss, the backward and SGD with momentum and max-change over a run's first
steps.

Written from Kaldi's equations, not from the port's code:

- fixed-affine-layer: y = x W + b, W and b fixed (Kaldi reads them from
  lda.mat; here they are drawn from the run's seed).
- relu-renorm-layer: y = relu(x W + b), then NormalizeComponent: each frame
  times (mean(y^2) / target_rms^2 + 2^-66)^-1/2.
- fast-lstmp-layer (steps/libs/nnet3/xconfig/lstm.py): with d the delay
  (-3) and s = 1 - |d| / decay-time (0.85), c' = s c_{t+d} and r' = s
  r_{t+d}, zero where frame t + d is not computed (IfDefined);
  [a_i a_f a_g a_o] = [x_t ; r'] W_all + b_all; i = sigma(a_i + w_ic c'),
  f = sigma(a_f + w_fc c'), c_t = f c' + i tanh(a_g), o = sigma(a_o + w_oc
  c_t), m_t = o tanh(c_t), [r_t ; p_t] = m_t W_rp + b_rp, and the layer's
  output is [r_t ; p_t].  The scale sits in a BackpropTruncationComponent
  on [c ; r]: in the backward it scales the derivative by s, clips each
  row (one sequence, one frame, C + R values) to norm clipping-threshold
  (30) and zeroes a row whose norm exceeds zeroing-threshold (15) on the
  frames that cross a multiple of zeroing-interval (20).
- output-layer with output-delay d: y(t) = x(t - d) W + b (log-softmax on
  the xent head).

Frames: nnet3 computes a layer only at the frames where its inputs exist.
So does this reference: every layer holds the frames [lo, hi] (input
frames of the chunk) at which it is defined, at the full frame rate, and
the outputs are read at the supervised frames origin + k * stride.

The trainer's deriv-truncate-margin (8 in the recipe) zeroes every
derivative at input frames before origin - margin - left or after
last + margin + right, left and right the model's context (nnet3's
min-deriv-time / max-deriv-time-relative as steps/nnet3/chain/train.py
sets them); a value at such a frame passes no derivative on.

The chain objective is reference/chain.py's float64 one; the update is
reference/train.py's `sgd_update` (per xconfig layer max-change, then the
global one).

Departures from Kaldi, each a choice where the repository holds no
Kaldi source to confirm the detail:
- the zeroing rule is Kaldi's as remembered from BackpropTruncationComponent::
  PrecomputeIndexes: sequence n's row at time t (from the chunk's first
  supervised frame) is zeroed when floor((t - n) / interval) !=
  floor((t - rec - n) / interval), rec = |delay| frames;
- the clipping and zeroing read the derivative's norm before the scale s;
- max-change is applied per xconfig layer (as the port's optimizer does),
  where Kaldi applies it per component (W_all, the LSTM nonlinearity and
  W_rp separately);
- the self-repair terms of Kaldi's ReLU and LSTM nonlinearity components
  (scale 1e-5) and NG-SGD are left out, as in the program.

`quant` rounds every matrix product's operands (the controls' float8);
`faults` runs the model with a known fault, to show the comparison's
limits catch it: "bf16_c" (the cell state held in bf16), "s1" (no decay
scale), "no_peephole", "no_delay" (output-delay 0; the supervised
frames past the chunk's computed ones read its last).

Plain `torch` only, in float32 with TF32 off; no kernel of the program.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from .chain import DenGraph, chain_objective
from .train import sgd_update

KINDS = ("input", "fixed-affine-layer", "relu-renorm-layer",
         "fast-lstmp-layer", "output-layer")
CONST = None          # the offset of a ReplaceIndex(x, t, 0) input


@dataclass
class RLayer:
    name: str
    kind: str
    inputs: List[Tuple[str, Optional[int]]]   # (source, offset or CONST)
    in_dim: int
    dim: int
    opts: Dict[str, str] = field(default_factory=dict)

    def num(self, key: str, default: float) -> float:
        return float(self.opts.get(key, default))


@dataclass
class RModel:
    layers: List[RLayer]

    def __post_init__(self):
        self.by_name = {l.name: l for l in self.layers}

    def context(self) -> Tuple[int, int]:
        """(left, right) input frames the outputs read beyond their own:
        the longest path of offsets (a recurrence reads only defined
        frames, and adds none)."""
        reach = {}
        for l in self.layers:
            if l.kind == "input":
                reach[l.name] = (0, 0)
                continue
            left = right = 0
            for src, off in l.inputs:
                if off is CONST:
                    continue
                sl, sr = reach[src]
                left, right = max(left, sl - off), max(right, sr + off)
            if l.kind == "output-layer":
                d = int(l.num("output-delay", 0))
                left, right = left + d, right - d
            reach[l.name] = (left, right)
        outs = [reach[l.name] for l in self.layers if l.kind == "output-layer"]
        return max(o[0] for o in outs), max(0, max(o[1] for o in outs))


def _tokens(line: str) -> List[str]:
    out, cur, depth = [], "", 0
    for ch in line:
        depth += (ch == "(") - (ch == ")")
        if ch.isspace() and depth == 0:
            if cur:
                out.append(cur)
            cur = ""
        else:
            cur += ch
    return out + ([cur] if cur else [])


def _descriptor(text: str, prev: str) -> List[Tuple[str, Optional[int]]]:
    text = text.strip()
    if not text:
        return [(prev, 0)]
    if text.startswith("Append(") and text.endswith(")"):
        parts, cur, depth = [], "", 0
        for ch in text[len("Append("):-1]:
            depth += (ch == "(") - (ch == ")")
            if ch == "," and depth == 0:
                parts.append(cur)
                cur = ""
            else:
                cur += ch
        out = []
        for p in parts + [cur]:
            out += _descriptor(p, prev)
        return out
    if re.fullmatch(r"-?\d+", text):
        return [(prev, int(text))]
    m = re.fullmatch(r"ReplaceIndex\((\S+?),\s*t,\s*0\)", text)
    if m:
        return [(m.group(1), CONST)]
    m = re.fullmatch(r"Offset\((\S+?),\s*(-?\d+)\)", text)
    if m:
        return [(m.group(1), int(m.group(2)))]
    return [(text, 0)]


def parse(text: str) -> RModel:
    """The xconfig's layers (the five kinds the configuration uses)."""
    layers: List[RLayer] = []
    dims: Dict[str, int] = {}
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        kind, *rest = _tokens(line)
        if kind not in KINDS:
            raise ValueError(f"the reference has no {kind!r}")
        opts = dict(t.split("=", 1) for t in rest)
        name = opts.pop("name")
        prev = layers[-1].name if layers else ""
        inputs = ([] if kind == "input"
                  else _descriptor(opts.pop("input", ""), prev))
        in_dim = sum(dims[s] for s, _ in inputs)
        if kind == "input":
            dim = in_dim = int(opts["dim"])
        elif kind == "fast-lstmp-layer":
            dim = (int(opts["recurrent-projection-dim"])
                   + int(opts["non-recurrent-projection-dim"]))
        else:
            dim = int(opts.get("dim", in_dim))
        dims[name] = dim
        layers.append(RLayer(name, kind, inputs, in_dim, dim, opts))
    return RModel(layers)


def load(path: str) -> RModel:
    with open(path) as f:
        return parse(f.read())


def param_shapes(model: RModel) -> Dict[str, Dict[str, tuple]]:
    """{layer: {name: shape}} of every leaf (the LDA's fixed ones too),
    matrices [in, out]."""
    out = {}
    for l in model.layers:
        if l.kind in ("fixed-affine-layer", "relu-renorm-layer",
                      "output-layer"):
            out[l.name] = {"w": (l.in_dim, l.dim), "b": (l.dim,)}
        elif l.kind == "fast-lstmp-layer":
            C = int(l.opts["cell-dim"])
            R = int(l.opts["recurrent-projection-dim"])
            out[l.name] = {"w_all": (l.in_dim + R, 4 * C),
                           "b_all": (4 * C,), "peephole": (3, C),
                           "w_rp": (C, l.dim), "b_rp": (l.dim,)}
    return out


def make_weights(model: RModel, seed: int, device) -> dict:
    """Xavier-normal matrices (std sqrt(2 / (rows + cols)), all drawn in
    one normal draw in layer order) and zero vectors, from the seed."""
    shapes = param_shapes(model)
    mats = [(l, k, s) for l, p in shapes.items() for k, s in p.items()
            if len(s) > 1]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(math.prod(s) for _, _, s in mats), generator=gen,
                       device=device, dtype=torch.float32)
    out = {l: {} for l in shapes}
    off = 0
    for l, k, s in mats:
        n = math.prod(s)
        out[l][k] = flat[off:off + n].view(s) * math.sqrt(2.0 / sum(s))
        off += n
    for l, p in shapes.items():
        for k, s in p.items():
            if len(s) == 1:
                out[l][k] = torch.zeros(s, device=device)
    return {l: {k: out[l][k] for k in shapes[l]} for l in shapes}


# ---------------------------------------------------------------------------
# The forward, frame by frame where it must be
# ---------------------------------------------------------------------------

@dataclass
class Frames:
    """A layer's values [B, n, dim] at input frames lo .. lo + n - 1."""
    x: torch.Tensor
    lo: int

    @property
    def hi(self) -> int:
        return self.lo + self.x.shape[1] - 1


class _Truncation(torch.autograd.Function):
    """BackpropTruncationComponent on [c ; r] rows [B, C + R]."""

    @staticmethod
    def forward(ctx, x, scale, clip, threshold, zero):
        ctx.scale, ctx.clip, ctx.threshold = scale, clip, threshold
        ctx.save_for_backward(zero)
        return x * scale

    @staticmethod
    def backward(ctx, grad):
        (zero,) = ctx.saved_tensors
        norm = torch.sqrt((grad * grad).sum(dim=1))
        keep = torch.ones_like(norm)
        if ctx.clip > 0:
            keep = torch.where(norm > ctx.clip, ctx.clip / norm, keep)
        if ctx.threshold > 0:
            keep = torch.where(zero & (norm > ctx.threshold),
                               torch.zeros_like(keep), keep)
        return grad * (ctx.scale * keep)[:, None], None, None, None, None


def _op(t, quant):
    return t if quant is None else quant(t)


def _mm(x, w, quant):
    return torch.matmul(_op(x, quant), _op(w, quant))


def _in_window(t: int, window) -> bool:
    return window is None or window[0] <= t <= window[1]


def _frame_window(v: Frames, window) -> Frames:
    """Values at frames outside the window pass no derivative on."""
    if window is None:
        return v
    t = v.lo + torch.arange(v.x.shape[1], device=v.x.device)
    inside = ((t >= window[0]) & (t <= window[1]))[None, :, None]
    return Frames(torch.where(inside, v.x, v.x.detach()), v.lo)


@dataclass
class Cell:
    """A fast-lstmp layer's recurrence settings (Kaldi's defaults)."""
    delay: int = -1                  # frames; negative
    scale: float = 1.0
    clip: float = 30.0
    threshold: float = 15.0
    interval: int = 20


def cell_of(l: RLayer, faults=()) -> Cell:
    d = int(l.opts.get("delay", -1))
    decay = l.num("decay-time", -1.0)
    return Cell(d, 1.0 if decay < 0 or "s1" in faults
                else 1.0 - abs(d) / decay,
                l.num("clipping-threshold", 30.0),
                l.num("zeroing-threshold", 15.0),
                int(l.num("zeroing-interval", 20)))


def recurrence(xw: torch.Tensor, w_r, peep, w_rp, b_rp, R: int, lo: int,
               cell: Cell, origin: int, window=None, quant=None,
               faults=(), stride: int = 1) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """The cell over frames lo + j * stride, j = 0 .. n - 1, of xw
    [B, n, 4C] (the input's part of W_all's product, with its bias):
    ([r ; p] [B, n, R + P], m [B, n, C]).  The stride divides |delay|:
    with stride = |delay| the frames are one of the delay's interleaved
    chains, as a layer on a frame grid holds them."""
    B, n_frames, G = xw.shape
    C = G // 4
    d = cell.delay
    rows = torch.arange(B, device=xw.device)
    if "no_peephole" in faults:
        peep = peep * 0.0
    state, ys, ms = {}, [], []
    for j in range(n_frames):
        t = lo + j * stride
        if t + d >= lo:
            c_prev, r_prev = state[t + d]
            # Kaldi's zeroing frames: a multiple of the interval in
            # (t + d - n, t - n] for the truncation row at time t + d
            tr = t + d - origin
            zero = (torch.div(tr - rows, cell.interval, rounding_mode="floor")
                    != torch.div(tr - abs(d) - rows, cell.interval,
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
        ys.append(y)
        ms.append(m)
    return torch.stack(ys, 1), torch.stack(ms, 1)


def _lstmp(l: RLayer, p: dict, x: Frames, origin: int, window, quant,
           faults) -> Frames:
    R = int(l.opts["recurrent-projection-dim"])
    xw = _mm(x.x, p["w_all"][:l.in_dim], quant) + p["b_all"]   # [B, n, 4C]
    y, _ = recurrence(xw, p["w_all"][l.in_dim:], p["peephole"], p["w_rp"],
                      p["b_rp"], R, x.lo, cell_of(l, faults), origin, window,
                      quant, faults)
    return Frames(y, x.lo)


def forward(model: RModel, params: dict, feats: torch.Tensor,
            ivectors: torch.Tensor, origin: int, n_out: int, stride: int,
            window=None, quant=None, faults=()) -> Dict[str, torch.Tensor]:
    """{output: [B, n_out, dim]} at the supervised frames origin + k *
    stride.  window: (first, last) input frame whose derivatives count."""
    vals: Dict[str, Frames] = {}
    consts: Dict[str, torch.Tensor] = {}
    outs = {}
    sup = origin + stride * torch.arange(n_out, device=feats.device)
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
            y = _lstmp(l, p, x, origin, window, quant, faults)
        else:                                   # output-layer
            delay = 0 if "no_delay" in faults else int(
                l.num("output-delay", 0))
            rows = sup - delay - x.lo
            if "no_delay" in faults:
                # the chunk's right context was sized for the delay: the
                # last supervised frames read the last computed one
                rows = rows.clamp(0, x.hi - x.lo)
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


def hyperparams(model: RModel) -> dict:
    """{layer: lr_factor, max_change, l2}: Kaldi's defaults are a
    max-change of 0.75 (None: sgd_update's default) and 1.5 on an output
    layer."""
    out = {}
    for l in model.layers:
        if l.kind == "input":
            continue
        default = 1.5 if l.kind == "output-layer" else None
        out[l.name] = {"lr_factor": l.num("learning-rate-factor", 1.0),
                       "max_change": (l.num("max-change", 0.75)
                                      if "max-change" in l.opts else default),
                       "l2": l.num("l2-regularize", 0.0)}
    return out


def follow_steps(model: RModel, weights: dict, batches: List[dict],
                 den: DenGraph, cfg: dict, lrs: List[float], quant=None,
                 faults=()) -> dict:
    """len(batches) training steps from `weights` (SGD with momentum and
    max-change; the fixed-affine layers held).

    batches: features [B, T, D], ivectors [B, I], weights [B],
    deriv_weights [B, n_out], num (numerator arrays), left_context.
    cfg: frame_subsampling_factor, momentum, max_param_change, l2, oor,
    leaky, xent_regularize, deriv_truncate_margin.
    Returns per-step loss / num_lp / den_lp, the outputs at the supervised
    frames of step 1 (on the host), every leaf's velocity after step 1 (a
    fixed leaf's zero) and the parameters after the last step."""
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
