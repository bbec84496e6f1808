"""The recurrence of Kaldi's fast-lstmp layer: a plain loop and one
hand-written CUDA kernel per pass.

`lstmp_recurrence(z, w_r, peephole, w_rr, b_r, steps)` runs, for steps
j = steps.start .. T-1 (D = steps.delay steps apart; the state before
`start` is zero, Kaldi's IfDefined):

    c' = s c_{j-D},  r' = s r_{j-D}          (zero where j - D < start)
    [a_i a_f a_g a_o] = z_j + r' W_r
    i = sigma(a_i + w_ic c'),  f = sigma(a_f + w_fc c'),  g = tanh(a_g)
    c_j = f c' + i g
    o = sigma(a_o + w_oc c_j),  m_j = o tanh(c_j)
    r_j = m_j W_rr + b_r

and returns (r [B, T, R], m [B, T, C]), both float32 and zero before
`start`.  A reverse walk (`steps.reverse`, Kaldi's delay > 0: the
backward layer of a BLSTM) runs j = steps.start down to 0 and reads
c_{j+D}, r_{j+D}, zero where j + D > start (IfDefined on the right);
there r and m are zero after `start`.  z [B, T, 4C] holds the gates'
pre-activations from the layer's input (its product with W_all's input
rows, one matmul over all frames, and W_all's bias), w_r [R, 4C] W_all's
recurrent rows, peephole [3, C] (w_ic, w_fc, w_oc), w_rr [C, R] and b_r
[R] the recurrent columns of W_rp.
The caller applies W_rp's other columns to m.

With `steps.bf16_ops` the products take bf16 operands (r', m and the
weights rounded to bf16, as the network's other matmuls take them) and
accumulate in float32; m comes back rounded.  The cell, the gates and every
sum are float32; derivatives are float32 throughout.

The backward is Kaldi's: the scale s sits in a BackpropTruncationComponent
on [c ; r], which in the backward clips each row's derivative (one frame of
one sequence, C + R values) to norm `clip` and zeroes a row whose norm
exceeds `zero_threshold` where the frame crosses a multiple of
`zero_interval`: Kaldi's rule for sequence n at time t (frames from the
chunk's first supervised frame) is floor((t - n) / interval) !=
floor((t - rec - n) / interval), rec the recurrence's delay in frames, t
the time of the row (the frame whose state it carries), in either
direction.  And every derivative at a step outside [deriv_lo, deriv_hi] is
zero (nnet3's LimitDerivativeTimes, the trainer's deriv-truncate-margin).

A CUDA tensor goes through csrc/lstmp.cu: one launch for the forward
(`lstmp_fwd_kernel`, a reverse walk `lstmp_rev_fwd_kernel`), one for the
backward (`lstmp_bwd_kernel`, `lstmp_rev_bwd_kernel`), each a persistent
cooperative grid that walks the steps with two grid barriers a step; it
takes C and R multiples of 4.  The weights' gradients are then ordinary
matmuls over all frames.
`lstmp_recurrence.launches` counts the kernel's launches in both
directions, `lstmp_recurrence.reverse_launches` those of reverse walks
alone (the forward walks' are the difference);
`lstmp_recurrence.tap`, where set, is called with each call's arguments
(a benchmark reads the layer's inputs and steps through it).  A CPU tensor
takes the plain loop `lstmp_recurrence_plain`, which autograd
differentiates and which the tests hold the kernel to.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from kaldi_fp16_tpu_torch.ops._build import launch
from kaldi_fp16_tpu_torch.ops.den_matmul import fp32_matmuls
from kaldi_fp16_tpu_torch.utils.spans import span

MAX_RECURRENT = 512     # csrc/lstmp.cu: R past this does not fit a block


@dataclasses.dataclass(frozen=True)
class LstmpSteps:
    """Where a recurrence runs and how its backward is cut (steps are
    frames of the layer's rate; times are input frames)."""
    start: int = 0                # first step with a state (reverse: last)
    delay: int = 1                # steps between a state and its use
    scale: float = 1.0            # 1 - |delay| / decay-time
    deriv_lo: int = 0             # steps whose derivatives are kept
    deriv_hi: int = 1 << 30
    clip: float = 30.0            # clipping-threshold
    zero_threshold: float = 15.0  # zeroing-threshold
    zero_interval: int = 20       # zeroing-interval, frames
    recurrence_frames: int = 1    # |delay| in frames
    frame0: int = 0               # time of step 0 from the chunk's origin
    frame_step: int = 1           # frames a step
    bf16_ops: bool = True
    reverse: bool = False         # walk down from `start`, reading j + delay

    def walk(self, T: int) -> range:
        """The steps with a state, in the forward pass's order."""
        if self.reverse:
            return range(min(self.start, T - 1), -1, -1)
        return range(max(self.start, 0), T)

    def window(self, T: int) -> Tuple[int, int]:
        """(first, last) step the backward walks."""
        if self.reverse:
            return max(self.deriv_lo, 0), min(self.deriv_hi, self.start,
                                                T - 1)
        return max(self.deriv_lo, self.start), min(self.deriv_hi, T - 1)

    def source(self, t: int) -> int:
        """The step whose state step t reads."""
        return t + self.delay if self.reverse else t - self.delay

    def zero_rows(self, B: int, T: int, device) -> torch.Tensor:
        """[B, T] bool: the rows whose derivative may be zeroed."""
        if self.zero_threshold <= 0 or self.zero_interval <= 0:
            return torch.zeros((B, T), dtype=torch.bool, device=device)
        t = (self.frame0 + self.frame_step
             * torch.arange(T, device=device))[None, :]
        n = torch.arange(B, device=device)[:, None]
        return torch.remainder(t - n, self.zero_interval) \
            < self.recurrence_frames


def _operand(x: torch.Tensor, bf16: bool) -> torch.Tensor:
    """x rounded to bf16 (kept float32) when `bf16`; the gradient passes
    through unrounded."""
    if not bf16:
        return x
    return x + (x.to(torch.bfloat16).float() - x).detach()


class _Truncate(torch.autograd.Function):
    """Kaldi's BackpropTruncationComponent on a [B, C + R] row block:
    forward y = s x; backward s x the derivative, each row clipped to norm
    `clip` and zeroed where `zero_rows` and its norm exceeds `thr`."""

    @staticmethod
    def forward(ctx, x, s, clip, thr, zero_rows):
        ctx.s, ctx.clip, ctx.thr = s, clip, thr
        ctx.save_for_backward(zero_rows)
        return x * s

    @staticmethod
    def backward(ctx, g):
        (zero_rows,) = ctx.saved_tensors
        norm = g.norm(dim=-1, keepdim=True)
        fac = torch.full_like(norm, ctx.s)
        if ctx.clip > 0:
            fac = fac * torch.clamp(ctx.clip / norm.clamp(min=1e-30), max=1.0)
        if ctx.thr > 0:
            fac = torch.where(zero_rows[:, None] & (norm > ctx.thr),
                              torch.zeros_like(fac), fac)
        return g * fac, None, None, None, None


class _NoDeriv(torch.autograd.Function):
    """Identity whose derivative is zero (a step outside the window)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return torch.zeros_like(g)


def lstmp_recurrence_plain(z, w_r, peephole, w_rr, b_r, steps: LstmpSteps):
    """The recurrence as a Python loop of torch ops (differentiable)."""
    B, T, G = z.shape
    C, R = G // 4, w_r.shape[0]
    bf = steps.bf16_ops
    z = z.float()
    wr = _operand(w_r.float(), bf)
    wrr = _operand(w_rr.float(), bf)
    peep = peephole.float()
    lo, hi = steps.window(T)
    zero_rows = steps.zero_rows(B, T, z.device)
    cs, rs = {}, {}
    zc, zr = z.new_zeros((B, C)), z.new_zeros((B, R))
    r_out, m_out = [zr] * T, [zc] * T
    for t in steps.walk(T):
        src = steps.source(t)
        if src in cs:
            cr = _Truncate.apply(torch.cat([cs[src], rs[src]], -1),
                                 steps.scale, steps.clip,
                                 steps.zero_threshold, zero_rows[:, src])
            cp, rp = cr[:, :C], cr[:, C:]
        else:
            cp, rp = zc, zr
        a = z[:, t] + _operand(rp, bf) @ wr
        i = torch.sigmoid(a[:, :C] + peep[0] * cp)
        f = torch.sigmoid(a[:, C:2 * C] + peep[1] * cp)
        g = torch.tanh(a[:, 2 * C:3 * C])
        c = f * cp + i * g
        o = torch.sigmoid(a[:, 3 * C:] + peep[2] * c)
        m = _operand(o * torch.tanh(c), bf)
        r = m @ wrr + b_r.float()
        if t < lo or t > hi:
            c, r, m = _NoDeriv.apply(c), _NoDeriv.apply(r), _NoDeriv.apply(m)
        cs[t], rs[t] = c, r
        r_out[t], m_out[t] = r, m
    return torch.stack(r_out, 1), torch.stack(m_out, 1)


def _check(z, w_r, peephole, w_rr, b_r) -> Tuple[int, int, int, int]:
    if z.ndim != 3 or z.shape[-1] % 4:
        raise ValueError(f"z must be [B, T, 4C], got {list(z.shape)}")
    B, T, G = z.shape
    C = G // 4
    R = w_r.shape[0]
    want = {"w_r": (w_r, (R, G)), "peephole": (peephole, (3, C)),
            "w_rr": (w_rr, (C, R)), "b_r": (b_r, (R,))}
    for name, (a, shape) in want.items():
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got "
                             f"{list(a.shape)}")
    if R > MAX_RECURRENT or C % 4 or R % 4:
        raise ValueError(f"the recurrence kernel takes C and R multiples of 4"
                         f" and R <= {MAX_RECURRENT}, got C = {C}, R = {R}")
    return B, T, C, R


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous at a 16-byte aligned address (the kernel's rows are
    copied 16 bytes at a time)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _kernel_weights(w: torch.Tensor, bf16: bool) -> torch.Tensor:
    w = w.detach()
    return _aligned((w.to(torch.bfloat16) if bf16 else w).float())


class _KernelRecurrence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, w_r, peephole, w_rr, b_r, steps):
        B, T, C, R = _check(z, w_r, peephole, w_rr, b_r)
        dev = z.device
        bf = steps.bf16_ops
        wr, wrr = _kernel_weights(w_r, bf), _kernel_weights(w_rr, bf)
        peep = peephole.detach().float().contiguous()
        zf = _aligned(z.detach().float())
        c = torch.zeros((B, T, C), dtype=torch.float32, device=dev)
        m = torch.zeros_like(c)
        r = torch.zeros((B, T, R), dtype=torch.float32, device=dev)
        # read only at the steps the kernel writes (c, m and r are read
        # over every frame outside it, so they start at zero)
        gates = torch.empty((B, T, 4 * C), dtype=torch.float32, device=dev)
        bar = torch.zeros(1, dtype=torch.int32, device=dev)
        walk = steps.walk(T)
        if len(walk):
            launch("lstmp_forward", dev, zf, wr, peep, wrr,
                   b_r.detach().float().contiguous(), c, m, r, gates, bar,
                   B, T, C, R, walk[0], steps.delay, float(steps.scale),
                   int(bf), int(steps.reverse))
            _count(steps)
        ctx.steps = steps
        ctx.save_for_backward(wr, peep, wrr, c, m, r, gates)
        return r, m

    @staticmethod
    def backward(ctx, g_r, g_m):
        with span("lstmp_reverse.backward" if ctx.steps.reverse
                  else "lstmp.backward"):
            return _kernel_backward(ctx, g_r, g_m)


def _count(steps: LstmpSteps) -> None:
    lstmp_recurrence.launches += 1
    if steps.reverse:
        lstmp_recurrence.reverse_launches += 1


def _kernel_backward(ctx, g_r, g_m):
    steps = ctx.steps
    wr, peep, wrr, c, m, r, gates = ctx.saved_tensors
    B, T, C = c.shape
    R = r.shape[-1]
    dev = c.device
    D, s = steps.delay, float(steps.scale)
    g_r = torch.zeros_like(r) if g_r is None else _aligned(g_r.float())
    g_m = torch.zeros_like(c) if g_m is None else _aligned(g_m.float())
    dz = torch.zeros((B, T, 4 * C), dtype=torch.float32, device=dev)
    drt = torch.zeros_like(r)
    lo, hi = steps.window(T)
    if lo <= hi:
        rc = torch.zeros_like(c)
        rr = torch.zeros_like(r)
        n_parts = _norm_parts(C, R)
        parts = torch.zeros((T, B, n_parts), dtype=torch.float32, device=dev)
        bar = torch.zeros(1, dtype=torch.int32, device=dev)
        launch("lstmp_backward", dev, gates, c, wr, peep, wrr, g_r, g_m, dz,
               drt, rc, rr, parts, bar, B, T, C, R, steps.walk(T)[0], D, lo,
               hi, s, float(steps.clip), float(steps.zero_threshold),
               int(steps.zero_interval), int(steps.recurrence_frames),
               int(steps.frame0), int(steps.frame_step), int(steps.reverse))
        _count(steps)
    with fp32_matmuls():
        # the weights' gradients: sums over every frame of the walk, with
        # each step's scaled state (c and r are zero off the walk)
        prev_c = torch.zeros_like(c)
        prev_r = torch.zeros_like(r)
        if D < T and steps.reverse:
            prev_c[:, :T - D] = s * c[:, D:]
            prev_r[:, :T - D] = s * r[:, D:]
        elif steps.start + D < T:
            prev_c[:, steps.start + D:] = s * c[:, steps.start:T - D]
            prev_r[:, steps.start + D:] = s * r[:, steps.start:T - D]
        if steps.bf16_ops:
            prev_r = prev_r.to(torch.bfloat16).float()
        g_wr = prev_r.reshape(-1, R).t() @ dz.reshape(-1, 4 * C)
        g_peep = torch.stack([(dz[..., :C] * prev_c).sum((0, 1)),
                              (dz[..., C:2 * C] * prev_c).sum((0, 1)),
                              (dz[..., 3 * C:] * c).sum((0, 1))])
        g_wrr = m.reshape(-1, C).t() @ drt.reshape(-1, R)
        g_br = drt.sum((0, 1))
    return dz, g_wr, g_peep, g_wrr, g_br, None


def _norm_parts(C: int, R: int) -> int:
    """Partial sums of a row's squared derivative the backward keeps: one
    per unit tile (csrc/lstmp.cu UNITS) and per column tile of R (COLS)."""
    return (C + 7) // 8 + (R + 31) // 32


def lstmp_recurrence(z, w_r, peephole, w_rr, b_r, steps: LstmpSteps):
    """(r [B, T, R], m [B, T, C]) float32: the kernel for CUDA tensors, the
    plain loop for CPU tensors."""
    if lstmp_recurrence.tap is not None:
        lstmp_recurrence.tap(z, w_r, peephole, w_rr, b_r, steps)
    if z.device.type == "cpu":
        return lstmp_recurrence_plain(z, w_r, peephole, w_rr, b_r, steps)
    return _KernelRecurrence.apply(z, w_r, peephole, w_rr, b_r, steps)


lstmp_recurrence.launches = 0
lstmp_recurrence.reverse_launches = 0
lstmp_recurrence.tap = None
