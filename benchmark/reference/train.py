"""Plain reference of the chain training step, followed for the first steps
of a run.

The step as kaldi_fp16_tpu_torch/training/train_step.py defines it at
commit de5aca0, on one process: the training forward on the frame grid
(reference/network.py), the chain objective and its analytic derivative in
float64 (reference/chain.py), the cross-entropy head weighted by the
numerator posteriors, autograd for the network, the natural-gradient
update and preconditioning (reference/ng.py), and SGD with momentum,
per-component and global max-change and L2 decay (a frozen copy of the
port's training/optimizer.py).  Loss scaling multiplies and divides by a
power of two, so the reference leaves it out.  The orthonormal constraint
falls on every 4th step, after the steps the reference follows.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from . import ng as ngmod
from .chain import DenGraph, chain_objective
from .layers import ConvReluBNSpec, OutputSpec
from .model import Model
from .network import (
    NGContext, Quant, conv_weight_from_oihw, conv_weight_to_oihw, forward,
    grid_layers, ng_sites,
)
from .xconfig import LayerType

DEFAULT_MAX_CHANGE = 0.75


def layer_hyperparams(model: Model) -> Dict[str, Dict[str, float]]:
    out = {}
    for layer in model.layers:
        lr_factor = 1.0
        max_change = None
        s = layer.spec
        if isinstance(s, (ConvReluBNSpec, OutputSpec)):
            lr_factor = s.learning_rate_factor
            max_change = s.max_change
        lr_factor = layer.config.get_float("learning-rate-factor", lr_factor)
        if "max-change" in layer.config.params:
            max_change = layer.config.get_float("max-change")
        l2 = getattr(s, "l2_reg", 0.0) or 0.0
        out[layer.name] = {"lr_factor": lr_factor, "max_change": max_change,
                           "l2": l2}
    return out


@torch.no_grad()
def sgd_update(params, grads, velocity, lr, momentum, max_param_change,
               hyper):
    """(new params, new velocities); Kaldi's per-component max-change, then
    the global one, then L2 decay."""
    new_vel, deltas, sq_norms, decay = {}, {}, [], {}
    for lname, lparams in params.items():
        h = hyper.get(lname, {})
        max_change = h.get("max_change")
        if max_change is None:
            max_change = DEFAULT_MAX_CHANGE
        layer_lr = lr * h.get("lr_factor", 1.0)
        l2 = h.get("l2", 0.0)
        new_vel[lname], deltas[lname] = {}, {}
        layer_sq = []
        for pname, w in lparams.items():
            v = momentum * velocity[lname][pname] + grads[lname][pname]
            new_vel[lname][pname] = v
            d = layer_lr * v
            deltas[lname][pname] = d
            layer_sq.append(torch.sum(d * d))
            if l2 > 0:
                decay[(lname, pname)] = layer_lr * l2 * w
        if layer_sq and max_change > 0:
            norm = torch.sqrt(sum(layer_sq))
            scale = torch.clamp(max_change / torch.clamp(norm, min=1e-20),
                                max=1.0)
            for pname in deltas[lname]:
                deltas[lname][pname] = deltas[lname][pname] * scale
            sq_norms.append((norm * scale) ** 2)
        elif layer_sq:
            sq_norms.append(sum(layer_sq))
    total = torch.sqrt(sum(sq_norms))
    gscale = torch.clamp(max_param_change / torch.clamp(total, min=1e-20),
                         max=1.0)
    new = {}
    for lname, lparams in params.items():
        new[lname] = {}
        for pname, w in lparams.items():
            nw = w - gscale * deltas[lname][pname]
            if (lname, pname) in decay:
                nw = nw - decay[(lname, pname)]
            new[lname][pname] = nw
    return new, new_vel


def recipe_lr(step: int, cell: dict) -> float:
    """The recipe's learning rate at a step (tools/train.py's schedule):
    lr * (lr_final / lr) ** (step / total) over the epochs' steps, after a
    linear warm-up from 0 that ends at the schedule's value there."""
    total = max(cell["schedule_egs_per_epoch"] // cell["batch"]
                * cell["epochs"], 1)
    lr, final = cell["learning_rate"], cell["lr_final"]

    def base(s):
        return lr * (final / lr) ** min(s / total, 1.0)
    w = cell["lr_warmup_steps"]
    if w and step < w:
        return base(w) * (step + 1) / w
    return base(step)


def init_ng_states(model: Model, rank_in: int, rank_out: int, device):
    states = {}
    for site in ng_sites(model):
        d_in = site["in_dim"] + (1 if site["b"] is not None else 0)
        states[site["name"]] = {
            "in": ngmod.init_ng_state(d_in, ngmod.NGConfig(rank=rank_in),
                                      device),
            "out": ngmod.init_ng_state(site["out_dim"],
                                       ngmod.NGConfig(rank=rank_out), device)}
    return states


def _ng_step(model, sites, states, ctx, grads, cfg_in, cfg_out):
    """Update the due Fisher factors from this batch's X and G, then
    precondition every site's gradient with the new factors."""
    new = {nm: dict(st) for nm, st in states.items()}
    groups = {}
    for site in sites:
        nm = site["name"]
        for side, cfg in (("in", cfg_in), ("out", cfg_out)):
            st = states[nm][side]
            if ngmod.update_due(int(st.t), cfg):
                groups.setdefault((tuple(st.v.shape), cfg), []).append(
                    (site, side))
            else:
                new[nm][side] = ngmod.advance(st)
    for (_, cfg), members in groups.items():
        samples = []
        for site, side in members:
            x = ctx.xs[site["name"]]
            if side == "in":
                x2 = x.float().reshape(-1, x.shape[-1])
                if site["b"] is not None:
                    x2 = torch.cat([x2, torch.ones((x2.shape[0], 1),
                                                   device=x2.device)], 1)
                samples.append(x2)
            else:
                g = ctx.gs.get(site["name"])
                samples.append(
                    torch.zeros((x[..., 0].numel(), site["out_dim"]),
                                device=x.device) if g is None
                    else g.float().reshape(-1, g.shape[-1]))
        for (site, side), st in zip(members, ngmod.fisher_update(
                [states[s["name"]][sd] for s, sd in members], samples, cfg)):
            new[site["name"]][side] = st
    grads = {k: dict(v) for k, v in grads.items()}
    for site in sites:
        lname = site["layer"]
        layer = model.layer_map[lname]
        conv = layer.type == LayerType.CONV_RELU_BATCHNORM
        st = new[site["name"]]
        dw = grads[lname][site["w"]]
        if conv:
            dw = conv_weight_from_oihw(dw, layer.spec)
        if site["b"] is not None:
            dw = torch.cat([dw, grads[lname][site["b"]][None, :]], dim=0)
        dwe = ngmod.precondition_grad(st["in"], st["out"], dw, cfg_in)
        if site["b"] is not None:
            grads[lname][site["b"]] = dwe[-1]
            dwe = dwe[:-1]
        grads[lname][site["w"]] = (conv_weight_to_oihw(dwe, layer.spec)
                                   if conv else dwe)
    return new, grads


def follow_steps(model: Model, params0, bn0, batches: List[dict],
                 den: DenGraph, cfg: dict, lrs: List[float],
                 generator: Optional[torch.Generator] = None,
                 quant: Quant = None) -> dict:
    """Run len(batches) training steps from params0 / bn0 (no more than 3:
    the 4th would apply the orthonormal constraint).

    batches: dicts of features [B, T_in, D], ivectors [B, I], weights [B],
    deriv_weights [B, n_out], num (the numerator arrays), left_context.
    cfg: frame_subsampling_factor, momentum, max_param_change, l2, oor,
    leaky, xent_regularize, natural_gradient, ng_rank_in, ng_rank_out.
    Returns per-step loss / num_lp / den_lp (means over sequences), the
    network's outputs at step 1 (on the host), the gradient each leaf's
    optimizer got at step 1 (its velocity after it), and the parameters
    after the last step."""
    if len(batches) > 3:
        raise ValueError("the reference follows at most 3 steps")
    stride = cfg["frame_subsampling_factor"]
    hyper = layer_hyperparams(model)
    chain_name = model.chain_output().name
    xent_layer = model.xent_output()
    xent_reg = cfg["xent_regularize"]
    sites = ng_sites(model) if cfg["natural_gradient"] else []
    ng_in = ngmod.NGConfig(rank=cfg["ng_rank_in"])
    ng_out = ngmod.NGConfig(rank=cfg["ng_rank_out"])
    dev = next(iter(next(iter(params0.values())).values())).device
    ng_states = (init_ng_states(model, cfg["ng_rank_in"], cfg["ng_rank_out"],
                                dev) if sites else None)
    params = {l: {k: w.detach().clone().float() for k, w in p.items()}
              for l, p in params0.items()}
    bn = bn0
    velocity = {l: {k: torch.zeros_like(w) for k, w in p.items()}
                for l, p in params.items()}
    out = {"loss": [], "num_lp": [], "den_lp": [], "grad1": None}
    grid = grid_layers(model, stride)
    for i, b in enumerate(batches):
        feats = b["features"]
        B, T_in, _ = feats.shape
        left = b["left_context"]
        n_out = b["deriv_weights"].shape[1]
        use_grid = chain_name in grid
        n_grid = (T_in - stride) // stride + 1 if use_grid else 0
        if use_grid and n_out > n_grid:
            use_grid, n_grid = False, 0
        ts = (stride, left % stride, n_grid) if use_grid else None

        def pick(full, name):
            if use_grid and name in grid:
                s = left // stride
                return full[:, s:s + n_out]
            return full[:, left:left + (n_out - 1) * stride + 1:stride]

        leaves = {l: {k: w.requires_grad_(True) for k, w in p.items()}
                  for l, p in params.items()}
        ctx = NGContext() if sites else None
        outs, new_bn = forward(model, leaves, bn, feats, b.get("ivectors"),
                               generator=generator, time_subsample=ts,
                               ng=ctx, quant=quant)
        chain_out = pick(outs[chain_name], chain_name)
        objf, deriv, num_post, num_lp, den_lp = chain_objective(
            den, b["num"], chain_out.detach(), b["weights"],
            b["deriv_weights"], cfg["l2"], cfg["oor"], cfg["leaky"])
        surrogate = -(chain_out * deriv.float()).sum()
        loss = -objf
        if xent_reg > 0 and xent_layer is not None:
            xent = pick(outs[xent_layer.name], xent_layer.name)
            xent = xent * b["deriv_weights"][:, :, None]
            xent_objf = torch.sum(b["weights"][:, None, None]
                                  * num_post.float() * xent)
            surrogate = surrogate - xent_reg * xent_objf
            loss = loss - xent_reg * xent_objf.detach().double()
        surrogate.backward()
        grads = {l: {k: (w.grad.detach() if w.grad is not None
                         else torch.zeros_like(w)) for k, w in p.items()}
                 for l, p in leaves.items()}
        if sites:
            ng_states, grads = _ng_step(model, sites, ng_states, ctx, grads,
                                        ng_in, ng_out)
            del ctx
        params, velocity = sgd_update(
            {l: {k: w.detach() for k, w in p.items()}
             for l, p in leaves.items()},
            grads, velocity, lrs[i], cfg["momentum"],
            cfg["max_param_change"], hyper)
        bn = new_bn
        if i == 0:
            out["grad1"] = {(l, k): v.clone() for l, p in velocity.items()
                            for k, v in p.items()}
            out["outs"] = {k: v.detach().cpu() for k, v in outs.items()}
        out["loss"].append(float(loss))
        out["num_lp"].append(float(num_lp.mean()))
        out["den_lp"].append(float(den_lp.mean()))
        del outs, chain_out, deriv, num_post, surrogate, grads
    out["params"] = params
    return out
