"""What the training drivers share: the program's den and model from a
configuration, the benchmark's weights put into the program, the
program's readings of its first steps, the reference's, and the
comparison that decides `correct`.

The comparison follows the first three steps of a run.  Numbers compared
(each against the limit in the cell's workload file, `limits`):

- out_gap: the network's outputs at step 1 (every output head, at the
  frames the step computes them), ||program - reference|| / ||reference||,
  the larger over the heads;
- grad_gap: the median leaf's gap between the norms of the gradient its
  optimizer got at step 1 (its velocity after step 1, NG-preconditioned
  where the cell has NG), relative to the larger of the reference leaf's
  norm and the median leaf's;
- change_gap: the same for each leaf's change over the three steps;
- chain_den_gap, chain_num_gap, chain_deriv_gap: the chain objective on
  the program's own step-1 output (the float32 input of its den), the
  reference's float64 den and numerator against what the program
  computed from that same output: the largest sequence's relative gap of
  the den log-prob, the relative gap of the mean numerator log-prob, and
  ||program's derivative - reference's|| / ||reference's|| of the
  objective by that output (the gradient the program's backward got
  there, over minus its loss scale).

Leaves whose reference gradient at step 1 is under a thousandth of the
median leaf's are left out of the leaf numbers: they move by round-off
alone.  Beside them, and not compared, the run reports on standard error
(`info`) the loss, numerator and denominator log-prob gaps of the
reference's own three steps, the worst leaves' gaps, and the median
leaf's ||program's vector - reference's|| of the step-1 gradient
(grad_vec_gap) and of the change over the three steps (change_vec_gap):
PERF.md gives the readings that left them out of the comparison.
"""

from __future__ import annotations

import gc
import math
import statistics
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.counts.den_scan import den_flops, scan_work
from benchmark.counts.network import step_flops
from benchmark.reference import model as ref_model
from benchmark.reference.chain import (
    DenGraph, chain_objective, num_forward_backward,
)
from benchmark.reference.network import fp8_quant, init_bn_state
from benchmark.reference.train import follow_steps
from benchmark.traffic.phone_lm import den_arcs
from benchmark.traffic.weights import make_weights

CHECK_STEPS = 3
NET_NUMBERS = ("out_gap", "grad_gap", "change_gap")
CHAIN_NUMBERS = ("chain_den_gap", "chain_num_gap", "chain_deriv_gap")
NUMBERS = NET_NUMBERS + CHAIN_NUMBERS


def xconfig_path(spec: dict) -> str:
    return str(spec["root"] / "benchmark" / "configs"
               / spec["config"]["xconfig"])


def port_den(spec: dict, device, mode: str = "exact"):
    """The program's DenominatorComputation of the configuration's den."""
    from kaldi_fp16_tpu_torch.chain.denominator import DenominatorComputation
    from kaldi_fp16_tpu_torch.chain.graph import DenominatorGraph
    from kaldi_fp16_tpu_torch.io.fst import Fst, FstArc, FstState
    cfg = spec["config"]
    a = den_arcs(cfg["den"])
    states = [FstState(final=0.0) for _ in range(a["states"])]
    for s, lab, w, d in zip(a["src"].tolist(), a["label"].tolist(),
                            a["weight"].tolist(), a["dst"].tolist()):
        states[s].arcs.append(FstArc(lab, w, d))
    graph = DenominatorGraph.from_fst(Fst(start=a["start"], states=states),
                                      cfg["pdfs"])
    return DenominatorComputation(graph, leaky=spec["cell"]["leaky_hmm"],
                                  mode=mode, device=device)


def ref_den(spec: dict, device) -> DenGraph:
    a = den_arcs(spec["config"]["den"])
    keep = a["label"] > 0
    return DenGraph.from_arcs(a["src"][keep], a["dst"][keep],
                              a["label"][keep] - 1, a["weight"][keep],
                              a["states"], a["start"], device)


@torch.no_grad()
def load_weights(params: dict, weights: dict) -> None:
    """Copy the benchmark's weights into the program's parameters."""
    for lname, p in weights.items():
        for k, w in p.items():
            params[lname][k].copy_(w)


class OutputTap:
    """Holds, on the host, the outputs of a network's next forward (a
    forward hook, removed after one call)."""

    def __init__(self, net):
        self.outs = None
        self._handle = net.register_forward_hook(self._hook)

    def _hook(self, module, inputs, output):
        self.outs = {k: v.detach().float().cpu() for k, v in output[0].items()}
        self._handle.remove()


class ChainTap:
    """Holds, on the host, the input and outputs of a den's next
    forward_backward (the chain objective's input, float32 [B, T, P], and
    the den log-probs) and the gradient the backward then gets at that
    input.  It wraps the method on the instance for one call."""

    def __init__(self, den):
        self.den = den
        self.x = self.den_lp = self.grad = None
        den.forward_backward = self._call

    def _call(self, nnet_output):
        del self.den.forward_backward       # back to the class's method
        lp, post = self.den.forward_backward(nnet_output)
        self.x = nnet_output.detach().float().cpu()
        self.den_lp = lp.detach().double().cpu()
        if nnet_output.requires_grad:
            nnet_output.register_hook(self._grad)
        return lp, post

    def _grad(self, g):
        self.grad = g.detach().float().cpu()

    def readings(self, scale: float, num_lp_mean: float) -> dict:
        if self.x is None or self.grad is None:
            raise RuntimeError("the den's forward_backward or its backward "
                               "did not run in the tapped step")
        return {"x": self.x, "den_lp": self.den_lp,
                "deriv": self.grad.double() / -scale,
                "num_lp_mean": num_lp_mean}


def param_deltas(params: dict, weights: dict, keys) -> dict:
    """Each leaf's change from the seed's weights, on the host."""
    with torch.no_grad():
        return {(l, k): (params[l][k].float() - weights[l][k].float()).cpu()
                for l, k in keys}


def host_leaves(tree: dict, keys) -> dict:
    """Each leaf of a {layer: {name: tensor}} tree, float32 on the host."""
    return {(l, k): tree[l][k].detach().float().cpu() for l, k in keys}


class HostLog:
    """The window's host-side record, reported on standard error: the host
    time between step marks (the host runs ahead of the device, so a long
    one is the host's own pause or a wait on the device) and Python's
    garbage collections by generation, with their seconds."""

    def __init__(self):
        self.marks = []
        self.gc = {}
        self.tracked = len(gc.get_objects())    # before the window opens
        self._t = None

    def _gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            slot = self.gc.setdefault(info["generation"], [0, 0.0, 0.0])
            dt = time.perf_counter() - self._t
            slot[0] += 1
            slot[1] += dt
            slot[2] = max(slot[2], dt)
            self._t = None

    def start(self, t0: float) -> None:
        self.marks = [t0]
        gc.callbacks.append(self._gc)

    def mark(self) -> None:
        self.marks.append(time.perf_counter())

    def stop(self) -> None:
        if self._gc in gc.callbacks:
            gc.callbacks.remove(self._gc)

    def summary(self) -> dict:
        dt = [b - a for a, b in zip(self.marks, self.marks[1:])]
        if not dt:
            return {"tracked_objects": self.tracked}
        med = statistics.median(dt)
        return {"tracked_objects": self.tracked,
                "step_s_median": med, "step_s_max": max(dt),
                "steps_over_1.5x": sum(1 for d in dt if d > 1.5 * med),
                "steps": len(dt),
                "gc": {f"gen{g}": {"count": c, "s": s, "max_s": m}
                       for g, (c, s, m) in sorted(self.gc.items())}}


def leaf_norms(tree: dict, keys) -> Dict[tuple, float]:
    vals = torch.stack([tree[l][k].float().norm() for l, k in keys]).tolist()
    return dict(zip(keys, vals))


def flops_per_step(spec: dict, frames_in: int, natural_gradient: bool
                   ) -> float:
    """The model's work per step (network forward and backward, the den's
    forward-backward) from the configuration's shapes."""
    cell, cfg = spec["cell"], spec["config"]
    model = ref_model.build_model(xconfig_path(spec))
    den = cfg["den"]
    return (step_flops(model, cell["batch"], frames_in,
                       cfg["frame_subsampling_factor"],
                       cut_convs=not natural_gradient)
            + den_flops(den["chains"], den["states_per_phone"], cell["batch"],
                        cell["frames_out"], den["states"], cfg["pdfs"]))


def den_scan_bound(spec: dict) -> dict:
    den = spec["config"]["den"]
    return scan_work(den["chains"], den["states_per_phone"],
                     spec["cell"]["batch"], spec["cell"]["frames_out"])


def reference_readings(spec: dict, weights: dict, batches: List[dict],
                       lrs: List[float], mask_seed: Optional[int], device,
                       control: bool = False, quant=None) -> dict:
    """The reference's readings of the first steps, from the benchmark's
    weights and batches (float32 network, float64 chain; the control:
    the network's operands in float8; `quant`: another rounding of them)."""
    cell = spec["cell"]
    model = ref_model.build_model(xconfig_path(spec))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = (torch.Generator(device=device).manual_seed(mask_seed)
           if mask_seed is not None else None)
    cfg = {"frame_subsampling_factor":
           spec["config"]["frame_subsampling_factor"],
           "momentum": cell["momentum"],
           "max_param_change": cell["max_param_change"],
           "l2": cell["l2_regularize"], "oor": cell["out_of_range_regularize"],
           "leaky": cell["leaky_hmm"], "xent_regularize": cell["xent_regularize"],
           "natural_gradient": cell["natural_gradient"],
           "ng_rank_in": cell["ng_rank_in"], "ng_rank_out": cell["ng_rank_out"]}
    out = follow_steps(model, weights, init_bn_state(model, device), batches,
                       ref_den(spec, device), cfg, lrs, generator=gen,
                       quant=fp8_quant if control else quant)
    keys = [(l, k) for l, p in weights.items() for k in p]
    return {"loss": out["loss"], "num_lp": out["num_lp"],
            "den_lp": out["den_lp"], "outs": out["outs"],
            "grad1": {key: float(out["grad1"][key].norm()) for key in keys},
            "grad1_vec": {key: out["grad1"][key].detach().float().cpu()
                          for key in keys},
            "change": {(l, k): float((out["params"][l][k]
                                      - weights[l][k]).norm())
                       for l, k in keys},
            "delta": param_deltas(out["params"], weights, keys)}


def chain_reference(spec: dict, x: torch.Tensor, batch: dict, device,
                    den_fb=None, num_dtype=None) -> dict:
    """The reference chain objective (float64) on the program's step-1
    output `x` [B, T, P] and the batch's numerator graphs.  `den_fb`: a
    den put in the reference's place (x -> (log_prob, posteriors)), as the
    control puts the program's bf16 den; `num_dtype`: the numerator's
    precision in its place (the control's bf16).  None where `x` is not of the
    batch's shape."""
    cell = spec["cell"]
    if tuple(x.shape[:2]) != tuple(batch["deriv_weights"].shape):
        return None         # not the batch's shape: nothing to compare
    xd = x.to(device).double()
    _, deriv, _, num_lp, den_lp = chain_objective(
        ref_den(spec, device), batch["num"], xd, batch["weights"],
        batch["deriv_weights"], cell["l2_regularize"],
        cell["out_of_range_regularize"], cell["leaky_hmm"], den_fb=den_fb)
    if num_dtype is not None:
        num_lp, _ = num_forward_backward(batch["num"], xd, dtype=num_dtype)
    return {"den_lp": den_lp.cpu(), "deriv": deriv.cpu(),
            "num_lp_mean": float(num_lp.mean())}


def chain_control(spec: dict, x: torch.Tensor, batch: dict, device,
                  fast=None) -> dict:
    """The chain's control on the program's step-1 output `x`: the
    program's own bf16 den (`fast`, built here when None: mode "fast") in
    the exact den's place, and the reference numerator computed in bf16;
    read as the program's readings are."""
    if fast is None:
        fast = port_den(spec, device, mode="fast")
    rc = chain_reference(
        spec, x, batch, device,
        den_fb=lambda o: fast.forward_backward(o.float()),
        num_dtype=torch.bfloat16)
    return {"den_lp": rc["den_lp"], "deriv": rc["deriv"],
            "num_lp_mean": rc["num_lp_mean"]}


def _leaf_gaps(prog: dict, ref: dict, name: str, kept: list) -> dict:
    floor = statistics.median(ref[name][k] for k in kept)
    return {k: abs(prog[name][k] - ref[name][k])
            / max(ref[name][k], floor, 1e-30) for k in kept}


def _out_gap(prog: dict, ref: dict) -> float:
    gaps = []
    for name, r in ref["outs"].items():
        p = prog["outs"].get(name)
        if p is None or p.shape != r.shape:
            return math.inf
        gaps.append(float((p.double() - r.double()).norm()
                          / r.double().norm().clamp(min=1e-30)))
    return max(gaps)


def _vec_gaps(prog: dict, ref: dict, vec: str, norm: str,
              kept: list) -> dict:
    """Each kept leaf's ||program's vector - reference's|| (`vec`: the
    step-1 gradient or the change), relative to the larger of the
    reference leaf's norm (`norm`) and the median leaf's."""
    floor = statistics.median(ref[norm][k] for k in kept)
    return {k: float((prog[vec][k].double() - ref[vec][k].double()).norm())
            / max(ref[norm][k], floor, 1e-30) for k in kept}


def chain_gaps(pc: dict, rc: dict) -> dict:
    """The chain numbers: the program's readings on its own output `pc`
    against the reference's on the same output `rc`."""
    den = ((pc["den_lp"] - rc["den_lp"]).abs()
           / rc["den_lp"].abs().clamp(min=1e-30)).max()
    num = (abs(pc["num_lp_mean"] - rc["num_lp_mean"])
           / max(abs(rc["num_lp_mean"]), 1e-30))
    deriv = ((pc["deriv"] - rc["deriv"]).norm()
             / rc["deriv"].norm().clamp(min=1e-30))
    return {"chain_den_gap": float(den), "chain_num_gap": float(num),
            "chain_deriv_gap": float(deriv)}


def gaps(prog: dict, ref: dict) -> tuple:
    """({number: value} of every number both sides have readings for, the
    vector gaps among them; info)."""
    med = statistics.median(ref["grad1"].values())
    kept = [k for k, v in ref["grad1"].items() if v >= 1e-3 * med]
    grad = _leaf_gaps(prog, ref, "grad1", kept)
    change = _leaf_gaps(prog, ref, "change", kept)
    values = {"out_gap": _out_gap(prog, ref),
              "grad_gap": statistics.median(grad.values()),
              "change_gap": statistics.median(change.values())}
    vecs = {}
    for name, vec, norm in (("grad_vec_gap", "grad1_vec", "grad1"),
                            ("change_vec_gap", "delta", "change")):
        if vec in prog and vec in ref:
            vecs[name] = _vec_gaps(prog, ref, vec, norm, kept)
            values[name] = statistics.median(vecs[name].values())
    if prog.get("chain") is not None and ref.get("chain") is not None:
        values.update(chain_gaps(prog["chain"], ref["chain"]))

    def rel(name):
        return [abs(p - r) / max(abs(r), 1e-30)
                for p, r in zip(prog[name], ref[name])]
    gw, cw = max(grad, key=grad.get), max(change, key=change.get)
    info = {"loss_gap_steps": rel("loss"), "num_lp_gap_steps": rel("num_lp"),
            "den_lp_gap_steps": rel("den_lp"),
            "grad_worst_leaf": ["/".join(gw), grad[gw]],
            "change_worst_leaf": ["/".join(cw), change[cw]]}
    for name, v in vecs.items():
        w = max(v, key=v.get)
        info[name.replace("_gap", "_worst_leaf")] = ["/".join(w), v[w]]
    return values, info


def compare(prog: dict, ref: dict, limits: Dict[str, float]) -> tuple:
    """(checks [{"name", "value", "limit"}], correct, info).  Every number
    the limits name is judged; one with no readings reads inf."""
    values, info = gaps(prog, ref)
    checks = [{"name": n, "value": values.get(n, math.inf),
               "limit": limits[n]} for n in NUMBERS if n in limits]
    correct = bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks)
    return checks, correct, info


def memory_peak(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) \
        if device.type == "cuda" else 0


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free_device(device) -> None:
    import gc
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def leaf_keys(weights: dict) -> list:
    return [(l, k) for l, p in weights.items() for k in p]


def as_list(xs) -> list:
    """Device scalars -> floats, in one transfer."""
    if not xs:
        return []
    return torch.stack([x.float().reshape(()) for x in xs]).tolist()


def seed_weights(spec: dict, seed: int, device) -> dict:
    model = ref_model.build_model(xconfig_path(spec))
    return make_weights(model, seed, device)


def finite(xs) -> np.ndarray:
    return np.isfinite(np.asarray(xs, dtype=np.float64))
