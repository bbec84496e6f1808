"""The chain training step on PyTorch.

Port of kaldi_fp16_tpu/training/train_step.py (`TrainConfig` :51,
`make_train_step` :141-364, `init_train_state` :367), without NG-SGD
(natural gradient) and rematerialisation, which are not ported yet.
Per step, as Kaldi NnetChainTrainer::TrainInternal:

  features/ivectors -> Network.forward (bf16 compute, frame grid)
  -> supervision frames (stride 3 from left_context)
  -> chain objective (autograd.Function: analytic forward-backward deriv)
  [+ xent head: xent_regularize * sum(num_post * log_softmax)]
  -> backward -> loss-scale bookkeeping
  -> SGD with momentum, per-component + global max-change
  -> every `orthonormal_interval` non-skipped steps, the semi-orthogonal
     constraint on the bottleneck linears.

The step updates the Network's parameters and BN statistics in place.  A
non-finite gradient (judged on the raw grads) skips the update and keeps
the old BN statistics.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional

import torch

from kaldi_fp16_tpu_torch.chain.denominator import DenominatorComputation
from kaldi_fp16_tpu_torch.chain.graph import NumeratorGraphBatch
from kaldi_fp16_tpu_torch.device import resolve_device
from kaldi_fp16_tpu_torch.chain.objective import (
    ChainTrainingOpts, make_chain_objf_with_post,
)
from kaldi_fp16_tpu_torch.models.model import Model
from kaldi_fp16_tpu_torch.models.network import (
    Network, grid_layers, trainable_mask,
)
from kaldi_fp16_tpu_torch.training.loss_scale import (
    grads_finite, init_loss_scale, tree_leaves, tree_map, unscale_grads,
    update_loss_scale,
)
from kaldi_fp16_tpu_torch.training.optimizer import (
    SGDConfig, init_sgd_state, layer_hyperparams, sgd_update,
)
from kaldi_fp16_tpu_torch.training.orthonormal import (
    constrain_orthonormal, orthonormal_targets,
)


@dataclass(frozen=True)
class TrainConfig:
    """(ref: TrainConfig train_step.go:21-28 + ChainTrainingOpts)."""
    learning_rate: float = 1e-3
    momentum: float = 0.0
    max_param_change: float = 2.0
    frame_subsampling_factor: int = 3
    left_context: int = 0          # row offset of the first supervised frame
    xent_regularize: float = 0.0
    use_loss_scaling: bool = False
    compute_dtype: str = "bfloat16"
    # semi-orthogonal constraint every N non-skipped steps (0 disables)
    orthonormal_interval: int = 4
    # run grid-eligible layers only at the supervision frame rate
    grid_subsample: bool = True


class TrainStepOutput(NamedTuple):
    loss: torch.Tensor
    objf_per_frame: torch.Tensor
    num_logprob: torch.Tensor
    den_logprob: torch.Tensor
    xent_objf: torch.Tensor
    param_change_norm: torch.Tensor
    grad_norm: torch.Tensor
    loss_scale: torch.Tensor
    skipped: torch.Tensor
    ok: torch.Tensor


def make_train_step(model: Model, net: Network,
                    den: DenominatorComputation,
                    num_graph: NumeratorGraphBatch,
                    chain_opts: ChainTrainingOpts = ChainTrainingOpts(),
                    config: TrainConfig = TrainConfig(),
                    num_frames_out: Optional[int] = None):
    """Build step(opt_state, scale_state, batch, generator=None,
    spec_masks=None, lr=None) -> (opt_state, scale_state, TrainStepOutput)
    for one batch geometry.

    batch: {"features" [B, T_in, D], "ivectors" [B, ivec] (if the model
    has them), "weights" [B] (optional), "deriv_weights" [B, n_out]
    (optional: masks the chain derivative and the xent head per frame)}.
    generator draws the SpecAugment masks (or spec_masks gives them).
    """
    objf_fn = make_chain_objf_with_post(num_graph, den, chain_opts)
    hyper = layer_hyperparams(model)
    dtype = torch.bfloat16 if config.compute_dtype == "bfloat16" \
        else torch.float32
    # two spellings of the Kaldi option exist; honour whichever is set
    xent_regularize = config.xent_regularize or chain_opts.xent_regularize
    sgd_cfg = SGDConfig(learning_rate=config.learning_rate,
                        momentum=config.momentum,
                        max_param_change=config.max_param_change)
    stride = config.frame_subsampling_factor
    left_context = config.left_context
    chain_head_name = model.chain_output().name
    xent_layer = model.xent_output()
    targets = (orthonormal_targets(model) if config.orthonormal_interval > 0
               else [])

    def step(opt_state, scale_state, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             spec_masks: Optional[dict] = None, lr: Optional[float] = None):
        feats = batch["features"]
        ivecs = batch.get("ivectors")
        weights = batch.get("weights")
        dws = batch.get("deriv_weights")
        B, T_in, _ = feats.shape
        dev = feats.device
        n_out = num_frames_out or (T_in - left_context + stride - 1) // stride
        if weights is None:
            weights = torch.ones(B, dtype=torch.float32, device=dev)
        dws_arg = (torch.ones((B, n_out), dtype=torch.float32, device=dev)
                   if dws is None else dws.float())

        # frame-grid subsampling: the grid-eligible suffix of the network
        # runs only at frames {left_context % stride + k*stride}; the output
        # heads then come back on the grid and the pick is a unit-stride slice
        grid = grid_layers(model, stride) if config.grid_subsample \
            else frozenset()
        use_grid = chain_head_name in grid
        n_grid = (T_in - stride) // stride + 1 if use_grid else 0
        if use_grid and n_out > n_grid:
            # chunk shorter than the supervision span: full-rate program
            use_grid, grid, n_grid = False, frozenset(), 0
        time_subsample = ((stride, left_context % stride, n_grid)
                          if use_grid else None)

        def pick_frames(full, on_grid):
            if on_grid:
                s = left_context // stride
                return full[:, s:s + n_out]
            return full[:, left_context:
                        left_context + (n_out - 1) * stride + 1:stride]

        params = net.params
        old_state = net.bn_state()
        net.zero_grad(set_to_none=True)
        outs, new_state = net(feats, ivecs, train=True, compute_dtype=dtype,
                              time_subsample=time_subsample,
                              spec_masks=spec_masks, generator=generator)
        out = pick_frames(outs[chain_head_name].float(), use_grid)
        objf, result, num_post = objf_fn(out, weights, dws_arg)
        loss = -objf
        xent_objf = torch.zeros((), dtype=torch.float32, device=dev)
        if xent_regularize > 0 and xent_layer is not None:
            xent = pick_frames(outs[xent_layer.name].float(),
                               xent_layer.name in grid)
            xent = xent * dws_arg[:, :, None]
            xent_objf = torch.sum(weights[:, None, None] * num_post * xent)
            loss = loss - xent_regularize * xent_objf
        if config.use_loss_scaling:
            loss = loss * scale_state.scale
        loss.backward()
        loss = loss.detach()
        # a parameter with no path to the loss (e.g. the xent head when
        # xent_regularize is 0) has a zero gradient, as under jax.grad
        grads = {l: {k: (w.grad if w.grad is not None
                         else torch.zeros_like(w)) for k, w in p.items()}
                 for l, p in params.items()}

        if config.use_loss_scaling:
            loss = loss / scale_state.scale
            grads = unscale_grads(grads, scale_state)

        # finiteness is judged on the raw grads
        finite = grads_finite(grads)
        if config.use_loss_scaling:
            new_scale_state, skip = update_loss_scale(scale_state, finite)
        else:
            new_scale_state, skip = scale_state, ~finite
        grad_norm = torch.sqrt(sum(torch.sum(g.float() ** 2)
                                   for g in tree_leaves(grads)))

        # a skipped (non-finite) batch must not poison the BN statistics
        net.set_bn_state(tree_map(lambda new, old: torch.where(skip, old, new),
                                  new_state, old_state))

        new_params, new_opt_state, stats = sgd_update(
            params, grads, opt_state, sgd_cfg, lr=lr, hyper=hyper,
            trainable=trainable_mask(model, params), skip=skip)
        with torch.no_grad():
            for l, p in params.items():
                for k, w in p.items():
                    w.copy_(new_params[l][k])
            # Kaldi applies ConstrainOrthonormal after the parameter update
            if targets and bool(
                    (new_opt_state["step"] % config.orthonormal_interval == 0)
                    & ~skip):
                for lname, pname, c in targets:
                    w = params[lname][pname]
                    w.copy_(constrain_orthonormal(w, c))

        return new_opt_state, new_scale_state, TrainStepOutput(
            loss=loss,
            objf_per_frame=result.objf_per_frame,
            num_logprob=result.num_logprob.mean(),
            den_logprob=result.den_logprob.mean(),
            xent_objf=xent_objf.detach(),
            param_change_norm=stats["param_change_norm"],
            grad_norm=grad_norm,
            loss_scale=new_scale_state.scale,
            skipped=skip,
            ok=result.ok.all(),
        )

    return step


def init_train_state(model: Model, generator: torch.Generator,
                     config: TrainConfig = TrainConfig(), device=None):
    """(net, opt_state, loss_scale_state), on `device` (default: the
    current CUDA device)."""
    device = resolve_device(device)
    net = Network(model, generator, device)
    opt_state = init_sgd_state(net.params)
    scale_state = (init_loss_scale(device=device) if config.use_loss_scaling
                   else init_loss_scale(1.0, device=device))
    return net, opt_state, scale_state
