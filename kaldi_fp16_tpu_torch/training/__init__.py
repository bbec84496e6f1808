"""Training: SGD with momentum and max-change, loss scaling, the
semi-orthogonal constraint, and the chain train step."""

from kaldi_fp16_tpu_torch.training.optimizer import (
    SGDConfig, init_sgd_state, sgd_update,
)
from kaldi_fp16_tpu_torch.training.loss_scale import (
    LossScaleState, init_loss_scale, update_loss_scale,
)
from kaldi_fp16_tpu_torch.training.train_step import (
    TrainConfig, TrainStepOutput, make_train_step,
)
