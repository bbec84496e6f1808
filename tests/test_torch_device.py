"""The port runs on the card unless it is asked for the CPU.

On a box without CUDA every public entry point that takes a device raises
when it is given none, instead of computing on the CPU; with
device="cpu" the same calls run.  (On a machine with a card the default
is the current CUDA device, which chip_smoke.py exercises; these tests
then skip.)"""

import numpy as np
import pytest
import torch

from kaldi_fp16_tpu_torch.chain.den_layout import analyze_chain_structure
from kaldi_fp16_tpu_torch.chain.den_structured import StructuredKernels
from kaldi_fp16_tpu_torch.chain.denominator import DenominatorComputation
from kaldi_fp16_tpu_torch.chain.graph import (
    DenominatorGraph, make_phone_lm_den_fst, make_simple_den_fst,
)
from kaldi_fp16_tpu_torch.device import default_device, resolve_device
from kaldi_fp16_tpu_torch.models.model import build_model_from_string
from kaldi_fp16_tpu_torch.models.network import Network, spec_augment_masks
from kaldi_fp16_tpu_torch.models.layers import SpecAugmentSpec
from kaldi_fp16_tpu_torch.ops.den_matmul import DenMatmul
from kaldi_fp16_tpu_torch.tools import train as train_tool
from kaldi_fp16_tpu_torch.training.loss_scale import init_loss_scale
from kaldi_fp16_tpu_torch.training.natural_gradient import init_ng_state
from kaldi_fp16_tpu_torch.training.train_step import (
    TrainConfig, init_train_state,
)
from kaldi_fp16_tpu_torch.training.trainer import Trainer

XCONFIG = ("input name=input dim=8\n"
           "relu-batchnorm-layer name=tdnn1 dim=16\n"
           "output-layer name=output dim=12 include-log-softmax=false\n")


def _graphs():
    structured = DenominatorGraph.from_fst(
        make_phone_lm_den_fst(24, 13, 2, 4, seed=3), 24)
    blocked = DenominatorGraph.from_fst(
        make_simple_den_fst(num_pdfs=6, num_states=5, seed=3), 6)
    return structured, blocked


ENTRY_POINTS = {
    "DenMatmul": lambda s, b, **kw: DenMatmul(np.eye(8, dtype=np.float32),
                                              **kw),
    "StructuredKernels": lambda s, b, **kw: StructuredKernels(
        analyze_chain_structure(s), 1e-5, **kw),
    "DenominatorComputation-structured": lambda s, b, **kw:
        DenominatorComputation(s, **kw),
    "DenominatorComputation-blocked": lambda s, b, **kw:
        DenominatorComputation(b, **kw),
    "Network": lambda s, b, **kw: Network(build_model_from_string(XCONFIG),
                                          torch.Generator(), **kw),
    "init_train_state": lambda s, b, **kw: init_train_state(
        build_model_from_string(XCONFIG), torch.Generator(), TrainConfig(),
        **kw),
    "init_train_state-ng": lambda s, b, **kw: init_train_state(
        build_model_from_string(XCONFIG), torch.Generator(),
        TrainConfig(natural_gradient=True), **kw),
    "init_ng_state": lambda s, b, **kw: init_ng_state(8, **kw),
    "Trainer": lambda s, b, **kw: Trainer(
        build_model_from_string(XCONFIG),
        DenominatorComputation(s, device="cpu"),
        TrainConfig(natural_gradient=True), **kw),
    "init_loss_scale": lambda s, b, **kw: init_loss_scale(**kw),
    "spec_augment_masks": lambda s, b, **kw: spec_augment_masks(
        SpecAugmentSpec(dim=8, freq_max_proportion=0.5,
                        time_zeroed_proportion=0.2, time_mask_max_frames=4),
        2, 10, torch.Generator(), **kw),
}


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_raises_without_a_device_on_a_cpu_box(no_card, name):
    structured, blocked = _graphs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name](structured, blocked)
    ENTRY_POINTS[name](structured, blocked, device="cpu")


def test_resolve_device(no_card):
    with pytest.raises(RuntimeError):
        default_device()
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")


def test_train_tool_raises_without_a_device(no_card, tmp_path):
    """tools.train resolves its device before it reads anything: with no
    --device on a box without a card it raises."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_tool.main(["--egs", str(tmp_path / "none.*.ark"),
                         "--den-fst", str(tmp_path / "den.fst"),
                         "--xconfig", str(tmp_path / "x.xconfig"),
                         "--pdfs", "12"])
