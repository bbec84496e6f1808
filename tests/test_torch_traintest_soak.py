"""The port's traintest, soak and abtest twins on the CPU.

* traintest at the JAX tool's defaults (its default model, 20 steps of 8
  on its synthetic cegs) makes the loss fall, and its pipelined loop's
  per-step losses equal Trainer.train_epoch's on the same batches, bit
  for bit.
* traintest's training from the JAX init on the same batches, at the JAX
  tool's lr 1e-2 and at 1e-3: the port's per-step losses follow the JAX
  package's (narrow flagship shape, fp32).
* soak on a narrow recipe model: SIGKILL mid-run, --resume, every check
  passes, with the JAX tool's result keys and re-trained steps that
  reproduce run 1's objf exactly.  The control: the same soak with the
  newest checkpoint's optimizer state reset before the resume fails.
* A kill inside a checkpoint save leaves only a temporary file, which
  the manager ignores: the resume takes the newest complete checkpoint.
* abtest --ab grid runs both arms and writes ab_result.json; den-mode and
  bn-lowp (revoked, not ported) exit 2.
"""

import itertools
import json

import numpy as np
import pytest
import torch

from kaldi_fp16_tpu_torch.chain.denominator import DenominatorComputation
from kaldi_fp16_tpu_torch.chain.graph import DenominatorGraph
from kaldi_fp16_tpu_torch.chain.objective import ChainTrainingOpts
from kaldi_fp16_tpu_torch.io.dataloader import DataLoader, DataLoaderConfig
from kaldi_fp16_tpu_torch.io.fst import read_fst_file
from kaldi_fp16_tpu_torch.models.model import build_model_from_string
from kaldi_fp16_tpu_torch.tools import (
    abtest, make_synthetic_egs, soak, traintest,
)
from kaldi_fp16_tpu_torch.training.checkpoint import CheckpointManager
from kaldi_fp16_tpu_torch.training.train_step import TrainConfig
from kaldi_fp16_tpu_torch.training.trainer import Trainer
from tests.test_torch_train_tool import EGS_XCONFIG
from tests.test_torch_tool_help import two_threads  # noqa: F401

# tools/soak.py's soak_result.json keys
SOAK_KEYS = {
    "killed_at_step", "last_ckpt_step", "resumed_at_step", "resume_ok",
    "no_restart", "replayed_steps", "replay_max_objf_diff", "replay_exact",
    "pre_kill_tail_objf", "post_resume_head_objf", "continuity_band",
    "continuity_ok", "lr_schedule_preserved", "final_objf", "total_steps"}


def test_traintest_loss_falls_and_equals_train_epoch(tmp_path, capsys):
    # the cegs traintest writes at its defaults (20 steps of 8)
    make_synthetic_egs.main([str(tmp_path), "--files", "2", "--per-file",
                             "104", "--pdfs", "48", "--frames-in", "48",
                             "--frames-out", "15"])
    res = traintest.main(["--device", "cpu", "--egs-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert res["improved"] and "(improved)" in out
    assert len(res["losses"]) == 20 and res["timed_steps"] == 18

    model = build_model_from_string(traintest.DEFAULT_XCONFIG.format(
        pdfs=48))
    den = DenominatorComputation(DenominatorGraph.from_fst(
        read_fst_file(str(tmp_path / "den.fst")), 48), leaky=1e-5,
        device="cpu")
    trainer = Trainer(model, den, TrainConfig(learning_rate=0.01,
                                              momentum=0.5),
                      ChainTrainingOpts(), device="cpu")
    losses = []
    run = trainer.train_batch

    def keep(*a, **k):
        o = run(*a, **k)
        losses.append(o.loss.item())
        return o

    trainer.train_batch = keep
    cfg = DataLoaderConfig(batch_size=8, label_dim=48, max_fst_states=64,
                           max_fst_arcs=128)
    trainer.train_epoch(itertools.islice(
        DataLoader(str(tmp_path / "cegs.*.ark"), cfg), 20))
    assert losses == res["losses"]


def soak_argv(workdir, xconfig):
    return ["--workdir", str(workdir), "--device", "cpu", "--xconfig",
            str(xconfig), "--pdfs", "12", "--files", "2", "--per-file", "16",
            "--batch", "4", "--epochs", "8", "--ckpt-every", "20",
            "--kill-after-steps", "22"]


@pytest.fixture
def xconfig(tmp_path):
    path = tmp_path / "narrow.xconfig"
    path.write_text(EGS_XCONFIG)
    return path


def test_soak_resumes_exactly(tmp_path, xconfig, capsys):
    res = soak.main(soak_argv(tmp_path / "soak", xconfig))
    assert "SOAK PASS" in capsys.readouterr().out
    assert res["ok"] and set(res) == SOAK_KEYS | {"ok"}
    saved = json.loads((tmp_path / "soak" / "soak_result.json").read_text())
    assert set(saved) == SOAK_KEYS
    # 8 steps per epoch, metrics flushed at each epoch's 5th step and its
    # end: killed once step 24's rows land, resumed from step 20
    assert res["resumed_at_step"] == 21 and res["replayed_steps"] >= 4
    assert res["replay_exact"] and res["replay_max_objf_diff"] == 0.0
    assert res["total_steps"] > 64


def test_soak_fails_without_the_optimizer_state(tmp_path, xconfig,
                                                monkeypatch, capsys):
    resume = soak.resume_run

    def reset_then_resume(cmd, log_path):
        mgr = CheckpointManager(str(tmp_path / "soak" / "ckpt"))
        step = mgr.latest_step()
        blob = mgr.load(step)
        vel = blob["opt_state"]["velocity"]
        for lname in vel:
            for pname in vel[lname]:
                vel[lname][pname] = torch.zeros_like(vel[lname][pname])
        torch.save(blob, mgr.path(step))
        resume(cmd, log_path)

    monkeypatch.setattr(soak, "resume_run", reset_then_resume)
    res = soak.main(soak_argv(tmp_path / "soak", xconfig))
    assert "SOAK FAIL" in capsys.readouterr().out
    assert not res["ok"] and not res["replay_exact"]
    assert res["replayed_steps"] >= 4


def test_a_save_killed_midway_leaves_the_newest_complete_checkpoint(
        tmp_path):
    from kaldi_fp16_tpu_torch.models.network import Network
    from kaldi_fp16_tpu_torch.training.train_step import init_train_state
    model = build_model_from_string(EGS_XCONFIG)
    net, opt, scale = init_train_state(model, torch.Generator().manual_seed(0),
                                       TrainConfig(), "cpu")
    assert isinstance(net, Network)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(20, net, opt, scale)
    whole = (tmp_path / "ckpt_20.pt").read_bytes()
    # what a SIGKILL inside torch.save of step 40 leaves behind
    (tmp_path / ".ckpt_torn").write_bytes(whole[:len(whole) // 2])
    assert mgr.all_steps() == [20] and mgr.latest_step() == 20
    assert mgr.load()["step"] == 20


def test_abtest_grid_runs_both_arms(tmp_path, capsys):
    res = abtest.main(["--ab", "grid", "--device", "cpu", "--workdir",
                       str(tmp_path), "--epochs", "1", "--files", "2",
                       "--per-file", "16", "--batch", "8"])
    out = capsys.readouterr().out.strip().splitlines()
    line = json.loads(out[-1])
    assert line["metric"] == "grid_subsample_ab"
    for arm in ("exact", "fast"):
        assert res["runs"][arm]["steps"] == 4
    assert res["max_abs_objf_diff"] is not None
    assert json.loads((tmp_path / "ab_result.json").read_text())["runs"]


@pytest.mark.parametrize("mode", ["den-mode", "bn-lowp"])
def test_abtest_revoked_modes_exit_2(mode, tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        abtest.main(["--ab", mode, "--workdir", str(tmp_path)])
    assert e.value.code == 2
    assert "queue 1 item 5" in capsys.readouterr().err


@pytest.fixture(scope="module")
def lr_egs(tmp_path_factory):
    d = tmp_path_factory.mktemp("lr_egs")
    make_synthetic_egs.main([str(d), "--files", "2", "--per-file", "16",
                             "--pdfs", "12", "--frames-in", "27",
                             "--frames-out", "8", "--den-states", "12",
                             "--den-topology", "phone-lm", "--seed", "1"])
    return d


@pytest.mark.parametrize("lr", [1e-2, 1e-3])
def test_traintest_loss_path_matches_jax(lr_egs, lr):
    """traintest's training (SGD, momentum 0.5, the max-change limits, the
    frame grid) on the narrow flagship shape, from the JAX init and on the
    same batches, at the JAX tool's lr and a tenth of it: the port's
    per-step losses follow the JAX package's, in fp32, at
    tests/test_torch_train_step.py's scalar bar."""
    from kaldi_fp16_tpu.chain.denominator import (
        DenominatorComputation as JaxDen,
    )
    from kaldi_fp16_tpu.chain.graph import DenominatorGraph as JaxGraph
    from kaldi_fp16_tpu.chain.objective import ChainTrainingOpts as JaxOpts
    from kaldi_fp16_tpu.io.dataloader import (
        DataLoader as JaxLoader, DataLoaderConfig as JaxLoaderConfig,
    )
    from kaldi_fp16_tpu.io.fst import read_fst_file as jax_read_fst
    from kaldi_fp16_tpu.models.model import (
        build_model_from_string as jax_build,
    )
    from kaldi_fp16_tpu.training.train_step import TrainConfig as JaxConfig
    from kaldi_fp16_tpu.training.trainer import Trainer as JaxTrainer
    from kaldi_fp16_tpu_torch.convert import train_state_from_jax
    from tests.test_torch_train_step import SCALAR

    steps, pdfs = 8, 12
    cfg = dict(learning_rate=lr, momentum=0.5, frame_subsampling_factor=3,
               compute_dtype="float32")
    den_fst = str(lr_egs / "den.fst")
    pattern = str(lr_egs / "cegs.*.ark")
    jt = JaxTrainer(jax_build(EGS_XCONFIG),
                    JaxDen(JaxGraph.from_fst(jax_read_fst(den_fst), pdfs),
                           leaky=1e-5),
                    JaxConfig(**cfg), JaxOpts(), fst_pad_states=64,
                    fst_pad_arcs=128)
    pm = build_model_from_string(EGS_XCONFIG)
    pt = Trainer(pm, DenominatorComputation(DenominatorGraph.from_fst(
        read_fst_file(den_fst), pdfs), leaky=1e-5, device="cpu"),
        TrainConfig(**cfg), ChainTrainingOpts(), device="cpu")
    sd, pt.opt_state, pt.scale_state = train_state_from_jax(
        pm, jt.params, jt.net_state, jt.opt_state, jt.scale_state,
        device="cpu")
    pt.net.load_state_dict(sd, strict=True)

    jbatches = JaxLoader(pattern, JaxLoaderConfig(batch_size=4,
                                                  label_dim=pdfs))
    pbatches = DataLoader(pattern, DataLoaderConfig(
        batch_size=4, label_dim=pdfs, max_fst_states=64, max_fst_arcs=128))
    jloss, ploss = [], []
    for jb, pb in itertools.islice(zip(jbatches, pbatches), steps):
        np.testing.assert_array_equal(np.asarray(jb.features), pb.features)
        jloss.append(float(jt.train_batch(jb).loss))
        ploss.append(float(pt.train_batch(pb).loss))
    assert len(ploss) == steps
    np.testing.assert_allclose(ploss, jloss, **SCALAR)
