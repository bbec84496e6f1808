"""The port's Trainer and train tool against the JAX package's.

* `Trainer.train_epoch` / `eval_epoch` (NG-SGD, xent head, loss scaling,
  fp32) on tiny egs against the JAX Trainer from the same state, at
  tests/test_torch_train_step.py's bars: rtol 2e-4 / atol 2e-5 on the
  metrics, 1e-4 / 1e-5 on the parameters; NG states by their invariants
  (tests/test_torch_trainer.py).
* `python -m kaldi_fp16_tpu_torch.tools.train` end to end with
  `--device cpu`: configs/train_flagship.sh's flags parse unchanged, and a
  run killed after a checkpoint and resumed replays the uninterrupted one
  bit for bit; so does a run on 2 gloo ranks (`--data-parallel 2`),
  whose first step equals one process's.
"""

import os
import re
import shlex
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax

from kaldi_fp16_tpu.chain import graph as jax_graph
from kaldi_fp16_tpu.chain.denominator import DenominatorComputation as JaxDen
from kaldi_fp16_tpu.chain.objective import ChainTrainingOpts as JaxOpts
from kaldi_fp16_tpu.models.model import (
    build_model_from_string as jax_build_from_string,
)
from kaldi_fp16_tpu.training import train_step as jax_ts
from kaldi_fp16_tpu_torch.chain import graph as port_graph
from kaldi_fp16_tpu_torch.chain.denominator import DenominatorComputation
from kaldi_fp16_tpu_torch.chain.objective import ChainTrainingOpts
from kaldi_fp16_tpu_torch.convert import train_state_from_jax
from kaldi_fp16_tpu_torch.models.model import build_model_from_string
from kaldi_fp16_tpu_torch.training import train_step as port_ts
from tests.test_torch_train_step import SCALAR
from tests.test_torch_trainer import (
    NG_CFG, assert_ng_states_close, assert_params_close, jax_init_train_state,
    tree_np,
)

ROOT = Path(__file__).resolve().parents[1]
# the egs xconfig: 40-dim features and 100-dim ivectors (the loader's
# validation defaults), the flagship's layer types, no SpecAugment
EGS_XCONFIG = """
input name=ivector dim=100
input name=input dim=40
idct-layer name=idct input=input dim=40 cepstral-lifter=22
batchnorm-component name=idct-batchnorm input=idct
linear-component name=ivector-linear l2-regularize=0.03 dim=40 input=ReplaceIndex(ivector, t, 0)
batchnorm-component name=ivector-batchnorm target-rms=0.025
combine-feature-maps-layer name=combine_inputs input=Append(idct-batchnorm, ivector-batchnorm) num-filters1=1 num-filters2=1 height=40
conv-relu-batchnorm-layer name=cnn1 height-in=40 height-out=20 height-subsample-out=2 time-offsets=-1,0,1 height-offsets=-1,0,1 num-filters-out=2
tdnnf-layer name=tdnnf2 dim=32 bottleneck-dim=8 time-stride=0
tdnnf-layer name=tdnnf3 dim=32 bottleneck-dim=8 time-stride=3
prefinal-layer name=prefinal-l input=tdnnf3 big-dim=24 small-dim=12
prefinal-layer name=prefinal-chain input=prefinal-l big-dim=24 small-dim=12
output-layer name=output include-log-softmax=false dim=12
prefinal-layer name=prefinal-xent input=prefinal-l big-dim=24 small-dim=12
output-layer name=output-xent dim=12
"""


@pytest.fixture(scope="module")
def egs(tmp_path_factory):
    from kaldi_fp16_tpu_torch.tools import make_synthetic_egs
    d = tmp_path_factory.mktemp("egs")
    make_synthetic_egs.main([str(d), "--files", "2", "--per-file", "8",
                             "--pdfs", "12", "--frames-in", "27",
                             "--frames-out", "8", "--den-states", "12",
                             "--den-topology", "phone-lm", "--seed", "1"])
    (d / "tiny.xconfig").write_text(EGS_XCONFIG)
    return d


def trainer_pair(egs_dir):
    from kaldi_fp16_tpu.io.fst import read_fst_file as jread_fst
    from kaldi_fp16_tpu.training import trainer as jax_trainer
    from kaldi_fp16_tpu.training.trainer import exponential_lr as jexp
    from kaldi_fp16_tpu_torch.io.fst import read_fst_file
    from kaldi_fp16_tpu_torch.training.trainer import Trainer, exponential_lr

    cfg = dict(NG_CFG, left_context=0, momentum=0.5, learning_rate=0.002)
    jm = jax_build_from_string(EGS_XCONFIG)
    pm = build_model_from_string(EGS_XCONFIG)
    den_path = str(egs_dir / "den.fst")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_trainer, "init_train_state", jax_init_train_state)
        jt = jax_trainer.Trainer(
            jm, JaxDen(jax_graph.DenominatorGraph.from_fst(
                jread_fst(den_path), 12), leaky=1e-5),
            jax_ts.TrainConfig(**cfg), JaxOpts(xent_regularize=0.1),
            lr_schedule=jexp(0.002, 0.0005, 4))
    pt = Trainer(pm, DenominatorComputation(
        port_graph.DenominatorGraph.from_fst(read_fst_file(den_path), 12),
        leaky=1e-5, device="cpu"), port_ts.TrainConfig(**cfg),
        ChainTrainingOpts(xent_regularize=0.1),
        lr_schedule=exponential_lr(0.002, 0.0005, 4), device="cpu")
    sd, pt.opt_state, pt.scale_state = train_state_from_jax(
        pm, tree_np(jt.params), tree_np(jt.net_state), tree_np(jt.opt_state),
        tree_np(jt.scale_state), device="cpu")
    pt.net.load_state_dict(sd, strict=True)
    return jt, pt


def loaders(egs_dir):
    from kaldi_fp16_tpu.io import dataloader as jdl
    from kaldi_fp16_tpu_torch.io import dataloader as pdl
    kw = dict(batch_size=4, label_dim=12, shuffle_files=True,
              shuffle_buffer=6, seed=2, max_fst_states=16, max_fst_arcs=24)
    pattern = str(egs_dir / "cegs.*.ark")
    return (jdl.DataLoader(pattern, jdl.DataLoaderConfig(**kw)),
            pdl.DataLoader(pattern, pdl.DataLoaderConfig(**kw)))


def test_trainer_epoch_and_eval_match_jax(egs):
    jt, pt = trainer_pair(egs)
    jb, pb = loaders(egs)
    jm = jt.train_epoch(jb)
    pm = pt.train_epoch(pb)
    assert (pm.steps, pm.examples, pm.skipped_steps) == \
        (jm.steps, jm.examples, jm.skipped_steps) == (4, 16, 0)
    assert pt.global_step == jt.global_step == 4
    np.testing.assert_allclose(pm.objf_per_frame, jm.objf_per_frame,
                               **SCALAR)
    np.testing.assert_allclose(pm.total_xent, jm.total_xent, **SCALAR)
    assert_params_close(pt.net, jt.params, jt.net_state)
    assert_ng_states_close(pt.opt_state["ng"], tree_np(jt.opt_state)["ng"])
    jb, pb = loaders(egs)
    je, pe = jt.eval_epoch(jb), pt.eval_epoch(pb)
    assert pe["batches"] == je["batches"] == 4
    for k in ("objf_per_frame", "num_logprob", "den_logprob", "xent_objf",
              "frames"):
        np.testing.assert_allclose(pe[k], je[k], **SCALAR, err_msg=k)


def flagship_flags():
    """configs/train_flagship.sh's flags to tools/train.py, as written."""
    text = (ROOT / "configs" / "train_flagship.sh").read_text()
    body = text.split('tools/train.py" \\', 1)[1].split('"$@"', 1)[0]
    return shlex.split(" ".join(line.strip().rstrip("\\")
                                for line in body.splitlines()))


def tool_args(egs_dir, ckpt_dir, extra=()):
    flags = flagship_flags()
    flags = [{"$EGS": str(egs_dir / "cegs.*.ark"),
              "$DEN": str(egs_dir / "den.fst")}.get(f, f) for f in flags]
    flags = [str(egs_dir / "tiny.xconfig") if "cnn_tdnn.xconfig" in f else f
             for f in flags]
    override = {"--pdfs": "12", "--epochs": "2", "--batch": "4",
                "--ckpt-dir": str(ckpt_dir), "--ckpt-every": "3",
                "--warmup-steps": "2"}
    for i, f in enumerate(flags[:-1]):
        if f in override:
            flags[i + 1] = override[f]
    return flags + ["--device", "cpu", "--log-every", "100",
                    "--fst-pad-states", "16", "--fst-pad-arcs", "24"] + list(extra)


def test_flagship_flags_parse_unchanged():
    from kaldi_fp16_tpu_torch.tools import train
    flags = flagship_flags()
    assert "--natural-gradient" in flags and "--loss-scaling" in flags
    args = train.parse_args([{"$EGS": "e", "$DEN": "d"}.get(f, f)
                             for f in flags])
    assert (args.pdfs, args.batch, args.epochs, args.ckpt_every) == \
        (3080, 128, 15, 500)
    assert args.natural_gradient and args.loss_scaling
    assert args.xent_regularize == 0.1 and args.orthonormal_interval == 4
    assert args.device is None and args.l2_regularize == 5e-5
    assert re.search(r"cnn_tdnn\.xconfig$", args.xconfig)
    assert args.data_parallel == 0
    assert train.parse_args(["--egs", "e", "--den-fst", "d", "--xconfig", "x",
                             "--pdfs", "3", "--data-parallel", "2"]
                            ).data_parallel == 2


@pytest.fixture(scope="module")
def dp_full(egs, tmp_path_factory):
    """The recipe at tiny width on 2 gloo ranks (--data-parallel 2
    --device cpu), checkpoints every 3 steps."""
    from kaldi_fp16_tpu_torch.tools import train
    d = tmp_path_factory.mktemp("dp")
    return d, train.main(tool_args(egs, d / "full", ["--data-parallel", "2"]))


def test_train_tool_data_parallel_matches_one_process(egs, dp_full,
                                                      tmp_path):
    """--data-parallel 2 --device cpu against one process at the same
    global batch: the first step, before any update, equal at rtol 1e-5
    (the global batch's forward, BatchNorm statistics and objective
    through 2 ranks).  --data-parallel 1 (one gloo rank, every collective
    run) is the single process's run bit for bit: the data group's
    BatchNorm merge and reported means reduce to torch.mean's and
    torch.var's bits at world 1.  Later steps of 2 ranks are not held to
    the single process: each rank's bf16 weight gradients are rounded
    before they are summed (the fp32 parity of 2 and 4 ranks is
    tests/test_torch_parallel.py's).  Rank 1's steps equal rank 0's, and
    the tool holds the ranks' parameters bit-identical."""
    from kaldi_fp16_tpu_torch.tools import train
    one = train.main(tool_args(egs, tmp_path / "one"))
    world1 = train.main(tool_args(egs, tmp_path / "w1",
                                  ["--data-parallel", "1"]))
    two = dp_full[1]
    names = ("loss", "objf_per_frame", "num", "den", "grad_norm")
    assert [s["step"] for s in world1["steps"]] == list(range(1, 9))
    assert [[s[k] for k in names] for s in world1["steps"]] == \
        [[s[k] for k in names] for s in one["steps"]]
    assert world1["param_digest"] == train.state_digest(
        one["trainer"].net.state_dict())
    for k in names[:4]:
        np.testing.assert_allclose(two["steps"][0][k], one["steps"][0][k],
                                   rtol=1e-5, err_msg=k)
    assert len(two["steps"]) == len(one["steps"]) == 8
    assert all(s["ok"] and not s["skipped"] and np.isfinite(s["loss"])
               for s in two["steps"])
    assert two["ranks"][0]["steps"] == two["steps"]
    # the gradient bucket at least: every parameter in fp32
    n_params = sum(p.numel() for p in two["trainer"].net.parameters())
    assert all(s["collectives"] > 0 and s["collective_bytes"] >= 4 * n_params
               for s in two["steps"])


def test_train_tool_under_torchrun_reads_file_shards(egs, tmp_path):
    """Two processes started as torchrun starts them (RANK, LOCAL_RANK,
    WORLD_SIZE, MASTER_ADDR and MASTER_PORT set): each is one gloo rank
    and reads its share of the two files (`shard_files`), 2 examples per
    batch of 4; both take the same 8 steps and end with the same
    parameters (the tool checks, over the group)."""
    from kaldi_fp16_tpu_torch.parallel.mesh import free_address
    host, port = free_address()[len("tcp://"):].rsplit(":", 1)
    procs = []
    try:
        for rank in range(2):
            env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                       WORLD_SIZE="2", MASTER_ADDR=host, MASTER_PORT=port,
                       PYTHONPATH=str(ROOT))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "kaldi_fp16_tpu_torch.tools.train"]
                + tool_args(egs, tmp_path, ["--data-parallel", "2"]),
                cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    assert "2 of every 4 sequences per rank, files sharded per rank" \
        in outs[0][0]
    assert "done: 8 steps" in outs[0][0]
    for rank, (out, _) in enumerate(outs):
        assert f"rank {rank}/2 on cpu: 2 sequences per step" in out
    assert sorted(p.name for p in tmp_path.glob("ckpt_*.pt")) == \
        ["ckpt_3.pt", "ckpt_6.pt", "ckpt_8.pt"]


def test_train_tool_data_parallel_refuses_what_it_cannot_run(egs, tmp_path):
    from kaldi_fp16_tpu_torch.tools import train
    with pytest.raises(SystemExit, match="does not divide"):
        train.main(tool_args(egs, tmp_path, ["--data-parallel", "3"]))
    with pytest.raises(SystemExit, match="counts cards"):
        train.main(tool_args(egs, tmp_path, ["--data-parallel", "-1"]))


def test_train_tool_data_parallel_resume_replays_bit_for_bit(egs, dp_full):
    """2 ranks killed after the step-3 checkpoint and resumed on 2 ranks
    end as the uninterrupted 2-rank run, bit for bit."""
    from kaldi_fp16_tpu_torch.tools import train
    d, full = dp_full
    (d / "killed").mkdir()
    shutil.copy(d / "full" / "ckpt_3.pt", d / "killed")
    resumed = train.main(tool_args(egs, d / "killed",
                                   ["--data-parallel", "2", "--resume"]))
    assert [s["step"] for s in resumed["steps"]] == list(range(4, 9))
    assert [s["loss"] for s in resumed["steps"]] == \
        [s["loss"] for s in full["steps"][3:]]
    assert resumed["param_digest"] == full["param_digest"]


def test_train_tool_resume_replays_bit_for_bit(egs, tmp_path):
    """The flagship recipe at tiny width on the CPU: a run killed after its
    step-3 checkpoint and resumed gives the uninterrupted run's parameters
    and optimizer state, bit for bit."""
    from kaldi_fp16_tpu_torch.tools import train
    from kaldi_fp16_tpu_torch.training.checkpoint import CheckpointManager
    full = train.main(tool_args(egs, tmp_path / "full",
                                ["--metrics", str(tmp_path / "m.jsonl")]))
    assert full["trainer"].global_step == 8
    assert all(s["ok"] and not s["skipped"] and np.isfinite(s["loss"])
               for s in full["steps"])
    assert full["readers"] in ("native", "python")
    assert (tmp_path / "m.jsonl").read_text().count("\n") == 8
    (tmp_path / "killed").mkdir()
    shutil.copy(tmp_path / "full" / "ckpt_3.pt", tmp_path / "killed")
    resumed = train.main(tool_args(egs, tmp_path / "killed", ["--resume"]))
    assert [s["step"] for s in resumed["steps"]] == list(range(4, 9))
    assert [s["loss"] for s in resumed["steps"]] == \
        [s["loss"] for s in full["steps"][3:]]
    a = full["trainer"].net.state_dict()
    b = resumed["trainer"].net.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    ca = CheckpointManager(str(tmp_path / "full")).load(8)
    cb = CheckpointManager(str(tmp_path / "killed")).load(8)
    for x, y in zip(jax.tree_util.tree_leaves(ca["opt_state"]),
                    jax.tree_util.tree_leaves(cb["opt_state"])):
        assert torch.equal(x, y)
    assert torch.equal(ca["data_position"]["rng_state"],
                       cb["data_position"]["rng_state"])


def test_train_tool_valid_average_and_bf16_features(egs, tmp_path, capsys):
    """--valid-egs (the eval pass), --average-last (the parameter mean of
    the last checkpoints, saved as one more) and --feats-bf16 (features
    cast on the host) run through the tool."""
    from kaldi_fp16_tpu_torch.tools import train
    from kaldi_fp16_tpu_torch.training.checkpoint import CheckpointManager
    res = train.main(tool_args(egs, tmp_path / "ck", [
        "--valid-egs", str(egs / "cegs.1.ark"), "--average-last", "2",
        "--feats-bf16", "--ckpt-every", "2", "--epochs", "1"]))
    out = capsys.readouterr().out
    assert "valid objf/frame=" in out and "averaged objf/frame=" in out
    assert all(s["ok"] and np.isfinite(s["loss"]) for s in res["steps"])
    mgr = CheckpointManager(str(tmp_path / "ck"))
    steps = mgr.all_steps()
    assert steps[-1] == res["trainer"].global_step + 1
    last_two = [mgr.load(s)["network"] for s in steps[-3:-1]]
    avg = mgr.load(steps[-1])["network"]
    for name, _ in res["trainer"].net.named_parameters():
        torch.testing.assert_close(avg[name],
                                   (last_two[0][name] + last_two[1][name]) / 2)


def test_checkpoint_manager_keeps_restores_and_refuses(tmp_path):
    """max_to_keep prunes the oldest, saves leave no temporary file, a
    restore rebuilds the NamedTuple states on the network's device, and a
    file of another format is refused."""
    from kaldi_fp16_tpu_torch.training.checkpoint import (
        CheckpointManager, DataPosition,
    )
    pm = build_model_from_string(EGS_XCONFIG)
    cfg = port_ts.TrainConfig(**NG_CFG)
    net, opt, scale = port_ts.init_train_state(
        pm, torch.Generator().manual_seed(0), cfg, "cpu")
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    gen = torch.Generator().manual_seed(5)
    for step in (1, 2, 3):
        mgr.save(step, net, opt, scale, DataPosition(
            epoch=1, batches_consumed=step, rng_state=gen.get_state()))
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == \
        ["ckpt_2.pt", "ckpt_3.pt"]
    other, opt0, scale0 = port_ts.init_train_state(
        pm, torch.Generator().manual_seed(1), cfg, "cpu")
    opt2, scale2, step, pos = mgr.restore(None, other, opt0, scale0)
    assert step == 3 and (pos.epoch, pos.batches_consumed) == (1, 3)
    assert torch.equal(pos.rng_state, gen.get_state())
    assert type(scale2) is type(scale) and \
        type(opt2["ng"]["cnn1/w"]["in"]) is type(opt["ng"]["cnn1/w"]["in"])
    a, b = net.state_dict(), other.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    torch.save({"format": "something else"}, str(tmp_path / "ck" / "ckpt_9.pt"))
    with pytest.raises(ValueError, match="not a"):
        mgr.load(9)
