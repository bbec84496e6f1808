"""The port's measurement tools and the x-vector trainer against the JAX
package's tools, on the CPU at tiny sizes: xvectortrain, trainbench,
roofline, scalebench, profile_host, profile_latdecode, profile_den,
profile_tree and profile_lattice.

* Each twin runs in this process with --device cpu (the card is their
  default) and prints the JAX tool's JSON keys: every key of the dict
  literals the JAX tool prints (read from its source) is among the keys
  of the twin's JSON lines.
* xvectortrain passes as tests/test_tools.py:42 runs the JAX tool, and
  from the JAX init (convert.xvector_params_from_jax) on the same batches
  its 8-step loss path follows the JAX tool's loop within 2e-4 rel.
* profile_tree and profile_lattice print the JAX tools' per-piece lines
  at --states 2000.
* scalebench's per-world function holds 1 and 2 gloo ranks against one
  process; trainbench exits 2 on the revoked --mode fast / --bn-lowp,
  profile_den on --impls split3, chainbench on --matmul-impl split3.
* profile_step, the in-context ablation: every variant at a narrow
  xconfig, the JAX tool's printed labels (read from its source) and
  results keys, each stand-in removing its stage and the patched module
  attributes restored after the run; from the JAX init on the same batch
  the first step's loss of full, no-den, no-num and no-chain follows the
  JAX tool's same variant within 2e-4 rel.  profile_kernels (the
  recipe's per-kernel profile, formerly tools.profile_step) keeps its keys.
"""

import ast
import functools
import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kaldi_fp16_tpu.models import xvector as jax_xv
from kaldi_fp16_tpu.training import schedulers as jax_sched
import kaldi_fp16_tpu_torch.chain.objective as port_objective
import kaldi_fp16_tpu_torch.training.train_step as port_train_step
from kaldi_fp16_tpu_torch.chain import graph as port_graph
from kaldi_fp16_tpu_torch.chain.denominator import DenominatorComputation
from kaldi_fp16_tpu_torch.convert import (
    params_from_jax, xvector_params_from_jax,
)
from kaldi_fp16_tpu_torch.models.model import build_model
from kaldi_fp16_tpu_torch.tools import (
    chainbench, profile_den, profile_host, profile_kernels,
    profile_latdecode, profile_lattice, profile_step, profile_tree,
    roofline, scalebench, trainbench, xvectortrain,
)
from tests.test_torch_tool_help import two_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
TINY_XCONFIG = """
input name=ivector dim=100
input name=input dim=40
idct-layer name=idct input=input dim=40 cepstral-lifter=22
batchnorm-component name=idct-batchnorm input=idct
spec-augment-layer name=spec-augment freq-max-proportion=0.5 time-zeroed-proportion=0.2 time-mask-max-frames=4
linear-component name=ivector-linear dim=40 input=ReplaceIndex(ivector, t, 0)
batchnorm-component name=ivector-batchnorm target-rms=0.025
combine-feature-maps-layer name=combine_inputs input=Append(spec-augment, ivector-batchnorm) num-filters1=1 num-filters2=1 height=40
conv-relu-batchnorm-layer name=cnn1 height-in=40 height-out=20 height-subsample-out=2 time-offsets=-1,0,1 height-offsets=-1,0,1 num-filters-out=2
tdnnf-layer name=tdnnf2 dim=32 bottleneck-dim=8 time-stride=0
tdnnf-layer name=tdnnf3 dim=32 bottleneck-dim=8 time-stride=3
prefinal-layer name=prefinal-chain input=tdnnf3 big-dim=32 small-dim=16
output-layer name=output include-log-softmax=false dim=24
prefinal-layer name=prefinal-xent input=tdnnf3 big-dim=32 small-dim=16
output-layer name=output-xent dim=24
"""
# the JAX tools' dict literals that are not output (their batches) and
# their environment writes
NOT_OUTPUT = {"features", "ivectors", "weights", "JAX_PLATFORMS",
              "XLA_FLAGS"}
LOSS_PATH_RTOL = 2e-4


@pytest.fixture(scope="module")
def xconfig(tmp_path_factory):
    p = tmp_path_factory.mktemp("xc") / "tiny.xconfig"
    p.write_text(TINY_XCONFIG)
    return str(p)


def jax_output_keys(tool):
    """The string keys of the dict literals in tools/<tool>.py, and the
    keys it assigns into them, less NOT_OUTPUT."""
    keys = set()
    for node in ast.walk(ast.parse((ROOT / "tools" / f"{tool}.py")
                                   .read_text())):
        if isinstance(node, ast.Dict):
            keys |= {k.value for k in node.keys
                     if isinstance(k, ast.Constant)
                     and isinstance(k.value, str)}
        elif isinstance(node, ast.Assign):
            keys |= {t.slice.value for t in node.targets
                     if isinstance(t, ast.Subscript)
                     and isinstance(t.slice, ast.Constant)}
    return keys - NOT_OUTPUT


def printed_keys(text):
    """Every key, at any depth, of the JSON objects among text's lines."""
    keys = set()

    def walk(x):
        if isinstance(x, dict):
            keys.update(x)
            for v in x.values():
                walk(v)
        elif isinstance(x, list):
            for v in x:
                walk(v)

    for line in text.splitlines():
        try:
            walk(json.loads(line))
        except json.JSONDecodeError:
            pass
    return keys


def run_twin(mod, argv, capsys):
    res = mod.main(argv)
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "cpu"          # the card line on the CPU
    return res, out


def check_keys(tool, out):
    missing = jax_output_keys(tool) - printed_keys(out)
    assert not missing, f"{tool} lacks the JAX tool's keys {missing}"


def test_trainbench_cpu_smoke(xconfig, capsys):
    for extra in ([], ["--remat", "--natural-gradient"],
                  ["--topology", "random", "--den-states", "64",
                   "--den-arcs", "400", "--no-grid"]):
        res, out = run_twin(trainbench, [
            "--device", "cpu", "--batch", "4", "--frames", "30", "--pdfs",
            "24", "--iters", "1", "--xconfig", xconfig] + extra, capsys)
        check_keys("trainbench", out)
        d = res["detail"]
        assert np.isfinite(d["loss"]) and res["value"] > 0
        assert res["timer"] == "host" and d["remat"] == ("--remat" in extra)
        assert d["den_layout"] == ("blocked" if "random" in extra
                                   else "structured")


@pytest.mark.parametrize("flags", [["--mode", "fast"], ["--bn-lowp"]])
def test_trainbench_revoked_modes_exit_2(flags, capsys):
    with pytest.raises(SystemExit) as e:
        trainbench.main(flags + ["--device", "cpu"])
    assert e.value.code == 2
    assert "ROADMAP.md queue 1 item 5" in capsys.readouterr().err


def test_roofline_cpu_smoke(xconfig, capsys):
    res, out = run_twin(roofline, [
        "--device", "cpu", "--batch", "2", "--frames", "30", "--pdfs", "24",
        "--iters", "1", "--xconfig", xconfig], capsys)
    check_keys("roofline", out)
    assert [r["stage"] for r in res["rows"]] == [
        "forward", "forward+grad", "den fwd-bwd", "num fwd-bwd",
        "train step"]
    assert not res["failures"] and "FAIL" not in out
    rows = {r["stage"]: r for r in res["rows"]}
    # forward + grad counts the forward's products and up to twice more
    # (no input gradient for the features)
    assert 2.0 < rows["forward+grad"]["gflop"] / rows["forward"]["gflop"] \
        <= 3.0
    assert all(r["gflop"] > 0 and r["bytes"] > 0 for r in res["rows"])


def test_roofline_counts_the_kernels_launches_by_formula():
    den = SimpleNamespace(_structured=SimpleNamespace(
        lay=SimpleNamespace(F=3584)))
    flops = roofline.kernel_flops(
        {"den_scan": 1, "den_matmul": 0, "segment_reduce": 3}, den, 128, 49)
    assert flops == 49 * 6 * 2 * 3584 ** 2 * 128          # 966.8 GFLOP


def test_scalebench_cpu_smoke_and_keys(capsys):
    res = scalebench.main(["--worlds", "1", "--iters", "1", "--frames",
                           "24", "--pdfs", "12", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "cpu"
    check_keys("scalebench", out)
    assert res["platform"] == "cpu" and len(res["points"]) == 1


@pytest.mark.parametrize("cards,real,want", [
    (1, False, [(1, None), (2, "gloo"), (4, "gloo"), (8, "gloo")]),
    (1, True, [(1, None)]),
    (4, False, [(1, None), (2, None), (4, None), (8, "gloo")]),
    (4, True, [(1, None), (2, None), (4, None)]),
])
def test_scalebench_puts_the_ranks_on_the_cards(cards, real, want,
                                                monkeypatch):
    """On cards every world runs there: NCCL (the default backend) up to
    the cards' count, gloo ranks sharing them above it; --real keeps the
    NCCL worlds only; the CPU is gloo throughout."""
    import torch
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    worlds = [1, 2, 4, 8]
    assert scalebench.world_backends(worlds, torch.device("cuda"),
                                     real) == want
    assert scalebench.world_backends(worlds, torch.device("cpu"), real) == [
        (n, "gloo") for n in worlds]


def test_scalebench_world_point_holds_ranks_to_one_process():
    args = scalebench.parse_args(["--iters", "1", "--frames", "24",
                                  "--pdfs", "12"])
    for world in (1, 2):
        p = scalebench.world_point(world, args, "cpu", "gloo")
        assert p["devices"] == world and p["global_batch"] == 4 * world
        assert p["checked_vs_one_process"] and p["backend"] == "gloo"
        assert p["step_ms"] > 0 and np.isfinite(p["loss"])


def test_profile_host_cpu_smoke(capsys):
    res, out = run_twin(profile_host, [
        "--batch", "8", "--batches", "4", "--pdfs", "48", "--frames-in",
        "48", "--frames-out", "15", "--place", "--device", "cpu"], capsys)
    check_keys("profile_host", out)
    assert res["batches_profiled"] == 4 and res["examples"] == 32
    parts = sum(res[k] for k in ("feature_stack_ms_per_batch",
                                 "fst_to_csr_ms_per_batch",
                                 "num_graph_ms_per_batch"))
    assert 0 < parts and res["make_batch_total_ms_per_batch"] > 0


def test_profile_latdecode_phases_sum_to_the_decode(capsys):
    res, out = run_twin(profile_latdecode, [
        "--device", "cpu", "--states", "500", "--pdfs", "64", "--batch",
        "4", "--frames", "30"], capsys)
    check_keys("profile_latdecode", out)
    phases = (res["kernels_s"] + res["compact_s"] + res["gather_s"]
              + res["host_assembly_s"])
    assert phases == pytest.approx(res["phases_sum_s"], rel=1e-9)
    assert res["transfer"] == "compact" and res["kept_bytes"] > 0
    assert res["kept_arcs"] == res["mean_arcs"] * 4


# the JAX tools' per-piece line labels (each must be in the JAX tool's
# source too)
PROFILE_LABELS = {
    "profile_tree": ["graph: S=", "tree build:", "level-1 buckets:",
                     "reduce level ",
                     "L1 gathers+max (no levels, no argmax)",
                     "min_step (levels, no argmax)",
                     "max_step (argmax+arc track, bp dropped)",
                     "max_step + [T,S,B] bp stack"],
    "profile_lattice": ["graph: S=", "min_step only",
                        "keep-mask gathers (3xA rows) + cmp",
                        "packbits [A, B] alone",
                        "full bwd_frame (min+mask+packbits)",
                        "FUSED bwd_frame (slot-order mask)"]}


@pytest.mark.parametrize("tool", sorted(PROFILE_LABELS))
def test_profile_tree_and_lattice_print_the_jax_lines(tool, two_threads,
                                                      capsys):
    """At --states 2000 each twin prints the JAX tool's lines, one timed
    piece per line in ms per frame."""
    mod = {"profile_tree": profile_tree,
           "profile_lattice": profile_lattice}[tool]
    jax_src = (ROOT / "tools" / f"{tool}.py").read_text()
    res, out = run_twin(mod, ["--device", "cpu", "--states", "2000",
                              "--pdfs", "64", "--batch", "2", "--frames",
                              "3"], capsys)
    lines = out.splitlines()[1:]
    for label in PROFILE_LABELS[tool]:
        assert label in jax_src, label
        assert any(ln.startswith(label) for ln in lines), label
    timed = [ln for ln in lines if ln.endswith(" ms/frame")]
    assert len(timed) == len([k for k in res if k.endswith("_ms")])
    assert all(float(ln.split()[-2]) > 0 for ln in timed)
    assert res["states"] == 2000 and res["device"] == "cpu"


def test_profile_den_cpu_smoke(capsys):
    res, out = run_twin(profile_den, [
        "--device", "cpu", "--frames", "6", "--pdfs", "24", "--iters", "1",
        "--impls", "high,pallas,fused"], capsys)
    check_keys("profile_den", out)
    calls = [json.loads(l)["call"] for l in out.splitlines()
             if l.startswith('{"call"')]
    assert calls[:3] == ["den_matmul", "den_scan_fwd", "den_scan_bwd"]
    assert {res[i]["scan_used"] for i in ("high", "pallas")} == {"loop"}
    assert res["fused"]["scan_used"] == "fused"


def test_profile_den_split3_exits_2(capsys):
    with pytest.raises(SystemExit) as e:
        profile_den.main(["--impls", "high,split3", "--device", "cpu"])
    assert e.value.code == 2
    assert "split3" in capsys.readouterr().err


def test_xvectortrain_smoke(capsys):
    """tests/test_tools.py:42's run, on the port."""
    res = xvectortrain.main(["--device", "cpu", "--steps", "30",
                             "--speakers", "4", "--batch", "16",
                             "--frames", "20"])
    out = capsys.readouterr().out
    assert '"ok": true' in out and res["ok"]
    check_keys("xvectortrain", out)


def load_jax_tool(name, monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT / "tools"))
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_xvectortrain_loss_path_follows_jax_from_its_init(monkeypatch,
                                                         capsys):
    """From the JAX init, on the batches both tools draw from --seed, the
    port's first 8 losses follow the JAX tool's loop (its recipe, Adam,
    warmup + StepLR) within 2e-4 rel."""
    jtool = load_jax_tool("xvectortrain", monkeypatch)
    steps, spk, batch, frames, feat, seed = 8, 4, 16, 20, 30, 0
    cfg = jax_xv.XVectorConfig(
        feat_dim=feat, tdnn_dims=(64, 64, 96),
        tdnn_contexts=((-2, -1, 0, 1, 2), (-2, 0, 2), (0,)),
        embed_dim=64, segment_dims=(64, 64), num_speakers=spk)
    params = jax_xv.init_xvector(cfg, jax.random.PRNGKey(seed))
    port = xvectortrain.main(
        ["--device", "cpu", "--steps", str(steps), "--speakers", str(spk),
         "--batch", str(batch), "--frames", str(frames)],
        params=xvector_params_from_jax(
            jax.tree_util.tree_map(np.asarray, params), device="cpu"))
    capsys.readouterr()

    opt = jax_sched.init_adam_state(params)
    sched = jax_sched.warmup_lr(jax_sched.step_lr(2e-3, 60, gamma=0.5), 10)
    rng = np.random.default_rng(seed)
    centers = 2.0 * rng.normal(size=(spk, feat))
    jtool.synth_batch(rng, centers, 256, frames, feat)       # the eval set
    grad = jax.jit(jax.value_and_grad(
        lambda p, f, y: jax_xv.xvector_loss(cfg, p, f, y)))
    losses = []
    for step in range(steps):
        f, y = jtool.synth_batch(rng, centers, batch, frames, feat)
        loss, g = grad(params, jnp.asarray(f), jnp.asarray(y))
        params, opt = jax_sched.adam_update(
            params, g, opt, jnp.asarray(sched(step), jnp.float32))
        losses.append(float(loss))
    np.testing.assert_allclose(port["losses"], losses, rtol=LOSS_PATH_RTOL)
    # the port's numpy copy draws the JAX tool's batches
    a, b = (np.random.default_rng(3), np.random.default_rng(3))
    c = 2.0 * a.normal(size=(spk, feat))
    b.normal(size=(spk, feat))
    for x, z in zip(xvectortrain.synth_batch(a, c, 4, 5, feat),
                    jtool.synth_batch(b, c, 4, 5, feat)):
        np.testing.assert_array_equal(x, z)


def test_chainbench_split3_exits_2(capsys):
    with pytest.raises(SystemExit) as e:
        chainbench.main(["--matmul-impl", "split3", "--device", "cpu"])
    assert e.value.code == 2
    assert "ROADMAP.md queue 1 item 5" in capsys.readouterr().err


def test_profile_kernels_keeps_its_keys(xconfig, capsys):
    """The per-kernel profile of the recipe's step, formerly
    tools.profile_step: its three JSON lines and their keys."""
    assert profile_kernels.main([
        "--device", "cpu", "--batch", "2", "--frames-in", "30",
        "--frames-out", "8", "--pdfs", "24", "--xconfig", xconfig]) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["step"] for r in rows] == ["ng", "ng_update", "no_ng"]
    for r in rows:
        assert set(r) == {"step", "wall_ms", "timed_on", "kernels_ms",
                          "busy_share", "by_category_ms", "kernels"}
        assert r["timed_on"] == "cpu" and r["kernels"]


# profile_step's geometry at a narrow size, on a small phone-LM den (the
# tool's den is the production topology whatever --pdfs is)
STEP_P = 24
STEP_ARGV = ["--device", "cpu", "--batch", "2", "--frames-in", "30",
             "--pdfs", str(STEP_P), "--iters", "1", "--lean"]
STEP_DEN = dict(num_phones=12, states_per_phone=2, branching=3, seed=0)
STEP_LOSS_RTOL = 2e-4
NO_SPEC_XCONFIG = TINY_XCONFIG.replace(
    "spec-augment-layer name=spec-augment freq-max-proportion=0.5 "
    "time-zeroed-proportion=0.2 time-mask-max-frames=4\n", "").replace(
    "Append(spec-augment,", "Append(idct-batchnorm,")


def jax_printed_labels(tool):
    """The text pieces of the JAX tool's print calls (f-string constants,
    a leading "ms" dropped), those with a letter in them."""
    labels = []
    for node in ast.walk(ast.parse((ROOT / "tools" / f"{tool}.py")
                                   .read_text())):
        if not (isinstance(node, ast.Call) and getattr(node.func, "id", "")
                == "print" and node.args):
            continue
        arg = node.args[0]
        parts = arg.values if isinstance(arg, ast.JoinedStr) else [arg]
        for part in parts:
            if isinstance(part, ast.Constant) and isinstance(part.value,
                                                             str):
                text = part.value.strip()
                text = text[2:].strip() if text.startswith("ms") else text
                if any(c.isalpha() for c in text):
                    labels.append(text)
    return labels


def small_step_den(monkeypatch):
    monkeypatch.setattr(
        profile_step, "make_phone_lm_den_fst",
        lambda num_pdfs: port_graph.make_phone_lm_den_fst(
            num_pdfs=num_pdfs, **STEP_DEN))


def test_profile_step_ablates_each_stage(xconfig, monkeypatch, capsys):
    """Every variant runs; the labels and the results keys are the JAX
    tool's; the den's forward_backward never runs in no-den, no-chain or
    fwd-only, the numerator never in no-num, no-chain or fwd-only; the
    swapped module attributes are restored."""
    small_step_den(monkeypatch)
    calls = {"den": 0, "num": 0}
    den_fb = DenominatorComputation.forward_backward
    num_fb = port_objective.numerator_forward_backward
    make_objf = port_train_step.make_chain_objf_with_post

    def den_spy(self, x):
        calls["den"] += 1
        return den_fb(self, x)

    def num_spy(graph, x):
        calls["num"] += 1
        return num_fb(graph, x)

    monkeypatch.setattr(DenominatorComputation, "forward_backward", den_spy)
    monkeypatch.setattr(port_objective, "numerator_forward_backward",
                        num_spy)
    per_variant = {}
    measure = profile_step.measure

    def counted(name, *a):
        before = dict(calls)
        res = measure(name, *a)
        per_variant[name] = {k: calls[k] - before[k] for k in calls}
        return res

    monkeypatch.setattr(profile_step, "measure", counted)
    res, out = run_twin(profile_step, STEP_ARGV + ["--xconfig", xconfig],
                        capsys)
    for label in jax_printed_labels("profile_step"):
        assert label in out, label
    assert set(res) == jax_output_keys("profile_step") == {
        "full", "no-den", "no-num", "no-chain", "fwd-only", "lean"}
    steps = 2                                  # one warm-up + --iters 1
    assert per_variant == {
        "full": {"den": steps, "num": steps},
        "no-den": {"den": 0, "num": steps},
        "no-num": {"den": steps, "num": 0},
        "no-chain": {"den": 0, "num": 0},
        "fwd-only": {"den": 0, "num": 0},
        "lean": {"den": steps, "num": steps}}
    assert port_objective.numerator_forward_backward is num_spy
    assert port_train_step.make_chain_objf_with_post is make_objf
    line = json.loads(out.splitlines()[-1])
    assert line["variants"] == res and line["den_layout"] == "structured"
    for name, r in res.items():
        assert r["device_ms"] is None and r["wall_ms"] > 0
        assert not any(r["launches"].values())   # the CPU runs no kernel
        assert np.isfinite(r["output_sum" if name == "fwd-only"
                             else "loss"])
        assert r["scan_used"] == ("loop" if name in ("full", "no-num",
                                                     "lean") else None)
    assert res["lean"]["loss"] == res["full"]["loss"]   # same first step


def test_profile_step_losses_follow_jax_from_its_init(monkeypatch,
                                                      tmp_path, capsys):
    """From the JAX init, on the same batch and graphs, the first step's
    loss of each step variant equals the JAX tool's variant (built with
    its own stand-ins) within 2e-4 rel.  No SpecAugment: the packages
    draw their masks from different generators.  Both compute in fp32, as
    tests/test_torch_train_step.py holds the steps: in bf16 the two
    frameworks round intermediates at different points (no-num's loss
    here lies 3.4e-4 rel apart)."""
    from kaldi_fp16_tpu.chain import graph as jax_graph
    from kaldi_fp16_tpu.chain import objective as jax_objective
    from kaldi_fp16_tpu.chain.denominator import (
        DenominatorComputation as JaxDen,
    )
    from kaldi_fp16_tpu.models.model import build_model as jax_build
    from kaldi_fp16_tpu.training import train_step as jax_ts

    monkeypatch.setenv("KALDI_TPU_NO_COMPILE_CACHE", "1")
    jtool = load_jax_tool("profile_step", monkeypatch)
    small_step_den(monkeypatch)
    monkeypatch.setattr(profile_step, "TrainConfig", functools.partial(
        profile_step.TrainConfig, compute_dtype="float32"))
    xc = tmp_path / "no_spec.xconfig"
    xc.write_text(NO_SPEC_XCONFIG)
    args = profile_step.parse_args(STEP_ARGV + ["--xconfig", str(xc)])
    B, T_in, P, left = args.batch, args.frames_in, args.pdfs, 3
    T_out = (T_in - left + 2) // 3

    model = jax_build(str(xc))
    den = JaxDen(jax_graph.DenominatorGraph.from_fst(
        jax_graph.make_phone_lm_den_fst(num_pdfs=P, **STEP_DEN), P),
        leaky=1e-5, mode="exact")
    rng = np.random.default_rng(0)
    g = profile_step.supervision(B, T_out, max(256, T_out), P, rng)
    num_graph = jax_graph.NumeratorGraphBatch(
        **{f: getattr(g, f) for f in ("arc_src", "arc_dst", "arc_pdf",
                                      "arc_logw", "arc_mask", "start",
                                      "final_logw", "num_states",
                                      "num_arcs")})
    batch = {"features": jnp.asarray(rng.normal(size=(B, T_in, 40))
                                     .astype(np.float32)),
             "ivectors": jnp.asarray(rng.normal(size=(B, 100))
                                     .astype(np.float32)),
             "weights": jnp.ones(B, jnp.float32)}
    config = jax_ts.TrainConfig(learning_rate=1e-3, momentum=0.9,
                                frame_subsampling_factor=3, left_context=left,
                                compute_dtype="float32")
    params, net_state, _, _ = jax_ts.init_train_state(
        model, jax.random.PRNGKey(0), config)

    def first_loss(step_den, patch=None):
        with monkeypatch.context() as m:
            if patch is not None:
                m.setattr(*patch)
            step = jax_ts.make_train_step(
                model, step_den, num_graph, jax_objective.ChainTrainingOpts(),
                config, num_frames_out=T_out, donate=False)
            p, ns, os_, ss = jax_ts.init_train_state(
                model, jax.random.PRNGKey(0), config)
            _, sub = jax.random.split(jax.random.PRNGKey(1))
            return float(step(p, ns, os_, ss, batch, sub)[-1].loss)

    jax_losses = {
        "full": first_loss(den),
        "no-den": first_loss(jtool._ZeroDen()),
        "no-num": first_loss(den, (jax_objective,
                                   "numerator_forward_backward",
                                   jtool._zero_num)),
        "no-chain": first_loss(den, (jax_ts, "make_chain_objf_with_post",
                                     jtool._trivial_objf_factory))}
    sd = params_from_jax(build_model(str(xc)),
                         jax.tree_util.tree_map(np.asarray, params),
                         jax.tree_util.tree_map(np.asarray, net_state))
    res = profile_step.main(STEP_ARGV + ["--xconfig", str(xc)],
                            state_dict=sd)
    capsys.readouterr()
    for name, want in jax_losses.items():
        np.testing.assert_allclose(res[name]["loss"], want,
                                   rtol=STEP_LOSS_RTOL, err_msg=name)
