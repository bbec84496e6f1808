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
  profile_den on --impls split3.
"""

import ast
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
from kaldi_fp16_tpu_torch.convert import xvector_params_from_jax
from kaldi_fp16_tpu_torch.tools import (
    profile_den, profile_host, profile_latdecode, profile_lattice,
    profile_tree, roofline, scalebench, trainbench, xvectortrain,
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
