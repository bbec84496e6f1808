"""The port's decode and decodebench tools against the JAX package's.

* The acoustic path of `python -m kaldi_fp16_tpu_torch.tools.decode`:
  tiny egs through the port's DataLoader and a tiny xconfig network whose
  weights are JAX's (`convert.params_from_jax`), `train=False`, then
  `subsample_output`: the posteriors against JAX's forward and
  subsample_output at tests/test_torch_network.py's bf16 bars (atol 0.1,
  mean error under 0.02); and those posteriors decoded by JAX's and the
  port's SparseViterbiDecoder to equal words.
* The tool end to end with `--device cpu`: demo mode prints what
  tools/decode.py prints, `--ref` gives JAX's WER report.
* `--model` with a Kaldi model the JAX exporter wrote (nnet3 text and a
  binary .raw): with both tools' networks in fp32, the posteriors the
  decoder gets equal the JAX tool's at the fp32 network bars (rtol / atol
  1e-4) and the words are equal; in the tool's bf16 the words are those
  of the same weights decoded from memory; without --egs, --graph and
  --xconfig it is an error.
* decodebench: its graphs equal tools/decodebench.py's, and its JSON line
  carries the JAX tool's mean cost / mean lattice size.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from kaldi_fp16_tpu.decode import tpu_viterbi as jv
from kaldi_fp16_tpu.decode.wer import wer as jax_wer
from kaldi_fp16_tpu.io.dataloader import (
    DataLoader as JaxLoader, DataLoaderConfig as JaxLoaderConfig,
)
from kaldi_fp16_tpu.models import network as jax_net
from kaldi_fp16_tpu.models.model import (
    build_model_from_string as jax_build_from_string,
)
from kaldi_fp16_tpu_torch.convert import params_from_jax
from kaldi_fp16_tpu_torch.decode import device_viterbi as pv
from kaldi_fp16_tpu_torch.io.dataloader import DataLoader, DataLoaderConfig
from kaldi_fp16_tpu_torch.io.fst import write_fst_file
from kaldi_fp16_tpu_torch.models import network as port_net
from kaldi_fp16_tpu_torch.models.model import build_model_from_string
from kaldi_fp16_tpu_torch.tools import decode as decode_tool
from kaldi_fp16_tpu_torch.tools import decodebench
from tests.test_torch_decode_host import both_graphs, port_fst
from tests.test_torch_decode_viterbi import assert_results_equal
from tests.test_torch_train_tool import EGS_XCONFIG
from tests.test_tpu_viterbi import random_eps_free_graph

ROOT = Path(__file__).resolve().parents[1]
P = 12                       # EGS_XCONFIG's output dim
BF16_ATOL, BF16_MEAN = 0.1, 0.02


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Tiny egs, the xconfig, a 40-state graph file and JAX weights."""
    from kaldi_fp16_tpu_torch.tools import make_synthetic_egs
    d = tmp_path_factory.mktemp("decode")
    make_synthetic_egs.main([str(d / "egs"), "--files", "1", "--per-file",
                             "8", "--pdfs", str(P), "--frames-in", "27",
                             "--frames-out", "8", "--den-states", "12"])
    xconfig = d / "tiny.xconfig"
    xconfig.write_text(EGS_XCONFIG)
    graph = d / "HCLG.fst"
    fst = random_eps_free_graph(seed=3)
    write_fst_file(str(graph), port_fst(fst))
    jm = jax_build_from_string(EGS_XCONFIG)
    params, state = jax_net.init_params(jm, jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    return {"dir": d, "egs": str(d / "egs" / "cegs.1.ark"),
            "xconfig": str(xconfig), "graph": str(graph), "fst": fst,
            "jax_model": jm, "params": params, "state": state}


def port_posteriors(data):
    pm = build_model_from_string(EGS_XCONFIG)
    net = port_net.Network(pm, torch.Generator().manual_seed(0), "cpu")
    net.load_state_dict(params_from_jax(pm, data["params"], data["state"]),
                        strict=True)
    loader = DataLoader(data["egs"], DataLoaderConfig(batch_size=4,
                                                      label_dim=P))
    return decode_tool.acoustic_posteriors(net, loader, "cpu")


def jax_posteriors(data):
    """tools/decode.py's acoustic path in JAX."""
    jm, out = data["jax_model"], {}
    for batch in JaxLoader(data["egs"], JaxLoaderConfig(batch_size=4,
                                                        label_dim=P)):
        outs, _ = jax_net.forward(
            jm, data["params"], data["state"], jnp.asarray(batch.features),
            jnp.asarray(batch.ivectors), train=False)
        y = jax_net.subsample_output(outs[jm.chain_output().name], 3,
                                     batch.left_context, batch.frames_per_seq)
        for i, key in enumerate(batch.keys):
            out[key] = np.asarray(y[i], np.float32)
    return out


def test_posteriors_match_jax(data):
    ours, ref = port_posteriors(data), jax_posteriors(data)
    assert list(ours) == list(ref) and len(ref) == 8
    for key, r in ref.items():
        p = ours[key].numpy()
        assert p.shape == r.shape == (8, P)
        np.testing.assert_allclose(p, r, rtol=0, atol=BF16_ATOL, err_msg=key)
        assert np.abs(p - r).mean() < BF16_MEAN, key


def test_port_posteriors_decode_to_equal_words(data):
    posts = port_posteriors(data)
    lls = torch.stack(list(posts.values())).numpy()
    jg, pg = both_graphs(data["fst"])
    assert_results_equal(
        jv.SparseViterbiDecoder(jg).decode_batch(lls),
        pv.SparseViterbiDecoder(pg, device="cpu").decode_batch(lls))


def test_subsample_output_matches_jax():
    x = np.random.default_rng(0).normal(size=(2, 30, 5)).astype(np.float32)
    for stride, offset, n in ((3, 1, 9), (3, 0, 10), (1, 2, 5)):
        np.testing.assert_array_equal(
            port_net.subsample_output(torch.from_numpy(x), stride, offset,
                                      n).numpy(),
            np.asarray(jax_net.subsample_output(jnp.asarray(x), stride,
                                                offset, n)))


def run_jax_tool(script, *flags):
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tools" / script), "--cpu", *flags],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu",
             "KALDI_TPU_NO_COMPILE_CACHE": "1"})
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


@pytest.mark.parametrize("flags", [[], ["--on-device"],
                                   ["--on-device", "--nbest", "3"]],
                         ids=["host", "on-device", "on-device-nbest"])
def test_demo_mode_prints_what_the_jax_tool_prints(flags, capsys):
    out = decode_tool.main(flags + ["--device", "cpu"])
    printed = capsys.readouterr().out
    assert out["hyps"] == {"demo-utt": [1, 2]}
    assert "demo-utt: 1 2  (cost -19.900" in printed
    assert printed == run_jax_tool("decode.py", *flags)


@pytest.mark.parametrize("flags", [[], ["--on-device"],
                                   ["--on-device", "--nbest", "2"]],
                         ids=["host", "on-device", "on-device-nbest"])
def test_ref_gives_the_jax_wer_report(data, flags, capsys):
    keys = list(port_posteriors(data))
    rng = np.random.default_rng(1)
    refs = {k: rng.integers(1, 5, size=int(rng.integers(0, 4))).tolist()
            for k in keys}
    ref_file = data["dir"] / "ref.txt"
    ref_file.write_text("".join(f"{k} {' '.join(map(str, r))}\n"
                                for k, r in refs.items()))
    out = decode_tool.main(["--egs", data["egs"], "--graph", data["graph"],
                            "--xconfig", data["xconfig"], "--pdfs", str(P),
                            "--ref", str(ref_file), "--device", "cpu"]
                           + flags)
    printed = capsys.readouterr().out
    assert sorted(out["hyps"]) == sorted(keys)
    hyp_keys = list(out["hyps"])
    report = jax_wer([refs[k] for k in hyp_keys],
                     [out["hyps"][k] for k in hyp_keys])
    assert out["wer"] == report
    assert printed.splitlines()[-1] == "WER: " + " ".join(
        f"{k}={v}" for k, v in report.items())
    assert all(out["final_reached"].values())


@pytest.fixture(scope="module")
def kaldi_models(data):
    """JAX weights (seed 5, BN statistics from one fp32 training forward)
    exported by the JAX exporter as nnet3 text and as a binary .raw."""
    from kaldi_fp16_tpu.io import nnet3_binary as jb
    from kaldi_fp16_tpu.models import kaldi_loader as jl
    jm = data["jax_model"]
    params, state = jax_net.init_params(jm, jax.random.PRNGKey(5))
    rng = np.random.default_rng(5)
    _, state = jax_net.forward(
        jm, params, state,
        jnp.asarray(rng.normal(size=(4, 27, 40)).astype(np.float32)),
        jnp.asarray(rng.normal(size=(4, 100)).astype(np.float32)),
        train=True, compute_dtype=jnp.float32)
    text = jl.export_params_to_text(jm, params, state)
    paths = {"text": data["dir"] / "final.txt", "raw": data["dir"] / "final.raw"}
    paths["text"].write_text(text)
    jb.write_nnet3(jb.Nnet3Model(config_lines=[], components=(
        jb.components_from_text(jl.parse_nnet3_text(text)))),
        str(paths["raw"]))
    return {k: str(v) for k, v in paths.items()}


def decode_flags(data, model):
    return ["--egs", data["egs"], "--graph", data["graph"], "--xconfig",
            data["xconfig"], "--pdfs", str(P), "--batch", "4",
            "--model", model, "--on-device"]


def jax_decode_tool(monkeypatch):
    """tools/decode.py as a module (it imports tools/_common)."""
    monkeypatch.syspath_prepend(str(ROOT / "tools"))
    monkeypatch.setenv("KALDI_TPU_NO_COMPILE_CACHE", "1")
    spec = importlib.util.spec_from_file_location(
        "jax_decode", ROOT / "tools" / "decode.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def recorded(monkeypatch, cls):
    """Record every batch of loglikes `cls.decode_batch` is given."""
    seen, run = [], cls.decode_batch

    def decode_batch(self, lls, *args, **kwargs):
        seen.append(np.asarray(lls, np.float32))
        return run(self, lls, *args, **kwargs)

    monkeypatch.setattr(cls, "decode_batch", decode_batch)
    return seen


@pytest.mark.parametrize("kind", ["text", "raw"])
def test_model_flag_gives_the_jax_tools_posteriors_and_words(
        data, kaldi_models, kind, monkeypatch, capsys):
    """--model in both tools, their networks in fp32: the posteriors the
    decoder is given agree at the fp32 network bars (rtol / atol 1e-4)
    and the words are equal, utterance for utterance."""
    flags = decode_flags(data, kaldi_models[kind])
    jax_forward = jax_net.forward
    monkeypatch.setattr(jax_net, "forward", lambda *a, **kw: jax_forward(
        *a, **{**kw, "compute_dtype": jnp.float32}))
    jax_seen = recorded(monkeypatch, jv.SparseViterbiDecoder)
    monkeypatch.setattr(sys, "argv", ["decode.py", "--cpu"] + flags)
    jax_decode_tool(monkeypatch).main()
    jax_words = {line.split(":")[0]: line.split(":")[1].split("(")[0].split()
                 for line in capsys.readouterr().out.splitlines()
                 if "on-device)" in line}

    port_forward = port_net.Network.forward
    monkeypatch.setattr(port_net.Network, "forward",
                        lambda self, *a, **kw: port_forward(
                            self, *a, **{**kw,
                                         "compute_dtype": torch.float32}))
    port_seen = recorded(monkeypatch, pv.SparseViterbiDecoder)
    out = decode_tool.main(flags + ["--device", "cpu"])
    assert len(port_seen) == len(jax_seen) == 1
    assert port_seen[0].shape == (8, 8, P)
    np.testing.assert_allclose(port_seen[0], jax_seen[0], rtol=1e-4,
                               atol=1e-4)
    assert {k: list(map(int, w)) for k, w in jax_words.items()} == \
        out["hyps"]
    # the weights came from the file: seed 0's network posts differently
    no_model = decode_tool.main(flags[:-3] + ["--on-device", "--device",
                                              "cpu"])
    assert len(port_seen) == 2
    assert not np.allclose(port_seen[1], port_seen[0], atol=1e-3)
    assert sorted(no_model["hyps"]) == sorted(out["hyps"])


def test_model_flag_decodes_as_the_network_in_memory(data, kaldi_models):
    """--model on the .raw gives the words of the same weights decoded
    from memory (bf16, the tool's default), utterance for utterance."""
    from kaldi_fp16_tpu_torch.models import kaldi_loader as pl
    net = port_net.Network(build_model_from_string(EGS_XCONFIG),
                           torch.Generator().manual_seed(3), "cpu")
    pl.load_into_network(net, kaldi_models["text"])
    net.eval()
    posts = decode_tool.acoustic_posteriors(net, DataLoader(
        data["egs"], DataLoaderConfig(batch_size=4, label_dim=P)), "cpu")
    _, pg = both_graphs(data["fst"])
    ref = pv.SparseViterbiDecoder(pg, device="cpu").decode_batch(
        torch.stack(list(posts.values())))
    out = decode_tool.main(decode_flags(data, kaldi_models["raw"])
                           + ["--device", "cpu"])
    assert out["hyps"] == {k: r["words"] for k, r in zip(posts, ref)}


def test_model_flag_without_the_decode_inputs_is_an_error():
    with pytest.raises(SystemExit, match="--xconfig"):
        decode_tool.main(["--model", "final.mdl", "--device", "cpu"])


def jax_decodebench(monkeypatch):
    """tools/decodebench.py as a module (it imports tools/_common)."""
    monkeypatch.syspath_prepend(str(ROOT / "tools"))
    spec = importlib.util.spec_from_file_location(
        "jax_decodebench", ROOT / "tools" / "decodebench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_decodebench_graphs_equal_the_jax_tool(monkeypatch):
    from tests.test_torch_decode_host import assert_graphs_equal
    from kaldi_fp16_tpu.decode.graph import DecodingGraph as JaxGraph
    from kaldi_fp16_tpu_torch.decode.graph import DecodingGraph
    jb = jax_decodebench(monkeypatch)
    assert_graphs_equal(JaxGraph.from_fst(jb.synth_graph(30, 10, 4)),
                        DecodingGraph.from_fst(decodebench.synth_graph(30, 10,
                                                                       4)))
    assert_graphs_equal(jb.synth_hclg_graph(203, 30),
                        decodebench.synth_hclg_graph(203, 30))


@pytest.mark.parametrize("flags", [[], ["--dense"], ["--lattice"],
                                   ["--lattice", "--transfer", "compact"],
                                   ["--hclg"], ["--layout", "tree"],
                                   ["--layout", "ell"],
                                   ["--lattice", "--layout", "tree"]],
                         ids=["sparse", "dense", "lattice", "compact",
                              "hclg", "tree", "ell", "lattice-tree"])
def test_decodebench_line_matches_the_jax_tool(flags, capsys):
    size = ["--states", "64", "--pdfs", "16", "--batch", "2", "--frames",
            "20", "--iters", "1"]
    line = decodebench.main(size + flags + ["--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == line
    ref = json.loads(run_jax_tool("decodebench.py", *size, *flags)
                     .strip().splitlines()[-1])
    assert line["metric"] == ref["metric"] == "decode_audio_sec_per_s"
    assert line["detail"]["device"] == "cpu"
    for key in ("decoder", "states", "pdfs", "batch", "frames",
                "mean_cost", "mean_lattice_arcs"):
        assert line["detail"].get(key) == ref["detail"].get(key), key
    if "--layout" in flags:
        assert line["detail"]["layout"] == flags[flags.index("--layout") + 1]
