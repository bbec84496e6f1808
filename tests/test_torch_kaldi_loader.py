"""The port's Kaldi model loader and exporter (models/kaldi_loader.py)
against the JAX package's.

* The mapping: both loaders on the same Kaldi text give bit-equal
  (params, state) trees (numpy, the JAX layout): tests/test_kaldi_loader.py's
  FIXTURE and cases (transpose convention, block BatchNorm tiling, the
  missing component's KeyError) and narrow models exported from JAX
  weights with non-trivial BatchNorm statistics.
* The exporter: `export_network_text(net)` is the JAX
  `export_params_to_text` string for string on the same weights, and the
  binary container written from it (`text_to_binary`) has the same bytes
  as the JAX path (components_from_text + write_nnet3).
* `load_into_network`: text and binary round trips give bit-equal
  parameters, BN buffers (count as max(count, 1), the JAX rule) and
  forwards in fp32 and bf16; a conv with weights that differ per offset
  lands in the port's OIHW weight and gives JAX's forward at the fp32
  bars of tests/test_torch_network.py (rtol / atol 1e-4).
* The flagship at full width through the binary container: the port's
  loaded parameters equal the JAX loader's.
* An attention layer is neither loaded nor exported, in both packages
  (a shared fault, ROADMAP queue 3).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import tests.test_kaldi_loader as tkl
from kaldi_fp16_tpu.io import nnet3_binary as JB
from kaldi_fp16_tpu.models import kaldi_loader as JL
from kaldi_fp16_tpu.models import network as jax_net
from kaldi_fp16_tpu.models.model import (
    build_model as jax_build_model,
    build_model_from_string as jax_build_from_string,
)
from kaldi_fp16_tpu_torch.convert import params_from_jax, params_to_numpy
from kaldi_fp16_tpu_torch.io import nnet3_binary as PB
from kaldi_fp16_tpu_torch.models import kaldi_loader as PL
from kaldi_fp16_tpu_torch.models import network as port_net
from kaldi_fp16_tpu_torch.models.model import (
    build_model, build_model_from_string,
)
from tests.test_torch_network import FLAGSHIP, NARROW

FP32 = dict(rtol=1e-4, atol=1e-4)
B, T = 2, 15
ATTENTION = NARROW.replace(
    "prefinal-layer name=prefinal-l input=tdnnf4",
    "attention-relu-batchnorm-layer name=attention1 num-heads=3 value-dim=6 "
    "key-dim=4 num-left-inputs=5 num-right-inputs=2 time-stride=3\n"
    "prefinal-layer name=prefinal-l input=attention1")
MODELS = {"narrow": NARROW, "small": tkl.SMALL}


def tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def assert_trees_bit_equal(a, b):
    fa, fb = flat(a), flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype == np.float32, k
        assert fa[k].shape == fb[k].shape, k
        assert fa[k].tobytes() == fb[k].tobytes(), k


def jax_weights(xconfig, seed=0):
    """JAX init_params, with BN statistics from one fp32 training forward
    (non-trivial means, variances and counts), as numpy trees."""
    jm = jax_build_from_string(xconfig)
    params, state = jax_net.init_params(jm, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    feat_dim = jm.layer_map["input"].output_dim
    feats = jnp.asarray(rng.normal(size=(B, T, feat_dim)).astype(np.float32))
    ivecs = (jnp.asarray(rng.normal(size=(B, 10)).astype(np.float32))
             if "ivector" in jm.layer_map else None)
    _, state = jax_net.forward(jm, params, state, feats, ivecs, train=True,
                               compute_dtype=jnp.float32)
    return jm, tree_np(params), tree_np(state)


def port_network(xconfig, seed=1):
    return port_net.Network(build_model_from_string(xconfig),
                            torch.Generator().manual_seed(seed), "cpu")


def load_both(xconfig, text):
    """The JAX loader on JAX's seed-9 trees and the port's on the same
    trees (numpy), from `text`."""
    jm = jax_build_from_string(xconfig)
    p0, s0 = tree_np(jax_net.init_params(jm, jax.random.PRNGKey(9)))
    jp, js, jrep = JL.load_weights_from_text(jm, p0, s0, text)
    pp, ps, prep = PL.load_weights_from_text(build_model_from_string(xconfig),
                                             p0, s0, text)
    assert prep == jrep
    return (tree_np(jp), tree_np(js)), (pp, ps)


@pytest.mark.parametrize("which", list(MODELS))
def test_loaders_give_bit_equal_trees(which):
    xconfig = MODELS[which]
    jm, params, state = jax_weights(xconfig)
    text = JL.export_params_to_text(jm, params, state)
    (jp, js), (pp, ps) = load_both(xconfig, text)
    assert_trees_bit_equal(pp, jp)
    assert_trees_bit_equal(ps, js)
    # and the loaded trees are the exported weights (BN count >= 1)
    assert_trees_bit_equal(pp, params)
    for k, v in flat(state).items():
        want = np.maximum(v, 1.0) if k.endswith("count") else v
        np.testing.assert_array_equal(flat(ps)[k], want, err_msg=k)


@pytest.mark.parametrize("case", ["transpose", "block_bn"])
def test_jax_loader_cases_bit_equal(case):
    if case == "transpose":
        xconfig = ("input name=input dim=3\n"
                   "linear-component name=lin dim=2\n"
                   "output-layer name=output dim=2 include-log-softmax=false")
        text = ("<ComponentName> lin <LinearComponent> <Params>  [\n"
                "  1 2 3\n  4 5 6 ]\n"
                "<ComponentName> output.affine "
                "<NaturalGradientAffineComponent> <LinearParams>  [\n"
                "  1 0\n  0 1 ]\n<BiasParams>  [ 0 0 ]\n")
    else:
        xconfig = ("input name=input dim=6\n"
                   "conv-relu-batchnorm-layer name=cnn1 height-in=3 "
                   "height-out=3 time-offsets=0 height-offsets=0 "
                   "num-filters-out=2\n"
                   "output-layer name=output dim=2 include-log-softmax=false")
        text = (
            "<ComponentName> cnn1.conv <TimeHeightConvolutionComponent> "
            "<NumFiltersIn> 2 <NumFiltersOut> 2 <HeightIn> 3 <HeightOut> 3 "
            "<Offsets> [ 0,0 ]\n<LinearParams>  [\n  1 0\n  0 1 ]\n"
            "<BiasParams>  [ 0 0 ]\n"
            "<ComponentName> cnn1.batchnorm <BatchNormComponent> <Dim> 6 "
            "<BlockDim> 2 <Epsilon> 0.001 <TargetRms> 1 <Count> 100 "
            "<StatsMean>  [ 0.5 -0.5 ]\n<StatsVar>  [ 1.0 2.0 ]\n")
    (jp, js), (pp, ps) = load_both(xconfig, text)
    assert_trees_bit_equal(pp, jp)
    assert_trees_bit_equal(ps, js)
    net = port_network(xconfig)
    PL.load_into_network(net, text)
    if case == "transpose":
        np.testing.assert_array_equal(net.params["lin"]["w"].detach().numpy(),
                                      [[1, 4], [2, 5], [3, 6]])
    else:
        # per-filter stats tiled across heights, h * nf + f, in the buffers
        bn = net.bn_state()["cnn1"]
        np.testing.assert_array_equal(bn["mean"].numpy(),
                                      [0.5, -0.5, 0.5, -0.5, 0.5, -0.5])
        np.testing.assert_array_equal(bn["var"].numpy(), [1, 2, 1, 2, 1, 2])
        assert float(bn["count"]) == 100.0


# tests/test_kaldi_loader.py's FIXTURE (captured nnet3-copy shapes) on the
# layers its components name: idct, ivector-linear, ivector-batchnorm,
# output.affine (its conv and tdnnf parts are fragments no layer can take)
FIXTURE_XCONFIG = """input name=ivector dim=3
input name=input dim=4
idct-layer name=idct input=input dim=4
batchnorm-component name=ivector-batchnorm input=idct
linear-component name=ivector-linear dim=2 input=ReplaceIndex(ivector, t, 0)
output-layer name=output dim=3 input=ivector include-log-softmax=false
"""


def test_captured_fixture_loads_bit_equal():
    (jp, js), (pp, ps) = load_both(FIXTURE_XCONFIG, tkl.FIXTURE)
    assert_trees_bit_equal(pp, jp)
    assert_trees_bit_equal(ps, js)
    assert pp["idct"]["idct"].shape == (4, 2)       # loaded as printed, .T
    assert float(ps["ivector-batchnorm"]["count"]) == 176000.0


def test_missing_component_raises_key_error():
    xconfig = ("input name=input dim=4\n"
               "tdnnf-layer name=tdnnf1 dim=4 bottleneck-dim=2 time-stride=1\n"
               "output-layer name=output dim=2 include-log-softmax=false")
    net = port_network(xconfig)
    before = params_to_numpy(net)
    with pytest.raises(KeyError, match="tdnnf1.linear"):
        PL.load_into_network(net, "")
    jm = jax_build_from_string(xconfig)
    with pytest.raises(KeyError, match="tdnnf1.linear"):
        JL.load_weights_from_text(jm, *jax_net.init_params(
            jm, jax.random.PRNGKey(0)), "")
    after = params_to_numpy(net)           # a failed load changes nothing
    assert_trees_bit_equal(after[0], before[0])
    assert_trees_bit_equal(after[1], before[1])


@pytest.mark.parametrize("which", list(MODELS))
def test_exported_text_and_binary_equal_jax(which):
    xconfig = MODELS[which]
    jm, params, state = jax_weights(xconfig)
    net = port_network(xconfig)
    net.load_state_dict(params_from_jax(net.model, params, state),
                        strict=True)
    text = JL.export_params_to_text(jm, params, state)
    assert PL.export_network_text(net) == text
    assert PL.export_params_to_text(net.model, params, state) == text
    jbytes = JB.write_nnet3(JB.Nnet3Model(
        config_lines=[],
        components=JB.components_from_text(JL.parse_nnet3_text(text))))
    assert PL.text_to_binary(text) == jbytes


@pytest.fixture(scope="module")
def round_trip(tmp_path_factory):
    """A port network with non-trivial weights and BN statistics, exported
    to text and to a .raw, loaded into two networks of another seed."""
    d = tmp_path_factory.mktemp("models")
    jm, params, state = jax_weights(NARROW, seed=4)
    src = port_network(NARROW, seed=0)
    src.load_state_dict(params_from_jax(src.model, params, state),
                        strict=True)
    text = PL.export_network_text(src)
    (d / "m.txt").write_text(text)
    PL.text_to_binary(text, str(d / "m.raw"))
    loaded = {}
    for kind in ("txt", "raw"):
        net = port_network(NARROW, seed=7)
        report = PL.load_into_network(net, str(d / f"m.{kind}"))
        loaded[kind] = (net, report)
    return src, loaded


@pytest.mark.parametrize("kind", ["txt", "raw"])
def test_load_into_network_round_trip_bit_equal(round_trip, kind):
    src, loaded = round_trip
    net, report = loaded[kind]
    assert report == loaded["txt"][1] and len(report) == 13
    sp, ss = params_to_numpy(src)
    np_, ns = params_to_numpy(net)
    assert_trees_bit_equal(np_, sp)
    for k, v in flat(ss).items():
        want = np.maximum(v, 1.0) if k.endswith("count") else v
        assert flat(ns)[k].tobytes() == want.astype(np.float32).tobytes(), k
    rng = np.random.default_rng(2)
    feats = torch.from_numpy(rng.normal(size=(B, T, 8)).astype(np.float32))
    ivecs = torch.from_numpy(rng.normal(size=(B, 10)).astype(np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        with torch.no_grad():
            a, _ = src(feats, ivecs, train=False, compute_dtype=dtype)
            b, _ = net(feats, ivecs, train=False, compute_dtype=dtype)
        for name in a:
            assert torch.equal(a[name], b[name]), (name, dtype)


CONV = """
input name=input dim=12
conv-relu-batchnorm-layer name=cnn1 height-in=4 height-out=4 time-offsets=-1,0,1 height-offsets=-1,0,1 num-filters-out=5
conv-relu-batchnorm-layer name=cnn2 height-in=4 height-out=2 height-subsample-out=2 time-offsets=-3,0,3 height-offsets=-1,0,1 num-filters-out=3
conv-relu-batchnorm-layer name=cnn3 height-in=2 height-out=2 time-offsets=-2,0,1 height-offsets=0,1 num-filters-out=2
output-layer name=output dim=4 include-log-softmax=false
"""


def conv_text(model, rng):
    """Kaldi text for CONV with every weight distinct: conv LinearParams
    [nf_out, offsets x nf_in] whose column c = offset * nf_in + filter."""
    lines = []
    for layer in model.execution_order():
        s = layer.spec
        if layer.type.value == "conv-relu-batchnorm-layer":
            k = len(s.offsets) * s.num_filters_in
            w = (np.arange(s.num_filters_out * k, dtype=np.float32)
                 .reshape(s.num_filters_out, k) / k
                 + rng.normal(size=(s.num_filters_out, k)) * 0.1)
            offs = " ".join(f"{a},{b}" for a, b in s.offsets)
            lines += [
                f"<ComponentName> {layer.name}.conv "
                f"<TimeHeightConvolutionComponent> <NumFiltersIn> "
                f"{s.num_filters_in} <NumFiltersOut> {s.num_filters_out} "
                f"<HeightIn> {s.height_in} <HeightOut> {s.height_out} "
                f"<Offsets> [ {offs} ]",
                f"<LinearParams>{JL._fmt_matrix(w.astype(np.float32))}",
                f"<BiasParams>{JL._fmt_vector(rng.normal(size=s.num_filters_out))}",
                f"<ComponentName> {layer.name}.batchnorm <BatchNormComponent> "
                f"<Count> 50 <StatsMean>"
                f"{JL._fmt_vector(rng.normal(size=s.num_filters_out) * 0.1)}",
                f"<StatsVar>"
                f"{JL._fmt_vector(rng.uniform(0.5, 2, s.num_filters_out))}"]
        elif layer.type.value == "output-layer":
            lines += [
                "<ComponentName> output.affine "
                "<NaturalGradientAffineComponent> <LinearParams>"
                f"{JL._fmt_matrix(rng.normal(size=(4, s.input_dim)))}",
                f"<BiasParams>{JL._fmt_vector(np.zeros(4))}"]
    return "\n".join(lines) + "\n"


def test_conv_with_offset_distinct_weights_matches_jax():
    rng = np.random.default_rng(11)
    jm, pm = jax_build_from_string(CONV), build_model_from_string(CONV)
    text = conv_text(pm, rng)
    comps = PL.parse_nnet3_text(text)
    params, state, _ = JL.load_weights_from_text(
        jm, *jax_net.init_params(jm, jax.random.PRNGKey(0)), text)
    net = port_net.Network(pm, torch.Generator().manual_seed(0), "cpu")
    PL.load_into_network(net, text)
    for name in ("cnn1", "cnn2", "cnn3"):
        s = pm.layer_map[name].spec
        kaldi = comps[f"{name}.conv"].linear_params     # [nf_out, k * nf_in]
        w = net.params[name]["w"].detach().numpy()      # OIHW
        kh = len(s.height_offsets)
        for a in range(len(s.time_offsets)):
            for b in range(kh):
                col = (a * kh + b) * s.num_filters_in
                np.testing.assert_array_equal(
                    w[:, :, a, b], kaldi[:, col:col + s.num_filters_in])
    x = rng.normal(size=(B, 20, 12)).astype(np.float32)
    jout, _ = jax_net.forward(jm, params, state, jnp.asarray(x), train=False,
                              compute_dtype=jnp.float32)
    for ng in (None, port_net.NGContext()):    # direct and patch lowerings
        pout, _ = net(torch.from_numpy(x), train=False,
                      compute_dtype=torch.float32, ng=ng)
        np.testing.assert_allclose(pout["output"].detach().numpy(),
                                   np.asarray(jout["output"]), **FP32)


def random_components(model, rng):
    """{name: KaldiComponent} for every component the exporter writes for
    `model`, filled with seeded random values (no text on the way)."""
    K = PL.KaldiComponent

    def mat(rows, cols):
        return rng.standard_normal((rows, cols), dtype=np.float32)

    def vec(n):
        return rng.standard_normal(n, dtype=np.float32)

    def bn(name, dim):
        return K(name=name, type="BatchNormComponent", stats_mean=vec(dim),
                 stats_var=rng.uniform(0.5, 2, dim).astype(np.float32),
                 count=float(rng.integers(0, 3)), epsilon=1e-3,
                 target_rms=1.0)

    out = []
    for layer in model.execution_order():
        n, s, t = layer.name, layer.spec, layer.type.value
        if t == "idct-layer":
            out.append(K(name=n, type="FixedAffineComponent",
                         linear_params=mat(s.dim, s.dim),
                         bias_params=np.zeros(s.dim, np.float32)))
        elif t == "linear-component":
            out.append(K(name=n, type="LinearComponent",
                         linear_params=mat(s.output_dim, s.input_dim)))
        elif t == "batchnorm-component":
            out.append(bn(n, s.dim))
        elif t == "conv-relu-batchnorm-layer":
            out += [K(name=f"{n}.conv", type="TimeHeightConvolutionComponent",
                      linear_params=mat(s.num_filters_out,
                                        len(s.offsets) * s.num_filters_in),
                      bias_params=vec(s.num_filters_out),
                      num_filters_in=s.num_filters_in,
                      num_filters_out=s.num_filters_out,
                      height_in=s.height_in, height_out=s.height_out,
                      offsets=list(s.offsets)),
                    bn(f"{n}.batchnorm", s.num_filters_out)]
        elif t == "tdnnf-layer":
            m = 2 if s.time_stride > 0 else 1
            out += [K(name=f"{n}.linear", type="TdnnComponent",
                      linear_params=mat(s.bottleneck_dim, s.input_dim * m)),
                    K(name=f"{n}.affine", type="TdnnComponent",
                      linear_params=mat(s.output_dim, s.bottleneck_dim * m),
                      bias_params=vec(s.output_dim)),
                    bn(f"{n}.batchnorm", s.output_dim)]
        elif t == "prefinal-layer":
            out += [K(name=f"{n}.affine", type="NaturalGradientAffineComponent",
                      linear_params=mat(s.big_dim, s.input_dim),
                      bias_params=vec(s.big_dim)),
                    bn(f"{n}.batchnorm1", s.big_dim),
                    K(name=f"{n}.linear", type="LinearComponent",
                      linear_params=mat(s.small_dim, s.big_dim)),
                    bn(f"{n}.batchnorm2", s.small_dim)]
        elif t == "output-layer":
            out.append(K(name=f"{n}.affine",
                         type="NaturalGradientAffineComponent",
                         linear_params=mat(s.output_dim, s.input_dim),
                         bias_params=vec(s.output_dim)))
    return {c.name: c for c in out}


def test_flagship_binary_container_loads_equal(tmp_path):
    """Full width through the binary container only (no text): the port's
    loaded network holds the JAX loader's trees bit for bit."""
    pm, jm = build_model(FLAGSHIP), jax_build_model(FLAGSHIP)
    comps = random_components(pm, np.random.default_rng(5))
    path = str(tmp_path / "flagship.raw")
    PB.write_nnet3(PB.Nnet3Model(
        config_lines=[], components=PB.components_from_text(comps)), path)
    net = port_net.Network(pm, torch.Generator().manual_seed(0), "cpu")
    p0, s0 = params_to_numpy(net)
    jp, js, jrep = JL.load_weights_from_file(jm, p0, s0, path)
    report = PL.load_into_network(net, path)
    assert report == jrep and len(report) == 30
    pp, ps = params_to_numpy(net)
    assert_trees_bit_equal(pp, tree_np(jp))
    assert_trees_bit_equal(ps, tree_np(js))
    assert sum(report.values()) == 13_362_112


def test_attention_layer_is_neither_loaded_nor_exported_as_in_jax():
    """The shared fault (ROADMAP queue 3): no attention component is
    written, and a load leaves the attention layer at its init weights,
    in both packages."""
    jm, params, state = jax_weights(ATTENTION)
    text = JL.export_params_to_text(jm, params, state)
    assert "attention1" not in text
    net = port_network(ATTENTION, seed=3)
    net.load_state_dict(params_from_jax(net.model, params, state),
                        strict=True)
    assert PL.export_network_text(net) == text
    (jp, _), (pp, _) = load_both(ATTENTION, text)
    assert_trees_bit_equal(pp, jp)
    j0, _ = tree_np(jax_net.init_params(jm, jax.random.PRNGKey(9)))
    for k in ("w", "b"):
        np.testing.assert_array_equal(pp["attention1"][k],
                                      j0["attention1"][k])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_formatters_equal_the_jax_exporters(dtype):
    """The port builds the '%.9g' strings in one %-format; they must be
    the JAX exporter's f-strings for every value, the odd ones included."""
    rng = np.random.default_rng(1)
    m = rng.standard_normal((7, 33)).astype(dtype) * 10.0 ** rng.integers(
        -40, 30, size=(7, 33))
    m[0, :8] = [0.0, -0.0, 1e-45, 3.699428e-43, 1e30, np.inf, -np.inf,
                np.nan]
    assert PL._fmt_matrix(m) == JL._fmt_matrix(m)
    for row in m:
        assert PL._fmt_vector(row) == JL._fmt_vector(row)
    assert PL._fmt_vector(np.zeros(0)) == JL._fmt_vector(np.zeros(0))
    assert PL._fmt_vector(np.arange(5)) == JL._fmt_vector(np.arange(5))
