"""The port's copy of the binary nnet3 container (io/nnet3_binary.py)
against the JAX package's, on the inputs of tests/test_nnet3_binary.py,
tests/test_foreign_bytes.py and tests/test_kaldi_text_fixtures.py.

Every input goes through both copies: what they read must be equal item
for item (tags, kinds, values bit for bit), and what they write must be
the same bytes.  The text fixtures go through both text parsers and both
text -> binary bridges (`components_from_text`).  No tolerance: the two
are the same numpy code.
"""

import dataclasses
import struct

import numpy as np
import pytest

import tests.test_foreign_bytes as tfb
import tests.test_kaldi_loader as tkl
import tests.test_kaldi_text_fixtures as ttf
import tests.test_nnet3_binary as tnb
from kaldi_fp16_tpu.io import kaldi_io as jio
from kaldi_fp16_tpu.io import nnet3_binary as J
from kaldi_fp16_tpu.models import kaldi_loader as JL
from kaldi_fp16_tpu_torch.io import kaldi_io as pio
from kaldi_fp16_tpu_torch.io import nnet3_binary as P
from kaldi_fp16_tpu_torch.models import kaldi_loader as PL


def port_comp(c):
    """A JAX BinaryComponent as the port's (the same items)."""
    return P.BinaryComponent(name=c.name, type=c.type, items=list(c.items))


def port_model(m):
    return P.Nnet3Model(config_lines=list(m.config_lines),
                        components=[port_comp(c) for c in m.components],
                        transition_model=m.transition_model)


def assert_items_equal(a, b):
    assert (a.name, a.type) == (b.name, b.type)
    assert len(a.items) == len(b.items)
    for (ta, ka, va), (tb, kb, vb) in zip(a.items, b.items):
        assert (ta, ka) == (tb, kb)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype and va.shape == vb.shape
            assert va.tobytes() == vb.tobytes(), ta
        else:
            assert type(va) is type(vb) and va == vb, (ta, va, vb)


def assert_models_equal(a, b):
    assert a.config_lines == b.config_lines
    assert a.transition_model == b.transition_model
    assert len(a.components) == len(b.components)
    for x, y in zip(a.components, b.components):
        assert_items_equal(x, y)


def assert_kaldi_components_equal(a, b):
    assert list(a) == list(b)
    for name in a:
        da, db = dataclasses.asdict(a[name]), dataclasses.asdict(b[name])
        assert da.keys() == db.keys()
        for k, v in da.items():
            if isinstance(v, np.ndarray):
                assert v.dtype == db[k].dtype and v.shape == db[k].shape
                assert v.tobytes() == db[k].tobytes(), (name, k)
            else:
                assert v == db[k], (name, k, v, db[k])


def both_write(comp):
    wj, wp = jio.BinaryWriter(), pio.BinaryWriter()
    J.write_component(wj, comp)
    P.write_component(wp, port_comp(comp))
    return wj.getvalue(), wp.getvalue()


def read_both(data):
    j = J.read_component(jio.BinaryReader(data))
    p = P.read_component(pio.BinaryReader(data))
    assert_items_equal(j, p)
    return j, p


# -- the components of tests/test_nnet3_binary.py ---------------------------

def built_components():
    """{case: JAX BinaryComponent}: each component the JAX test file builds
    with the set_* helpers."""
    rng = np.random.default_rng(0)
    out = {}
    c = J.BinaryComponent(type="LinearComponent")
    c.set_int("<Dim>", 512)
    c.set_float("<LearningRate>", 0.00125)
    c.set_bool("<IsGradient>", True)
    out["scalars_ints_bools"] = c
    c = J.BinaryComponent(type="NaturalGradientAffineComponent")
    c.set_matrix("<LinearParams>", rng.normal(size=(7, 5)).astype(np.float32))
    c.set_vector("<BiasParams>", rng.normal(size=7).astype(np.float32))
    out["matrix_vector"] = c
    c = J.BinaryComponent(type="BatchNormComponent")
    c.set_float("<Epsilon>", 1e-3)
    c.set_float("<TargetRms>", 0.025)
    out["negative_exponent"] = c
    c = J.BinaryComponent(type="NoOpComponent")
    c.set_flag("<SomeFlag>")
    out["flag"] = c
    c = J.BinaryComponent(type="TimeHeightConvolutionComponent")
    c.set_intvec("<RequiredTimeOffsets>", np.array([-1, 0, 1], np.int32))
    c.set_intvec("<TimeOffsets>", np.array([-3, 0, 3], np.int32))
    out["integer_vectors"] = c
    rng = np.random.default_rng(3)
    c = J.BinaryComponent(type="NaturalGradientAffineComponent")
    c.set_float("<LearningRate>", 0.001)
    c.set_matrix("<LinearParams>", rng.normal(size=(4, 3)).astype(np.float32))
    c.set_vector("<BiasParams>", rng.normal(size=4).astype(np.float32))
    c.set_int("<RankIn>", 20)
    c.set_float("<NumSamplesHistory>", 2000.0)
    c.set_bool("<IsGradient>", False)
    out["source_order"] = c
    c = J.BinaryComponent(type="TimeHeightConvolutionComponent")
    c.set_intpairvec("<Offsets>", np.array(
        [-1, 0, -1, 1, 0, 0, 0, 1, 1, 0, 1, 1], np.int32))
    c.set_intvec("<RequiredTimeOffsets>", np.array([0], np.int32))
    c.set_matrix("<LinearParams>", np.ones((4, 6), np.float32))
    out["pair_vector_offsets"] = c
    c = J.BinaryComponent(type="BatchNormComponent")
    c.set_double("<Count>", 176000.0)
    c.append_untagged_float(4.0)
    c.append_untagged_int(80)
    out["double_and_untagged"] = c
    return out


def fuzz_component(seed):
    """tests/test_nnet3_binary.py's TestComponentFuzz component for `seed`."""
    F = tnb.TestComponentFuzz
    rng = np.random.default_rng(seed)
    c = J.BinaryComponent(type="FuzzComponent")
    used = set()
    for i in range(int(rng.integers(4, 16))):
        kind = rng.choice(["int", "float", "vector", "matrix", "intvec",
                           "bool", "pairvec"])
        if kind == "int":
            tag = str(rng.choice(F.KNOWN_INT))
            if tag in used:
                continue
            c.set_int(tag, int(rng.integers(-1000, 100000)))
        elif kind == "float":
            tag = str(rng.choice(F.KNOWN_FLOAT))
            if tag in used:
                continue
            c.set_float(tag, float(rng.choice([0.0, 1e-8, -2.5e-4, 3.25,
                                               65536.0, -1.0])))
        elif kind == "bool":
            tag = str(rng.choice(F.KNOWN_BOOL))
            if tag in used:
                continue
            c.set_bool(tag, bool(rng.integers(0, 2)))
        elif kind == "vector":
            tag = f"<FuzzVec{i}>"
            c.set_vector(tag, rng.normal(
                size=int(rng.integers(0, 40))).astype(np.float32))
        elif kind == "matrix":
            tag = f"<FuzzMat{i}>"
            c.set_matrix(tag, rng.normal(size=(
                int(rng.integers(1, 12)),
                int(rng.integers(1, 12)))).astype(np.float32))
        elif kind == "intvec":
            tag = str(rng.choice(F.KNOWN_INTVEC))
            if tag in used:
                continue
            c.set_intvec(tag, rng.integers(
                -99, 99, size=int(rng.integers(0, 12))).astype(np.int32))
        else:
            tag = "<Offsets>"
            if tag in used:
                continue
            n = int(rng.integers(1, 9))
            c.set_intpairvec(tag, rng.integers(
                -9, 9, size=2 * n).astype(np.int32))
        used.add(tag)
    return c


COMPONENT_CASES = list(built_components()) + ["fuzz5", "fuzz17", "fuzz29"]


def component_case(name):
    if name.startswith("fuzz"):
        return fuzz_component(int(name[4:]))
    return built_components()[name]


@pytest.mark.parametrize("case", COMPONENT_CASES)
def test_component_write_and_read_equal(case):
    comp = component_case(case)
    data, pdata = both_write(comp)
    assert pdata == data
    j, p = read_both(data)
    # read -> write replays the same bytes in both
    assert both_write(j) == (data, data)
    w = pio.BinaryWriter()
    P.write_component(w, p)
    assert w.getvalue() == data


def test_hand_written_streams_read_equal():
    """tests/test_nnet3_binary.py's untagged payload and unknown-int-tag
    streams."""
    w = jio.BinaryWriter()
    w.write_token("<SumBlockComponent>")
    w.write_token("FV")
    w.write_byte(4)
    w.write_bytes(struct.pack("<i", 2))
    w.write_bytes(np.array([1.5, -2.5], np.float32).tobytes())
    w.write_token("</SumBlockComponent>")
    untagged = w.getvalue()
    w = jio.BinaryWriter()
    w.write_token("<FooComponent>")
    w.write_token("<LeftContext>")
    w.write_byte(4)
    w.write_bytes(struct.pack("<i", 100))
    w.write_token("</FooComponent>")
    for data in (untagged, w.getvalue()):
        j, p = read_both(data)
        assert both_write(j) == (data, data)
    assert p.ints["<LeftContext>"] == 100


def test_legacy_offsets_framing_reads_equal():
    c = built_components()["pair_vector_offsets"]
    raw, _ = both_write(c)
    needle = b"<Offsets> \x04" + struct.pack("<i", 6)
    assert raw.count(needle) == 1
    legacy = raw.replace(needle, b"<Offsets> \x04" + struct.pack("<i", 12))
    j, p = read_both(legacy)
    np.testing.assert_array_equal(p.int_vectors["<Offsets>"],
                                  c.int_vectors["<Offsets>"])


def test_views_are_read_only():
    c = P.BinaryComponent(type="LinearComponent")
    c.set_int("<Dim>", 4)
    with pytest.raises(TypeError):
        c.ints["<Dim>"] = 8
    assert c.ints["<Dim>"] == 4


# -- the foreign byte streams of tests/test_foreign_bytes.py -----------------

FOREIGN = ["ng_affine_bytes", "linear_bytes", "batchnorm_bytes",
           "tdnn_bytes", "conv_bytes"]


@pytest.mark.parametrize("make", FOREIGN)
def test_foreign_streams_read_and_replay_equal(make):
    data = getattr(tfb, make)()
    j, p = read_both(data)
    w = pio.BinaryWriter()
    P.write_component(w, p)
    assert w.getvalue() == data


def foreign_kaldi_components():
    """The KaldiComponents of test_foreign_bytes.py's emitter cases, with
    the foreign stream each must emit."""
    K = JL.KaldiComponent
    return [
        (K(name="a", type="NaturalGradientAffineComponent",
           linear_params=tfb.W_AFF, bias_params=tfb.B_AFF, max_change=0.75,
           learning_rate=1e-3), tfb.ng_affine_bytes()),
        (K(name="l", type="LinearComponent", linear_params=tfb.W_LIN,
           learning_rate=2e-4), tfb.linear_bytes()),
        (K(name="bn", type="BatchNormComponent", stats_mean=tfb.MEAN,
           stats_var=tfb.VAR, epsilon=1e-3, target_rms=1.0, count=176000.0),
         tfb.batchnorm_bytes()),
        (K(name="t", type="TdnnComponent", linear_params=tfb.W_TDNN,
           bias_params=tfb.B_TDNN, learning_rate=1e-4, time_offsets=[-3, 0]),
         tfb.tdnn_bytes()),
        (K(name="c", type="TimeHeightConvolutionComponent",
           linear_params=tfb.W_CONV, bias_params=tfb.B_CONV,
           learning_rate=3.33e-5, num_filters_in=2, num_filters_out=8,
           height_in=3, height_out=3, height_subsample=1,
           offsets=tfb.CONV_OFFSETS), tfb.conv_bytes()),
    ]


def canonical_kaldi_components():
    """The KaldiComponents of test_nnet3_binary.py's token-sequence cases."""
    K = JL.KaldiComponent
    ones = lambda *s: np.ones(s, np.float32)   # noqa: E731
    return [
        K(name="a", type="NaturalGradientAffineComponent",
          linear_params=ones(3, 4), bias_params=np.zeros(3, np.float32)),
        K(name="a", type="AffineComponent", linear_params=ones(2, 2),
          max_change=0.75, l2_regularize=0.004, learning_rate=1e-3),
        K(name="l", type="LinearComponent", linear_params=ones(2, 3)),
        K(name="bn", type="BatchNormComponent",
          stats_mean=np.zeros(4, np.float32), stats_var=ones(4),
          epsilon=1e-3, target_rms=1.0, count=0.0),
        K(name="c", type="TimeHeightConvolutionComponent",
          linear_params=ones(8, 6), num_filters_in=2, num_filters_out=8),
        K(name="c", type="TimeHeightConvolutionComponent",
          linear_params=ones(8, 6), num_filters_in=2, num_filters_out=8,
          height_in=3, height_out=3,
          offsets=[(-1, 0), (-1, 1), (0, 0), (0, 1)]),
        K(name="t", type="TdnnComponent", linear_params=ones(4, 8),
          bias_params=np.zeros(4, np.float32)),
        K(name="t", type="TdnnComponent", linear_params=ones(4, 8),
          bias_params=np.zeros(4, np.float32), time_offsets=[-3, 0]),
        K(name="t", type="TdnnComponent", linear_params=ones(4, 8)),
        K(name="at", type="RestrictedAttentionComponent", num_heads=4,
          key_dim=16, value_dim=16, key_scale=0.25),
        K(name="u", type="SomeFutureComponent", linear_params=ones(2, 2),
          count=0.0),
    ]


def port_kaldi_component(kc):
    return PL.KaldiComponent(**dataclasses.asdict(kc))


def bridge_bytes(mod, io_mod, comps):
    """components_from_text of `mod` on {name: KaldiComponent}, written."""
    out = []
    for bc in mod.components_from_text(comps):
        w = io_mod.BinaryWriter()
        mod.write_component(w, bc)
        out.append(w.getvalue())
    return out


@pytest.mark.parametrize("which", ["foreign", "canonical"])
def test_components_from_text_emit_equal_bytes(which):
    cases = (foreign_kaldi_components() if which == "foreign"
             else [(kc, None) for kc in canonical_kaldi_components()])
    for kc, want in cases:
        jb = bridge_bytes(J, jio, {kc.name: kc})
        pb = bridge_bytes(P, pio, {kc.name: port_kaldi_component(kc)})
        assert pb == jb, kc.type
        if want is not None:
            assert pb == [want], kc.type
        [jc] = J.components_from_text({kc.name: kc})
        [pc] = P.components_from_text({kc.name: port_kaldi_component(kc)})
        assert_items_equal(jc, pc)


# -- whole files --------------------------------------------------------------

def file_cases():
    """{case: bytes of a whole binary file}: test_nnet3_binary.py's .raw
    and its .mdl with an opaque TransitionModel, and test_foreign_bytes.py's
    hand-built container."""
    raw = tnb.small_model()
    mdl = tnb.small_model()
    mdl.transition_model = (b"<TransitionModel> <Topology> "
                            + bytes(range(1, 40)) + b" </Topology> "
                            b"<Tuples> junk </Tuples> </TransitionModel> ")
    return {"raw": J.write_nnet3(raw), "mdl": J.write_nnet3(mdl),
            "foreign": tfb.TestForeignWholeFile()._file_bytes()}


@pytest.mark.parametrize("case", ["raw", "mdl", "foreign"])
def test_whole_file_read_write_equal(case, tmp_path):
    data = file_cases()[case]
    path = tmp_path / "m.bin"
    path.write_bytes(data)
    jm = J.read_nnet3(data)
    pm = P.read_nnet3(str(path))
    assert_models_equal(jm, pm)
    assert P.write_nnet3(pm) == J.write_nnet3(jm)
    if case != "foreign":        # the foreign file's newlines are not ours
        assert P.write_nnet3(pm, str(tmp_path / "out.raw")) == data
        assert (tmp_path / "out.raw").read_bytes() == data
    assert P.write_nnet3(port_model(jm)) == J.write_nnet3(jm)
    assert_kaldi_components_equal(J.to_kaldi_components(jm),
                                  P.to_kaldi_components(pm))


def test_rejects_text_file():
    for mod in (J, P):
        with pytest.raises(ValueError, match="binary"):
            mod.read_nnet3(b"<Nnet3> not binary")


# -- the text fixtures of tests/test_kaldi_text_fixtures.py --------------------

TEXTS = {
    "captured": ttf.TEST_COMPONENTS,
    "loader_fixture": tkl.FIXTURE,
    "batchnorm_line": (
        "<ComponentName> prefinal-chain.batchnorm2 "
        "<BatchNormComponent> <Dim> 192 <BlockDim> 192 "
        "<Epsilon> 0.001 <TargetRms> 1 <TestMode> F <Count> 41344 "
        "<StatsMean>  [ 4.844032e-10 -4.039575e-09 -7.640916e-11 ]\n"
        "<StatsVar>  [ 0.001 0.002 0.003 ]"),
    "inline_vector": (
        "<ComponentName> test <BatchNormComponent> <Dim> 3 "
        "<Epsilon> 0.001 <TargetRms> 1 <Count> 100 "
        "<StatsMean>  [ 0.1 0.2 0.3 ]\n"
        "<StatsVar>  [ 0.4 0.5 0.6 ]"),
}


@pytest.mark.parametrize("case", list(TEXTS))
def test_text_fixtures_parse_and_bridge_equal(case, tmp_path):
    jc = JL.parse_nnet3_text(TEXTS[case])
    pc = PL.parse_nnet3_text(TEXTS[case])
    assert_kaldi_components_equal(jc, pc)
    assert bridge_bytes(P, pio, pc) == bridge_bytes(J, jio, jc)
    # the bridged file reads back to equal components in both
    data = J.write_nnet3(J.Nnet3Model([], J.components_from_text(jc)))
    assert P.write_nnet3(P.Nnet3Model([], P.components_from_text(pc))) == data
    assert_kaldi_components_equal(J.to_kaldi_components(J.read_nnet3(data)),
                                  P.to_kaldi_components(P.read_nnet3(data)))
