"""modeltools: Kaldi-style model file utilities (nnet3-info / nnet3-copy
analogs, standalone: no Kaldi install needed even for binary .mdl files).

The twin of tools/modeltools.py, on the port's copies of the nnet3 binary
container (io/nnet3_binary.py) and the text parser (models/kaldi_loader.py).
It is host file work: no device, no network.

Commands:
  info <model>              summary: container, components, dims, params
  copy <in> <out>           convert between binary (.mdl/.raw) and text
                            (--binary/--text select the output container;
                            default keeps the input container)
  compare <a> <b>           numeric diff of two models' shared components

Examples:
  python -m kaldi_fp16_tpu_torch.tools.modeltools info exp/final.mdl
  python -m kaldi_fp16_tpu_torch.tools.modeltools copy exp/final.mdl exp/final.txt --text
  python -m kaldi_fp16_tpu_torch.tools.modeltools compare exp/a.raw exp/b.raw

`main(argv)` returns the exit code: 0, or 1 when `compare` finds a
difference.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from kaldi_fp16_tpu_torch.io.nnet3_binary import (
    Nnet3Model, components_from_text, read_nnet3, to_kaldi_components,
    write_nnet3,
)
from kaldi_fp16_tpu_torch.models.kaldi_loader import (
    _FLOAT_TAGS, _INT_TAGS, _fmt_matrix, _fmt_vector, parse_nnet3_text,
)


def _load(path):
    """-> (kind, components dict, raw Nnet3Model or None), kind 'binary'
    or 'text'."""
    with open(path, "rb") as f:
        head = f.read(2)
    if head == b"\x00B":
        m = read_nnet3(path)
        return "binary", to_kaldi_components(m), m
    with open(path, "r") as f:
        return "text", parse_nnet3_text(f.read()), None


def cmd_info(args):
    kind, comps, raw = _load(args.model)
    print(f"{args.model}: {kind} container, {len(comps)} components")
    if raw is not None and raw.transition_model is not None:
        print(f"  TransitionModel: {len(raw.transition_model)} bytes "
              "(preserved opaquely)")
    if raw is not None and raw.config_lines:
        print(f"  graph: {len(raw.config_lines)} config lines")
    total = 0
    for name, c in comps.items():
        parts = []
        n = 0
        if c.linear_params is not None:
            parts.append(f"params{list(c.linear_params.shape)}")
            n += c.linear_params.size
        if c.bias_params is not None:
            parts.append(f"bias[{c.bias_params.size}]")
            n += c.bias_params.size
        if c.stats_mean is not None:
            parts.append(f"stats[{c.stats_mean.size}]")
        total += n
        print(f"  {name:32s} {c.type:36s} {' '.join(parts)}")
    print(f"total parameters: {total:,}")
    return 0


def cmd_copy(args):
    kind, comps, raw = _load(args.input)
    out_kind = ("binary" if args.binary else
                "text" if args.text else kind)
    if out_kind == "binary":
        if raw is not None:
            # binary in -> binary out: every item of every component kept
            # in source order (not routed through the lossy text bridge)
            write_nnet3(raw, args.output)
        else:
            write_nnet3(Nnet3Model(config_lines=[],
                                   components=components_from_text(comps)),
                        args.output)
    else:
        # the token layout the text parser reads, through the exporter's
        # formatters; every scalar and int field the parsers know is
        # written (one bracketed field per line: the parser reads at most
        # one [ ... ] block per line)
        lines = []
        for name, c in comps.items():
            fields = [f"<ComponentName> {name} <{c.type}>"]
            if c.offsets:
                fields.append("<Offsets> [ " + " ".join(
                    f"{t},{h}" for t, h in c.offsets) + " ]")
            if c.time_offsets:
                fields.append("<TimeOffsets> [ " + " ".join(
                    str(t) for t in c.time_offsets) + " ]")
            if c.linear_params is not None:
                tag = ("<Params>"
                       if c.type == "TimeHeightConvolutionComponent"
                       else "<LinearParams>")
                fields.append(f"{tag}{_fmt_matrix(c.linear_params)}")
            if c.bias_params is not None:
                fields.append(f"<BiasParams>{_fmt_vector(c.bias_params)}")
            if c.stats_mean is not None:
                fields.append(f"<StatsMean>{_fmt_vector(c.stats_mean)}")
            if c.stats_var is not None:
                fields.append(f"<StatsVar>{_fmt_vector(c.stats_var)}")
            for tag, attr in sorted(_INT_TAGS.items()):
                v = getattr(c, attr)
                if v:
                    fields.append(f"{tag} {int(v)}")
            for tag, attr in sorted(_FLOAT_TAGS.items()):
                v = getattr(c, attr)
                if v:
                    fields.append(f"{tag} {v:.9g}")
            lines.append("\n".join(fields))
        with open(args.output, "w") as f:
            f.write("<Nnet3>\n" + "\n".join(lines) + "\n</Nnet3>\n")
    print(f"wrote {args.output} ({out_kind})")
    return 0


def cmd_compare(args):
    _, ca, _ = _load(args.a)
    _, cb, _ = _load(args.b)
    shared = sorted(set(ca) & set(cb))
    only_a = sorted(set(ca) - set(cb))
    only_b = sorted(set(cb) - set(ca))
    if only_a:
        print(f"only in {args.a}: {', '.join(only_a)}")
    if only_b:
        print(f"only in {args.b}: {', '.join(only_b)}")
    worst = 0.0
    for name in shared:
        for attr in list(_INT_TAGS.values()) + list(_FLOAT_TAGS.values()):
            va, vb = getattr(ca[name], attr), getattr(cb[name], attr)
            err = abs(float(va) - float(vb))
            if err > 1e-6:
                print(f"  {name}.{attr}: {va} vs {vb}")
                worst = max(worst, err)
        for attr in ("linear_params", "bias_params", "stats_mean",
                     "stats_var"):
            va, vb = getattr(ca[name], attr), getattr(cb[name], attr)
            if va is None and vb is None:
                continue
            if va is None or vb is None or va.shape != vb.shape:
                print(f"  {name}.{attr}: SHAPE MISMATCH "
                      f"{None if va is None else va.shape} vs "
                      f"{None if vb is None else vb.shape}")
                worst = float("inf")
                continue
            err = float(np.max(np.abs(va - vb))) if va.size else 0.0
            if err > 0:
                print(f"  {name}.{attr}: max |diff| = {err:.3e}")
            worst = max(worst, err)
    print(f"{len(shared)} shared components, worst |diff| = {worst:.3e}")
    return 0 if worst == 0 else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m kaldi_fp16_tpu_torch.tools.modeltools")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("info")
    p.add_argument("model")
    p = sub.add_parser("copy")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--binary", action="store_true")
    p.add_argument("--text", action="store_true")
    p = sub.add_parser("compare")
    p.add_argument("a")
    p.add_argument("b")
    args = ap.parse_args(argv)
    return {"info": cmd_info, "copy": cmd_copy,
            "compare": cmd_compare}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
