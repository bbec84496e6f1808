"""The torch chainbench twin runs end to end at a tiny size on the CPU.

`--device cpu` runs the plain versions and times them on the host clock;
the line must keep tools/chainbench.py's keys and name the layout, scan
and reduce that ran.  Timings here are host numbers, checked only for
being positive.
"""

import json

import pytest

from kaldi_fp16_tpu_torch.tools import chainbench


@pytest.mark.parametrize("argv,layout,scan,reduce", [
    (["--topology", "phone-lm", "--pdfs", "24", "--batch", "128",
      "--frames", "4", "--scan-impl", "fused"], "structured", "fused", None),
    (["--topology", "random", "--pdfs", "12", "--den-states", "30",
      "--den-arcs", "120", "--batch", "3", "--frames", "4",
      "--posterior-reduce", "kernel"], "blocked", None, "kernel"),
    # the den's default reduce, "auto", is the one-hot product on the CPU
    (["--topology", "random", "--pdfs", "12", "--den-states", "30",
      "--den-arcs", "120", "--batch", "3", "--frames", "4"], "blocked", None,
     "einsum"),
])
def test_chainbench_twin_on_cpu(capsys, argv, layout, scan, reduce):
    chainbench.main(argv + ["--iters", "1", "--num-arcs", "8",
                            "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "chain_loss_ms_per_sequence"
    assert line["unit"] == "ms/seq" and "vs_baseline" not in line
    assert line["device"] == "cpu" and line["timer"] == "host"
    detail = line["detail"]
    assert (detail["den_layout"], detail["scan_used"],
            detail["posterior_reduce"]) == (layout, scan, reduce)
    assert detail["den_fwd_bwd"] > 0 and detail["num_fwd_bwd"] > 0
    assert line["value"] > 0


@pytest.mark.parametrize("impl,scan", [("high", "loop"), ("pallas", "loop"),
                                       ("auto", "fused")])
def test_chainbench_matmul_impl_maps_to_the_den(capsys, impl, scan):
    """--matmul-impl as profile_den's impls: high and pallas run the loop
    scans (torch.matmul, the den_matmul kernel), auto the port's default
    with --scan-impl; --num-states is accepted and unused."""
    chainbench.main(["--topology", "phone-lm", "--pdfs", "24", "--batch",
                     "128", "--frames", "4", "--scan-impl", "fused",
                     "--matmul-impl", impl, "--num-states", "7",
                     "--iters", "1", "--num-arcs", "8", "--device", "cpu"])
    detail = json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "detail"]
    assert (detail["matmul_impl"], detail["scan_used"]) == (impl, scan)
