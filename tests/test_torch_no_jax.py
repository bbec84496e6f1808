"""The PyTorch port must import without JAX (the GPU machine has none)
and without the JAX package.

In a fresh interpreter where `import jax` and `import kaldi_fp16_tpu` both
fail, every module of kaldi_fp16_tpu_torch and chip_smoke.py (imported,
not run) must load: the port carries its own copies of what it needs.
"""

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

# the production loop's, the decoding path's, the serving path's, the
# data-parallel path's, the model interchange's and the verification
# harness's modules (data path, NG-SGD, trainer, checkpoint, decoders,
# streaming, process groups, the nnet3 container and loader, tools): each
# must be among the modules the script imports
REQUIRED = [
    "kaldi_fp16_tpu_torch.io." + m for m in (
        "kaldi_io", "fst", "matrix", "egs", "native", "batch", "dataloader",
        "nnet3_binary")
] + [
    "kaldi_fp16_tpu_torch.models.kaldi_loader",
] + [
    "kaldi_fp16_tpu_torch.training." + m for m in (
        "natural_gradient", "schedulers", "trainer", "checkpoint")
] + [
    "kaldi_fp16_tpu_torch.decode." + m for m in (
        "graph", "viterbi", "lattice", "lm", "wer", "device_viterbi",
        "streaming")
] + [
    "kaldi_fp16_tpu_torch.parallel.mesh",
    "kaldi_fp16_tpu_torch.parallel.data_parallel",
    "kaldi_fp16_tpu_torch.utils.metrics", "kaldi_fp16_tpu_torch.utils.profiling",
    "kaldi_fp16_tpu_torch.tools.train",
    "kaldi_fp16_tpu_torch.tools.decode",
    "kaldi_fp16_tpu_torch.tools.decodebench",
    "kaldi_fp16_tpu_torch.tools.streambench",
    "kaldi_fp16_tpu_torch.tools.synthwer",
    "kaldi_fp16_tpu_torch.tools.make_synthetic_egs",
    "kaldi_fp16_tpu_torch.tools.profile_step",
    "kaldi_fp16_tpu_torch.tools.ng_precision",
    "kaldi_fp16_tpu_torch.tools.mpworker",
    "kaldi_fp16_tpu_torch.tools.dryrun_multichip",
    "kaldi_fp16_tpu_torch.tools.modeltools",
    "kaldi_fp16_tpu_torch.tools.loadtest",
    "kaldi_fp16_tpu_torch.tools.nnettest",
] + [
    # the verification harness and its numpy copy of utils/lowp.py
    "kaldi_fp16_tpu_torch.tools." + m for m in (
        "chainverify", "denverify", "chaintest", "fwdtest", "backtest",
        "sgdtest", "traintest", "soak", "abtest", "gputest", "dltest",
        "egstools", "nscheck", "csrdump")
] + [
    "kaldi_fp16_tpu_torch.utils.lowp",
]

SCRIPT = """
import importlib, pkgutil, sys
REQUIRED = %r
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["jaxlib"] = None
sys.modules["kaldi_fp16_tpu"] = None   # and so does the JAX package
import kaldi_fp16_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    kaldi_fp16_tpu_torch.__path__, "kaldi_fp16_tpu_torch.")]
for name in names:
    importlib.import_module(name)
missing = [m for m in REQUIRED if m not in names]
assert not missing, missing
import chip_smoke
assert not any(k == "jax" or k.startswith(("jax.", "jaxlib"))
               or k == "kaldi_fp16_tpu" or k.startswith("kaldi_fp16_tpu.")
               for k, v in sys.modules.items() if v is not None)
print(len(names))
"""


def test_port_and_chip_smoke_import_without_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT % (REQUIRED,)],
                          cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    # models x5, chain x7, ops x4, training x8, tools x31, io x9, utils x3,
    # decode x7, parallel x2, convert, device, the 9 subpackages
    assert int(proc.stdout.strip()) >= 87
