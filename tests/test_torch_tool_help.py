"""Every tool of the port parses --help, and every flag its docstring's
Usage block names is one of its options: the port's counterpart of
tests/test_tools.py's test_help_parses and test_documented_flags_exist,
one case per tool (main(["--help"]) in this process).  And every twin
that runs on a device goes to the card when given no --device: here,
with no card, it stops with a message instead of running on the CPU.
"""

import contextlib
import importlib
import io
import re
from pathlib import Path

import pytest
import torch

TOOLS_DIR = Path(__file__).resolve().parents[1] / "kaldi_fp16_tpu_torch" / "tools"
TOOLS = sorted(p.stem for p in TOOLS_DIR.glob("*.py")
               if not p.stem.startswith("_"))


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads here and in the processes a test starts.  The
    tier-1 run shares the cores among its workers, and torch's default, a
    thread per core in every worker, spends most of a small op waiting on
    threads that are not running.  The tool tests import this fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "2")
        yield
    torch.set_num_threads(n)


def usage_flags(doc: str):
    """The kebab-case --flags of the docstring's Usage: block (prose may
    cite other programs' flags)."""
    u = re.search(r"Usage:(.*?)(?:\n\n|$)", doc or "", re.S)
    if not u:
        return []
    return [f for f in re.findall(r"--[a-z][a-z0-9_-]*", u.group(1))
            if "_" not in f]


@pytest.mark.parametrize("tool", TOOLS)
def test_help_parses_and_usage_flags_exist(tool):
    mod = importlib.import_module(f"kaldi_fp16_tpu_torch.tools.{tool}")
    buf = io.StringIO()
    with pytest.raises(SystemExit) as e, contextlib.redirect_stdout(buf):
        mod.main(["--help"])
    assert e.value.code == 0
    text = buf.getvalue()
    assert "usage" in text.lower()
    defined = set(re.findall(r"--[a-z0-9][a-z0-9-]*", text))
    missing = [f for f in usage_flags(mod.__doc__) if f not in defined]
    assert not missing, f"{tool} documents {missing} but never defines them"


def test_the_verification_twins_are_among_the_tools():
    assert {"chainverify", "denverify", "chaintest", "fwdtest", "backtest",
            "sgdtest", "traintest", "soak", "abtest", "gputest", "dltest",
            "egstools", "nscheck", "csrdump"} <= set(TOOLS)


# each twin with a device, and the least argv it needs besides --device
DEVICE_TWINS = [("chainverify", []), ("denverify", []), ("chaintest", []),
                ("fwdtest", []), ("backtest", []), ("sgdtest", []),
                ("traintest", []), ("gputest", []), ("soak", []),
                ("abtest", ["--ab", "grid"])]


@pytest.mark.parametrize("tool,argv", DEVICE_TWINS,
                         ids=[t for t, _ in DEVICE_TWINS])
def test_twin_without_a_card_stops(tool, argv, monkeypatch, tmp_path):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    mod = importlib.import_module(f"kaldi_fp16_tpu_torch.tools.{tool}")
    with pytest.raises(SystemExit) as e:
        mod.main(argv + (["--workdir", str(tmp_path)]
                         if tool in ("soak", "abtest") else []))
    assert "no CUDA device" in str(e.value.code)
    assert not list(tmp_path.iterdir())
