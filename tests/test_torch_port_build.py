"""The kernels' build cache, on the CPU: a build keeps its ``ptxas -v``
report beside the library, a library found built brings that report back
into ``_build.LOGS`` without running ``nvcc``, and one found without its
report is built again; and chip_smoke's gate on the fused-MLP,
attention-block, flash-attention, Swin window (GEMM, core and
backward) and talking-heads reports.  A stand-in ``nvcc`` (a Python script that writes the library,
prints a report and counts its calls) takes the compiler's place."""

import importlib.util
import os
import stat
import sys

import pytest

from vit_torch_tpu_torch.ops import _build
from torch_threads import fit_threads_to_workers

fit_threads_to_workers()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REPORT = """\
ptxas info    : Compiling entry function '_Z6kernelv' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelv
    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
"""
SERIALISED = ("ptxas info    : (C7512) Potential Performance Loss: "
              "wgmma.mma_async instructions are serialized due to "
              "insufficient register resources for the wgmma pipeline in "
              "the function '_Z6kernelv'\n")

_NVCC = """#!{python}
import sys
out = sys.argv[sys.argv.index("-o") + 1]
with open(out, "w") as f:
    f.write("library")
with open({calls!r}, "a") as f:
    f.write("x")
print({report!r})
"""


@pytest.fixture
def stand_in(tmp_path, monkeypatch):
    """A source ``k.cu`` and a stand-in nvcc; returns the count of its
    calls."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// kernel\n")
    calls = tmp_path / "calls"
    calls.write_text("")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_NVCC.format(python=sys.executable, calls=str(calls),
                                 report=REPORT.format(spill=0)))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "LOGS", {})
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    return lambda: len(calls.read_text())


def test_a_library_found_built_brings_back_its_report(stand_in):
    _build.build(["k"])
    lib = _build._library_path("k")
    assert stand_in() == 1 and lib.exists()
    assert lib.with_suffix(".log").read_text() == _build.LOGS["k"]
    assert "Used 168 registers" in _build.LOGS["k"]
    _build.LOGS.clear()
    _build.build(["k"])
    assert stand_in() == 1, "a library found built is not built again"
    assert "0 bytes spill stores" in _build.LOGS["k"]


def test_a_library_without_its_report_is_built_again(stand_in):
    lib = _build._library_path("k")
    lib.parent.mkdir(parents=True)
    lib.write_text("library")
    _build.build(["k"])
    assert stand_in() == 1
    assert "Used 168 registers" in lib.with_suffix(".log").read_text()


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


GATE_CASES = pytest.mark.parametrize("log,ok", [
    (REPORT.format(spill=0) * 2, True),
    (REPORT.format(spill=0) + REPORT.format(spill=8), False),
    (REPORT.format(spill=0) + SERIALISED, False),
    ("", False),
], ids=["clean", "spills", "serialised-wgmma", "no-report"])


def _gate(kernel, log, ok):
    gate = _chip_smoke().ptxas_gate
    if ok:
        assert any("Used 168 registers" in line for line in gate(kernel, log))
    else:
        with pytest.raises(AssertionError, match=kernel):
            gate(kernel, log)


@GATE_CASES
def test_chip_smoke_gates_the_fused_mlp_report(log, ok):
    """chip_smoke fails unless every instance's report is there, spills
    nothing and keeps its wgmma asynchronous."""
    _gate("fused_mlp", log, ok)


@GATE_CASES
def test_chip_smoke_gates_the_attn_block_report(log, ok):
    """The same gate on the attention block's two kernels (every head-dim
    and pass-width instance of the attention kernel)."""
    _gate("attn_block", log, ok)


@GATE_CASES
@pytest.mark.parametrize("kernel", ["flash_attention_fwd",
                                    "flash_attention_bwd"])
def test_chip_smoke_gates_the_flash_reports(kernel, log, ok):
    """The same gate on the flash forward's ping-pong kernel and the
    backward's three kernels (each head-dim instance)."""
    _gate(kernel, log, ok)


@GATE_CASES
@pytest.mark.parametrize("kernel", ["window_gemm", "window_attention_fwd"])
def test_chip_smoke_gates_the_window_reports(kernel, log, ok):
    """The same gate on the Swin window GEMM (each tile width) and the
    window-attention core (each key width)."""
    _gate(kernel, log, ok)


@GATE_CASES
def test_chip_smoke_gates_the_window_backward_report(log, ok):
    """The same gate on the window-attention backward (each key width, and
    its dbias reduction)."""
    _gate("window_attention_bwd", log, ok)


@GATE_CASES
def test_chip_smoke_gates_the_talking_heads_report(log, ok):
    """The same gate on talking heads' three kernels (each head-dim and
    padded-heads instance of the statistics, mix and PV launches)."""
    _gate("talking_heads", log, ok)
