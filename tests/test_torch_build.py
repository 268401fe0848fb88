"""`cuda_ntt.build` and `chip_smoke.py`'s phase 1 on the CPU, with `nvcc`
replaced by a stub that writes the library and prints a ptxas report.

A library of the same source is reused, and it comes back with the report
of the build that made it, so phase 1 passes on a reused build as on a
fresh one and fails on a spill either way.
"""

import importlib.util
import os
import subprocess

import pytest

from ringsnark_tpu_torch.ops import cuda_ntt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PTXAS_OK = """ptxas info    : Compiling entry function '_Z10ntt_kernelILb0ELb0ELi4ELi256EEv' for 'sm_90a'
ptxas info    : Function properties for _Z10ntt_kernelILb0ELb0ELi4ELi256EEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 420 bytes cmem[0]
ptxas info    : Compiling entry function '_Z12outer_kernelILi5ELb0ELb0EEv' for 'sm_90a'
ptxas info    : Function properties for _Z12outer_kernelILi5ELb0ELb0EEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers, 412 bytes cmem[0]
"""
PTXAS_SPILL = PTXAS_OK.replace(
    "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
    "ptxas info    : Used 128",
    "24 bytes stack frame, 24 bytes spill stores, 24 bytes spill loads\n"
    "ptxas info    : Used 128")


@pytest.fixture
def nvcc_stub(monkeypatch, tmp_path):
    """Builds go to a fresh directory through a stub compiler; returns the
    list of its calls and a setter for the report it prints."""
    calls, report = [], {"text": PTXAS_OK}

    def run(cmd, capture_output, text):
        calls.append(cmd)
        with open(cmd[cmd.index("-o") + 1], "wb") as f:
            f.write(b"\x7fELF stub")
        return subprocess.CompletedProcess(cmd, 0, stdout="", stderr=report["text"])

    monkeypatch.setattr(cuda_ntt, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(cuda_ntt, "_find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(cuda_ntt.subprocess, "run", run)
    return calls, report


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_build_reuses_library_with_its_report(nvcc_stub):
    calls, _ = nvcc_stub
    first = cuda_ntt.build()
    assert len(calls) == 1 and first.path.exists() and first.log == PTXAS_OK
    assert "-Xptxas" in calls[0] and "arch=compute_90a,code=sm_90a" in calls[0]
    again = cuda_ntt.build()
    assert len(calls) == 1, "a library of the same source is reused"
    assert again == first
    first.path.with_suffix(".log").unlink()  # a library without its report is rebuilt
    assert cuda_ntt.build() == first and len(calls) == 2
    assert sorted(p.name for p in cuda_ntt.BUILD_DIR.iterdir()) == [
        first.path.with_suffix(".log").name, first.path.name]


@pytest.mark.parametrize("spill", [False, True], ids=["no_spill", "spill"])
@pytest.mark.parametrize("reused", [False, True], ids=["fresh", "reused"])
def test_chip_smoke_phase1_on_fresh_and_reused_builds(nvcc_stub, capsys, reused, spill):
    calls, report = nvcc_stub
    report["text"] = PTXAS_SPILL if spill else PTXAS_OK
    chip_smoke = _chip_smoke()
    if reused:
        cuda_ntt.build()
    if spill:
        with pytest.raises(RuntimeError, match="spill"):
            chip_smoke.build_kernels()
    else:
        chip_smoke.build_kernels()
        assert "2 kernels, registers per thread 40-128, spills: none" in capsys.readouterr().out
    assert len(calls) == 1
